"""The port's training slice on the CPU vs the JAX reference: the whole train
step (``make_train_step(lm_loss_fn(cfg), ...)``, jitted on the reference's
side), AdamW on identical grads with the reference's decay rule, remat and
remat_group, float32 microbatch accumulation, ``token_batch``,
``ShardedBatchIterator``, ``CheckpointManager`` (cross-loads with the
reference's included) and ``python -m repro_torch.launch.train
--device cpu`` with a resume.

Params and AdamW state are drawn by the reference and carried across
(``convert``); the reduced smollm config at S = 32 with q_chunk 8, so the
chunked path (K3's plain version and its plain backward) runs.  Limits:
loss, grad_norm and lr rtol 1e-5; grads rtol 1e-4 / atol 1e-6; params
after 2 steps atol 1e-5 at lr 3e-4 (AdamW's normalised update turns a
grad difference at |g| ~ eps into a step of order lr, so the params' limit
follows lr: at lr 1e-2 the same code differs by 1.2e-4)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_arch
from repro.data.pipeline import ShardedBatchIterator as JIterator
from repro.data.synthetic import token_batch as jax_token_batch
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.common.tree import flatten, leaves
from repro_torch.configs import (
    NUM_MICRO,
    REMAT_GROUP,
    get_config,
    reduced_config,
    training_config,
)
from repro_torch.convert import adamw_state_from_jax, transformer_from_jax, transformer_to_numpy
from repro_torch.data.pipeline import ShardedBatchIterator
from repro_torch.data.synthetic import token_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

ARCH = "smollm-360m"


def _cfgs(**kw):
    jcfg = dataclasses.replace(get_arch(ARCH).model_config(reduced=True), q_chunk=8, kv_chunk=8,
                               **kw)
    pcfg = dataclasses.replace(reduced_config(get_config(ARCH)), q_chunk=8, kv_chunk=8, **kw)
    return jcfg, pcfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _stacked(port_tree_np, jax_tree):
    """Each leaf of the reference's tree beside the port's (numpy, stacked)."""
    for path, a in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        b = port_tree_np
        for key in path:
            b = b[key.key]
        yield jax.tree_util.keystr(path), np.asarray(a, np.float32), b


def _stack(named: dict, n_layers: int) -> dict:
    """Port leaves by name (``blocks/3/attn/wq``) in the reference's stacked
    layout, as numpy."""
    out = {}
    for name, t in named.items():
        parts = name.split("/")
        if parts[0] == "blocks":
            continue
        d = out
        for key in parts[:-1]:
            d = d.setdefault(key, {})
        d[parts[-1]] = t.float().numpy()
    groups = {tuple(n.split("/")[2:]) for n in named if n.startswith("blocks/")}
    out["blocks"] = {}
    for g, n in groups:
        out["blocks"].setdefault(g, {})[n] = np.stack(
            [named[f"blocks/{l}/{g}/{n}"].float().numpy() for l in range(n_layers)])
    return out


def _batch(seed, B=4, S=32, vocab=512):
    toks, labels = token_batch(B, S, vocab, seed=seed)
    return {"tokens": toks, "labels": labels}


# --------------------------------------------------------------------------
# configs


def test_training_and_reduced_configs_match_reference():
    for arch in ("smollm-360m", "qwen2-72b", "codeqwen1.5-7b"):
        ref_arch = get_arch(arch)
        cfg = get_config(arch)
        assert (NUM_MICRO[arch], REMAT_GROUP[arch]) == (ref_arch.num_micro, ref_arch.remat_group)
        want = ref_arch._dryrun_model_cfg(ref_arch.cells["train_4k"])
        assert dataclasses.asdict(training_config(cfg)) == dataclasses.asdict(want)
        assert (dataclasses.asdict(reduced_config(cfg))
                == dataclasses.asdict(ref_arch.model_config(reduced=True)))
        assert cfg.num_params() == ref_arch.model_config().num_params()


# --------------------------------------------------------------------------
# the whole step


@pytest.mark.parametrize("num_micro", [1, 2])
def test_train_step_matches_reference(num_micro):
    jcfg, pcfg = _cfgs()
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    opt_cfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    jstate = jopt.init_state(jparams)
    pparams = transformer_from_jax(pcfg, _np(jparams), device="cpu")
    pstate = adamw_state_from_jax(pcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jts.make_train_step(jts.lm_loss_fn(jcfg), opt_cfg, num_micro=num_micro))
    pstep = pts.make_train_step(pts.lm_loss_fn(pcfg),
                                popt.AdamWConfig(**dataclasses.asdict(opt_cfg)),
                                num_micro=num_micro)
    for s in range(2):
        batch = _batch(seed=s)
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch))
        pparams, pstate, pm = pstep(pparams, pstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        assert int(pstate["step"]) == int(jstate["step"]) == s + 1
    for name, want, got in _stacked(transformer_to_numpy(pparams), jparams):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_grads_match_reference_tied_embeddings_included():
    """The microbatch-mean grads (2 microbatches) against the reference's
    ``_accumulate_grads``; smollm ties embed and lm_head, so embed's grad is
    the gather's plus the head's."""
    jcfg, pcfg = _cfgs()
    assert pcfg.tie_embeddings
    jparams = jtf.init(jax.random.PRNGKey(1), jcfg)
    batch = _batch(seed=3)
    jloss, jgrads, _ = jts._accumulate_grads(jts.lm_loss_fn(jcfg), jparams,
                                             jax.tree.map(jnp.asarray, batch), 2)
    pparams = transformer_from_jax(pcfg, _np(jparams), device="cpu")
    ploss, pgrads, _ = pts._accumulate_grads(pts.lm_loss_fn(pcfg), pparams, batch, 2)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    names = [n for n, _ in flatten(tf.param_tree(pparams))]
    assert all(g.dtype == torch.float32 for g in pgrads)
    stacked = _stack(dict(zip(names, pgrads)), pcfg.n_layers)
    for name, want, got in _stacked(stacked, jgrads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# AdamW


def _adamw_trees(seed):
    """A reference params / grads / state triple in the stacked layout with
    norm scales away from 1, and the same in the port's."""
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(a.shape))
                          .astype(np.float32), jtf.init(jax.random.PRNGKey(seed), jcfg))
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    m = jax.tree.map(lambda a: 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    v = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32), params)
    state = {"step": np.int32(3), "m": m, "v": v}
    pparams = transformer_from_jax(pcfg, params, device="cpu")
    pstate = adamw_state_from_jax(pcfg, state, device="cpu")
    pgrads = adamw_state_from_jax(pcfg, {"step": 0, "m": grads, "v": grads}, device="cpu")["m"]
    return pcfg, params, grads, state, pparams, pgrads, pstate


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference_on_identical_grads(clip):
    pcfg, params, grads, state, pparams, pgrads, pstate = _adamw_trees(seed=2)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jp, js, jm = jopt.adamw_update(cfg, jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, state))
    pp, ps, pm = popt.adamw_update(popt.AdamWConfig(**dataclasses.asdict(cfg)), pparams, pgrads,
                                   pstate)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ps["step"]) == 4
    for name, want, got in _stacked(transformer_to_numpy(pp), jp):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    for key in ("m", "v"):
        for name, want, got in _stacked(_stack(dict(flatten(ps[key])), pcfg.n_layers), js[key]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{key} {name}")


def test_adamw_decays_block_norms_as_the_reference():
    """The reference decays leaves of rank >= 2 in ITS layout, where the
    block norm scales are (L, d): so they decay, and final_norm (d,) does
    not.  Zero grads leave only the decay: a port that skipped the block
    norms would leave them unchanged."""
    pcfg, _, _, _, pparams, pgrads, _ = _adamw_trees(seed=5)
    for g in leaves(pgrads):
        g.zero_()
    before = {n: t.clone() for n, t in flatten(tf.param_tree(pparams))}
    cfg = popt.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    popt.adamw_update(cfg, pparams, pgrads, popt.init_state(pparams))
    after = dict(flatten(tf.param_tree(pparams)))
    for name in ("blocks/0/attn_norm/scale", "blocks/1/mlp_norm/scale", "blocks/0/attn/wq",
                 "embed"):
        assert popt.default_decay_mask(name, after[name])
        want = before[name] * (1 - 1e-2 * 0.1)
        np.testing.assert_allclose(after[name].numpy(), want.numpy(), rtol=1e-6, err_msg=name)
    assert not popt.default_decay_mask("final_norm/scale", after["final_norm/scale"])
    assert torch.equal(after["final_norm/scale"], before["final_norm/scale"])


def test_lr_schedule_matches_reference():
    for cfg in (jopt.AdamWConfig(warmup_steps=10, total_steps=100),
                jopt.AdamWConfig(warmup_steps=0, total_steps=50, schedule="constant")):
        pcfg = popt.AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 5, 10, 11, 60, 100, 150):
            np.testing.assert_allclose(float(popt.lr_schedule(pcfg, step)),
                                       float(jopt.lr_schedule(cfg, step)), rtol=1e-6)


# --------------------------------------------------------------------------
# remat and microbatches


class _CountForwards:
    """Counts K3's forward calls (the plain version here) during a block."""

    def __enter__(self):
        self.n, self._orig = 0, ops._flash_forward

        def counting(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)

        ops._flash_forward = counting
        return self

    def __exit__(self, *exc):
        ops._flash_forward = self._orig
        return False


@pytest.mark.parametrize("remat,group,forwards", [
    (True, 0, lambda L: 2 * L),  # every block recomputed once in the backward
    (True, 2, lambda L: 3 * L - L // 2),  # groups, then their blocks; a group's last block
                                          # is not recomputed a third time
    (True, 4, lambda L: 3 * L - L // 4),
])
def test_remat_and_remat_group_give_the_grads_of_no_remat(remat, group, forwards):
    _, base = _cfgs(n_layers=4)
    batch = _batch(seed=7, B=2)
    params = tf.init(base, seed=0, device="cpu")
    with _CountForwards() as plain:
        _, want, _ = pts._accumulate_grads(pts.lm_loss_fn(base), params, batch, 1)
    cfg = dataclasses.replace(base, remat=remat, remat_group=group)
    with _CountForwards() as counted:
        _, got, _ = pts._accumulate_grads(pts.lm_loss_fn(cfg), params, batch, 1)
    assert plain.n == base.n_layers and counted.n == forwards(base.n_layers)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_microbatch_grads_accumulate_in_float32():
    """bf16 params, 4 microbatches: the step's grads are the float32 sum of
    each microbatch's bf16 grads, scaled by 1/4 — not a bf16 running sum
    (which differs here, so this fails if accumulation drops to bf16)."""
    _, cfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = tf.init(cfg, seed=0, device="cpu")
    batch = _batch(seed=11, B=8)
    loss_fn = pts.lm_loss_fn(cfg)
    loss, got, _ = pts._accumulate_grads(loss_fn, params, batch, 4)
    leaf_list = leaves(tf.param_tree(params))
    f32 = [torch.zeros(p.shape) for p in leaf_list]
    b16 = [torch.zeros(p.shape, dtype=torch.bfloat16) for p in leaf_list]
    losses = []
    for i in range(4):
        mb = {k: torch.as_tensor(v[2 * i: 2 * i + 2]) for k, v in batch.items()}
        l, _ = loss_fn(params, mb)
        losses.append(l.detach().float())
        for a, b, g in zip(f32, b16, torch.autograd.grad(l, leaf_list)):
            assert g.dtype == torch.bfloat16
            a.add_(g.float())
            b.add_(g)
    assert all(g.dtype == torch.float32 for g in got)
    for g, a in zip(got, f32):
        assert torch.equal(g, a * 0.25)
    assert any(not torch.equal(a, b.float()) for a, b in zip(f32, b16))
    assert float(loss) == pytest.approx(float(sum(losses) / 4), rel=1e-6)
    _, single, _ = pts._accumulate_grads(loss_fn, params, batch, 1)
    assert all(g.dtype == torch.bfloat16 for g in single)


def test_losses_of_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pts.dimenet_loss_fn(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pts.recsys_loss_fn("din", None)


def test_cross_entropy_and_bce_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for kw in ({}, {"z_loss": 1e-2}, {"mask": mask}):
        want = jts.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      **{k: jnp.asarray(v) if k == "mask" else v
                                         for k, v in kw.items()})
        got = pts.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     **{k: torch.from_numpy(v) if k == "mask" else v
                                        for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    y = (rng.random(20) > 0.5).astype(np.float32)
    x = rng.standard_normal(20).astype(np.float32) * 5
    np.testing.assert_allclose(float(pts.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jts.bce_with_logits(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6)


@pytest.mark.parametrize("masked", [True, False])
def test_cross_entropy_labels_outside_vocab_match_reference(masked):
    """A label outside [0, V) has gold logit 0, as the reference's iota
    select gives: the loss and its grads w.r.t. the logits match
    ``jax.grad`` at 1e-6 relative, with those tokens masked out (the
    reference gives 2.92399) and with every token counted."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 3], labels[1, 4] = -1, 11
    mask = np.ones((2, 5), np.float32)
    mask[0, 3] = mask[1, 4] = 0.0
    m = mask if masked else None

    def jloss(x):
        return jts.cross_entropy_loss(x, jnp.asarray(labels), z_loss=1e-4,
                                      mask=None if m is None else jnp.asarray(m))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = pts.cross_entropy_loss(x, torch.from_numpy(labels), z_loss=1e-4,
                                 mask=None if m is None else torch.from_numpy(m))
    (got_g,) = torch.autograd.grad(got, x)
    if masked:
        assert float(want) == pytest.approx(2.92399, abs=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)
    # the out-of-range tokens' gold logits get no gradient beyond the softmax's
    assert not np.any(got_g.numpy()[0, 3] < 0)


# --------------------------------------------------------------------------
# data


@pytest.mark.parametrize("batch,seq,vocab,seed", [(4, 32, 512, 0), (3, 17, 49152, 1_000_003)])
def test_token_batch_matches_reference(batch, seq, vocab, seed):
    for got, want in zip(token_batch(batch, seq, vocab, seed=seed),
                         jax_token_batch(batch, seq, vocab, seed=seed)):
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


def _batch_fn(seed, step):
    return {"x": np.full((8, 3), seed * 100 + step, dtype=np.float32),
            "y": np.arange(8, dtype=np.int32) + step}


@pytest.mark.parametrize("host_index,num_hosts,start", [(0, 1, 0), (1, 2, 0), (3, 4, 5)])
def test_sharded_batch_iterator_matches_reference(host_index, num_hosts, start):
    """Determinism, host slicing and resume from a step: the same (step,
    slice) sequence as the reference's iterator, twice."""
    kw = dict(seed=2, start_step=start, host_index=host_index, num_hosts=num_hosts)
    runs = []
    for _ in range(2):
        it = ShardedBatchIterator(_batch_fn, **kw)
        runs.append([next(it) for _ in range(4)])
        it.close()
    jit = JIterator(_batch_fn, **kw)
    want = [next(jit) for _ in range(4)]
    jit.close()
    for run in runs:
        for (s, b), (ws, wb) in zip(run, want):
            assert s == ws
            assert b.keys() == wb.keys()
            for k in b:
                assert np.array_equal(b[k], np.asarray(wb[k]))
    assert runs[0][0][0] == start and runs[0][0][1]["x"].shape == (8 // num_hosts, 3)


def test_sharded_batch_iterator_moves_to_the_device():
    it = ShardedBatchIterator(_batch_fn, seed=1, device="cpu")
    step, batch = next(it)
    it.close()
    assert step == 0 and isinstance(batch["x"], torch.Tensor)
    assert torch.equal(batch["y"], torch.arange(8, dtype=torch.int32))


# --------------------------------------------------------------------------
# checkpoints


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g),
            "b": [torch.randn(5, generator=g).to(torch.bfloat16), torch.tensor(7, dtype=torch.int32)]}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_checkpoint_roundtrip(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree, extra={"loss": 1.5})
    got, extra = mgr.restore(10, _tree(seed=1))
    assert _equal(got, tree) and extra == {"loss": 1.5}
    assert got["b"][0].dtype == torch.bfloat16 and got["b"][1].dtype == torch.int32
    manifest = json.load(open(tmp_path / "step_0000000010" / "manifest.json"))
    assert [a["name"] for a in manifest["arrays"]] == ["b/0", "b/1", "w"]
    assert [a["dtype"] for a in manifest["arrays"]] == ["bfloat16", "int32", "float32"]
    with np.load(tmp_path / "step_0000000010" / "arrays.npz") as z:
        assert z["a0"].dtype == np.dtype("V2")


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path), keep_last_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    step, got, _ = mgr.restore_latest(_tree())
    assert step == 4 and _equal(got, _tree(4))
    assert pckpt.CheckpointManager(str(tmp_path / "empty")).restore_latest(_tree()) is None
    os.makedirs(tmp_path / ".tmp_torn")  # a crashed write is never a step
    assert mgr.steps() == [3, 4]


def test_checkpoint_detects_corruption(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    path = tmp_path / "step_0000000001" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        mgr.restore(1, _tree())


def test_checkpoint_shape_mismatch(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = _tree()
    bad["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"w": torch.zeros(4, 3)})


def test_checkpoint_async(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))  # joins the first write
    mgr.wait()
    assert mgr.steps() == [1, 2]
    assert _equal(mgr.restore(2, _tree())[0], _tree(2))


def test_checkpoint_cross_loads_with_reference(tmp_path):
    """A bf16, a float32 and an int32 leaf: the reference's checkpoint loads
    in the port, and the port's in the reference (as |V2 bytes for bf16,
    what the reference's own bf16 checkpoints reload as)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    h = rng.standard_normal(9).astype(np.float32)
    jtree = {"p": {"w": jnp.asarray(w, jnp.bfloat16), "h": jnp.asarray(h)},
             "o": {"step": jnp.int32(5)}}
    ptree = {"p": {"w": torch.from_numpy(w).to(torch.bfloat16), "h": torch.from_numpy(h)},
             "o": {"step": torch.tensor(5, dtype=torch.int32)}}
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(3, jtree, extra={"loss": 2.0})
    got, extra = pckpt.CheckpointManager(str(tmp_path / "ref")).restore(
        3, {"p": {"w": torch.zeros(6, 4, dtype=torch.bfloat16), "h": torch.zeros(9)},
            "o": {"step": torch.tensor(0, dtype=torch.int32)}})
    assert _equal(got, ptree) and extra == {"loss": 2.0}

    pckpt.CheckpointManager(str(tmp_path / "port")).save(3, ptree, extra={"loss": 2.0})
    back, extra = jckpt.CheckpointManager(str(tmp_path / "port")).restore(3, jtree)
    assert extra == {"loss": 2.0}
    assert back["p"]["w"].dtype == np.dtype("V2")
    assert np.array_equal(back["p"]["w"].view(jnp.bfloat16), np.asarray(jtree["p"]["w"]))
    assert np.array_equal(back["p"]["h"], h) and int(back["o"]["step"]) == 5
    for d in ("ref", "port"):
        m = json.load(open(tmp_path / d / "step_0000000003" / "manifest.json"))
        assert [(a["name"], a["dtype"]) for a in m["arrays"]] == [
            ("o/step", "int32"), ("p/h", "float32"), ("p/w", "bfloat16")]


def test_train_state_checkpoint_restores_bit_equal(tmp_path):
    _, cfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    params = tf.init(cfg, seed=0, device="cpu")
    state = popt.init_state(params)
    step = pts.make_train_step(pts.lm_loss_fn(cfg), popt.AdamWConfig(lr=1e-3, warmup_steps=1))
    params, state, _ = step(params, state, _batch(seed=0))
    tree = {"p": tf.param_tree(params), "o": state}
    mgr = pckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    fresh = tf.init(cfg, seed=9, device="cpu")
    got, _ = mgr.restore(1, {"p": tf.param_tree(fresh), "o": popt.init_state(fresh)})
    assert _equal(got, tree)
    assert got["p"]["embed"].dtype == torch.bfloat16 and got["o"]["step"].dtype == torch.int32


# --------------------------------------------------------------------------
# the entry point


def test_launch_train_cpu_checkpoint_and_resume(tmp_path, capsys):
    common = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
              "--num-micro", "2", "--log-every", "1"]
    whole = launch_train.train(launch_train.parse_args(common))
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = launch_train.train(launch_train.parse_args(common + ckpt))
    assert pckpt.CheckpointManager(str(tmp_path)).steps() == [2]
    resumed = launch_train.train(launch_train.parse_args(common + ckpt + ["--resume"]))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: final loss" in out
    assert first["losses"] == whole["losses"]
    assert resumed["start_step"] == 3 and list(resumed["losses"]) == [3]
    assert resumed["losses"][3] == whole["losses"][3]
    assert all(np.isfinite(list(whole["losses"].values())))
    assert launch_train.main(common[:2] + ["--steps", "1"]) == 0

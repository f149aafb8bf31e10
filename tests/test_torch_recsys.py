"""The port's recsys family on the CPU vs the JAX reference: AutoInt, DIN,
SASRec and xDeepFM at the reference's reduced configs (forward, loss,
grads, one AdamW step), the EmbeddingBag substrate, ``criteo_like_batch``,
the configs, ``convert``'s recsys functions, the retrieval_cand step
(``serve/recsys.py``: K1's plain version here) and the example twin.

Params are drawn by the reference and carried across (``convert``);
inputs come from numpy with a seed.  Limits: logits and hidden states
within 1e-5 of the reference's largest |value| (at least 1); loss 1e-6
relative; each grad within 1e-5 of the reference's largest entry of that
grad; params and moments after one AdamW step within 1e-6.  The retrieval
step: the reference rounds each score to bf16 and the port (K1, float32)
does not, so the id sets are held to agree outside bf16 ties at the 100th
place, and the port's scores to within 1e-5 (relative to the largest) of a
float32 dot of the same bf16 values.
"""

import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import families as jfam
from repro.configs.registry import CRITEO39_VOCABS as J_CRITEO39_VOCABS
from repro.configs.registry import get_arch
from repro.core import recall_at_k
from repro.data.synthetic import criteo_like_batch as jax_criteo_like_batch
from repro.launch.mesh import compat_make_mesh
from repro.models import recsys as jrs
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.common.tree import flatten, unflatten
from repro_torch.configs import (
    CRITEO39_VOCABS,
    EMBED_DIM_RETRIEVAL,
    RECSYS_ARCH_IDS,
    RECSYS_CELLS,
    get_config,
    reduced_recsys_config,
)
from repro_torch.convert import (
    recsys_adamw_state_from_jax,
    recsys_params_from_jax,
    recsys_params_to_numpy,
)
from repro_torch.data.synthetic import criteo_like_batch
from repro_torch.models import recsys as prs
from repro_torch.serve import recsys as pserve
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("autoint", "din", "sasrec", "xdeepfm")
#: a loss case: the arch, and for SASRec whether the batch has sampled negatives
LOSS_CASES = ("autoint", "din", "sasrec", "sasrec-full-vocab", "xdeepfm")
J_INIT = {"autoint": jrs.autoint_init, "din": jrs.din_init, "sasrec": jrs.sasrec_init,
          "xdeepfm": jrs.xdeepfm_init}


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(get_arch(arch).model_config(reduced=True), **kw)
    pcfg = dataclasses.replace(reduced_recsys_config(get_config(arch)), **kw)
    return jcfg, pcfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _jparams(arch, jcfg, seed):
    return J_INIT[arch](jax.random.PRNGKey(seed), jcfg)


def _batch(arch, cfg, B, seed, *, for_loss, pad=False):
    """The reference's smoke batch layout for ``arch`` (numpy).  ``pad``
    puts id -1 into the lookups: sparse fields, DIN's history, SASRec's
    leading positions (a left-padded sequence)."""
    rng = np.random.default_rng(seed + 1000)
    if arch in ("autoint", "xdeepfm"):
        data = criteo_like_batch(B, n_sparse=cfg.n_sparse, vocab_sizes=list(cfg.vocab_sizes),
                                 seed=seed)
        b = {"sparse_ids": data["sparse_ids"], "label": data["label"]}
        if pad:
            b["sparse_ids"][rng.random(b["sparse_ids"].shape) < 0.1] = -1
    elif arch == "din":
        data = criteo_like_batch(B, n_sparse=cfg.n_context,
                                 vocab_sizes=[cfg.context_vocab] * cfg.n_context,
                                 hist_len=cfg.seq_len, n_items=cfg.n_items, seed=seed)
        b = {"history": data["history"], "hist_len": data["hist_len"],
             "target_item": data["target_item"], "context_ids": data["sparse_ids"],
             "label": data["label"]}
        if pad:
            b["history"][rng.random(b["history"].shape) < 0.1] = -1
            b["context_ids"][0, 0] = -1
    else:
        seq = rng.integers(0, cfg.n_items, (B, cfg.seq_len + 1)).astype(np.int32)
        b = {"item_seq": seq[:, :-1], "next_items": seq[:, 1:].copy()}
        if arch == "sasrec":
            b["neg_items"] = rng.integers(0, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)
        b["next_items"][rng.random(b["next_items"].shape) < 0.2] = -1  # padded labels
        if pad:
            lead = rng.integers(0, cfg.seq_len // 2, B)
            b["item_seq"][np.arange(cfg.seq_len)[None, :] < lead[:, None]] = -1
    if not for_loss:
        b = {k: v for k, v in b.items() if k not in ("label", "next_items", "neg_items")}
    return b


def _jforward(arch, jparams, jcfg, b):
    """The reference's serving forward, jitted."""

    def fwd(p, j):
        if arch == "autoint":
            return jrs.autoint_apply(p, jcfg, j["sparse_ids"])
        if arch == "xdeepfm":
            return jrs.xdeepfm_apply(p, jcfg, j["sparse_ids"])
        if arch == "din":
            return jrs.din_apply(p, jcfg, history=j["history"], hist_len=j["hist_len"],
                                 target_item=j["target_item"], context_ids=j["context_ids"])
        return jrs.sasrec_encode(p, jcfg, j["item_seq"])[:, -1]

    return jax.jit(fwd)(jparams, {k: jnp.asarray(v) for k, v in b.items()})


def _close(got, want, tol, label):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    assert np.all(np.isfinite(got)), label
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0), \
        f"{label}: max abs err {err}"


def _leaves_by_name(jtree):
    """{"/"-joined path: numpy leaf} of a reference pytree, in the port's
    naming (``blocks/0/wq``)."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = np.asarray(a, np.float32)
    return out


# --------------------------------------------------------------------------
# configs and data


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    ref = get_arch(arch)
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.model_config())
    assert (dataclasses.asdict(reduced_recsys_config(cfg))
            == dataclasses.asdict(ref.model_config(reduced=True)))
    assert cfg.num_params() == ref.model_config().num_params()
    assert EMBED_DIM_RETRIEVAL[arch] == (ref.embed_dim_retrieval or 64)
    assert arch in RECSYS_ARCH_IDS and CRITEO39_VOCABS == J_CRITEO39_VOCABS
    for name, cell in jfam.RECSYS_CELLS.items():
        assert RECSYS_CELLS[name] == {"kind": cell.kind, "global_batch": cell.global_batch,
                                      **dict(cell.extra)}
    assert set(RECSYS_CELLS) == set(jfam.RECSYS_CELLS)


@pytest.mark.parametrize("kw", [
    {"batch": 64},
    {"batch": 33, "n_sparse": 5, "vocab_sizes": [7, 100, 3, 1000, 2], "seed": 4},
    {"batch": 20, "n_sparse": 8, "n_dense": 3, "hist_len": 12, "n_items": 500, "seed": 9},
    {"batch": 16, "n_sparse": 2, "vocab_sizes": [5, 5], "hist_len": 4, "n_items": 0, "seed": 2},
])
def test_criteo_like_batch_matches_reference(kw):
    want = jax_criteo_like_batch(**kw)
    got = criteo_like_batch(**kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --------------------------------------------------------------------------
# the EmbeddingBag substrate


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    """Padding ids (-1) dropped, bags 2 and 5 empty (zeros, the mean
    divided by max(count, 1)), ids out of bag order."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 40, 30).astype(np.int32)
    ids[[3, 11, 17]] = -1
    seg = rng.choice(np.array([0, 1, 3, 4, 6]), 30).astype(np.int32)
    seg[[3]] = 2  # a padding id in an otherwise empty bag
    want = jrs.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 7, mode)
    got = prs.embedding_bag(torch.from_numpy(table), ids, seg, 7, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[2].any() and not got[5].any()
    with pytest.raises(ValueError, match="mode"):
        prs.embedding_bag(torch.from_numpy(table), ids, seg, 7, "max")


def test_embedding_lookups_match_reference():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    ids = rng.integers(-1, 30, (5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        prs.embedding_lookup(torch.from_numpy(table), ids).numpy(),
        np.asarray(jrs.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))
    vocab = [10, 5, 15]
    fused = rng.standard_normal((512, 3)).astype(np.float32)
    sparse = np.stack([rng.integers(-1, v, 9) for v in vocab], 1).astype(np.int32)
    np.testing.assert_array_equal(prs.field_offsets(vocab), jrs.field_offsets(vocab))
    np.testing.assert_array_equal(
        prs.multi_field_lookup({"table": torch.from_numpy(fused)}, sparse, vocab).numpy(),
        np.asarray(jrs.multi_field_lookup({"table": jnp.asarray(fused)}, jnp.asarray(sparse),
                                          vocab)))


def test_lookup_backwards_match_reference_scatter_adds():
    """The lookups' table grads on ids that repeat many times (and -1
    padding) against the reference's vjp, a scatter-add: within float32
    rounding (the port sums each row's grads in index order, in a fixed
    order on the card too); two runs bit-equal."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((12, 4)).astype(np.float32)
    ids = rng.integers(-1, 12, (40, 6)).astype(np.int32)
    seg = rng.integers(0, 9, ids.size).astype(np.int32)
    vocab = [5, 7]
    fused = rng.standard_normal((512, 4)).astype(np.float32)
    sparse = np.stack([rng.integers(-1, v, 300) for v in vocab], 1).astype(np.int32)
    cases = (
        (table, lambda t: jrs.embedding_lookup(t, jnp.asarray(ids)),
         lambda t: prs.embedding_lookup(t, ids)),
        (table, lambda t: jrs.embedding_bag(t, jnp.asarray(ids.reshape(-1)), jnp.asarray(seg),
                                            9, "mean"),
         lambda t: prs.embedding_bag(t, ids.reshape(-1), seg, 9, "mean")),
        (fused, lambda t: jrs.multi_field_lookup({"table": t}, jnp.asarray(sparse), vocab),
         lambda t: prs.multi_field_lookup({"table": t}, sparse, vocab)),
    )
    for tab, jfn, pfn in cases:
        want, vjp = jax.vjp(jfn, jnp.asarray(tab))
        cot = rng.standard_normal(want.shape).astype(np.float32) * 10
        grads = []
        for _ in range(2):
            t = torch.from_numpy(tab).requires_grad_()
            got = pfn(t)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
            grads.append(torch.autograd.grad(got, t, torch.from_numpy(cot))[0])
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                                   rtol=1e-6, atol=1e-5)
        assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_scales_match_reference(arch):
    """The port's own draws: the reference's tree, shapes, dtypes (bf16 too)
    and scales (tables 0.01, dense 1/sqrt(fan_in), norms 1, biases 0)."""
    jcfg, pcfg = _cfgs(arch)
    want = _leaves_by_name(_jparams(arch, jcfg, 0))
    got = dict(flatten(prs.init(pcfg, seed=0, device="cpu")))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif w.size > 500:
            assert 0.8 < g.std() / w.std() < 1.25, name
    b16 = prs.init(dataclasses.replace(pcfg, param_dtype="bfloat16"), seed=0, device="cpu")
    f32 = prs.init(pcfg, seed=0, device="cpu")
    for (name, a), (_, b) in zip(flatten(b16), flatten(f32)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16)), name


# --------------------------------------------------------------------------
# forward, loss, grads, AdamW


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, pcfg = _cfgs(arch)
    jparams = _jparams(arch, jcfg, 1)
    pparams = recsys_params_from_jax(_np(jparams), device="cpu")
    b = _batch(arch, pcfg, 24, seed=2, for_loss=False, pad=True)
    with torch.no_grad():
        got = prs.forward(pparams, pcfg, b)
    _close(got.numpy(), _jforward(arch, jparams, jcfg, b), 1e-5, f"{arch} forward")
    if arch == "sasrec":
        j_seq = jnp.asarray(b["item_seq"])
        with torch.no_grad():
            hidden = prs.sasrec_encode(pparams, pcfg, b["item_seq"])
            logits = prs.sasrec_apply(pparams, pcfg, b["item_seq"])
            pos, neg = prs.sasrec_sampled_logits(pparams, pcfg, b["item_seq"], b["item_seq"],
                                                 np.flip(b["item_seq"], 1).copy())
            cands = np.array([3, 7, -1, 200], np.int32)
            sc = prs.sasrec_score_candidates(pparams, pcfg, b["item_seq"], cands)
            sc3 = prs.sasrec_score_candidates(pparams, pcfg, b["item_seq"],
                                              np.tile(cands, (24, 1)))
        _close(hidden.numpy(), jrs.sasrec_encode(jparams, jcfg, j_seq), 1e-5, "hidden")
        assert not hidden[b["item_seq"] < 0].any()  # padded positions are zero
        _close(logits.numpy(), jrs.sasrec_apply(jparams, jcfg, j_seq), 1e-5, "logits")
        jpos, jneg = jrs.sasrec_sampled_logits(jparams, jcfg, j_seq, j_seq,
                                               jnp.asarray(np.flip(b["item_seq"], 1).copy()))
        _close(pos.numpy(), jpos, 1e-5, "pos")
        _close(neg.numpy(), jneg, 1e-5, "neg")
        want = jrs.sasrec_score_candidates(jparams, jcfg, j_seq, jnp.asarray(cands))
        _close(sc.numpy(), want, 1e-5, "candidates")
        _close(sc3.numpy(), want, 1e-5, "candidates per user")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_follows_reference_dtypes(arch):
    """The serve cells' bf16 params: the output dtype of the reference's
    promotion (SASRec's float32), and values within a few bf16 ulps."""
    jcfg, pcfg = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = _jparams(arch, jcfg, 3)
    pparams = recsys_params_from_jax(_np(jparams), dtype=torch.bfloat16, device="cpu")
    b = _batch(arch, pcfg, 16, seed=4, for_loss=False)
    with torch.no_grad():
        got = prs.forward(pparams, pcfg, b)
    want = _jforward(arch, jparams, jcfg, b)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), 2.0 ** -5, f"{arch} bf16")


def _loss_setup(case, B=32, seed=5):
    arch = case.split("-")[0]
    jcfg, pcfg = _cfgs(arch)
    b = _batch(case, pcfg, B, seed=seed, for_loss=True)
    jloss = jts.recsys_loss_fn(arch, jcfg)
    ploss = pts.recsys_loss_fn(arch, pcfg)
    return arch, jcfg, pcfg, b, jloss, ploss


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_grads_match_reference(case):
    arch, jcfg, pcfg, b, jloss, ploss = _loss_setup(case)
    jparams = _jparams(arch, jcfg, 6)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    pparams = recsys_params_from_jax(_np(jparams), device="cpu")
    got, grads, _ = pts._accumulate_grads(ploss, pparams, b, 1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    names = [n for n, _ in flatten(pparams)]
    jg = _leaves_by_name(jgrads)
    assert names == list(jg)
    for name, g in zip(names, grads):
        _close(g.numpy(), jg[name], 1e-5, f"{case} grad {name}")


@pytest.mark.parametrize("case", LOSS_CASES)
def test_train_step_matches_reference(case):
    """One whole step (``make_train_step(recsys_loss_fn(...), AdamW)``) from
    the same params: loss, grad norm and lr within 1e-6 relative, the
    moments within 1e-6, the params within 1e-5 (AdamW's normalised update
    turns a grad difference at |g| near eps into a step of order lr, 5e-4
    here: the params' limit follows lr, as in the LM's step test)."""
    arch, jcfg, pcfg, b, jloss, ploss = _loss_setup(case, seed=7)
    jparams = _jparams(arch, jcfg, 8)
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    jstate = jopt.init_state(jparams)
    pparams = recsys_params_from_jax(_np(jparams), device="cpu")
    pstate = recsys_adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jts.make_train_step(jloss, opt_cfg))
    pstep = pts.make_train_step(ploss, popt.AdamWConfig(**dataclasses.asdict(opt_cfg)))
    jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
    pparams, pstate, pm = pstep(pparams, pstate, b)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
    assert int(pstate["step"]) == int(jstate["step"]) == 1
    for label, got, want, tol in (("params", pparams, jparams, 1e-5),
                                  ("m", pstate["m"], jstate["m"], 1e-6),
                                  ("v", pstate["v"], jstate["v"], 1e-6)):
        jl = _leaves_by_name(want)
        for name, t in flatten(got):
            np.testing.assert_allclose(t.detach().numpy(), jl[name], rtol=0, atol=tol,
                                       err_msg=f"{case} {label} {name}")


@pytest.mark.parametrize("case", LOSS_CASES)
def test_adamw_step_matches_reference(case):
    """One AdamW step on the reference's own grads (carried across), from
    params with SASRec's norm scales away from 1: params and moments within
    1e-6.  A port that decayed SASRec's ``blocks/i/ln1`` / ``ln2`` (the
    LM's stacked rule) would be off by lr x 0.1 x |scale|, ~1e-4 here."""
    arch, jcfg, pcfg, b, jloss, _ = _loss_setup(case, seed=13)
    rng = np.random.default_rng(14)
    jparams = jax.tree.map(lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
                           _np(_jparams(arch, jcfg, 15)))
    _, jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jparams), {k: jnp.asarray(v) for k, v in b.items()})
    cfg = jopt.AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=30)
    jstate = {"step": np.int32(2), "m": _np(jax.tree.map(lambda g: 0.1 * g, jgrads)),
              "v": _np(jax.tree.map(lambda g: 0.5 * g * g, jgrads))}
    jp, js, jm = jax.jit(lambda p, g, st: jopt.adamw_update(cfg, p, g, st))(
        jax.tree.map(jnp.asarray, jparams), jgrads, jax.tree.map(jnp.asarray, jstate))
    pparams = recsys_params_from_jax(jparams, device="cpu")
    pgrads = recsys_params_from_jax(_np(jgrads), device="cpu")
    pstate = recsys_adamw_state_from_jax(jstate, device="cpu")
    pp, ps, pm = popt.adamw_update(popt.AdamWConfig(**dataclasses.asdict(cfg)), pparams, pgrads,
                                   pstate)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(ps["step"]) == 3
    for label, got, want in (("params", pp, jp), ("m", ps["m"], js["m"]),
                             ("v", ps["v"], js["v"])):
        jl = _leaves_by_name(want)
        for name, t in flatten(got):
            np.testing.assert_allclose(t.numpy(), jl[name], rtol=0, atol=1e-6,
                                       err_msg=f"{case} {label} {name}")


def test_sasrec_block_norms_do_not_decay():
    """Zero grads leave only the decay: the reference's ``leaf.ndim >= 2``
    on SASRec's unstacked blocks decays the (d, d) weights and the tables,
    not ``ln1`` / ``ln2``; the LM rule (blocks stacked) would decay them."""
    _, pcfg = _cfgs("sasrec")
    params = prs.init(pcfg, seed=0, device="cpu")
    with torch.no_grad():
        for bp in params["blocks"]:
            bp["ln1"].mul_(1.5)
    before = {n: t.clone() for n, t in flatten(params)}
    grads = unflatten(params, [torch.zeros_like(t) for t in before.values()])
    cfg = popt.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    popt.adamw_update(cfg, params, grads, popt.init_state(params))
    after = dict(flatten(params))
    for name in after:
        decays = after[name].dim() >= 2
        want = before[name] * (1 - 1e-2 * 0.1) if decays else before[name]
        np.testing.assert_allclose(after[name].numpy(), want.numpy(), rtol=1e-6, err_msg=name)
        assert popt.unstacked_decay_mask(name, after[name]) == decays
    assert popt.default_decay_mask("blocks/0/ln1", after["blocks/0/ln1"])  # the LM rule


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    jcfg, _ = _cfgs(arch)
    jparams = _jparams(arch, jcfg, 9)
    params_np = _np(jparams)
    params = recsys_params_from_jax(params_np, device="cpu")
    back = recsys_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params_np)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params_np)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    b16 = recsys_params_from_jax(params_np, dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(b16))
    state = jopt.init_state(jparams)
    state = {"step": np.int32(4), "m": _np(jax.tree.map(lambda a: a + 1, state["m"])),
             "v": _np(state["v"])}
    pstate = recsys_adamw_state_from_jax(state, device="cpu")
    assert int(pstate["step"]) == 4 and pstate["step"].dtype == torch.int32
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(state[key]),
                        jax.tree.leaves(recsys_params_to_numpy(pstate[key]))):
            np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------------
# the retrieval_cand step


N_CAND = 4000


@pytest.fixture(scope="module")
def mesh():
    return compat_make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_step_matches_reference(arch, mesh):
    """The reference's own step (``RecsysArch.build_cell`` for a
    retrieval_cand cell of 4,000 candidates at the reduced config, bf16
    params), jitted, against the port's.  The user vectors agree within a
    bf16 ulp.  From the reference's user vector, K1's plain version returns
    every id whose reference score is strictly above the reference's 100th;
    an id of only one of the two lists ties with the 100th score at bf16
    precision (the reference may round each score to bf16, the port does
    not); a score of both lists is the reference's within a bf16 ulp.  The
    port's scores descend, its ids are int32 under ``n_cand``, and its
    scores are within 1e-5 (of the largest) of a float32 dot of the bf16
    values."""
    jcfg, pcfg = _cfgs(arch)
    d_emb = EMBED_DIM_RETRIEVAL[arch]
    ref_arch = jfam.RecsysArch(arch, jcfg, embed_dim_retrieval=get_arch(arch).embed_dim_retrieval)
    cell = jfam.Cell("retrieval_cand", "retrieval", global_batch=1,
                     extra=(("n_candidates", N_CAND),))
    spec = ref_arch.build_cell(cell, mesh)
    jcfg16 = dataclasses.replace(jcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    pcfg16 = dataclasses.replace(pcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = _jparams(arch, jcfg16, 10)
    b = _batch(arch, pcfg, 1, seed=11, for_loss=False)
    n_pad = pserve.padded_candidates(N_CAND)
    assert n_pad == 4096
    rng = np.random.default_rng(12)
    cand = jnp.asarray(rng.standard_normal((n_pad, d_emb)).astype(np.float32), jnp.bfloat16)
    ud = d_emb if arch == "sasrec" else 1
    proj = jnp.asarray((rng.standard_normal((ud, d_emb)) / np.sqrt(ud)).astype(np.float32),
                       jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    top_r, idx_r = jax.jit(spec.fn)(jparams, jb, cand, proj)
    top_r, idx_r = np.asarray(top_r)[0], np.asarray(idx_r)[0]
    # the reference's user vector, by the step's own lines
    fwd = ref_arch._forward_fn(jcfg16, jfam.make_ctx(mesh))
    u_ref = jax.jit(lambda p, bb: (fwd(p, bb).reshape(1, -1).astype(jnp.bfloat16) @ proj)
                    .astype(jnp.bfloat16))(jparams, jb)
    u_ref32 = np.asarray(u_ref, np.float32)

    pparams = recsys_params_from_jax(_np(jparams), dtype=torch.bfloat16, device="cpu")
    proj_t = torch.from_numpy(np.asarray(proj, np.float32)).to(torch.bfloat16)
    cand32 = np.asarray(cand, np.float32)
    cand_t = torch.from_numpy(cand32)
    u_port = pserve.user_vector(pparams, pcfg16, b, proj_t)
    assert u_port.dtype == torch.float32 and u_port.shape == (1, d_emb)
    assert torch.equal(u_port, u_port.to(torch.bfloat16).float())  # bf16 values
    _close(u_port.numpy(), u_ref32, 2.0 ** -8, f"{arch} user vector")

    ulp = 2.0 ** -8 * abs(float(top_r[-1]))
    ref = dict(zip(idx_r.tolist(), top_r.tolist()))

    def check(scores, ids, u, label):
        scores, ids = scores.numpy()[0], ids.numpy()[0]
        assert ids.dtype == np.int32 and scores.shape == ids.shape == (100,), label
        assert np.all(np.diff(scores) <= 0) and np.all((ids >= 0) & (ids < N_CAND)), label
        assert len(set(ids.tolist())) == 100, label
        _close(scores, cand32[ids] @ u[0], 1e-5, f"{label} scores")
        port = dict(zip(ids.tolist(), scores.tolist()))
        assert set(idx_r[top_r > top_r[-1]].tolist()) <= set(port), f"{label}: a strictly-above id"
        for i in set(port) - set(ref):
            assert abs(port[i] - top_r[-1]) <= ulp, f"{label}: id {i} is not a tie at the 100th"
        for i in set(port) & set(ref):
            assert abs(port[i] - ref[i]) <= 2.0 ** -8 * abs(ref[i]), f"{label}: score of id {i}"

    check(*pserve.scan_candidates(torch.from_numpy(u_ref32), cand_t, N_CAND), u_ref32,
          f"{arch} scan of the reference's user vector")
    check(*pserve.retrieval_step(pparams, pcfg16, b, cand_t, proj_t, N_CAND), u_port.numpy(),
          f"{arch} step")


# --------------------------------------------------------------------------
# the example


def test_example_matches_reference():
    """``examples/recsys_retrieval_torch.py`` on the CPU against the
    reference's script on the same data: the scan engine's ids equal, so
    the same R@50."""
    ref = runpy.run_path(str(ROOT / "examples" / "recsys_retrieval.py"), run_name="ref_example")
    example = runpy.run_path(str(ROOT / "examples" / "recsys_retrieval_torch.py"),
                             run_name="example")
    out = example["retrieve"]("cpu")
    np.testing.assert_array_equal(out["ids"], ref["ids"])
    np.testing.assert_array_equal(out["truth"], ref["ti"])
    want = recall_at_k(ref["ids"], ref["ti"], 50)
    assert out["r_at_k"] == want
    assert example["main"]("cpu") == want

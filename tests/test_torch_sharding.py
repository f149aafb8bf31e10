"""The port's sharding rules (``repro_torch.distributed.sharding_rules``),
the LMs' and recsys tables' param specs, and the sharded LM steps, vs the
JAX package.

* ``ShardingCtx.spec`` of every logical name equals the reference's on
  meshes with and without 'pod', under ``make_ctx``'s pod rule and
  smollm-360m's tp=False rules (no device needed: both read the mesh's
  axis sizes).
* ``transformer.param_specs`` and ``RecsysArch._param_specs`` equal the
  reference's on every arch's params at full width (the reference's from
  ``jax.eval_shape``, the port's fake tensors).
* Every leaf's local shard at mesh 2 x 4 (a DTensor on a fake world of 8
  ranks) has ``NamedSharding.shard_shape`` of the reference, which runs in
  a child with 8 forced host devices as ``tests/test_distributed.py`` runs
  it.
* In a gloo world of 2 x 2 ranks, reduced LM train steps under FSDP + TP
  (codeqwen: dense GQA; deepseek-moe-16b: MoE's expert-parallel path;
  deepseek-v2-lite-16b: MLA through the K3 path) match their one-device
  counterparts within 1e-5: loss, grads and params after one step.  The
  one-device step takes each rank's microbatch rows as its own
  microbatch, since MoE's aux loss is each routing group's (the
  reference's ``pmean`` over the batch axes).
* In the same world, a prefill cell (its bf16 cache sharded by sequence
  over 'model') on a prompt of 8, then one decode step (the flash-decoding
  merge over the cache's shards; MLA's absorbed form on DTensors) match one
  device: logits within 1e-5, the cache within one bf16 rounding.

Spawned ranks import this module, so JAX is imported inside the tests.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.families import Cell, get_arch, make_ctx
from repro_torch.distributed.sharding_rules import ShardingCtx, flat_specs
from repro_torch.launch.mesh import run_world

ROOT = Path(__file__).resolve().parents[1]
LM_IDS = ("codeqwen1.5-7b", "qwen2-72b", "smollm-360m", "deepseek-moe-16b",
          "deepseek-v2-lite-16b")
RECSYS_IDS = ("autoint", "din", "sasrec", "xdeepfm")
MESHES = {"2d": {"data": 2, "model": 4}, "pod": {"pod": 2, "data": 2, "model": 4}}
NAMES = ("batch", "fsdp", "model", "expert", "seq", "kv_seq", "vocab", None)


def _port_mesh(shape: dict):
    return types.SimpleNamespace(mesh_dim_names=tuple(shape), shape=tuple(shape.values()))


def _ref_tp_false(ctx, kind, mesh_shape):
    """The reference's tp=False rules (``LMArch.build_cell``,
    ``families.py:196-212``)."""
    rules = dict(ctx.rules)
    rules["model"] = ()
    rules["vocab"] = ()
    rules["expert"] = ()
    if kind == "train":
        if "pod" in mesh_shape:
            rules["batch"] = ("pod", "data")
            rules["fsdp"] = ("model",)
        else:
            rules["batch"] = ("data", "model")
    return dataclasses.replace(ctx, rules=rules)


def _ctx_pair(mesh_key, variant):
    from repro.configs import families as rf

    shape = MESHES[mesh_key]
    ref_mesh = types.SimpleNamespace(shape=shape)
    port_mesh = _port_mesh(shape)
    if variant == "default":
        return rf.make_ctx(ref_mesh), make_ctx(port_mesh)
    if variant == "no_pod_dp":
        return rf.make_ctx(ref_mesh, pod_dp=False), make_ctx(port_mesh, pod_dp=False)
    kind = variant.split("_")[-1]  # tp_false_train / tp_false_decode
    ref = _ref_tp_false(rf.make_ctx(ref_mesh), kind, shape)
    port = get_arch("smollm-360m").cell_ctx(Cell("c", kind), port_mesh)
    return ref, port


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("variant", ["default", "no_pod_dp", "tp_false_train",
                                     "tp_false_decode"])
def test_spec_matches_reference(mesh_key, variant):
    ref, port = _ctx_pair(mesh_key, variant)
    assert port.rules == ref.rules
    for name in NAMES:
        assert port.spec(name) == tuple(ref.spec(name)), name
    assert port.spec("batch", None, "vocab") == tuple(ref.spec("batch", None, "vocab"))
    off = ShardingCtx()
    assert off.spec("batch", "model") == (None, None)
    assert off.constrain("x", "batch") == "x"


def _ref_flat(tree):
    import jax
    from jax.sharding import PartitionSpec as P

    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, P))[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = tuple(spec)
    return out


def _lm_specs(arch_id):
    """(reference's spec tree flattened, port's) of an LM's train cell on
    mesh 2 x 4."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf
    from repro_torch.models import transformer as tf
    from torch._subclasses.fake_tensor import FakeTensorMode

    ref_arch, arch = ref_get_arch(arch_id), get_arch(arch_id)
    cell = arch.cells["train_4k"]
    shape = MESHES["2d"]
    ref_ctx = _ctx_pair("2d", "tp_false_train" if arch_id == "smollm-360m" else "default")[0]
    ref_cfg = ref_arch._dryrun_model_cfg(ref_arch.cells["train_4k"])
    ref_params = jax.eval_shape(lambda k: rtf.init(k, ref_cfg), jax.random.PRNGKey(0))
    ref = _ref_flat(rtf.param_specs(ref_params, ref_cfg, ref_ctx))
    ctx = arch.cell_ctx(cell, _port_mesh(shape))
    cfg = arch._dryrun_model_cfg(cell)
    with FakeTensorMode():
        params = tf.init(cfg, 0, "cpu")
    return ref, flat_specs(tf.param_specs(params, cfg, ctx)), params, cfg, ctx


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_param_specs_match_reference(arch_id):
    ref, port, *_ = _lm_specs(arch_id)
    assert port == ref


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_recsys_param_specs_match_reference(arch_id):
    from repro.configs import get_arch as ref_get_arch
    from repro_torch.models import recsys as rs
    from torch._subclasses.fake_tensor import FakeTensorMode

    ref_arch = ref_get_arch(arch_id)
    ref_cfg = dataclasses.replace(ref_arch._config, param_dtype="bfloat16")
    ref = _ref_flat(ref_arch._param_specs(ref_arch._init_abstract(ref_cfg)))
    arch = get_arch(arch_id)
    with FakeTensorMode():
        params = rs.init(dataclasses.replace(arch._config, param_dtype="bfloat16"), 0, "cpu")
    port = flat_specs(arch._param_specs(params))
    assert port == ref
    assert any(s == ("model", None) for s in port.values())  # a table is sharded


_SHARD_SHAPES = """
import json, dataclasses, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.configs.families import make_ctx
from repro.launch.mesh import make_debug_mesh
from repro.models import transformer as tf

mesh = make_debug_mesh(2, 4)
out = {}
for aid in %r:
    arch = get_arch(aid)
    cell = arch.cells["train_4k"]
    ctx = make_ctx(mesh)
    if not arch.tp:
        rules = dict(ctx.rules, model=(), vocab=(), expert=(), batch=("data", "model"))
        ctx = dataclasses.replace(ctx, rules=rules)
    cfg = arch._dryrun_model_cfg(cell)
    params = jax.eval_shape(lambda k: tf.init(k, cfg), jax.random.PRNGKey(0))
    specs = tf.param_specs(params, cfg, ctx)
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    rec = {}
    for (path, leaf), spec in zip(flat_p, flat_s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        try:
            rec[name] = list(NamedSharding(mesh, spec).shard_shape(leaf.shape))
        except ValueError:
            rec[name] = "uneven"
    out[aid] = rec
print("SHAPES" + json.dumps(out))
"""


def test_local_shard_shapes_match_named_sharding():
    """Each LM param's local shard on rank 0 of a fake 2 x 4 world equals
    the reference's ``NamedSharding.shard_shape``; the reference side runs
    in a child with 8 forced host devices.  A stacked block leaf's shard
    is its layers' (the port keeps blocks per layer)."""
    from repro_torch.launch.dryrun import fake_mesh
    import torch.distributed as dist

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARD_SHAPES % (LM_IDS,))],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.split("SHAPES", 1)[1])
    try:
        mesh = fake_mesh((2, 4), ("data", "model"))
        compared = 0
        for aid in LM_IDS:
            arch = get_arch(aid)
            spec = arch.build_cell(arch.cells["train_4k"], mesh)
            params = spec.args[0]
            from repro_torch.common.tree import flatten
            from repro_torch.models.transformer import param_tree

            for name, p in flatten(param_tree(params)):
                parts = name.split("/")
                if parts[0] in ("blocks", "dense_blocks"):
                    key = "/".join([parts[0]] + parts[2:])
                    want = ref[aid][key]
                    want = want if want == "uneven" else want[1:]
                else:
                    want = ref[aid][name]
                if want == "uneven":
                    continue
                assert list(p.to_local().shape) == want, (aid, name)
                compared += 1
        assert compared > 100
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# sharded LM steps in a gloo world vs one device
# ---------------------------------------------------------------------------

LM_STEPS = {"codeqwen1.5-7b": {}, "deepseek-moe-16b": {},
            "deepseek-v2-lite-16b": {"q_chunk": 8}}
B, S, NUM_MICRO = 4, 16, 2


def _reduced_arch(arch_id):
    arch = copy.copy(get_arch(arch_id))
    cfg = dataclasses.replace(arch.model_config(reduced=True), remat=True,
                              **LM_STEPS[arch_id])
    arch._dryrun_model_cfg = lambda cell: cfg
    arch.num_micro = NUM_MICRO
    return arch, cfg


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().to(torch.float32).numpy()


def _lm_world(mesh, arch_ids):
    """On each rank: every arch's sharded grads (placed as the params, then
    gathered) and the params after one step; rank 0 returns them."""
    from repro_torch.common.tree import flatten
    from repro_torch.models.transformer import param_tree
    from repro_torch.train.optimizer import tree_of
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

    out = {}
    for aid in arch_ids:
        arch, cfg = _reduced_arch(aid)
        cell = Cell("train_4k", "train", global_batch=B, seq_len=S)
        spec = arch.build_cell(cell, mesh)
        params, st, batch = spec.make_args(seed=0, device="cpu")
        loss, grads, _ = _accumulate_grads(lm_loss_fn(cfg, arch.cell_ctx(cell, mesh)), params,
                                           batch, NUM_MICRO)
        names = [n for n, _ in flatten(tree_of(params))]
        g = {n: _full(x) for n, x in zip(names, grads)}
        _, _, m = spec.fn(params, st, batch)
        p = {n: _full(x) for n, x in flatten(param_tree(params))}
        out[aid] = {"loss": float(_full(loss)), "step_loss": float(_full(m["loss"])),
                    "grads": g, "params": p}
    return out if mesh.get_rank() == 0 else None


@pytest.fixture(scope="module")
def lm_world():
    return run_world(_lm_world, (2, 2), ("data", "model"), (tuple(LM_STEPS),), device="cpu")[0]


def _one_device(arch_id):
    """The same params and batch on one device, each rank's microbatch rows
    its own microbatch (rank-major within each microbatch index)."""
    from repro_torch.common.tree import flatten
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_state, tree_of
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn, make_train_step

    arch, cfg = _reduced_arch(arch_id)
    params = tf.init(cfg, 0, "cpu")
    gen = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    n_data, per = 2, B // 2 // NUM_MICRO
    order = [r * (B // n_data) + i * per + j for i in range(NUM_MICRO)
             for r in range(n_data) for j in range(per)]
    batch = {"tokens": toks[order, :-1], "labels": toks[order, 1:]}
    loss, grads, _ = _accumulate_grads(lm_loss_fn(cfg), params, batch, NUM_MICRO * n_data)
    g = {n: x.detach().numpy() for (n, _), x in zip(flatten(tree_of(params)), grads)}
    step = make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=3e-4, total_steps=10_000),
                           num_micro=NUM_MICRO * n_data)
    _, _, m = step(params, init_state(params), batch)
    p = {n: x.detach().numpy() for n, x in flatten(tf.param_tree(params))}
    return float(loss), float(m["loss"]), g, p


@pytest.mark.parametrize("arch_id", tuple(LM_STEPS))
def test_sharded_lm_step_matches_one_device(lm_world, arch_id):
    got = lm_world[arch_id]
    loss, step_loss, grads, params = _one_device(arch_id)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(got["step_loss"], step_loss, rtol=1e-5)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got["grads"][n] - g).max()) <= 1e-5 * scale + 1e-8, n
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n], p, rtol=1e-5, atol=1e-7, err_msg=n)


# ---------------------------------------------------------------------------
# sharded serving: a prefill into a sequence-sharded cache, then decode
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("codeqwen1.5-7b", "deepseek-v2-lite-16b")
PROMPT, CACHE = 8, 16


def _serve_cfg(arch_id):
    arch = copy.copy(get_arch(arch_id))
    cfg = dataclasses.replace(arch.model_config(reduced=True), q_chunk=4)
    arch._dryrun_model_cfg = lambda cell: cfg
    return arch, cfg


def _serve_tokens():
    gen = torch.Generator(device="cpu").manual_seed(3)
    return torch.randint(0, 512, (4, PROMPT + 1), generator=gen, dtype=torch.int32)


def _serve_world(mesh, arch_ids):
    """Each arch's prefill cell (its cache sharded by sequence over
    'model', K3's path for the prompt) on a prompt of 8 into a cache of 16,
    then one decode step (the flash-decoding merge over the cache shards):
    rank 0 returns the last logits of each and the cache."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.serve.engine import make_decode_fn

    out = {}
    toks = _serve_tokens()
    for aid in arch_ids:
        arch, cfg = _serve_cfg(aid)
        cell = Cell("prefill_32k", "prefill", global_batch=4, seq_len=CACHE)
        spec = arch.build_cell(cell, mesh)
        params, _, cache = spec.make_args(seed=0, device="cpu")
        pl = spec.placements[1]
        prompt = distribute_tensor(toks[:, :PROMPT], mesh, pl, src_data_rank=None)
        lg_p, cache = spec.fn(params, prompt, cache)
        decode = make_decode_fn(cfg, arch.cell_ctx(Cell("d", "decode"), mesh))
        nxt = distribute_tensor(toks[:, PROMPT:], mesh, pl, src_data_rank=None)
        lg_d, cache = decode(params, nxt, cache, PROMPT)
        out[aid] = {"prefill": _full(lg_p), "decode": _full(lg_d),
                    "cache": {k: _full(v) for k, v in cache.items()}}
    return out if mesh.get_rank() == 0 else None


@pytest.fixture(scope="module")
def serve_world():
    return run_world(_serve_world, (2, 2), ("data", "model"), (SERVE_ARCHS,), device="cpu")[0]


@pytest.mark.parametrize("arch_id", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_one_device(serve_world, arch_id):
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_decode_fn, make_prefill_fn

    got = serve_world[arch_id]
    _, cfg = _serve_cfg(arch_id)
    params = tf.init(cfg, 0, "cpu")
    cache = tf.make_cache(cfg, 4, CACHE, dtype=torch.bfloat16, device="cpu")
    toks = _serve_tokens()
    lg_p, cache = make_prefill_fn(cfg)(params, toks[:, :PROMPT], cache)
    lg_d, cache = make_decode_fn(cfg)(params, toks[:, PROMPT:], cache, PROMPT)
    np.testing.assert_allclose(got["prefill"], lg_p.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["decode"], lg_d.numpy(), rtol=1e-5, atol=1e-5)
    # the bf16 cache holds float32 k / v that agree within 1e-6: one of them
    # may round to the neighbouring bf16 value (at most 2^-7 relative)
    for k, v in cache.items():
        np.testing.assert_allclose(got["cache"][k], v.to(torch.float32).numpy(), rtol=2**-7,
                                   atol=1e-6, err_msg=k)

"""The port's MoE FFN, MLA attention and the two DeepSeek LMs on the CPU vs
the JAX reference: ``_ranks_within_expert``, ``moe_apply`` against the
reference's local path at several capacity factors (drops in the
reference's stable order), the three ``mla_apply`` branches (no cache,
whole prefill into the latent cache, the absorbed decode), K3's plain path
with a v head dim other than q's, ``transformer.apply`` logits and aux,
prefill-then-decode, ``init``, the parameter counts, the numpy round trip
and the ``ServeEngine`` (greedy tokens equal to the JAX engine's); and
training: ``lm_loss_fn``'s loss, aux and grads (drops included) against
``jax.value_and_grad`` of the reference's, the MoE layer's gradient, the
dispatch's deterministic backward, remat, and K3's path differentiable
with v's head dim other than q's.  Inputs and params are drawn with numpy
and carried across; float32 throughout, rtol = atol = 1e-5 (the combine
sums each token's k expert rows where the reference scatter-adds them:
another order, within float32 rounding); grads rtol 1e-4 with an atol of
1e-5 of each tensor's largest entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_arch
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jts
from repro_torch.common.tree import unflatten
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import transformer_from_jax, transformer_to_numpy, tree_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as pl
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _perturb(tree, rng):
    """Norm scales away from 1, so they matter."""
    def f(path, a):
        if getattr(path[-1], "key", "") == "scale":
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _reduced(arch, **kw):
    """The reference's and the port's reduced config of ``arch``, with the
    same overrides."""
    jcfg = dataclasses.replace(get_arch(arch).model_config(reduced=True), **kw)
    pcfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _models(arch, seed=0, **kw):
    jcfg, pcfg = _reduced(arch, **kw)
    params_np = _perturb(_np_tree(jtf.init(jax.random.PRNGKey(seed), jcfg)),
                         np.random.default_rng(seed))
    return (jcfg, jax.tree.map(jnp.asarray, params_np), pcfg,
            transformer_from_jax(pcfg, params_np, device="cpu"), params_np)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

MOE = jmoe.MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, n_shared=1, capacity_factor=8.0)


def _pmoe_cfg(cfg):
    return pmoe.MoEConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seed,n,E", [(0, 200, 8), (1, 997, 64), (2, 64, 3)])
def test_ranks_within_expert_match(seed, n, E):
    """Ids in long runs of repeats (and shuffled runs): ranks array-equal."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(rng.integers(0, E, n // 7 + 1), 7)[:n]
    ids[n // 2:] = rng.permutation(ids[n // 2:])
    ids = ids.astype(np.int32)
    want = np.asarray(jax.jit(lambda e: jmoe._ranks_within_expert(e, E))(jnp.asarray(ids)))
    got = pmoe._ranks_within_expert(torch.from_numpy(ids.astype(np.int64)), E)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cf,repeat", [(8.0, False), (1.0, False), (0.5, False), (-1.0, False),
                                       (0.5, True)])
def test_moe_apply_matches_local_path(cf, repeat):
    """Output and aux against ``_moe_apply_local``; at cf 1.0 and 0.5 tokens
    drop.  ``repeat``: identical token rows, so only the stable rank order
    decides which copies drop."""
    rng = np.random.default_rng(3)
    params = _np_tree(jmoe.moe_init(jax.random.PRNGKey(3), 32, MOE))
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    if repeat:
        x[:, 8:] = x[:, :1]
    jx = jnp.asarray(x)
    want, want_aux = jax.jit(lambda p, x: jmoe._moe_apply_local(p, MOE, x, capacity_factor=cf))(
        jax.tree.map(jnp.asarray, params), jx)
    got, aux = pmoe.moe_apply(_torch_tree(params), _pmoe_cfg(MOE), torch.from_numpy(x),
                              capacity_factor=cf)
    assert aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    T, K = 48, MOE.top_k
    C = pmoe.capacity(_pmoe_cfg(MOE), T, cf)
    _, _, top_e = pmoe.route(_torch_tree(params), _pmoe_cfg(MOE), torch.from_numpy(x).reshape(T, -1))
    dropped = int((pmoe._ranks_within_expert(top_e.reshape(-1), MOE.num_experts) >= C).sum())
    assert (dropped > 0) == (cf in (1.0, 0.5)), (cf, dropped)


def test_moe_init_router_float32_under_bf16():
    gen = torch.Generator().manual_seed(0)
    p = pmoe.moe_init(gen, 32, _pmoe_cfg(MOE), torch.bfloat16)
    ref = jmoe.moe_init(jax.random.PRNGKey(0), 32, MOE, jnp.bfloat16)
    assert p["router"].dtype == torch.float32 and ref["router"].dtype == jnp.float32
    for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
        leaf = p
        for k in path:
            leaf = leaf[k.key]
        assert tuple(leaf.shape) == a.shape
        assert (leaf.dtype == torch.float32) == (a.dtype == jnp.float32)
    assert abs(float(p["router"].std()) - 0.02) < 0.004


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------


def _mla_case(q_chunk, seed=4, S=40):
    jcfg = jl.MLAConfig(d_model=32, n_heads=4, kv_lora_rank=24, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16, q_chunk=q_chunk, kv_chunk=16)
    pcfg = pl.MLAConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)
    params = _perturb(_np_tree(jl.mla_init(jax.random.PRNGKey(seed), jcfg)), rng)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    return jcfg, pcfg, params, x


@pytest.mark.parametrize("q_chunk", [0, 16])
def test_mla_no_cache_matches(q_chunk):
    """q_chunk 16: the K3 path's plain version with q . k 24 and v 16."""
    jcfg, pcfg, params, x = _mla_case(q_chunk)
    pos = np.arange(x.shape[1], dtype=np.int32)
    want, _ = jax.jit(lambda p, x, pos: jl.mla_apply(p, jcfg, x, positions=pos))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(pos))
    got, cache = pl.mla_apply(_torch_tree(params), pcfg, torch.from_numpy(x),
                              positions=torch.from_numpy(pos))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("q_chunk", [0, 16])
def test_mla_whole_prefill_matches(q_chunk):
    """Offset 0, S > 1: attention over the fresh latent; latent and k_rope
    written into the cache in place."""
    jcfg, pcfg, params, x = _mla_case(q_chunk)
    S = x.shape[1]
    pos = np.arange(S, dtype=np.int32)
    zl, zr = np.zeros((2, 64, 24), np.float32), np.zeros((2, 64, 8), np.float32)
    want, jcache = jax.jit(lambda p, x, pos, c: jl.mla_apply(
        p, jcfg, x, positions=pos, latent_cache=c, cache_offset=0))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(pos),
        {"latent": jnp.asarray(zl), "k_rope": jnp.asarray(zr)})
    cache = {"latent": torch.zeros(2, 64, 24), "k_rope": torch.zeros(2, 64, 8)}
    got, pcache = pl.mla_apply(_torch_tree(params), pcfg, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), latent_cache=cache,
                               cache_offset=0)
    assert pcache is cache
    _close(got, want)
    _close(cache["latent"], jcache["latent"])
    _close(cache["k_rope"], jcache["k_rope"])


@pytest.mark.parametrize("per_row,causal", [(True, True), (False, True), (True, False)])
def test_mla_absorbed_decode_matches(per_row, causal):
    """Per-row offsets (slots) and a scalar offset > 0, against a latent
    cache that already holds tokens: the absorbed scores and values."""
    jcfg, pcfg, params, x = _mla_case(0, seed=5, S=3)
    rng = np.random.default_rng(5)
    cl = rng.standard_normal((2, 32, 24)).astype(np.float32)
    cr = rng.standard_normal((2, 32, 8)).astype(np.float32)
    if per_row:
        off_np = np.array([5, 17], np.int32)
        pos = off_np[:, None] + np.arange(3, dtype=np.int32)[None, :]
        j_off, p_off = jnp.asarray(off_np), torch.from_numpy(off_np.astype(np.int64))
    else:
        pos = 9 + np.arange(3, dtype=np.int32)
        j_off = p_off = 9
    want, jcache = jax.jit(lambda p, x, pos, c: jl.mla_apply(
        p, jcfg, x, positions=pos, causal=causal, latent_cache=c, cache_offset=j_off))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(pos),
        {"latent": jnp.asarray(cl), "k_rope": jnp.asarray(cr)})
    cache = {"latent": torch.from_numpy(cl.copy()), "k_rope": torch.from_numpy(cr.copy())}
    got, _ = pl.mla_apply(_torch_tree(params), pcfg, torch.from_numpy(x),
                          positions=torch.from_numpy(pos), causal=causal, latent_cache=cache,
                          cache_offset=p_off)
    _close(got, want)
    _close(cache["latent"], jcache["latent"])
    _close(cache["k_rope"], jcache["k_rope"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_v_head_dim_matches_chunked(causal):
    """``ops.flash_attention`` on the CPU with q, k (BH, S, 24) and v
    (BH, S, 16): the reference's ``chunked_attention`` with hd_v 16."""
    rng = np.random.default_rng(6)
    B, S, H = 2, 37, 3
    q, k = (rng.standard_normal((B, S, H, 24)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, S, H, 16)).astype(np.float32)
    want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                q_chunk=16, kv_chunk=8, scale=0.3)
    got = ops.flash_attention_bhsd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                   scale=0.3)
    assert tuple(got.shape) == (B, S, H, 16)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_with_v_head_dim_matches_chunked(causal):
    """The gradient of ``ops.flash_attention`` with q . k 24 and v 16 (the
    reduced MLA config's): its backward (``flash_attention_bwd_ref`` on the
    CPU) against ``jax.grad`` of the reference's ``chunked_attention``,
    and the same call under ``no_grad`` keeps no graph."""
    rng = np.random.default_rng(16)
    B, S, H = 2, 37, 3
    q, k = (rng.standard_normal((B, S, H, 24)).astype(np.float32) for _ in range(2))
    v, w = (rng.standard_normal((B, S, H, 16)).astype(np.float32) for _ in range(2))
    f = lambda q, k, v: jnp.sum(jl.chunked_attention(q, k, v, causal=causal, q_chunk=16,
                                                     kv_chunk=8, scale=0.3) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_bhsd(qt, kt, vt, causal=causal, scale=0.3)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    for g, wg in zip(got, want):
        assert tuple(g.shape) == wg.shape
        _close(g, wg)
    with torch.no_grad():
        assert ops.flash_attention(qt[0], kt[0], vt[0]).grad_fn is None


# --------------------------------------------------------------------------
# the DeepSeek LMs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q_chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_apply_logits_and_aux_match(arch, q_chunk):
    jcfg, jparams, pcfg, pparams, _ = _models(arch, q_chunk=q_chunk, kv_chunk=16)
    toks = np.random.default_rng(7).integers(0, 512, (2, 40)).astype(np.int32)
    want, _, want_aux = jax.jit(lambda p, t: jtf.apply(p, jcfg, t))(jparams, jnp.asarray(toks))
    logits, cache, aux = tf.apply(pparams, pcfg, torch.from_numpy(toks))
    assert cache is None and aux.dtype == torch.float32 and float(aux) > 0
    _close(logits, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_prefill_then_decode_matches(arch):
    """Whole prefill (K3 path, q_chunk 16) into a cache, then per-row
    decode (dropless MoE; MLA's absorbed form)."""
    jcfg, jparams, pcfg, pparams, _ = _models(arch, seed=1, q_chunk=16, kv_chunk=16)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 512, (2, 33)).astype(np.int32)
    jcache = jtf.make_cache(jcfg, 2, 64, dtype=jnp.float32)
    pcache = tf.make_cache(pcfg, 2, 64, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in pcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    jl_, jcache, _ = jax.jit(lambda p, t, c: jtf.apply(p, jcfg, t, cache=c, cache_offset=0))(
        jparams, jnp.asarray(toks), jcache)
    jdecode = jax.jit(lambda p, t, c, off: jtf.apply(p, jcfg, t, cache=c, cache_offset=off))
    pl_, pcache, _ = tf.apply(pparams, pcfg, torch.from_numpy(toks), cache=pcache,
                              cache_offset=0)
    _close(pl_, jl_)
    off = np.array([33, 20], np.int32)  # row 1 decodes over its pad rows, as slots do
    for _ in range(3):
        tok = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl_, jcache, ja = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(off))
        pl_, pcache, pa = tf.apply(pparams, pcfg, torch.from_numpy(tok), cache=pcache,
                                   cache_offset=torch.from_numpy(off.astype(np.int64)))
        _close(pl_, jl_)
        _close(pa, ja)
        off = off + 1
    for name in pcache:
        _close(pcache[name], jcache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_dtypes_match_reference(arch):
    """Every leaf of the reference's tree, its shape and dtype (the router
    float32 under bf16), in the port's ``param_tree``; the MLA cache."""
    jcfg, pcfg = _reduced(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    tree = tf.param_tree(tf.init(pcfg, seed=0, device="cpu"))
    assert set(tree) == set(jparams)
    for path, a in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("blocks", "dense_blocks"):
            layers, keys, shape = tree[keys[0]], keys[1:], a.shape[1:]
            assert len(layers) == a.shape[0]
            leaf = layers[-1]
        else:
            leaf, shape = tree, a.shape
        for k in keys:
            leaf = leaf[k]
        assert tuple(leaf.shape) == shape, keys
        assert str(leaf.dtype).split(".")[-1] == str(a.dtype), (keys, leaf.dtype, a.dtype)
    router = tree["blocks"][0]["moe"]["router"]
    assert router.dtype == torch.float32 and abs(float(router.std()) - 0.02) < 0.01
    jc = jtf.make_cache(jcfg, 3, 20, dtype=jnp.bfloat16)
    pc = tf.make_cache(pcfg, 3, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == {k: v.shape for k, v in jc.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_match_reference(arch):
    jcfg, pcfg = get_arch(arch).model_config(), get_config(arch)
    assert pcfg.num_params() == jcfg.num_params()
    assert pcfg.num_active_params() == jcfg.num_active_params()
    assert pcfg.n_dense_layers == jcfg.n_dense_layers == 1
    assert pcfg.n_scan_layers == jcfg.n_scan_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_to_numpy_round_trip(arch):
    _, _, pcfg, pparams, params_np = _models(arch, seed=2)
    back = transformer_to_numpy(pparams)
    assert jax.tree.structure(back) == jax.tree.structure(params_np)
    jax.tree.map(np.testing.assert_array_equal, back, params_np)
    bf = transformer_from_jax(dataclasses.replace(pcfg, param_dtype="bfloat16"), params_np,
                              device="cpu")
    assert bf.blocks[0]["moe"]["router"].dtype == torch.float32
    assert bf.blocks[0]["moe"]["w_gate"].dtype == torch.bfloat16


def _engines(arch, q_chunk, capacity_factor=None):
    jcfg, jparams, pcfg, pparams, _ = _models(arch, seed=3, q_chunk=q_chunk, kv_chunk=16)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=capacity_factor))
    return (JServeEngine(jcfg, jparams, slots=2, max_seq=64),
            ServeEngine(pcfg, pparams, slots=2, max_seq=64))


@pytest.mark.parametrize("arch,q_chunk,cf", [(a, q, None) for a in ARCHS for q in (0, 16)]
                         + [("deepseek-moe-16b", 16, 1.25)])
def test_engine_tokens_match_jax_engine(arch, q_chunk, cf):
    """Continuous batching over 2 slots, prompts across three buckets; with
    q_chunk 16 the buckets 32 and 64 prefill through the K3 path.  At
    capacity 1.25 the bucket's pad tokens take expert capacity, as in the
    reference's engine."""
    jeng, peng = _engines(arch, q_chunk, cf)
    rng = np.random.default_rng(9)
    pairs = []
    for uid, L in enumerate((5, 21, 40, 12, 33)):
        prompt = rng.integers(0, 512, L).astype(np.int32)
        pairs.append((JRequest(uid, prompt, max_new_tokens=5),
                      Request(uid, prompt, max_new_tokens=5)))
        jeng.submit(pairs[-1][0])
        peng.submit(pairs[-1][1])
    jeng.run()
    peng.run()
    assert [p.tokens_out for _, p in pairs] == [j.tokens_out for j, _ in pairs]
    keys = ("prefill_tokens", "decode_steps", "completed")
    assert {k: peng.stats[k] for k in keys} == {k: jeng.stats[k] for k in keys}


# --------------------------------------------------------------------------
# training: the loss, its grads, the MoE layer's gradient
# --------------------------------------------------------------------------


class _CountDrops:
    """Counts the (token, k) assignments that ``moe.moe_apply`` drops at its
    capacity while a block runs (the routing recomputed with the port's
    ``route``)."""

    def __enter__(self):
        self.dropped, self._orig = 0, pmoe.moe_apply

        def counting(params, cfg, x, *, capacity_factor=0.0):
            T = x.shape[0] * x.shape[1]
            with torch.no_grad():
                _, _, top_e = pmoe.route(params, cfg, x.reshape(T, -1))
                rank = pmoe._ranks_within_expert(top_e.reshape(-1), cfg.num_experts)
            self.dropped += int((rank >= pmoe.capacity(cfg, T, capacity_factor)).sum())
            return self._orig(params, cfg, x, capacity_factor=capacity_factor)

        pmoe.moe_apply = counting
        return self

    def __exit__(self, *exc):
        pmoe.moe_apply = self._orig
        return False


def _grads_np(pparams, grads):
    """The port's grads (in the params' leaf order) in the reference's
    stacked layout, numpy."""
    return tree_to_numpy(unflatten(tf.param_tree(pparams), grads))


# limits of a grad tensor: rtol 1e-4, atol 1e-5 of the tensor's largest
# |entry| (float32 on both sides, sums in other orders: an entry near zero
# carries the rounding of its sum's largest terms; the loss's grads here
# come within 3.8e-6 of the largest)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


def _grad_close(got, want, name=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=name)


def _assert_tree_close(got_np, want):
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got_np
        for key in path:
            g = g[key.key]
        _grad_close(g, w, jax.tree_util.keystr(path))


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("q_chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_fn_loss_aux_and_grads_match_reference(arch, q_chunk, cf):
    """``lm_loss_fn`` on the reduced DeepSeek configs: loss (ce + aux), aux
    and every grad against ``jax.value_and_grad`` of the reference's
    ``lm_loss_fn``.  q_chunk 16 runs attention through K3's path (the
    plain versions here, MLA at q . k 24 and v 16); capacity factor 1.25
    drops assignments (counted), so the gates' grads cover kept and
    dropped routes.  Loss and aux rtol 1e-5."""
    moe_cf = lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
    jcfg, jparams, pcfg, pparams, _ = _models(arch, seed=4, q_chunk=q_chunk, kv_chunk=16)
    jcfg, pcfg = moe_cf(jcfg), moe_cf(pcfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 512, (2, 40)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 40)).astype(np.int32)
    (want, want_aux), want_g = jax.value_and_grad(jts.lm_loss_fn(jcfg), has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with _CountDrops() as drops:
        loss, grads, aux = _accumulate_grads(lm_loss_fn(pcfg), pparams,
                                             {"tokens": toks, "labels": labels}, 1)
    assert (drops.dropped > 0) == (cf == 1.25), drops.dropped
    assert float(aux) > 0 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    _assert_tree_close(_grads_np(pparams, grads), want_g)


@pytest.mark.parametrize("cf,top_k", [(8.0, 2), (1.0, 2), (0.5, 2), (1.0, 6)])
def test_moe_apply_grads_match_local_path(cf, top_k):
    """The MoE layer's gradient alone: d(sum(out * w) + aux) with respect to
    x and every param (router, experts, shared) against ``jax.grad`` of the
    reference's ``_moe_apply_local``, kept and dropped routes (cf 1.0,
    0.5), top-2 and top-6."""
    cfg = dataclasses.replace(MOE, top_k=top_k)
    rng = np.random.default_rng(13)
    params = _np_tree(jmoe.moe_init(jax.random.PRNGKey(5), 32, cfg))
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    w = rng.standard_normal((2, 24, 32)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe._moe_apply_local(p, cfg, x, capacity_factor=cf)
        return jnp.sum(out * w) + aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = pmoe.moe_apply(tp, _pmoe_cfg(cfg), tx, capacity_factor=cf)
    flat = jax.tree_util.tree_leaves(tp)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux, [tx] + flat)
    _grad_close(got[0].numpy(), want_x, "x")
    for g, wg in zip(got[1:], jax.tree_util.tree_leaves(want_p)):
        _grad_close(g.numpy(), wg)


def test_moe_dispatch_backward_is_the_gather_of_its_slot_grads():
    """``moe._Dispatch``'s backward (each token's k slot grads gathered and
    summed) equals autograd of the plain dispatch gather (a scatter-add of
    every slot into token space), with drops at capacity 1.0, top-6, and
    two backwards give the same bits; ``moe._Combine``'s backward (the
    dispatch's gather) equals autograd of the plain combine bit for bit."""
    cfg = _pmoe_cfg(dataclasses.replace(MOE, top_k=6))
    rng = np.random.default_rng(14)
    params = _torch_tree(_np_tree(jmoe.moe_init(jax.random.PRNGKey(6), 32, MOE)))
    xf = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    T, K, E = 48, 6, cfg.num_experts
    C = pmoe.capacity(cfg, T, 1.0)
    _, _, top_e = pmoe.route(params, cfg, xf)
    flat_e = top_e.reshape(T * K)
    rank = pmoe._ranks_within_expert(flat_e, E)
    assert int((rank >= C).sum()) > 0
    slot = torch.where(rank < C, flat_e * C + rank, E * C)
    tok_buf = torch.full((E * C + 1,), T, dtype=torch.long)
    tok_buf[slot] = torch.arange(T).repeat_interleave(K)
    g = torch.from_numpy(rng.standard_normal((E * C, 32)).astype(np.float32))
    x1 = xf.clone().requires_grad_()
    (got,) = torch.autograd.grad(pmoe._Dispatch.apply(x1, tok_buf[:E * C], slot, K), x1, g)
    (again,) = torch.autograd.grad(pmoe._Dispatch.apply(x1, tok_buf[:E * C], slot, K), x1, g)
    x2 = xf.clone().requires_grad_()
    plain = torch.cat([x2, x2.new_zeros(1, 32)])[tok_buf[:E * C]]
    (want,) = torch.autograd.grad(plain, x2, g)
    assert torch.equal(pmoe._Dispatch.apply(xf, tok_buf[:E * C], slot, K), plain.detach())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, again)

    # the combine: each token's k slot rows summed; its backward is the
    # dispatch's gather, autograd's the index backward of the plain gather
    ye = torch.from_numpy(rng.standard_normal((E * C, 32)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((T, 32)).astype(np.float32))
    y1 = ye.clone().requires_grad_()
    out = pmoe._Combine.apply(y1, tok_buf[:E * C], slot, K)
    (got_y,) = torch.autograd.grad(out, y1, gy)
    y2 = ye.clone().requires_grad_()
    plain_y = torch.cat([y2, y2.new_zeros(1, 32)])[slot].reshape(T, K, 32).sum(dim=1)
    (want_y,) = torch.autograd.grad(plain_y, y2, gy)
    assert torch.equal(out.detach(), plain_y.detach())
    assert torch.equal(got_y, want_y)  # one source a kept slot, none an empty one


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_grads_of_no_remat_on_moe(arch):
    """Remat (every block, dense head layer included, checkpointed and run
    again in the backward, routing and dispatch with it) gives the same
    grads, bit for bit, and aux, as no remat."""
    _, _, pcfg, pparams, _ = _models(arch, seed=6, q_chunk=16, kv_chunk=16)
    rng = np.random.default_rng(15)
    batch = {"tokens": rng.integers(0, 512, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 40)).astype(np.int32)}
    loss, want, aux = _accumulate_grads(lm_loss_fn(pcfg), pparams, batch, 1)
    loss_r, got, aux_r = _accumulate_grads(lm_loss_fn(dataclasses.replace(pcfg, remat=True)),
                                           pparams, batch, 1)
    assert torch.equal(loss, loss_r) and torch.equal(aux, aux_r)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

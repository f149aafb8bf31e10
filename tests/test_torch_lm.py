"""The port's LM serving path on the CPU vs the JAX reference: layers
(``rms_norm``, ``apply_rope``, the three ``attention_apply`` cache branches,
``mlp_apply``), ``transformer.apply`` logits on tiny configs (GQA, QKV bias,
tied embeddings, chunked attention through the K3 path, unchunked), the
``ServeEngine`` (greedy tokens equal to the JAX engine's), and the registry.
Inputs and params are drawn with numpy and carried across; float32
throughout, rtol = atol = 1e-5 for logits and layer outputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.families import LM_CELLS
from repro.configs.registry import get_arch
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.analysis import RetraceSentinel
from repro_torch.configs import get_config, serving_config
from repro_torch.convert import transformer_from_jax
from repro_torch.models import layers as pl
from repro_torch.models import transformer as tf
from repro_torch.obs import Telemetry
from repro_torch.serve import Request, ServeEngine, make_prefill_fn

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _pdict(d):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v), requires_grad=False) for k, v in d.items()})


def _perturb(tree, rng):
    """Norm scales away from 1 and biases away from 0, so both matter."""
    def f(path, a):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _jax_cfg(**kw):
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=128)
    base.update(kw)
    return jtf.TransformerConfig(**base)


def _port_cfg(jcfg):
    return tf.TransformerConfig(**dataclasses.asdict(jcfg))


def _models(jcfg, seed=0):
    """The reference's params (perturbed) and the same params in the port."""
    params_np = _perturb(_np_tree(jtf.init(jax.random.PRNGKey(seed), jcfg)),
                         np.random.default_rng(seed))
    jparams = jax.tree.map(jnp.asarray, params_np)
    pcfg = _port_cfg(jcfg)
    return jparams, pcfg, transformer_from_jax(pcfg, params_np, device="cpu")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    want = jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(pl.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)), want)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 3000, (2, 9)) if per_row else np.arange(5, 14)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4), want)


def test_mlp_apply_matches():
    rng = np.random.default_rng(2)
    params = _np_tree(jl.mlp_init(jax.random.PRNGKey(2), 24, 40))
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    want = jl.mlp_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    _close(pl.mlp_apply(_pdict(params), torch.from_numpy(x)), want)


def _attn_case(q_chunk, seed=3, S=40, qkv_bias=True):
    jcfg = jl.AttentionConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                              qkv_bias=qkv_bias, q_chunk=q_chunk, kv_chunk=16)
    pcfg = pl.AttentionConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)
    params = _perturb(_np_tree(jl.attention_init(jax.random.PRNGKey(seed), jcfg)), rng)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    return jcfg, pcfg, params, x


@pytest.mark.parametrize("q_chunk", [0, 16])
def test_attention_no_cache_matches(q_chunk):
    jcfg, pcfg, params, x = _attn_case(q_chunk)
    pos = np.arange(x.shape[1], dtype=np.int32)
    want, _ = jl.attention_apply(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos))
    got, cache = pl.attention_apply(_pdict(params), pcfg, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("q_chunk", [0, 16])
def test_attention_whole_prefill_matches(q_chunk):
    """Offset 0, S > 1: attention over the fresh k/v; the cache is written."""
    jcfg, pcfg, params, x = _attn_case(q_chunk)
    S = x.shape[1]
    pos = np.arange(S, dtype=np.int32)
    zeros = np.zeros((2, 64, 2, 8), np.float32)
    want, jcache = jl.attention_apply(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}, cache_offset=0)
    cache = {"k": torch.zeros(2, 64, 2, 8), "v": torch.zeros(2, 64, 2, 8)}
    got, pcache = pl.attention_apply(_pdict(params), pcfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos), kv_cache=cache,
                                     cache_offset=0)
    assert pcache is cache  # written in place
    _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("per_row", [True, False])
def test_attention_cached_branch_matches(per_row):
    """Per-row offsets (decode, grouped einsum) and a scalar offset > 0
    (incremental prefill) against a cache that already holds tokens."""
    jcfg, pcfg, params, x = _attn_case(0, seed=4, S=3)
    rng = np.random.default_rng(4)
    ck = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    if per_row:
        off_np = np.array([5, 17], np.int32)
        pos = off_np[:, None] + np.arange(3, dtype=np.int32)[None, :]
        j_off, p_off = jnp.asarray(off_np), torch.from_numpy(off_np.astype(np.int64))
    else:
        pos = 9 + np.arange(3, dtype=np.int32)
        j_off = p_off = 9
    want, jcache = jl.attention_apply(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, cache_offset=j_off)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, _ = pl.attention_apply(_pdict(params), pcfg, torch.from_numpy(x),
                                positions=torch.from_numpy(pos), kv_cache=cache,
                                cache_offset=p_off)
    _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


# --------------------------------------------------------------------------
# transformer
# --------------------------------------------------------------------------

APPLY_CASES = {
    "gqa_nrep2": dict(n_heads=4, n_kv_heads=2, head_dim=8),
    "qkv_bias": dict(qkv_bias=True),
    "tie_embeddings": dict(tie_embeddings=True, rope_theta=1e6),
    "q_chunk16": dict(n_heads=4, n_kv_heads=2, head_dim=8, q_chunk=16, kv_chunk=16),
    "q_chunk0": dict(q_chunk=0, n_layers=3),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_transformer_apply_logits_match(case):
    jcfg = _jax_cfg(**APPLY_CASES[case])
    jparams, pcfg, pparams = _models(jcfg)
    toks = np.random.default_rng(5).integers(0, 128, (2, 40)).astype(np.int32)
    want = jtf.apply(jparams, jcfg, jnp.asarray(toks))[0]
    logits, cache, aux = tf.apply(pparams, pcfg, torch.from_numpy(toks))
    assert cache is None and aux == 0.0
    _close(logits, want)


def test_transformer_prefill_then_decode_matches():
    """Whole prefill (K3 path, q_chunk 16) into a cache, then per-row decode."""
    jcfg = _jax_cfg(n_heads=4, n_kv_heads=2, head_dim=8, q_chunk=16, kv_chunk=16)
    jparams, pcfg, pparams = _models(jcfg, seed=1)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 128, (2, 33)).astype(np.int32)
    jcache = jtf.make_cache(jcfg, 2, 64, dtype=jnp.float32)
    pcache = tf.make_cache(pcfg, 2, 64, dtype=torch.float32, device="cpu")
    jl_, jcache, _ = jtf.apply(jparams, jcfg, jnp.asarray(toks), cache=jcache, cache_offset=0)
    pl_, pcache, _ = tf.apply(pparams, pcfg, torch.from_numpy(toks), cache=pcache,
                              cache_offset=0)
    _close(pl_, jl_)
    off = np.array([33, 20], np.int32)  # row 1 decodes over its pad rows, as slots do
    for _ in range(3):
        tok = rng.integers(0, 128, (2, 1)).astype(np.int32)
        jl_, jcache, _ = jtf.apply(jparams, jcfg, jnp.asarray(tok), cache=jcache,
                                   cache_offset=jnp.asarray(off))
        pl_, pcache, _ = tf.apply(pparams, pcfg, torch.from_numpy(tok), cache=pcache,
                                  cache_offset=torch.from_numpy(off.astype(np.int64)))
        _close(pl_, jl_)
        off = off + 1
    _close(pcache["k"], jcache["k"])


def test_init_and_cache_shapes_match_reference():
    jcfg = _jax_cfg(n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True)
    pcfg = _port_cfg(jcfg)
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    pparams = tf.init(pcfg, seed=0, device="cpu")
    assert tuple(pparams.embed.shape) == jparams["embed"].shape
    assert tuple(pparams.lm_head.shape) == jparams["lm_head"].shape
    assert len(pparams.blocks) == jcfg.n_layers
    for group, leaves in jparams["blocks"].items():
        for name, a in leaves.items():
            assert tuple(pparams.blocks[0][group][name].shape) == a.shape[1:], (group, name)
    # the reference's scales: embed 0.02, dense 1/sqrt(fan_in), biases 0
    assert abs(float(pparams.embed.std()) - 0.02) < 0.002
    wq = pparams.blocks[0]["attn"]["wq"]
    assert abs(float(wq.std()) - 32 ** -0.5) < 0.03
    assert float(pparams.blocks[1]["attn"]["bq"].abs().max()) == 0.0
    jc = jtf.make_cache(jcfg, 3, 20, dtype=jnp.bfloat16)
    pc = tf.make_cache(pcfg, 3, 20, device="cpu")
    assert tuple(pc["k"].shape) == jc["k"].shape and pc["v"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


def _fields(cfg):
    return dataclasses.asdict(cfg)  # the MoE config, a dataclass of either package, as a dict


@pytest.mark.parametrize("arch_id", ["smollm-360m", "codeqwen1.5-7b", "qwen2-72b",
                                     "deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_registry_matches_reference(arch_id):
    arch = get_arch(arch_id)
    assert _fields(get_config(arch_id)) == _fields(arch.model_config())
    for cell in ("prefill_32k", "decode_32k"):
        want = arch._dryrun_model_cfg(LM_CELLS[cell])
        assert _fields(serving_config(get_config(arch_id), LM_CELLS[cell].kind)) == _fields(want)


# --------------------------------------------------------------------------
# ServeEngine (mirrors tests/test_serve_engine.py on the port)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = _jax_cfg()
    return _models(jcfg)


def test_prefill_traces_bounded_by_buckets(tiny_lm):
    _, cfg, params = tiny_lm
    eng = ServeEngine(cfg, params, slots=2, max_seq=64)
    rng = np.random.default_rng(0)
    lengths = [2, 3, 5, 7, 9, 11, 13, 17, 19, 23, 29, 31, 33, 40]
    for uid, L in enumerate(lengths):
        eng.submit(Request(uid, rng.integers(0, 128, L).astype(np.int32), max_new_tokens=2))
    eng.run()
    assert eng.stats["completed"] == len(lengths)
    # 14 distinct prompt lengths -> at most 3 buckets (16, 32, 64)
    assert eng.stats["prefill_traces"] <= 3, eng.stats


def test_bucketed_prefill_matches_exact(tiny_lm):
    """Greedy continuation from the bucketed engine == greedy continuation
    computed with an exact-length prefill + per-token decode, and == the
    JAX engine's tokens for the same prompt and params."""
    jparams, cfg, params = tiny_lm
    rng = np.random.default_rng(1)
    prefill_exact = make_prefill_fn(cfg)
    for L in (3, 9, 14, 16, 21):
        prompt = rng.integers(0, 128, L).astype(np.int32)
        n_new = 4
        cache = tf.make_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
        logits, cache = prefill_exact(params, torch.from_numpy(prompt[None]), cache)
        want = [int(np.argmax(logits[0].numpy()))]
        offset = L
        for _ in range(n_new - 1):
            tok = torch.tensor([[want[-1]]])
            logits, cache, _ = tf.apply(params, cfg, tok, cache=cache,
                                        cache_offset=torch.tensor([offset]))
            want.append(int(np.argmax(logits[0, -1].numpy())))
            offset += 1

        eng = ServeEngine(cfg, params, slots=1, max_seq=64)
        req = Request(0, prompt, max_new_tokens=n_new)
        eng.submit(req)
        eng.run()
        assert req.tokens_out == want, (L, req.tokens_out, want)
        jeng = JServeEngine(_jax_cfg(), jparams, slots=1, max_seq=64)
        jreq = JRequest(0, prompt, max_new_tokens=n_new)
        jeng.submit(jreq)
        jeng.run()
        assert req.tokens_out == jreq.tokens_out


@pytest.mark.parametrize("q_chunk", [0, 16])
def test_engine_tokens_match_jax_engine(q_chunk):
    """Continuous batching over 2 slots, prompts across three buckets; with
    q_chunk 16 the buckets 32 and 64 prefill through the K3 path."""
    jcfg = _jax_cfg(n_heads=4, n_kv_heads=2, head_dim=8, q_chunk=q_chunk, kv_chunk=16)
    jparams, pcfg, pparams = _models(jcfg, seed=2)
    jeng = JServeEngine(jcfg, jparams, slots=2, max_seq=64)
    peng = ServeEngine(pcfg, pparams, slots=2, max_seq=64)
    rng = np.random.default_rng(3)
    pairs = []
    for uid, L in enumerate((5, 21, 40, 12, 33)):
        prompt = rng.integers(0, 128, L).astype(np.int32)
        pairs.append((JRequest(uid, prompt, max_new_tokens=5), Request(uid, prompt,
                                                                       max_new_tokens=5)))
        jeng.submit(pairs[-1][0])
        peng.submit(pairs[-1][1])
    jeng.run()
    peng.run()
    assert [p.tokens_out for _, p in pairs] == [j.tokens_out for j, _ in pairs]
    assert {k: peng.stats[k] for k in ("prefill_tokens", "decode_steps", "completed")} == \
        {k: jeng.stats[k] for k in ("prefill_tokens", "decode_steps", "completed")}
    assert peng.stats["prefill_traces"] == 3


def test_engine_telemetry_registers_gauges(tiny_lm):
    """One exposition covers the LM engine: its stats dict registers as
    serve_engine_* pull gauges on the shared registry
    (``tests/test_obs.py``'s ``test_register_serve_engine_pull_gauges``)."""
    _, cfg, params = tiny_lm
    tel = Telemetry(sentinel=RetraceSentinel(torch.device("cpu")))
    eng = ServeEngine(cfg, params, slots=2, max_seq=32, telemetry=tel)
    text = tel.registry.expose_text()
    for key in eng.stats:
        assert f"serve_engine_{key} 0" in text
    eng.submit(Request(0, np.arange(4, dtype=np.int32), max_new_tokens=2))
    eng.run()
    # pull mode: the next collection reads the live dict, no push needed
    text = tel.registry.expose_text()
    assert "serve_engine_completed 1" in text
    assert f"serve_engine_decode_steps {eng.stats['decode_steps']}" in text

"""The gradient of the port's K3 path on the CPU: ``ref.flash_attention_bwd_ref``
(the plain version of K3-bwd) against torch autograd of the plain forward
``ref.flash_attention_ref``, and the port's differentiable
``layers.chunked_attention`` (``ops.flash_attention`` -> its autograd
Function) against ``jax.vjp`` of the reference's ``chunked_attention``,
GQA through ``_repeat_kv`` included.  float32; causal and bidirectional,
ragged S, D in {16, 64}, and a v head dim other than q's: the reduced MLA
config's (24, 16) and DeepSeek-V2's (192, 128).  Limits: rtol 1e-4 / atol
1e-5 against JAX (two summation orders), 1e-5 against autograd of the same
plain forward.
K3-bwd itself is held against this plain version on the card in
``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import _repeat_kv as jax_repeat_kv
from repro.models.layers import chunked_attention as jax_chunked
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

JAX_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, S, H, D, causal): ragged S against every block size used below
CASES = [(2, 64, 2, 16, True), (1, 77, 3, 16, False), (1, 100, 2, 64, True),
         (2, 33, 1, 64, False), (1, 129, 2, 16, True), (1, 1, 2, 16, True)]


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D,block", [(50, 16, 16), (97, 64, 32), (64, 16, 1024), (1, 16, 8)])
def test_bwd_ref_matches_autograd_of_plain_forward(causal, S, D, block):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((3, S, D), 4, seed=S + D))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ref.flash_attention_ref(qg, kg, vg, causal=causal, block_q=block, block_k=block)
    want = torch.autograd.grad(out, (qg, kg, vg), do)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, block_q=block, block_k=block,
                                     with_lse=True)
    assert torch.equal(o, out.detach())
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, block_q=block,
                                      block_k=block)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_is_the_row_logsumexp(causal):
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, 70, 16), 3, seed=4))
    _, lse = ref.flash_attention_ref(q, k, v, causal=causal, scale=0.3, block_q=16,
                                     block_k=32, with_lse=True)
    s = q @ k.transpose(1, 2) * 0.3
    if causal:
        s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6, atol=1e-6)


def _jax_vjp(q, k, v, do, causal, q_chunk, kv_chunk, n_rep=1):
    def f(q, k, v):
        return jax_chunked(q, jax_repeat_kv(k, n_rep), jax_repeat_kv(v, n_rep), causal=causal,
                           q_chunk=q_chunk, kv_chunk=kv_chunk)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,S,H,D,causal", CASES)
def test_chunked_attention_grads_match_jax_vjp(B, S, H, D, causal):
    q, k, v, do = _arrays((B, S, H, D), 4, seed=S * 10 + D)
    want_out, want = _jax_vjp(q, k, v, do, causal, q_chunk=16, kv_chunk=32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.chunked_attention(qt, kt, vt, causal=causal, q_chunk=16, kv_chunk=32)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **JAX_TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(48, 16), (90, 64)])
def test_gqa_grads_through_repeat_kv_match_jax(causal, S, D):
    """5 query heads on 1 kv head and 6 on 2, as smollm's 15 on 5: the
    repeat is an expand, so autograd sums dk and dv over each group."""
    for H, KV in ((5, 1), (6, 2)):
        q = _arrays((1, S, H, D), 1, seed=S)[0]
        k, v = _arrays((1, S, KV, D), 2, seed=S + 1)
        do = _arrays((1, S, H, D), 1, seed=S + 2)[0]
        _, want = _jax_vjp(q, k, v, do, causal, q_chunk=16, kv_chunk=16, n_rep=H // KV)
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = layers.chunked_attention(qt, layers._repeat_kv(kt, H // KV),
                                       layers._repeat_kv(vt, H // KV), causal=causal,
                                       q_chunk=16, kv_chunk=16)
        got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
        assert got[1].shape == (1, S, KV, D)
        for name, g, w in zip("qkv", got, want):
            np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=f"d{name} H={H}")


# (BH or B, S, D, Dv, causal): MLA's head dims, the reduced config's and the
# full config's, ragged S against the blocks used below
DV_CASES = [(2, 50, 24, 16, True), (3, 33, 24, 16, False), (1, 40, 192, 128, True),
            (2, 19, 192, 128, False)]


def _jax_vjp_dv(q, k, v, do, causal, q_chunk, kv_chunk):
    out, vjp = jax.vjp(lambda q, k, v: jax_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                                                   kv_chunk=kv_chunk),
                       *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("BH,S,D,Dv,causal", DV_CASES)
def test_bwd_ref_with_v_head_dim_matches_jax_vjp(BH, S, D, Dv, causal):
    """``ref.flash_attention_bwd_ref`` on q, k (BH, S, D) and v, o, dO (BH, S,
    Dv) from the plain forward's output and lse: dq, dk (BH, S, D) and dv
    (BH, S, Dv) against ``jax.vjp`` of the reference's
    ``chunked_attention`` (heads as its H axis, one batch row)."""
    rng = np.random.default_rng(S + D + Dv)
    q, k = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(2))
    v, do = (rng.standard_normal((BH, S, Dv)).astype(np.float32) for _ in range(2))
    bshd = lambda a: a.transpose(1, 0, 2)[None]
    _, want = _jax_vjp_dv(*(bshd(a) for a in (q, k, v, do)), causal, q_chunk=16, kv_chunk=16)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal, block_q=16, block_k=16,
                                     with_lse=True)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, o, dot, lse, causal=causal, block_q=16,
                                      block_k=16)
    assert [tuple(g.shape) for g in got] == [(BH, S, D), (BH, S, D), (BH, S, Dv)]
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w[0].transpose(1, 0, 2), **JAX_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,H,D,Dv,causal", [(2, 37, 3, 24, 16, True), (1, 37, 2, 24, 16, False),
                                               (1, 40, 2, 192, 128, True)])
def test_flash_attention_grads_with_v_head_dim_match_jax_vjp(B, S, H, D, Dv, causal):
    """``ops.flash_attention_bhsd`` is differentiable with v's head dim other
    than q's (MLA training): its autograd Function (the plain forward with
    lse, then ``flash_attention_bwd_ref``) against ``jax.vjp`` of the
    reference's ``chunked_attention``."""
    rng = np.random.default_rng(B * S + D)
    q, k = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    v, do = (rng.standard_normal((B, S, H, Dv)).astype(np.float32) for _ in range(2))
    want_out, want = _jax_vjp_dv(q, k, v, do, causal, q_chunk=16, kv_chunk=8)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_bhsd(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **JAX_TOL)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 64), (96, 96)])
def test_bwd_launcher_refuses_head_dims_without_an_instance(D, Dv):
    """K3-bwd's launcher refuses a (D, Dv) that has no CUDA instance before
    it looks at the device: on the card such a gradient raises and never
    falls back to the plain version (``ops.flash_attention_bwd`` hands
    every CUDA tensor to it)."""
    from repro_torch.kernels.flash_attention import INSTANCES
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    assert (D, Dv) not in INSTANCES and (192, 128) in INSTANCES
    q = torch.zeros(2, 8, D)
    v = torch.zeros(2, 8, Dv)
    with pytest.raises(NotImplementedError, match="not in"):
        flash_attention_bwd_cuda(q, q, v, v, v, torch.zeros(2, 8), causal=True, scale=0.1)


def test_grad_path_on_cpu_launches_nothing_and_inference_keeps_no_lse():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays((2, 40, 16), 3, seed=6))
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 0
    assert ops.KERNEL_LAUNCHES["flash_attention_bwd"] == 0
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    want = ref.flash_attention_ref(q.detach(), k.detach(), v.detach(), causal=True)
    assert torch.equal(out.detach(), want)


def test_bwd_scale_argument_and_noncontiguous_grad():
    """A scale other than 1/sqrt(D), and a dO that is a permuted view (as
    autograd hands back through ``flash_attention_bhsd``'s fold)."""
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 30, 2, 16), 3, seed=8))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention_bhsd(qt, kt, vt, causal=True, scale=0.2)
    do = torch.from_numpy(_arrays((1, 2, 30, 16), 1, seed=9)[0]).permute(0, 2, 1, 3)
    assert not do.is_contiguous()
    got = torch.autograd.grad(out, (qt, kt, vt), do)
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * 0.2
    s = s.masked_fill(torch.ones(30, 30, dtype=torch.bool).triu(1), float("-inf"))
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    want = torch.autograd.grad(dense, (qd, kd, vd), do.double())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


# K3-bwd's float32 path (csrc/flash_attention_bwd.cu) runs all seven of its
# products on the tensor cores as 3xTF32 splits: s^T = k q^T, dp^T = v dO^T,
# dv += p^T dO, dk += ds^T q over 32-row q tiles (16 at D = 128), then
# s = q k^T, dp = dO v^T, dq += ds k over kv tiles of the same size.  Each
# operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), rounded as
# csrc/tf32.cuh rounds ((bits + 0x1000) & 0xffffe000: to nearest, ties away
# from zero), and a product is lo.hi + hi.lo + hi.hi (lo.lo dropped).
# Emulated here in numpy float32, each walked tile's product started from
# zero and added to the float32 sum once, the exponent in base 2 with the
# rows pass's lse log2 e; held against jax.vjp of the reference's
# chunked_attention at the card tests' limit (max |d| / max |want| per
# tensor), and a single TF32 product shown to miss it.
K3_BWD_REL_TOL = 1e-4


def _tf32_np(a: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dot_3xtf32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ah, bh = _tf32_np(a), _tf32_np(b)
    al, bl = _tf32_np(a - ah), _tf32_np(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _dot_tf32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _tf32_np(a) @ _tf32_np(b)


def _emulated_k3_bwd(q, k, v, o, do, lse, causal, dot):
    """K3-bwd's float32 arithmetic over (BH, S, D) float32 arrays, the
    products done by ``dot``; returns (dq, dk, dv)."""
    BH, S, D = q.shape
    bt = 16 if D == 128 else 32
    scale = np.float32(D ** -0.5)
    sl2 = np.float32(scale * np.log2(np.e))
    lse2 = (lse * np.float32(np.log2(np.e))).astype(np.float32)
    delta = (do * o).sum(-1, dtype=np.float32)
    pos = np.arange(S)
    dq, dk, dv = (np.zeros((BH, S, D), np.float32) for _ in range(3))
    for b in range(BH):
        for t0 in range(0, S, bt):
            t = slice(t0, min(t0 + bt, S))
            # dk, dv: the tile is q rows t, against every kv row
            sT = dot(k[b], q[b, t].T)
            dpT = dot(v[b], do[b, t].T)
            p = np.exp2(sT * sl2 - lse2[b, t][None, :])
            if causal:
                p = np.where(pos[:, None] > pos[t][None, :], np.float32(0), p)
            ds = p * (dpT - delta[b, t][None, :])
            dv[b] += dot(p, do[b, t])
            dk[b] += dot(ds, q[b, t])
            # dq: the tile is kv rows t, against every q row
            s = dot(q[b], k[b, t].T)
            dp = dot(do[b], v[b, t].T)
            p = np.exp2(s * sl2 - lse2[b][:, None])
            if causal:
                p = np.where(pos[t][None, :] > pos[:, None], np.float32(0), p)
            dq[b] += dot(p * (dp - delta[b][:, None]), k[b, t])
    return dq * scale, dk * scale, dv


# (BH, S, D, causal, q scale, v scale): S from 64 to 257 against every
# walked tile size, D 16-128, plain inputs, a peaky softmax (q x 4) and
# large values (v x 8)
K3_BWD_TF32_CASES = [
    (2, 64, 16, True, 1, 1), (1, 100, 32, False, 1, 1), (2, 129, 64, True, 1, 1),
    (1, 257, 128, False, 1, 1), (1, 200, 64, True, 4, 1), (1, 96, 16, False, 4, 1),
    (1, 257, 32, True, 4, 1), (1, 150, 128, True, 4, 1), (1, 77, 64, False, 1, 8),
    (2, 160, 128, True, 1, 8), (1, 129, 16, True, 1, 8), (1, 65, 32, False, 1, 8)]


def _k3_bwd_emulation_err(BH, S, D, causal, q_scale, v_scale, dot):
    q, k, v, do = _arrays((1, S, BH, D), 4, seed=BH * 1000 + S + D)
    q = q * np.float32(q_scale)
    v = v * np.float32(v_scale)
    _, want = _jax_vjp(q, k, v, do, causal, q_chunk=32, kv_chunk=64)
    fold = lambda a: torch.from_numpy(np.ascontiguousarray(a[0].transpose(1, 0, 2)))
    qt, kt, vt, dot_ = (fold(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal, with_lse=True)
    got = _emulated_k3_bwd(*(t.numpy() for t in (qt, kt, vt, o, dot_, lse)), causal, dot)
    return max(float(np.abs(g.transpose(1, 0, 2)[None] - w).max()) / float(np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("BH,S,D,causal,q_scale,v_scale", K3_BWD_TF32_CASES)
def test_k3_bwd_3xtf32_emulation_matches_jax_vjp(BH, S, D, causal, q_scale, v_scale):
    err = _k3_bwd_emulation_err(BH, S, D, causal, q_scale, v_scale, _dot_3xtf32_np)
    assert err <= K3_BWD_REL_TOL, err


@pytest.mark.parametrize("BH,S,D,causal,q_scale,v_scale", K3_BWD_TF32_CASES[::3])
def test_k3_bwd_single_tf32_product_misses_the_limit(BH, S, D, causal, q_scale, v_scale):
    err = _k3_bwd_emulation_err(BH, S, D, causal, q_scale, v_scale, _dot_tf32_np)
    assert err > K3_BWD_REL_TOL, err


def test_k3_bwd_tf32_rounding_is_the_kernels():
    """tf32.cuh's rounding: to nearest, ties away from zero, 10 mantissa
    bits kept; hi + lo keeps 22 of float32's 24 significant bits."""
    a = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -1.0 - 2.0**-11],
                 np.float32)
    assert _tf32_np(a).tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0 + 2.0**-9,
                                    -1.0 - 2.0**-10]
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    hi = _tf32_np(x)
    lo = _tf32_np(x - hi)
    assert float(np.abs((hi + lo - x) / x).max()) <= 2.0**-22
    assert float(np.abs((hi - x) / x).max()) > 2.0**-13

"""The port's K3 path on the CPU vs the JAX reference: ``ops.flash_attention_bhsd``
(the plain blocked version, ``ref.flash_attention_ref``) against the Pallas
kernel ``flash_attention_bhsd`` in interpret mode, the jnp
``chunked_attention`` and ``dot_attention``.  Limits are the reference's own
(``tests/test_flash_attention.py``): max abs error 3e-5 in float32, 3e-2 in
bfloat16.  ``ref.bf16_agreement``, the stricter bf16 check against the
float32 function, is tested here too, and so is the arithmetic of K3's two
paths, through emulations: the 3xTF32 products of float32, and bfloat16's
p split into hi + lo with each kv tile folded by one rounded multiply-add.
K3 itself is held against its plain version on the card in
``test_torch_cuda.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash_bhsd
from repro.models.layers import chunked_attention as jax_chunked
from repro.models.layers import dot_attention as jax_dot
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import layers

F32_TOL, BF16_TOL = 3e-5, 3e-2

# the reference's CASES, plus S = 1 and a ragged bidirectional case
CASES = [
    (2, 128, 2, 64, True),
    (1, 200, 3, 32, True),
    (2, 96, 2, 64, False),
    (1, 256, 1, 128, True),
    (2, 1, 3, 16, True),
    (1, 77, 2, 32, False),
]


def _qkv(B, S, H, D, seed, kv_heads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kv = [rng.standard_normal((B, S, kv_heads or H, D)).astype(np.float32) for _ in range(2)]
    return q, *kv


def _port(q, k, v, causal, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)
    return ops.flash_attention_bhsd(t(q), t(k), t(v), causal=causal).float().numpy()


@pytest.mark.parametrize("B,S,H,D,causal", CASES)
def test_flash_matches_pallas_interpret(B, S, H, D, causal):
    q, k, v = _qkv(B, S, H, D, seed=B * 1000 + S)
    want = np.asarray(jax_flash_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, interpret=True))
    got = _port(q, k, v, causal)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < F32_TOL


@pytest.mark.parametrize("B,S,H,D,causal", CASES[:3])
def test_flash_matches_dense(B, S, H, D, causal):
    q, k, v = _qkv(B, S, H, D, seed=S)
    want = np.asarray(jax_dot(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert np.abs(_port(q, k, v, causal) - want).max() < F32_TOL


def test_flash_gqa_repeated_kv():
    """GQA as the layers feed it: 2 kv heads repeated to 6 query heads."""
    q, k, v = _qkv(1, 150, 6, 32, seed=3, kv_heads=2)
    rep = lambda a: np.repeat(a, 3, axis=2)
    want = np.asarray(jax_flash_bhsd(jnp.asarray(q), jnp.asarray(rep(k)), jnp.asarray(rep(v)),
                                     causal=True, interpret=True))
    got = layers._repeat_kv(torch.from_numpy(k), 3)
    assert np.array_equal(got.numpy(), rep(k))
    assert np.abs(_port(q, rep(k), rep(v), True) - want).max() < F32_TOL


def test_flash_bf16():
    q, k, v = _qkv(2, 128, 1, 64, seed=9)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_flash_bhsd(bf(q), bf(k), bf(v), causal=True, interpret=True)
                      .astype(jnp.float32))
    got = _port(q, k, v, True, dtype=torch.bfloat16)
    assert np.abs(got - want).max() < BF16_TOL


@pytest.mark.parametrize("q_chunk,kv_chunk", [(64, 64), (32, 128)])
def test_chunked_attention_matches_jax(q_chunk, kv_chunk):
    q, k, v = _qkv(1, 160, 2, 64, seed=7)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk))
    t = torch.from_numpy
    got = layers.chunked_attention(t(q), t(k), t(v), causal=True, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk).numpy()
    assert np.abs(got - want).max() < F32_TOL


@pytest.mark.parametrize("block_q,block_k", [(16, 32), (64, 16), (7, 5)])
def test_blocked_plain_version_block_sizes(block_q, block_k):
    """The plain version's result does not depend on its block sizes
    (ragged last blocks, q blocks smaller and larger than kv blocks)."""
    q, k, v = _qkv(2, 101, 2, 16, seed=11)
    fold = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3).reshape(4, 101, 16)
    for causal in (True, False):
        want = np.asarray(jax_dot(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
        got = ref.flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                                      block_q=block_q, block_k=block_k)
        got = got.reshape(2, 2, 101, 16).permute(0, 2, 1, 3).numpy()
        assert np.abs(got - want).max() < F32_TOL


def test_flash_scale_argument():
    q, k, v = _qkv(1, 40, 2, 32, seed=5)
    want = np.asarray(jax_dot(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              scale=0.3))
    t = torch.from_numpy
    got = ops.flash_attention_bhsd(t(q), t(k), t(v), causal=True, scale=0.3).numpy()
    assert np.abs(got - want).max() < F32_TOL


def test_cpu_runs_plain_version_without_launch():
    q, k, v = (torch.randn(3, 50, 48) for _ in range(3))  # D = 48: no kernel instance
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(q, k[:, :10], v)


def test_kernel_launcher_needs_cuda_tensors():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, causal=True, scale=0.125)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each (bf16-representable, nonzero) value."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs())) - 7)


BF16_VALUES = [0.5, 1.0, 1.5, 3.0, -5.0, 100.0, -0.75]


def test_bf16_agreement_passes_half_an_ulp():
    x = torch.tensor(BF16_VALUES).bfloat16()
    for sign in (1, -1):
        want = x.float() + sign * _bf16_ulp(x) / 2  # exact in float32: a rounding tie
        assert ref.bf16_agreement(x, want) <= 1.0
    assert ref.bf16_agreement(x, x.float()) == 0.0


@pytest.mark.parametrize("value", BF16_VALUES)
def test_bf16_agreement_fails_two_ulps(value):
    x = torch.tensor([value]).bfloat16()
    out = (x.float() + 2 * _bf16_ulp(x)).bfloat16()
    assert float(out.float() - x.float()) == float(2 * _bf16_ulp(x))  # representable
    assert ref.bf16_agreement(out, x.float()) > 1.0


@pytest.mark.parametrize("BH,S,D,causal", [(4, 256, 64, True), (2, 200, 32, False),
                                           (3, 77, 16, True), (2, 130, 128, False)])
def test_bf16_agreement_of_plain_version(BH, S, D, causal):
    """The plain version in bf16 rounds its own float32 result once, so it
    agrees with it; the same attention with p rounded to bf16 before p @ v
    passes the absolute 3e-2 limit but not the agreement check."""
    rng = np.random.default_rng(BH * S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, D)).astype(np.float32)).bfloat16()
               for _ in range(3))
    want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    out = ref.flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    assert ref.bf16_agreement(out, want32) <= 1.0

    s = q.float() @ k.float().transpose(1, 2) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    bf16_p = ((p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    assert float((bf16_p.float() - out.float()).abs().max()) < BF16_TOL
    assert ref.bf16_agreement(bf16_p, want32) > 1.0


def test_bf16_agreement_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="shapes"):
        ref.bf16_agreement(torch.zeros(2, 3), torch.zeros(3, 2))


# K3's float32 path (csrc/flash_attention.cu) runs both products on the
# tensor cores as a 3xTF32 split: each operand a = hi + lo with hi = tf32(a)
# and lo = tf32(a - hi), and a product is lo.hi + hi.lo + hi.hi.  Emulated
# here with its 64-row kv tiles, its base-2 online softmax with the TPU
# kernel's guards, and each tile's p @ v folded into acc.  A TF32 value keeps
# the top 10 mantissa bits of a float32, rounded to nearest even.
def _tf32(a: torch.Tensor) -> torch.Tensor:
    b = a.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _dot_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _emulated_k3(q, k, v, causal, dot, block_k=64):
    """K3's float32 arithmetic over (BH, S, D) float32 tensors, with the
    products done by ``dot``."""
    BH, S, D = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    rows = torch.arange(S)[:, None]
    m = torch.full((BH, S), -math.inf)
    l, acc = torch.zeros(BH, S), torch.zeros(BH, S, D)
    for k0 in range(0, S, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = dot(q, kt.transpose(1, 2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[1])[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp2(m - m_safe), 0.0)
        p = torch.exp2(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + dot(p, vt)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


# the file's CASES, and two with q scaled by 4: a peaky softmax
TF32_CASES = [c + (1.0,) for c in CASES] + [(1, 256, 2, 64, True, 4.0),
                                            (1, 200, 2, 128, False, 4.0)]


def _emulation_vs_pallas(B, S, H, D, causal, q_scale, dot):
    q, k, v = _qkv(B, S, H, D, seed=B * 1000 + S + D)
    q = q * np.float32(q_scale)
    want = np.asarray(jax_flash_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, interpret=True))
    fold = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3).reshape(B * H, S, D)
    got = _emulated_k3(fold(q), fold(k), fold(v), causal, dot)
    got = got.reshape(B, H, S, D).permute(0, 2, 1, 3).numpy()
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("B,S,H,D,causal,q_scale", TF32_CASES)
def test_3xtf32_emulation_matches_pallas_interpret(B, S, H, D, causal, q_scale):
    assert _emulation_vs_pallas(B, S, H, D, causal, q_scale, _dot_3xtf32) < F32_TOL


@pytest.mark.parametrize("B,S,H,D,causal,q_scale", TF32_CASES)
def test_single_tf32_product_misses_the_float32_limit(B, S, H, D, causal, q_scale):
    assert _emulation_vs_pallas(B, S, H, D, causal, q_scale, _dot_tf32) > F32_TOL


def test_tf32_emulation_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0 - 2.0**-12])
    assert _tf32(a).tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -3.0]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    # hi + lo keeps 22 of float32's 24 significant bits; hi alone 11
    assert float(((hi + lo - x) / x).abs().max()) <= 2.0**-22
    assert float(((hi - x) / x).abs().max()) > 2.0**-13


# K3's bfloat16 path (csrc/flash_attention.cu, wgmma) keeps the TPU
# kernel's float32 arithmetic: q . k^T of bf16 values into float32 (exact
# products), p split into two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p -
# p_hi), each kv tile's p @ v started from zero (the p_lo and then the p_hi
# product of each k-step into one float32 sum) and folded into acc with one
# rounded multiply-add, acc * corr + tile.  Emulated here at its kv tiles
# (128 rows up to Dv = 64, 64 past it); the multiply-add is exact in float64
# before its one rounding to float32.  The Pallas kernel takes v of q's head dim only, so MLA's (192,
# 128) runs it with v padded by zero columns (attention is linear in each
# column of v).
def k3_bf16_block_k(Dv: int) -> int:
    """Rows of K3's bfloat16 kv tile (``Tiles::BK``)."""
    return 128 if Dv <= 64 else 64


def _round_bf16(a: torch.Tensor) -> torch.Tensor:
    return a.bfloat16().float()


def _emulated_k3_bf16(q, k, v, causal, split=True):
    """K3's bfloat16 arithmetic over (BH, S, D) q, k and (BH, S, Dv) v, float32
    tensors of bf16 values; the output in bf16.  ``split=False`` keeps p_hi
    alone (a bf16 p)."""
    BH, S, D = q.shape
    block_k = k3_bf16_block_k(v.shape[-1])
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    rows = torch.arange(S)[:, None]
    m = torch.full((BH, S), -math.inf)
    l, acc = torch.zeros(BH, S), torch.zeros(BH, S, v.shape[-1])
    for k0 in range(0, S, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = (q @ kt.transpose(1, 2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[1])[None, :] > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp2(m - m_safe), 0.0)
        p = torch.exp2(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        hi = _round_bf16(p)
        tile = _round_bf16(p - hi) @ vt + hi @ vt if split else hi @ vt
        acc = (acc.double() * corr.double()[..., None] + tile.double()).float()
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


def _k3_bf16_vs_pallas(BH, S, D, Dv, causal, q_scale, split):
    """``bf16_agreement`` of the emulation against the Pallas kernel in
    interpret mode in float32 on the same bf16-valued inputs."""
    rng = np.random.default_rng(BH * S + D + Dv)
    q, k = (_round_bf16(torch.from_numpy(rng.standard_normal((BH, S, D)).astype(np.float32)))
            for _ in range(2))
    v = _round_bf16(torch.from_numpy(rng.standard_normal((BH, S, Dv)).astype(np.float32)))
    q = _round_bf16(q * q_scale)
    v_pad = torch.nn.functional.pad(v, (0, D - Dv))
    want = np.asarray(jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v_pad.numpy()), causal=causal, interpret=True))
    got = _emulated_k3_bf16(q, k, v, causal, split=split)
    return ref.bf16_agreement(got, torch.from_numpy(np.array(want[..., :Dv])))


# the edges of the 64- and 128-row kv tiles at every head dim, MLA's (192,
# 128), and q scaled by 4 (a peaky softmax)
K3_BF16_CASES = [(2, S, D, D, causal, 1.0) for D in (16, 32, 64, 128)
                 for S in (1, 63, 65, 127, 129) for causal in (True, False)] + [
    (2, S, 192, 128, causal, 1.0) for S in (65, 200) for causal in (True, False)] + [
    (2, 129, 64, 64, True, 4.0), (2, 200, 192, 128, False, 4.0)]


@pytest.mark.parametrize("BH,S,D,Dv,causal,q_scale", K3_BF16_CASES)
def test_k3_bf16_emulation_matches_pallas_interpret(BH, S, D, Dv, causal, q_scale):
    assert _k3_bf16_vs_pallas(BH, S, D, Dv, causal, q_scale, split=True) <= 1.0


@pytest.mark.parametrize("BH,S,D,Dv,causal,q_scale", [
    (2, 129, 64, 64, True, 1.0), (2, 200, 192, 128, False, 4.0), (2, 129, 128, 128, False, 1.0)])
def test_k3_bf16_p_without_its_low_term_misses_the_agreement(BH, S, D, Dv, causal, q_scale):
    """The same tiles with p rounded to bf16 (p_hi alone): why p is split."""
    assert _k3_bf16_vs_pallas(BH, S, D, Dv, causal, q_scale, split=False) > 1.0

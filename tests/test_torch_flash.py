"""The port's K3 path on the CPU vs the JAX reference: ``ops.flash_attention_bhsd``
(the plain blocked version, ``ref.flash_attention_ref``) against the Pallas
kernel ``flash_attention_bhsd`` in interpret mode, the jnp
``chunked_attention`` and ``dot_attention``.  Limits are the reference's own
(``tests/test_flash_attention.py``): max abs error 3e-5 in float32, 3e-2 in
bfloat16.  ``ref.bf16_agreement``, the stricter bf16 check against the
float32 function, is tested here too.  K3 itself is held against its plain
version on the card in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_chunked_attention_rejects_mla_head_dims():
    q = torch.zeros(1, 8, 2, 24)
    v = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.chunked_attention(q, q, v, causal=True, q_chunk=4, kv_chunk=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.mla_apply()


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

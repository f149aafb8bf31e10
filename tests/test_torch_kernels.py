"""Port kernel layer vs the JAX reference: ``repro_torch.kernels.ops``
against ``repro.kernels.ops.distance_topk`` (jnp backend and the Pallas
kernel in interpret mode), plus the wrapper edge cases.  Tolerance
rtol = atol = 3e-4 (the reference's own kernel tolerance); ids compared as
sets per row allowing one tie swap.  K1 itself is held against its plain
version on the card in ``test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.distance_topk import TILE_N, split_plan


def _rand(B, N, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, D)).astype(dtype),
        rng.standard_normal((N, D)).astype(dtype),
    )


def _assert_topk_close(d, i, d_r, i_r):
    d, i, d_r, i_r = (np.asarray(a) for a in (d, i, d_r, i_r))
    assert d.shape == d_r.shape and i.shape == i_r.shape
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d))
    assert np.all(i[~fin] == -1) and np.all(i_r[~fin] == -1)
    assert np.allclose(d[fin], d_r[fin], rtol=3e-4, atol=3e-4), np.abs(d - d_r)[fin].max()
    for rk, rr, f in zip(i, i_r, fin):
        sk, sr = set(rk[f].tolist()), set(rr[f].tolist())
        assert len(sk & sr) >= len(sr) - 1  # allow one tie swap


# a reduced tests/test_kernels.py sweep: odd dims, k below/at/above N
SWEEP = [
    (1, 100, 8, 5, "l2"),
    (5, 1000, 32, 10, "l2"),
    (8, 700, 50, 100, "l2"),
    (3, 513, 128, 7, "ip"),
    (4, 300, 20, 5, "cos"),
    (2, 64, 8, 100, "l2"),  # k > N
    (9, 255, 96, 128, "ip"),
]


# every shape against the jnp backend; three against the Pallas kernel
# itself in interpret mode (seconds per call on the CPU)
CASES = [(*s, "jnp") for s in SWEEP] + [
    (*SWEEP[i], "pallas_interpret") for i in (2, 3, 4)
]


@pytest.mark.parametrize("B,N,D,k,metric,backend", CASES)
def test_distance_topk_matches_reference(B, N, D, k, metric, backend):
    q, x = _rand(B, N, D, seed=B * 1000 + N)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), k, metric)
    d_r, i_r = jops.distance_topk(q, x, k, metric, backend=backend)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    _assert_topk_close(d.numpy(), i.numpy(), d_r, i_r)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_n_valid_masks_padding_rows(metric):
    q, x = _rand(6, 900, 24, seed=5)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 12, metric, n_valid=611)
    d_r, i_r = jops.distance_topk(q, x, 12, metric, backend="jnp", n_valid=611)
    _assert_topk_close(d.numpy(), i.numpy(), d_r, i_r)
    assert int(i.max()) < 611
    d_u, i_u = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x[:611]), 12, metric)
    assert torch.equal(i, i_u) and torch.equal(d, d_u)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_empty_corpus(metric):
    q = torch.zeros((3, 8))
    d, i = ops.distance_topk(q, torch.zeros((0, 8)), 5, metric)
    assert d.shape == (3, 5) and torch.isinf(d).all() and (i == -1).all()
    d, i = ops.distance_topk(q, torch.zeros((10, 8)), 5, metric, n_valid=0)
    assert torch.isinf(d).all() and (i == -1).all()


def test_k_larger_than_corpus_pads():
    q, x = _rand(2, 7, 8, seed=1)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 10, "l2")
    assert d.shape == (2, 10)
    assert torch.isinf(d[:, 7:]).all() and (i[:, 7:] == -1).all()
    assert sorted(i[0, :7].tolist()) == list(range(7))


def test_cos_normalizes_once_like_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((8, 16)).astype(np.float32) * 3.0
    x = rng.standard_normal((150, 16)).astype(np.float32) * 0.5
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 6, "cos")
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=-1, keepdims=True)
    d_ip, i_ip = ops.distance_topk(torch.from_numpy(qn), torch.from_numpy(xn), 6, "ip")
    assert torch.equal(i, i_ip)
    assert torch.allclose(d, d_ip, atol=1e-5)


def test_large_k_runs_plain_on_cpu():
    # k_pad > 256: the reference streams through its blocked merge; on CPU
    # tensors the port's plain version handles any k
    q, x = _rand(4, 600, 16, seed=2)
    d, i = ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 300, "cos")
    d_r, i_r = jops.distance_topk(q, x, 300, "cos", backend="jnp")
    _assert_topk_close(d.numpy(), i.numpy(), d_r, i_r)


def test_bf16_inputs_upcast():
    q, x = _rand(4, 500, 64, seed=3)
    qb, xb = torch.from_numpy(q).bfloat16(), torch.from_numpy(x).bfloat16()
    d, i = ops.distance_topk(qb, xb, 10, "l2")
    d_r, i_r = ref.distance_topk_ref(qb.float(), xb.float(), 10, "l2")
    assert torch.equal(i, i_r)
    assert torch.allclose(d, d_r, rtol=3e-4, atol=3e-4)


def test_cpu_tensors_never_launch_the_kernel():
    ops.reset_launches()
    q, x = _rand(3, 200, 8)
    ops.distance_topk(torch.from_numpy(q), torch.from_numpy(x), 4, "l2")
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 0


@pytest.mark.parametrize("block_n", [64, 4096])
def test_blocked_matches_full_matrix(block_n):
    q, x = _rand(16, 5000, 48, seed=4)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    d_b, i_b = ref.distance_topk_blocked(qt, xt, 20, "l2", block_n=block_n)
    d_r, i_r = ref.distance_topk_ref(qt, xt, 20, "l2")
    assert torch.equal(i_b, i_r)
    assert torch.allclose(d_b, d_r, rtol=1e-5)


@pytest.mark.parametrize("k_pad", [128, 256])
@pytest.mark.parametrize("B,n_valid", [(1, 1), (5, 100), (430, 125_000), (4096, 1_000_000),
                                       (280, 156_250), (1, 33_554_432)])
def test_split_plan_covers_rows(B, n_valid, k_pad):
    nsplit, chunk = split_plan(B, n_valid, sm_count=132, k_pad=k_pad)
    assert 1 <= nsplit <= 65535
    assert chunk % TILE_N == 0
    assert (nsplit - 1) * chunk < n_valid <= nsplit * chunk

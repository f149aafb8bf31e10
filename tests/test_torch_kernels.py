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
from repro_torch.kernels import distance_topk as k1
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


@pytest.mark.parametrize("k_pad", [128, 256, 512])
@pytest.mark.parametrize("B,n_valid", [(1, 1), (1, 3), (2, 255), (3, 5003), (4, 99_999),
                                       (1, 1_000_000), (3, 1_000_001), (4, 33_554_432)])
def test_small_plan_covers_rows_in_whole_groups(B, n_valid, k_pad):
    """The small-batch scan's chunks: every row once, each chunk starting on
    a whole 4-row group (a 16-byte multiple of any row), at most k_pad
    chunks (their bounds' slots) and one wave of one block a SM."""
    nsplit, chunk = k1.small_plan(B, n_valid, sm_count=132, k_pad=k_pad)
    assert 1 <= nsplit <= min(k_pad, 132)
    assert chunk % k1.SMALL_GROUP == 0
    starts = [s * chunk for s in range(nsplit)]
    assert all(s % 4 == 0 for s in starts)
    covered = sum(min(s + chunk, n_valid) - s for s in starts)
    assert covered == n_valid and starts[-1] < n_valid  # no empty chunk, no row twice
    assert nsplit == 1 or chunk >= k1.SMALL_MIN_ROWS


@pytest.mark.parametrize("B,path", [(1, 1), (2, 1), (k1.B_SMALL - 1, 1), (k1.B_SMALL, 1),
                                    (k1.B_SMALL + 1, 0), (63, 0), (65, 0), (4096, 0)])
def test_the_batch_alone_chooses_the_scan(B, path):
    for D in (7, 50, 128, 512):
        nsplit, chunk, got = k1.launch_plan(B, D, 124_606, sm_count=132, k_pad=128)
        assert got == path
        want = (k1.small_plan if path else split_plan)(B, 124_606, 132, 128)
        assert (nsplit, chunk) == want


def test_small_batch_refuses_rows_wider_than_its_stage():
    k1.launch_plan(k1.B_SMALL, k1.SMALL_D_MAX, 5000, 132, 128)
    with pytest.raises(ValueError, match="D="):
        k1.launch_plan(k1.B_SMALL, k1.SMALL_D_MAX + 1, 5000, 132, 128)
    assert k1.launch_plan(k1.B_SMALL + 1, 4096, 5000, 132, 128)[2] == 0


def test_launches_by_shape_add_up_to_the_launch_counts(monkeypatch):
    """K1's and K2's launches are counted by (B, N = n_valid, D, k_pad)
    beside ``KERNEL_LAUNCHES``; the counts by shape sum to it, and
    ``reset_launches`` clears both."""
    stub = lambda q, *a, k_pad, **kw: (torch.empty(q.shape[0], k_pad),
                                       torch.empty(q.shape[0], k_pad, dtype=torch.int32))
    monkeypatch.setattr(ops, "distance_topk_cuda", stub)
    monkeypatch.setattr(ops, "distance_topk_q8_cuda", stub)
    ops.reset_launches()
    calls = [(1, 1000, 50, 128, 999), (440, 124_606, 128, 128, 124_606),
             (1, 1000, 50, 128, 999), (3, 64, 8, 256, 40)]
    for B, N, D, k_pad, nv in calls:
        ops._k1_launch(torch.zeros(B, D), torch.zeros(N, D), k_pad, nv, "l2")
    for B, N, D, k_pad, nv in calls[:2]:
        ops._k2_launch(torch.zeros(B, D, dtype=torch.int8), torch.zeros(N, D, dtype=torch.int8),
                       torch.ones(B), torch.zeros(N), k_pad, nv, "ip")
    k1s, k2s = ops.LAUNCHES_BY_SHAPE["distance_topk"], ops.LAUNCHES_BY_SHAPE["distance_topk_q8"]
    assert k1s == {(1, 999, 50, 128): 2, (440, 124_606, 128, 128): 1, (3, 40, 8, 256): 1}
    assert k2s == {(1, 999, 50, 128): 1, (440, 124_606, 128, 128): 1}
    assert sum(k1s.values()) == ops.KERNEL_LAUNCHES["distance_topk"] == 4
    assert sum(k2s.values()) == ops.KERNEL_LAUNCHES["distance_topk_q8"] == 2
    ops.reset_launches()
    assert not any(ops.LAUNCHES_BY_SHAPE.values()) and not any(ops.KERNEL_LAUNCHES.values())


# K1's small-batch scan (csrc/distance_topk.cu, small_scan_kernel) sums in
# float32 on the CUDA cores: lane l of a warp takes dimensions l, l + 32,
# ... of a row, keeping its part of ||x||^2 and of each q.x, and the warp's
# 32 parts of ||x||^2 - 2 q.x are added in a fixed tree.  Emulated here.
def _small_scan_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    B, D = q.shape
    parts = torch.zeros(32, B, x.shape[0])
    for lane in range(32):
        nrm = torch.zeros(x.shape[0])
        dot = torch.zeros(B, x.shape[0])
        for d in range(lane, D, 32):  # one fmaf a dimension, in order
            nrm = torch.addcmul(nrm, x[:, d], x[:, d])
            dot = torch.addcmul(dot, q[:, d, None], x[None, :, d])
        parts[lane] = nrm[None, :] - 2 * dot
    for o in (16, 8, 4, 2, 1):  # lanes l and l ^ o, the lower half kept
        parts = parts[:o] + parts[o:2 * o]
    return parts[0]


@pytest.mark.parametrize("D", [7, 18, 50, 128, 512])
def test_small_scan_sums_hold_the_parity_contract(D):
    q, x = _rand(4, 300, D, seed=D)
    s = _small_scan_scores(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    assert np.allclose(s, _l2_scores_f64(q, x), rtol=3e-4, atol=3e-4)


# K1 scores on the tensor cores as a 3xTF32 split (csrc/distance_topk.cu):
# each operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and a dot
# is lo.hi + hi.lo + hi.hi accumulated in float32.  Emulated here: a TF32
# value keeps the top 10 mantissa bits of a float32, rounded to nearest even.
def _tf32(a: torch.Tensor) -> torch.Tensor:
    b = a.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _l2_scores_3xtf32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    dot = ql @ xh.T + qh @ xl.T + qh @ xh.T
    return (x * x).sum(1)[None, :] - 2 * dot


def _l2_scores_tf32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(1)[None, :] - 2 * (_tf32(q) @ _tf32(x).T)


def _l2_scores_f64(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    q, x = q.astype(np.float64), x.astype(np.float64)
    return (x * x).sum(1)[None, :] - 2 * q @ x.T


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.0 - 2.0**-12])
    assert _tf32(a).tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -3.0]


@pytest.mark.parametrize("D", [50, 128, 512, 2048])
def test_3xtf32_split_holds_the_parity_contract(D):
    q, x = _rand(16, 300, D, seed=D)
    s = _l2_scores_3xtf32(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    assert np.allclose(s, _l2_scores_f64(q, x), rtol=3e-4, atol=3e-4)


def test_single_tf32_product_breaks_the_parity_contract():
    # near-duplicate rows, the case a nearest-neighbour search ranks: the
    # squared distance is small beside the terms that cancel in it
    rng = np.random.default_rng(7)
    q = rng.standard_normal((16, 128)).astype(np.float32)
    x = (np.repeat(q, 20, 0) + 0.01 * rng.standard_normal((320, 128))).astype(np.float32)
    qn = (q.astype(np.float64) ** 2).sum(1)[:, None]
    want = qn + _l2_scores_f64(q, x)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    split = qn + _l2_scores_3xtf32(qt, xt).numpy()
    single = qn + _l2_scores_tf32(qt, xt).numpy()
    assert np.allclose(split, want, rtol=3e-4, atol=3e-4)
    assert not np.allclose(single, want, rtol=3e-4, atol=3e-4)

"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
module imports torch and the port only (no JAX), so it runs on a machine
that has the card but not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.data.synthetic import sift_like
from repro_torch.kernels import ops, ref


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc to build K1")
    return torch.device("cuda")


def _assert_topk_close(d, i, d_r, i_r):
    d, i, d_r, i_r = (t.cpu().numpy() for t in (d, i, d_r, i_r))
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d))
    assert np.all(i[~fin] == -1)
    assert np.allclose(d[fin], d_r[fin], rtol=3e-4, atol=3e-4), np.abs(d - d_r)[fin].max()
    for rk, rr, f in zip(i, i_r, fin):
        assert len(set(rk[f].tolist()) & set(rr[f].tolist())) >= f.sum() - 1  # one tie swap


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("B,N,D,k,n_valid", [
    (37, 5003, 128, 100, None),
    (9, 4097, 50, 200, 257),
    (3, 64, 960, 100, 40),
    (1000, 200_000, 128, 10, None),
])
def test_k1_matches_plain(cuda, metric, B, N, D, k, n_valid):
    g = torch.Generator(device=cuda).manual_seed(B + N)
    q = torch.randn(B, D, generator=g, device=cuda)
    x = torch.randn(N, D, generator=g, device=cuda)
    ops.reset_launches()
    d, i = ops.distance_topk(q, x, k, metric, n_valid=n_valid)
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 1
    d_p, i_p = ref.distance_topk_blocked(q, x, k, metric, n_valid=n_valid)
    torch.cuda.synchronize()
    _assert_topk_close(d, i, d_p, i_p)


@pytest.mark.cuda
def test_k1_rejects_large_k(cuda):
    q = torch.randn(2, 8, device=cuda)
    x = torch.randn(1000, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.distance_topk(q, x, 300, "l2")


@pytest.mark.cuda
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_card_index_matches_cpu_index(cuda, spill):
    data, queries = sift_like(2500, 24, 48, seed=5)
    cfg = LannsConfig(num_shards=2, num_segments=4, engine="scan", spill=spill)
    gpu = LannsIndex(cfg).build(data)
    cpu = LannsIndex(cfg, device="cpu").build(data)
    ops.reset_launches()
    d, i = gpu.query(queries, 10)
    assert ops.KERNEL_LAUNCHES["distance_topk"] > 0
    d_c, i_c = cpu.query(queries, 10)
    np.testing.assert_array_equal(i, i_c)
    np.testing.assert_allclose(d, d_c, rtol=3e-4, atol=3e-4)

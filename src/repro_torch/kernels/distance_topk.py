"""Launcher of K1, the fused distance + streaming top-k CUDA kernel.

The kernel (``csrc/distance_topk.cu``) replaces the Pallas TPU kernel
``repro/kernels/distance_topk.py::_distance_topk_kernel``.  This module
checks the inputs, splits the corpus into per-block chunks, allocates the
outputs and launches on PyTorch's current stream.  Nothing here runs at
import: the library is built and loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE_N = 128  # corpus rows per tile
K_PADS = (128, 256, 512)
#: queries per block, by k_pad (csrc/topk.cuh ``QTile``)
TILE_Q = {128: 32, 256: 32, 512: 16}
#: resident blocks per SM, as shared memory allows (101 / 165 / 155 KB a block)
BLOCKS_PER_SM = {128: 2, 256: 1, 512: 1}
_METRIC = {"l2": 0, "ip": 1}
_INT32_MAX = 2**31 - 1

_FN: dict[str, object] = {}


def _kernel():
    fn = _FN.get("distance_topk")
    if fn is None:
        fn = _build.load("distance_topk.cu").repro_distance_topk
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["distance_topk"] = fn
    return fn


def split_plan(B: int, n_valid: int, sm_count: int, k_pad: int) -> tuple[int, int]:
    """(nsplit, chunk): how many corpus chunks each query tile is split
    into, and the rows per chunk (a multiple of the tile).  K1 and K2 share
    the block shape and shared-memory size, so both use this plan.

    Fills at most two waves of resident blocks (never a sliver of a third),
    with at least four tiles per chunk so that a chunk's running top-k
    settles before its end.
    """
    n_tiles = -(-n_valid // TILE_N)
    q_tiles = -(-B // TILE_Q[k_pad])
    waves = 2 * sm_count * BLOCKS_PER_SM[k_pad]
    nsplit = max(1, min(waves // q_tiles, n_tiles // 4, 65535))
    chunk = -(-n_tiles // nsplit) * TILE_N
    return -(-n_valid // chunk), chunk


def distance_topk_cuda(
    q: torch.Tensor, x: torch.Tensor, *, k_pad: int, n_valid: int, metric: str
):
    """Launch K1: for each row of ``q`` the ``k_pad`` smallest scores over
    rows ``< n_valid`` of ``x``.

    q (B, D) and x (N, D) float32, contiguous, on one CUDA device.  Returns
    (dists (B, k_pad) ascending, ids (B, k_pad) int32), padded with
    (inf, -1).  l2 scores omit ``||q||^2``; ip scores are ``-q.x``.
    """
    if not (q.is_cuda and x.is_cuda and q.device == x.device):
        raise ValueError("distance_topk_cuda: q and x must be on one CUDA device")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"distance_topk_cuda: float32 only, got {q.dtype}/{x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"distance_topk_cuda: shapes {tuple(q.shape)} x {tuple(x.shape)}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("distance_topk_cuda: q and x must be contiguous")
    if k_pad not in K_PADS:
        raise ValueError(f"distance_topk_cuda: k_pad={k_pad} not in {K_PADS}")
    if metric not in _METRIC:
        raise ValueError(f"distance_topk_cuda: metric={metric!r} (l2 or ip)")
    B, D = q.shape
    N = x.shape[0]
    if not 0 < n_valid <= N or N > _INT32_MAX or B > _INT32_MAX or B == 0:
        raise ValueError(f"distance_topk_cuda: B={B}, N={N}, n_valid={n_valid}")
    dev = q.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, chunk = split_plan(B, n_valid, sm_count, k_pad)
    out_d = torch.empty((B, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k_pad), dtype=torch.int32, device=dev)
    if nsplit > 1:
        part_d = torch.empty((B, nsplit, k_pad), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, nsplit, k_pad), dtype=torch.int32, device=dev)
    else:
        part_d, part_i = out_d, out_i  # unused by the kernel
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernel()(
            q.data_ptr(), x.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            B, D, n_valid, k_pad, _METRIC[metric], nsplit, chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"distance_topk kernel launch failed: cudaError {rc}")
    return out_d, out_i

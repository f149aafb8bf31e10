"""Launcher of K1, the fused distance + streaming top-k CUDA kernel.

The kernel (``csrc/distance_topk.cu``) replaces the Pallas TPU kernel
``repro/kernels/distance_topk.py::_distance_topk_kernel``.  This module
checks the inputs, chooses the kernel by the batch alone (the small-batch
scan for ``B <= B_SMALL``, else the batched scan), splits the corpus into
per-block chunks, allocates the outputs and launches on PyTorch's current
stream.  Nothing here runs at import: the library is built and loaded at
the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE_N = 64  # corpus rows per tile (csrc/scan.cuh ``TN``)
K_PADS = (128, 256, 512)
#: queries per block of the batched scan (csrc/scan.cuh ``TQ``: two consumer
#: warpgroups of 64) at every k_pad: the running lists live in the partial
#: output, so the tile does not shrink as k_pad grows
TILE_Q = 128
#: resident blocks per SM, as shared memory allows (218 KB a block)
BLOCKS_PER_SM = 1
#: the largest batch the small-batch scan takes (csrc/distance_topk.cu
#: ``small::QMAX``): the crossover with the batched scan, measured on the
#: card between B = 4 and 8 (PERF.md)
B_SMALL = 4
#: the small-batch scan's chunks start on whole groups of rows (one 16-byte
#: multiple of any D) and hold at least this many rows
SMALL_GROUP = 4
SMALL_MIN_ROWS = 256
#: the widest row the small-batch scan stages (4 rows in its 32 KB stage)
SMALL_D_MAX = 2048
_METRIC = {"l2": 0, "ip": 1}
_INT32_MAX = 2**31 - 1

_FN: dict[str, object] = {}


def _kernel():
    fn = _FN.get("distance_topk")
    if fn is None:
        fn = _build.load("distance_topk.cu").repro_distance_topk
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["distance_topk"] = fn
    return fn


def small_batch(B: int) -> bool:
    """Whether a batch of B queries takes the small-batch scan: by B alone."""
    return B <= B_SMALL


def small_plan(B: int, n_valid: int, sm_count: int, k_pad: int) -> tuple[int, int]:
    """(nsplit, chunk) of the small-batch scan: one block a chunk, all B
    queries in it.  One wave of one block a SM, at most k_pad chunks (their
    bounds live in the first k_pad words of each output row until the
    chunk merge writes it), at least ``SMALL_MIN_ROWS`` rows a chunk, and
    every chunk starts on a multiple of ``SMALL_GROUP`` rows."""
    nsplit = max(1, min(sm_count, k_pad, n_valid // SMALL_MIN_ROWS))
    rows = -(-n_valid // nsplit)
    chunk = -(-rows // SMALL_GROUP) * SMALL_GROUP
    return -(-n_valid // chunk), chunk


def launch_plan(B: int, D: int, n_valid: int, sm_count: int,
                k_pad: int) -> tuple[int, int, int]:
    """(nsplit, chunk, path) of one K1 launch: path 1, the small-batch scan
    with ``small_plan``, for ``B <= B_SMALL``; path 0, the batched scan with
    ``split_plan``, for any other B.  The batch alone decides; a row wider
    than the small-batch scan's stage raises."""
    if small_batch(B):
        if D > SMALL_D_MAX:
            raise ValueError(f"distance_topk_cuda: D={D} > {SMALL_D_MAX} at B={B} <= {B_SMALL}")
        return (*small_plan(B, n_valid, sm_count, k_pad), 1)
    return (*split_plan(B, n_valid, sm_count, k_pad), 0)


def split_plan(B: int, n_valid: int, sm_count: int, k_pad: int) -> tuple[int, int]:
    """(nsplit, chunk): how many corpus chunks each query tile is split
    into, and the rows per chunk (a multiple of the tile).  K1 and K2 share
    the block shape and shared-memory size, so both use this plan.

    Fills one wave of resident blocks, so that all chunks of a query run at
    once and each can prune with the bounds the others publish
    (csrc/scan.cuh); at most k_pad chunks, whose bounds live in the first
    k_pad words of each output row until the chunk merge writes it; at
    least four tiles per chunk.
    """
    n_tiles = -(-n_valid // TILE_N)
    q_tiles = -(-B // TILE_Q)
    wave = sm_count * BLOCKS_PER_SM
    nsplit = max(1, min(wave // q_tiles, n_tiles // 4, k_pad))
    chunk = -(-n_tiles // nsplit) * TILE_N
    return -(-n_valid // chunk), chunk


def distance_topk_cuda(
    q: torch.Tensor, x: torch.Tensor, *, k_pad: int, n_valid: int, metric: str
):
    """Launch K1: for each row of ``q`` the ``k_pad`` smallest scores over
    rows ``< n_valid`` of ``x``.

    q (B, D) and x (N, D) float32, contiguous, on one CUDA device.  Returns
    (dists (B, k_pad) ascending, ids (B, k_pad) int32), padded with
    (inf, -1).  l2 scores omit ``||q||^2``; ip scores are ``-q.x``.  B <=
    ``B_SMALL`` runs the small-batch scan (D <= ``SMALL_D_MAX``), any
    other B the batched scan.
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
    nsplit, chunk, path = launch_plan(B, D, n_valid, sm_count, k_pad)
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
            B, D, n_valid, k_pad, _METRIC[metric], nsplit, chunk, path, stream,
        )
    if rc != 0:
        raise RuntimeError(f"distance_topk kernel launch failed: cudaError {rc}")
    return out_d, out_i

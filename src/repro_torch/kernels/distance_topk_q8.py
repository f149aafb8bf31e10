"""Launcher of K2, the fused int8 distance + streaming top-k CUDA kernel.

The kernel (``csrc/distance_topk_q8.cu``) replaces the Pallas TPU kernel
``repro/kernels/distance_topk_q8.py::_distance_topk_q8_kernel``.  This
module checks the inputs, splits the corpus into per-block chunks (the same
plan as K1's), allocates the outputs and launches on PyTorch's current
stream.  Nothing here runs at import: the library is built and loaded at
the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk import K_PADS, split_plan

_METRIC = {"l2": 0, "ip": 1}
_INT32_MAX = 2**31 - 1

_FN: dict[str, object] = {}


def _kernel():
    fn = _FN.get("distance_topk_q8")
    if fn is None:
        fn = _build.load("distance_topk_q8.cu").repro_distance_topk_q8
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["distance_topk_q8"] = fn
    return fn


def distance_topk_q8_cuda(
    q_codes: torch.Tensor,
    x_codes: torch.Tensor,
    q_scale: torch.Tensor,
    norms2: torch.Tensor,
    *,
    k_pad: int,
    n_valid: int,
    metric: str,
):
    """Launch K2: for each row of ``q_codes`` the ``k_pad`` smallest
    quantized scores over rows ``< n_valid`` of ``x_codes``.

    q_codes (B, D) and x_codes (N, D) int8 with D a multiple of 4 (zero
    padding along D is exact), q_scale (B,) and norms2 (N,) float32, all
    contiguous on one CUDA device.  Returns (scores (B, k_pad) ascending,
    ids (B, k_pad) int32), padded with (inf, -1).  l2 scores are
    ``norms2 - 2 * qx`` (no ||q||^2); ip scores are ``-qx``.
    """
    ts = (q_codes, x_codes, q_scale, norms2)
    if not all(t.is_cuda and t.device == q_codes.device for t in ts):
        raise ValueError("distance_topk_q8_cuda: all inputs must be on one CUDA device")
    if q_codes.dtype != torch.int8 or x_codes.dtype != torch.int8:
        raise TypeError(f"distance_topk_q8_cuda: int8 codes only, got {q_codes.dtype}/{x_codes.dtype}")
    if q_scale.dtype != torch.float32 or norms2.dtype != torch.float32:
        raise TypeError("distance_topk_q8_cuda: q_scale and norms2 must be float32")
    if q_codes.dim() != 2 or x_codes.dim() != 2 or q_codes.shape[1] != x_codes.shape[1]:
        raise ValueError(
            f"distance_topk_q8_cuda: shapes {tuple(q_codes.shape)} x {tuple(x_codes.shape)}"
        )
    B, D = q_codes.shape
    N = x_codes.shape[0]
    if D % 4 or D == 0:
        raise ValueError(f"distance_topk_q8_cuda: D={D} must be a positive multiple of 4")
    if q_scale.shape != (B,) or norms2.shape != (N,):
        raise ValueError(
            f"distance_topk_q8_cuda: q_scale {tuple(q_scale.shape)} / norms2 "
            f"{tuple(norms2.shape)} for B={B}, N={N}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("distance_topk_q8_cuda: inputs must be contiguous")
    if k_pad not in K_PADS:
        raise ValueError(f"distance_topk_q8_cuda: k_pad={k_pad} not in {K_PADS}")
    if metric not in _METRIC:
        raise ValueError(f"distance_topk_q8_cuda: metric={metric!r} (l2 or ip)")
    if not 0 < n_valid <= N or N > _INT32_MAX or B > _INT32_MAX or B == 0:
        raise ValueError(f"distance_topk_q8_cuda: B={B}, N={N}, n_valid={n_valid}")
    dev = q_codes.device
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
            q_codes.data_ptr(), x_codes.data_ptr(), q_scale.data_ptr(), norms2.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            B, D // 4, n_valid, k_pad, _METRIC[metric], nsplit, chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"distance_topk_q8 kernel launch failed: cudaError {rc}")
    return out_d, out_i

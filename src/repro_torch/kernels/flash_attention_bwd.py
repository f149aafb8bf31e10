"""Launcher of K3-bwd, the gradient of the flash-attention forward kernel.

The kernel (``csrc/flash_attention_bwd.cu``) replaces what the JAX package
gets from autodiff of ``repro/models/layers.py::chunked_attention``: dq,
dk, dv from q, k, v, the forward's output o, the output's gradient dO and
K3's row log-sum-exp.  Both dtypes run on Hopper's warpgroup MMAs fed by
TMA (``wgmma``): bfloat16 with p and ds split into two bf16 terms, float32
with every product a 3xTF32 split.  This module checks the inputs, allocates the outputs and the
kernel's scratch and launches on PyTorch's current stream.  Nothing here
runs at import: the library is built and loaded at the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPE, _MAX_BH, HEAD_DIMS

_FN: dict[str, object] = {}
#: the scratch pads S to a multiple of this (the rows a bf16 block owns)
_BLOCK_ROWS = 128


def _kernel():
    fn = _FN.get("flash_attention_bwd")
    if fn is None:
        fn = _build.load("flash_attention_bwd.cu").repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["flash_attention_bwd"] = fn
    return fn


def _scratch_shape(BH: int, S: int) -> tuple:
    """The kernel's float32 scratch: (lse log2 e, delta) per row, S padded
    to whole blocks."""
    return (BH, -(-S // _BLOCK_ROWS) * _BLOCK_ROWS, 2)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool, scale: float):
    """Launch K3-bwd over q, k, v, o, dO (BH, S, D), contiguous and 16-byte
    aligned, of one dtype (float32 or bfloat16), and lse (BH, S) float32,
    all on one CUDA device.  Returns (dq, dk, dv) in the inputs' dtype."""
    ts = (q, k, v, o, do)
    if not (q.is_cuda and all(t.device == q.device for t in (*ts, lse))):
        raise ValueError("flash_attention_bwd_cuda: every input must be on one CUDA device")
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError("flash_attention_bwd_cuda: shapes "
                         f"{[tuple(t.shape) for t in ts]}; expected five equal (BH, S, D)")
    BH, S, D = q.shape
    if lse.shape != (BH, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda: lse {lse.dtype} {tuple(lse.shape)}; "
                         f"expected contiguous float32 ({BH}, {S})")
    if q.dtype not in _DTYPE or any(t.dtype != q.dtype for t in ts):
        raise NotImplementedError("flash_attention_bwd_cuda: dtypes "
                                  f"{[t.dtype for t in ts]}; the kernel takes float32 or "
                                  "bfloat16, all five alike")
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention_bwd_cuda: head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd_cuda: q, k, v, o and dO must be contiguous")
    if not (0 < BH <= _MAX_BH and 0 < S < 2**31):
        raise ValueError(f"flash_attention_bwd_cuda: BH={BH}, S={S}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention_bwd_cuda: q, k, v, o and dO must be 16-byte aligned "
                         "(the kernel copies rows in 16-byte pieces)")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty(_scratch_shape(BH, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel()(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, scratch, dq, dk, dv)),
            BH, S, D, _DTYPE[q.dtype], int(bool(causal)), float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {rc}")
    return dq, dk, dv

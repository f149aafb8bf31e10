"""Launcher of K3, the flash-attention forward CUDA kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_fwd_kernel``.  Both dtypes run
on the tensor cores at float32 grade.  bfloat16 runs Hopper's warpgroup
MMAs (``wgmma``) in a warp-specialised block: a producer warpgroup streams
k and v tiles by TMA through a ring of shared-memory stages, two consumer
warpgroups of 64 q rows each take turns on the tensor cores, and p @ v
splits p into two bf16 terms (hi + lo) from the score accumulators.
float32 runs ``mma.sync`` as a 3xTF32 split of every operand.  This module
checks the inputs, allocates the output and launches on PyTorch's current
stream.
Nothing here runs at import: the library is built and loaded at the first
launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: head dims with q . k and v of one width
HEAD_DIMS = (16, 32, 64, 128)
#: the (q . k, v) head dims the kernel (and K3-bwd) is instantiated for:
#: equal pairs, and MLA's (192, 128) (DeepSeek-V2: 128 nope + 64 rope dims,
#: v 128)
INSTANCES = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # the grid's second dimension

_FN: dict[str, object] = {}


def _kernel():
    fn = _FN.get("flash_attention")
    if fn is None:
        fn = _build.load("flash_attention.cu").repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN["flash_attention"] = fn
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                         scale: float, with_lse: bool = False):
    """Launch K3: attention forward over q, k (BH, S, D) and v (BH, S, Dv),
    contiguous and 16-byte aligned, of one dtype (float32 or bfloat16), on
    one CUDA device, (D, Dv) one of ``INSTANCES``.  Returns the output
    (BH, S, Dv) in that dtype; with ``with_lse``, also each row's
    log-sum-exp of the scaled scores, (BH, S) float32 in natural-log units,
    which the backward kernel reads."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k and v must be on one CUDA device")
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}; expected q, k (BH, S, D) and v (BH, S, Dv)")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                                  "the kernel takes float32 or bfloat16, all three alike")
    BH, S, D = q.shape
    Dv = v.shape[-1]
    if (D, Dv) not in INSTANCES:
        raise NotImplementedError(f"flash_attention_cuda: head dims (q . k, v) = {(D, Dv)} not "
                                  f"in {INSTANCES}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k and v must be contiguous")
    if not (0 < BH <= _MAX_BH and 0 < S < 2**31):
        raise ValueError(f"flash_attention_cuda: BH={BH}, S={S}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k and v must be 16-byte aligned "
                         "(the kernel copies rows in 16-byte pieces, or by TMA)")
    out = q.new_empty((BH, S, Dv))
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            BH, S, D, Dv, _DTYPE[q.dtype], int(bool(causal)), float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    return (out, lse) if with_lse else out

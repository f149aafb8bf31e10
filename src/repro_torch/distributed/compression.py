"""Gradient compression for the cross-pod hop: int8 quantization with error
feedback (1-bit-Adam-style residual carrying), and top-k sparsification.

The port of ``repro.distributed.compression``.  Compression lives outside
the collective (quantize -> all_reduce in int32 -> dequantize), so it
composes with any reduction schedule; error feedback keeps the
quantization residual on the device and re-injects it next step.
"""

from __future__ import annotations

import torch

from repro_torch.common.tree import flatten, unflatten
from repro_torch.distributed.collectives import all_reduce_max, all_reduce_sum


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q int8, scale float32 0-d)."""
    amax = x.abs().max().to(torch.float32)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8-compressed all-reduce over ``group``: ~4x fewer bytes than
    float32.  Sums in int32 (no overflow below ~2^23 summands) and takes
    the largest scale of the group (a conservative dequantization)."""
    q, scale = quantize_int8(x)
    acc = all_reduce_sum(q.to(torch.int32), group)
    return acc.to(torch.float32) * all_reduce_max(scale, group)


def error_feedback_compress(grads, residuals):
    """g' = quantize(g + r); r' = (g + r) - dequant(g'), leaf by leaf.

    Returns (a tree of (q, scale) pairs, the tree of new residuals)."""
    pairs, new_res = [], []
    for (_, g), (_, r) in zip(flatten(grads), flatten(residuals)):
        target = g.to(torch.float32) + r
        q, scale = quantize_int8(target)
        pairs.append((q, scale))
        new_res.append(target - dequantize_int8(q, scale))
    return unflatten(grads, pairs), unflatten(residuals, new_res)


def topk_sparsify(x: torch.Tensor, frac: float):
    """Keep the top-``frac`` magnitude entries (dense mask form): returns
    (the masked tensor, the mask)."""
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(x.abs().reshape(-1), k).values[-1]  # k-th largest magnitude
    mask = x.abs() >= thresh
    return torch.where(mask, x, torch.zeros_like(x)), mask

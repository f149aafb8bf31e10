"""Public wrappers around the kernels: the entry points the rest of the
package uses.

``distance_topk`` and ``distance_topk_q8`` keep the wrapper contract of
``repro.kernels.ops``: empty corpora and ``k > N`` pad with (inf, -1),
``cos`` normalizes once and scores as ``ip``, ``l2`` adds ``||q||^2`` back,
inf maps to id -1.  Which code runs follows the tensors: on CPU tensors the
plain PyTorch versions (``ref.distance_topk_blocked``,
``ref.distance_topk_q8_blocked``, ``ref.flash_attention_ref``), on CUDA
tensors the K1 / K2 / K3 kernels — never a fallback from one to the other.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.utils import next_pow2
from repro_torch.kernels import ref
from repro_torch.kernels.distance_topk import distance_topk_cuda
from repro_torch.kernels.distance_topk_q8 import distance_topk_q8_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.quant.codec import quantize_queries_q8_t

LANE = 128
#: the largest per-query list the kernels keep (csrc/topk.cuh)
K_PAD_MAX = 512

#: kernel launches by the wrappers of this module, by kernel name
KERNEL_LAUNCHES = {"distance_topk": 0, "distance_topk_q8": 0, "flash_attention": 0,
                   "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _cuda_k_pad(k: int, name: str) -> int:
    k_pad = max(next_pow2(k), LANE)
    if k_pad > K_PAD_MAX:
        raise NotImplementedError(
            f"{name}: k={k} needs k_pad={k_pad} > {K_PAD_MAX} on CUDA "
            "(ROADMAP 'TPU kernels to port': k_pad > 512 on CUDA)"
        )
    return k_pad


def _empty_topk(B: int, k: int, dev):
    return (
        torch.full((B, k), float("inf"), dtype=torch.float32, device=dev),
        torch.full((B, k), -1, dtype=torch.int32, device=dev),
    )


def _pad_topk(d: torch.Tensor, i: torch.Tensor, k: int):
    """Pad (B, n) results to (B, k) with (inf, -1)."""
    B, n = d.shape
    pad_d = torch.full((B, k - n), float("inf"), dtype=d.dtype, device=d.device)
    pad_i = torch.full((B, k - n), -1, dtype=i.dtype, device=i.device)
    return torch.cat([d, pad_d], 1), torch.cat([i, pad_i], 1)


def distance_topk(q, x, k: int, metric: str = "l2", *, n_valid: int | None = None):
    """Top-k nearest rows of ``x`` for each row of ``q``.

    Returns (dists (B, k) ascending float32, ids (B, k) int32; id -1 where
    fewer than k valid rows exist).  For metric='l2' distances are true
    squared L2; for 'ip'/'cos' they are negative (inner product / cosine
    similarity).  ``n_valid``: rows >= n_valid of ``x`` are padding.
    """
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(metric)
    q = torch.as_tensor(q)
    x = torch.as_tensor(x)
    if q.device != x.device:
        raise ValueError(f"q on {q.device} but x on {x.device}")
    dev = q.device
    B = q.shape[0]
    N = x.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    if N == 0 or nv == 0:
        return _empty_topk(B, k, dev)
    if k > N:  # fewer corpus rows than requested: pad with (inf, -1)
        d, i = distance_topk(q, x, N, metric, n_valid=nv)
        return _pad_topk(d, i, k)
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "cos":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        metric_k = "ip"
    else:
        metric_k = metric

    if dev.type == "cpu":
        return ref.distance_topk_blocked(q, x, k, metric_k, n_valid=nv)
    if dev.type != "cuda":
        raise ValueError(f"distance_topk: unsupported device {dev}")
    k_pad = _cuda_k_pad(k, "distance_topk")
    if B == 0:
        return _empty_topk(0, k, dev)
    out_d, out_i = distance_topk_cuda(
        q.contiguous(), x.contiguous(), k_pad=k_pad, n_valid=nv, metric=metric_k
    )
    KERNEL_LAUNCHES["distance_topk"] += 1
    out_d, out_i = out_d[:, :k], out_i[:, :k]
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        out_d = torch.where(torch.isinf(out_d), out_d, out_d + qn)
    out_i = torch.where(torch.isinf(out_d), -1, out_i)
    return out_d, out_i


def distance_topk_q8_codes(q_codes, x_codes, q_scale, norms2, k: int, metric: str = "l2", *,
                           n_valid: int | None = None):
    """Stage-1 top-k over int8 codes: for each row of ``q_codes`` the ``k``
    smallest quantized scores over rows ``< n_valid`` of ``x_codes``.

    q_codes (B, D) and x_codes (N, D) int8, q_scale (B,) and norms2 (N,)
    float32, on one device; metric 'l2' (``norms2 - 2 qx``, no ||q||^2) or
    'ip' (``-qx``).  Returns (scores (B, k) ascending float32, ids (B, k)
    int32), (inf, -1) past the valid rows.  CPU tensors run
    ``ref.distance_topk_q8_blocked``; CUDA tensors launch K2.
    """
    if metric not in ("l2", "ip"):
        raise ValueError(metric)
    dev = q_codes.device
    B, D = q_codes.shape
    N = x_codes.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    if nv == 0:
        return _empty_topk(B, k, dev)
    if dev.type == "cpu":
        return ref.distance_topk_q8_blocked(q_codes, x_codes, q_scale, norms2, k, metric,
                                            n_valid=nv)
    if dev.type != "cuda":
        raise ValueError(f"distance_topk_q8: unsupported device {dev}")
    k_pad = _cuda_k_pad(k, "distance_topk_q8")
    if B == 0:
        return _empty_topk(0, k, dev)
    if D % 4:  # zero columns leave every integer dot unchanged
        q_codes = torch.nn.functional.pad(q_codes, (0, 4 - D % 4))
        x_codes = torch.nn.functional.pad(x_codes, (0, 4 - D % 4))
    out_d, out_i = distance_topk_q8_cuda(
        q_codes.contiguous(), x_codes.contiguous(), q_scale.contiguous(), norms2.contiguous(),
        k_pad=k_pad, n_valid=nv, metric=metric,
    )
    KERNEL_LAUNCHES["distance_topk_q8"] += 1
    return out_d[:, :k], out_i[:, :k]


def distance_topk_q8(q, qc, k: int, metric: str = "l2", *, n_valid: int | None = None):
    """Quantized top-k: rank the int8 corpus ``qc`` for each row of ``q``.

    ``qc`` is a ``repro_torch.quant.codec.Q8Corpus`` (or any object with
    ``codes``/``scales``/``norms2`` and optionally ``metric``; numpy arrays
    or tensors).  Returns (dists, ids) in the convention of
    :func:`distance_topk`, except distances are the QUANTIZED scores — the
    distance to the dequantized corpus point, with the query itself
    quantized for the integer contraction.  The codes decide the device;
    numpy input runs on the CPU.
    """
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(metric)
    codes = torch.as_tensor(qc.codes)
    dev = codes.device
    q = torch.as_tensor(q)
    if q.device != dev:
        raise ValueError(f"q on {q.device} but the codes on {dev}")
    q = q.to(torch.float32)
    B = q.shape[0]
    N = codes.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    if N == 0 or nv == 0:
        return _empty_topk(B, k, dev)
    if k > N:  # fewer corpus rows than requested: pad with (inf, -1)
        d, i = distance_topk_q8(q, qc, N, metric, n_valid=nv)
        return _pad_topk(d, i, k)
    qc_metric = getattr(qc, "metric", None)
    if qc_metric is not None and qc_metric != metric:
        # 'cos' codes are built from normalized rows; scoring them as 'ip'
        # (or vice versa) would silently return wrong rankings.
        raise ValueError(
            f"corpus was quantized for metric={qc_metric!r} but scoring "
            f"requested metric={metric!r}"
        )
    q_eff, metric_k = q, metric
    if metric == "cos":
        q_eff = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        metric_k = "ip"
    scales = torch.as_tensor(qc.scales).to(device=dev, dtype=torch.float32)
    norms2 = torch.as_tensor(qc.norms2).to(device=dev, dtype=torch.float32)
    q_codes, q_scale = quantize_queries_q8_t(q_eff, scales)
    out_d, out_i = distance_topk_q8_codes(q_codes, codes, q_scale, norms2, k, metric_k,
                                          n_valid=nv)
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        out_d = torch.where(torch.isinf(out_d), out_d, out_d + qn)
    out_i = torch.where(torch.isinf(out_d), -1, out_i)
    return out_d, out_i


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary, copied if need be."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _flash_forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """K3 on CUDA tensors, its plain version on CPU tensors: the output,
    and with ``with_lse`` (out, lse)."""
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, with_lse=with_lse)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    res = flash_attention_cuda(_aligned(q), _aligned(k), _aligned(v), causal=causal,
                               scale=scale, with_lse=with_lse)
    KERNEL_LAUNCHES["flash_attention"] += 1
    return res


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, scale: float | None = None):
    """The gradient of :func:`flash_attention`: (dq, dk, dv) from q, k, v
    (BH, S, D), the forward's output ``o``, the output's gradient ``do``
    and the forward's row log-sum-exp ``lse`` (BH, S) float32.  CPU tensors
    run ``ref.flash_attention_bwd_ref``; CUDA tensors launch K3-bwd (the
    dtypes and head dims of K3; anything else raises).  Inputs that are
    not contiguous or not on the 16-byte grid are copied first."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {dev}")
    grads = flash_attention_bwd_cuda(*(_aligned(t) for t in (q, k, v, o, do)), lse.contiguous(),
                                     causal=causal, scale=scale)
    KERNEL_LAUNCHES["flash_attention_bwd"] += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    """K3 with a gradient: the forward keeps its output and row
    log-sum-exp, the backward is K3-bwd (on the CPU, the two plain
    versions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=ctx.causal,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Attention forward over q, k, v (BH, S, D), one device, one dtype:
    ``softmax(scale * q k^T) v`` per row, causal or bidirectional, with all
    math in float32 and the output in q's dtype.  ``scale`` defaults to
    1/sqrt(D).  CPU tensors run ``ref.flash_attention_ref``; CUDA tensors
    launch K3 (float32 or bfloat16, D in 16/32/64/128; anything else
    raises).  Inputs that are not contiguous, or do not start on a
    16-byte boundary (the kernel copies rows in 16-byte pieces), are
    copied first.  Where autograd records (an input requires grad), the
    call is differentiable: its backward is :func:`flash_attention_bwd`."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}; expected three equal (BH, S, D)")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda" and q.numel() == 0:
        return torch.empty_like(q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale, with_lse=False)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, scale: float | None = None):
    """:func:`flash_attention` over (B, S, H, D) tensors, the layout of
    ``models/layers``: batch and heads fold into the first dimension."""
    B, S, H, D = q.shape
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(B * H, S, D)
    out = flash_attention(fold(q), fold(k), fold(v), causal=causal, scale=scale)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)

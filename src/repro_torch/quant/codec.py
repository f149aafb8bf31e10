"""Symmetric per-dimension int8 codec + numpy reference scoring.

The numpy functions follow ``repro.quant.codec`` operation for operation,
so codes, scales and norms2 are bit-identical to the JAX package's.  ``quantize_queries_q8_t``
is the torch twin of the query side, on the queries' own device.

Quantization scheme
-------------------
Each corpus dimension d gets one fp32 scale ``s[d] = max_n |x[n, d]| / 127``
and rows are stored as ``codes[n, d] = round(x[n, d] / s[d])`` in [-127, 127]
— symmetric, so the int8 dot needs no zero-point cross terms.  Per-vector
fp32 ``norms2`` (the squared norm of the DEQUANTIZED row) ride along so l2
scores can be reconstructed from a single integer dot product; for 'cos' the
rows are normalized before encoding and scoring reduces to 'ip'.

Query-side: corpus scales fold into the query (``q * s``) and the folded
query is quantized per-query symmetric, so

    <q, x_hat>  ~=  q_scale[b] * <q_codes[b], codes[n]>     (int8 x int8)

with one fp32 rescale per (query, row) — the contraction the K2 kernel
(``kernels/csrc/distance_topk_q8.cu``) runs.

Error: |x - dequantize(quantize(x))| <= s[d] / 2 per coordinate (round-to-
nearest, no clipping because s is derived from the per-dimension absmax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# scales are clamped so all-zero dimensions quantize to 0 instead of NaN
EPS_SCALE = 1e-12

# The int8 x int8 contraction is an exact integer dot: the worst case is
# d * 127 * 127, which must stay below 2^31 - 1.  Encoding refuses wider
# rows up front — a corpus that passes encode can never overflow the
# scoring accumulator, on any backend.
Q8_ACCUM_MAX_D = (2**31 - 1) // (127 * 127)  # = 133_144


def _check_accum_dim(d: int) -> None:
    if d > Q8_ACCUM_MAX_D:
        raise ValueError(
            f"d={d} exceeds Q8_ACCUM_MAX_D={Q8_ACCUM_MAX_D}: the int8 dot "
            "would overflow its int32 accumulator (d * 127^2 >= 2^31)"
        )


@dataclasses.dataclass
class Q8Corpus:
    """An int8-encoded corpus: codes + per-dim scales + per-vector norms.

    ``norms2[n] = ||codes[n] * scales||^2`` — the squared norm of the
    dequantized row, NOT of the original: l2 scores built from it are then
    exactly the distance to the dequantized point, which is what the
    candidate-generation stage ranks by.
    ``metric`` records what the codes were prepared for ('cos' rows are
    normalized before encoding; everything else stores rows as-is).
    """

    codes: np.ndarray  # (N, D) int8
    scales: np.ndarray  # (D,) fp32
    norms2: np.ndarray  # (N,) fp32
    metric: str = "l2"

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def _prep_rows(x: np.ndarray, metric: str) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if metric == "cos":
        x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return x


def quantize_q8(x: np.ndarray, metric: str = "l2") -> Q8Corpus:
    """Encode corpus rows to int8 with per-dimension symmetric scales."""
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r} — expected 'l2', 'ip' or 'cos'")
    x = _prep_rows(x, metric)
    _check_accum_dim(x.shape[1])
    if x.shape[0] == 0:
        return Q8Corpus(
            codes=np.zeros(x.shape, np.int8),
            scales=np.full((x.shape[1],), EPS_SCALE, np.float32),
            norms2=np.zeros((0,), np.float32),
            metric=metric,
        )
    # the reference's operations, with one float32 scratch array reused in
    # place (the same values: max|x| = max(max x, -min x), and an int8 code
    # times a float32 scale is the float32 product of its exact value)
    absmax = np.maximum(x.max(axis=0), -x.min(axis=0))
    scales = np.maximum(absmax / 127.0, EPS_SCALE).astype(np.float32)
    tmp = np.divide(x, scales)
    np.rint(tmp, out=tmp)
    np.clip(tmp, -127, 127, out=tmp)
    codes = tmp.astype(np.int8)
    deq = np.multiply(codes, scales, out=tmp, dtype=np.float32)
    norms2 = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
    return Q8Corpus(codes=codes, scales=scales, norms2=norms2, metric=metric)


def dequantize_q8(qc: Q8Corpus) -> np.ndarray:
    """Decode back to fp32 (the points stage-1 scoring actually ranks)."""
    return qc.codes.astype(np.float32) * qc.scales


def quantize_queries_q8(q: np.ndarray, scales: np.ndarray):
    """Fold corpus scales into queries and quantize per-query symmetric.

    Returns (q_codes (B, D) int8, q_scale (B,) fp32) such that
    ``q_scale[b] * <q_codes[b], codes[n]> ~= <q[b], dequantized x[n]>``.
    """
    q = np.asarray(q, dtype=np.float32)
    _check_accum_dim(q.shape[1])
    qf = q * np.asarray(scales, np.float32)[None, :]
    q_scale = np.maximum(np.abs(qf).max(axis=-1) / 127.0, EPS_SCALE).astype(np.float32)
    q_codes = np.clip(np.rint(qf / q_scale[:, None]), -127, 127).astype(np.int8)
    return q_codes, q_scale


def quantize_queries_q8_t(q: torch.Tensor, scales: torch.Tensor):
    """Torch twin of :func:`quantize_queries_q8` on ``q``'s device.

    The same operations in the same order — ``q * s``, absmax / 127 clamped
    at ``EPS_SCALE``, round half to even, clip, int8 — each an IEEE
    float32 operation, so the codes and scales are bit-equal to the numpy
    version's.  The divisor 127 is a tensor, not a Python scalar: CUDA
    divides by a scalar as a product with its reciprocal, which can differ
    in the last bit.  Returns (q_codes (B, D) int8, q_scale (B,) float32).
    """
    _check_accum_dim(q.shape[1])
    qf = q.to(torch.float32) * scales.to(device=q.device, dtype=torch.float32)[None, :]
    if qf.shape[0] == 0:
        return qf.to(torch.int8), qf.new_zeros((0,))
    amax = qf.abs().amax(dim=-1)
    q_scale = (amax / torch.full_like(amax, 127.0)).clamp_min(EPS_SCALE)
    q_codes = torch.round(qf / q_scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q_codes, q_scale


def q8_scores_np(q: np.ndarray, qc: Q8Corpus, metric: str = "l2"):
    """Reference stage-1 scores (B, N), lower is better.

    Int32 dots, one fp32 rescale, then the metric-specific correction.  For
    'l2' the returned value is ``||q||^2 - 2 q_scale <q_c, x_c> +
    ||x_hat||^2`` — the (true) squared distance to the dequantized point up
    to query-quantization error.
    """
    q = np.asarray(q, dtype=np.float32)
    if metric == "cos":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q_codes, q_scale = quantize_queries_q8(q, qc.scales)
    dots = q_codes.astype(np.int32) @ qc.codes.astype(np.int32).T  # exact
    qx = dots.astype(np.float32) * q_scale[:, None]
    if metric == "l2":
        qn = np.einsum("bd,bd->b", q, q)
        return qc.norms2[None, :] - 2.0 * qx + qn[:, None]
    return -qx  # ip / cos (cos is ip over pre-normalized inputs)


def distance_topk_q8_np(q: np.ndarray, qc: Q8Corpus, k: int, metric="l2"):
    """Reference top-k over the quantized scores (oracle for kernel tests)."""
    s = q8_scores_np(q, qc, metric)
    B, N = s.shape
    k_eff = min(k, N)
    idx = np.argsort(s, axis=1, kind="stable")[:, :k_eff]
    d = np.take_along_axis(s, idx, axis=1)
    if k_eff < k:
        d = np.concatenate([d, np.full((B, k - k_eff), np.inf, np.float32)], axis=1)
        idx = np.concatenate([idx, np.full((B, k - k_eff), -1, idx.dtype)], axis=1)
    return d.astype(np.float32), idx.astype(np.int32)


def q8_bytes_per_vector(qc: Q8Corpus) -> float:
    """Resident scan-corpus bytes per vector: codes + amortized scales +
    the per-vector fp32 norm correction.  The fp32 originals used by the
    exact re-rank stage are accounted separately."""
    n = max(qc.size, 1)
    return (qc.codes.nbytes + qc.scales.nbytes + qc.norms2.nbytes) / n

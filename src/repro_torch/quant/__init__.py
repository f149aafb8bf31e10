"""Quantized scan + exact re-rank subsystem (int8 codes, fp32 re-rank).

Scoring a compact int8 corpus generates candidates; a small candidate set
is then re-ranked against the exact fp32 vectors, recovering full-precision
recall at a quarter of the scanned bytes.

* ``codec``    — symmetric per-dimension int8 quantization (numpy, bit-
  identical to ``repro.quant.codec``) and the torch twin of the query side;
* ``twostage`` — the two-stage scan executor the query plan dispatches to
  (stage 1 through K2, ``kernels/ops.py::distance_topk_q8_codes``);
* ``rerank``   — the exact re-rank stage (``ExactStore`` +
  ``exact_candidate_distances``), on the host or on the device.
"""

from repro_torch.quant.codec import (
    Q8Corpus,
    dequantize_q8,
    distance_topk_q8_np,
    q8_bytes_per_vector,
    q8_scores_np,
    quantize_q8,
    quantize_queries_q8,
    quantize_queries_q8_t,
)
from repro_torch.quant.rerank import ExactStore, exact_candidate_distances

__all__ = [
    "ExactStore",
    "Q8Corpus",
    "dequantize_q8",
    "distance_topk_q8_np",
    "exact_candidate_distances",
    "q8_bytes_per_vector",
    "q8_scores_np",
    "quantize_q8",
    "quantize_queries_q8",
    "quantize_queries_q8_t",
]

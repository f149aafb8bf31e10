"""Collectives over the process groups of a named mesh
(``repro_torch.launch.mesh``), and gradient compression for them."""

from repro_torch.distributed.collectives import (
    all_gather_stacked,
    all_reduce_max,
    all_reduce_sum,
    hierarchical_grad_sync,
    ring_topk_merge,
)
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize_int8,
    error_feedback_compress,
    quantize_int8,
    topk_sparsify,
)

__all__ = ["all_gather_stacked", "all_reduce_max", "all_reduce_sum", "compressed_psum",
           "dequantize_int8", "error_feedback_compress", "hierarchical_grad_sync",
           "quantize_int8", "ring_topk_merge", "topk_sparsify"]

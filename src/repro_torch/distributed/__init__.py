"""Collectives over the process groups of a named mesh
(``repro_torch.launch.mesh``)."""

from repro_torch.distributed.collectives import (
    all_gather_stacked,
    all_reduce_sum,
    ring_topk_merge,
)

__all__ = ["all_gather_stacked", "all_reduce_sum", "ring_topk_merge"]

"""LANNS core: two-level partitioning (hash sharding + learned segmentation)
over per-partition engines (HNSW graphs or dense scans), spill routing,
perShardTopK-trimmed merging and exact brute-force ground truth."""

from repro_torch.core.brute_force import brute_force_topk
from repro_torch.core.hnsw import (
    DEFAULT_BUILD_CHUNK,
    FrozenHNSW,
    HNSWConfig,
    HNSWIndex,
    beam_search,
    beam_search_flat,
)
from repro_torch.core.lanns import LannsConfig, LannsIndex
from repro_torch.core.merge import (
    merge_topk_disjoint,
    merge_topk_disjoint_np,
    merge_topk_np,
    merge_topk_vec,
    per_shard_topk,
    two_level_merge_np,
)
from repro_torch.core.plan import QueryPlan, QueryPlanExecutor, choose_merge_path, knob_groups
from repro_torch.core.recall import recall_at_k, recall_table
from repro_torch.core.segmenter import (
    RandomSegmenter,
    SegmenterConfig,
    TreeSegmenter,
    expected_spill_fraction,
    failure_probability,
    make_segmenter,
)
from repro_torch.core.sharding import TwoLevelPartitioner, hash_shard

__all__ = [
    "DEFAULT_BUILD_CHUNK",
    "FrozenHNSW",
    "HNSWConfig",
    "HNSWIndex",
    "LannsConfig",
    "LannsIndex",
    "QueryPlan",
    "QueryPlanExecutor",
    "RandomSegmenter",
    "SegmenterConfig",
    "TreeSegmenter",
    "TwoLevelPartitioner",
    "beam_search",
    "beam_search_flat",
    "brute_force_topk",
    "choose_merge_path",
    "expected_spill_fraction",
    "failure_probability",
    "hash_shard",
    "knob_groups",
    "make_segmenter",
    "merge_topk_disjoint",
    "merge_topk_disjoint_np",
    "merge_topk_np",
    "merge_topk_vec",
    "per_shard_topk",
    "recall_at_k",
    "recall_table",
    "two_level_merge_np",
]

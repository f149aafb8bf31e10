"""LANNS level-1 partitioning: hash sharding + the two-level partitioner.

Paper §4.1: a point is hashed to ONE shard by its key, and every query goes
to every shard.  §5.1: one segmenter, learned once on a subsample, is shared
by all shards.  Assignment is host-side (the rows are host indices into the
input); routing of the points runs on the partitioner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import stable_hash_u64
from repro_torch.core.segmenter import SegmenterConfig, make_segmenter


def hash_shard(keys: np.ndarray, num_shards: int, salt: int = 0x5AAD) -> np.ndarray:
    """Deterministic shard id per key (splitmix64 % S)."""
    return (stable_hash_u64(keys, salt=salt) % np.uint64(num_shards)).astype(np.int64)


@dataclasses.dataclass
class PartitionAssignment:
    """rows[s][g] — int64 row indices of the input that land in (shard s,
    segment g).  With physical spill a row may appear in several segments of
    its shard (never in two shards)."""

    num_shards: int
    num_segments: int
    rows: list  # list[list[np.ndarray]]

    def partition_sizes(self) -> np.ndarray:
        return np.array(
            [[len(self.rows[s][g]) for g in range(self.num_segments)]
             for s in range(self.num_shards)],
            dtype=np.int64,
        )

    @property
    def total_stored(self) -> int:
        return int(self.partition_sizes().sum())


class TwoLevelPartitioner:
    """shard = hash(key) % S;  segment(s) = shared learned segmenter."""

    def __init__(
        self,
        num_shards: int,
        segmenter_config: SegmenterConfig,
        device: torch.device,
        salt: int = 0x5AAD,
    ):
        self.num_shards = num_shards
        self.segmenter_config = segmenter_config
        self.segmenter = make_segmenter(segmenter_config, device)
        self.salt = salt
        self._fitted = False

    def fit(self, data: np.ndarray) -> "TwoLevelPartitioner":
        """Learn the shared segmenter on a subsample of the full dataset."""
        self.segmenter.fit(data)
        self._fitted = True
        return self

    def assign(self, data: np.ndarray, keys: Optional[np.ndarray] = None) -> PartitionAssignment:
        if not self._fitted:
            raise RuntimeError("call fit() first (pre-learned shared segmenter)")
        n = data.shape[0]
        if keys is None:
            keys = np.arange(n, dtype=np.uint64)
        shard = hash_shard(keys, self.num_shards, self.salt)
        seg_mask = self.segmenter.route_points(data, keys)  # (n, m) bool
        m = seg_mask.shape[1]
        rows = []
        for s in range(self.num_shards):
            in_shard = shard == s
            rows.append([np.nonzero(in_shard & seg_mask[:, g])[0] for g in range(m)])
        return PartitionAssignment(self.num_shards, m, rows)

    def route_queries(self, q: torch.Tensor) -> torch.Tensor:
        """(B, m) segment mask on ``q``'s device — the same for every shard."""
        return self.segmenter.route_queries(q)

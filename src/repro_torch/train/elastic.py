"""Elastic scaling + straggler mitigation plans for a searcher fleet.

The port's own copy of ``repro.train.elastic`` (numpy only, the same
functions and the same placements for the same events).  Failures arrive
as "host h went away"; everything here is the deterministic control-plane
logic for that event, pure functions from (cluster state, manifest) to
placement / action:

* ``ShardPlacement``: shard -> host assignment as a pure function of
  (num_hosts, num_shards, generation).  LANNS shards are independent by
  construction (hash-partitioned, one index per shard), so re-placement is
  "reload shard s from the saved artifact (``LannsIndex.save`` / ``load``)
  on its new host" — no resharding of data.
* ``replan_on_failure``: drop failed hosts, rebalance with minimal movement
  (only shards that lived on dead hosts move), bump generation.
* ``escalation_plan``: mesh-size fallback — on loss of a data-parallel
  slice, shrink the data axis to the largest power of two that still fits
  and rescale the per-device batch.
* ``StragglerMonitor``: detects slow hosts from step-time EWMAs (the
  paper's Spark "time-out errors" §5.3.1 are straggler cascades) and
  emits speculative-duplicate assignments for the slowest host's shards —
  in LANNS serving a duplicated shard is always safe (same answer, first
  responder wins).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    num_hosts: int
    num_shards: int
    generation: int
    assignment: tuple  # shard -> host
    dead: tuple = ()  # hosts that have failed (cumulative)

    @classmethod
    def initial(cls, num_hosts: int, num_shards: int):
        # round-robin; deterministic
        return cls(
            num_hosts=num_hosts,
            num_shards=num_shards,
            generation=0,
            assignment=tuple(s % num_hosts for s in range(num_shards)),
        )

    def hosts_of(self, shard: int) -> int:
        return self.assignment[shard]

    def shards_of(self, host: int):
        return [s for s, h in enumerate(self.assignment) if h == host]

    def load(self) -> np.ndarray:
        counts = np.zeros(self.num_hosts, dtype=np.int64)
        for h in self.assignment:
            if h >= 0:
                counts[h] += 1
        return counts


def replan_on_failure(placement: ShardPlacement, failed_hosts) -> ShardPlacement:
    """Minimal-movement rebalance: only shards on failed hosts move, to the
    currently least-loaded surviving hosts.  Dead hosts accumulate across
    generations (a restarted host re-joins via a fresh placement epoch)."""
    failed = set(failed_hosts) | set(placement.dead)
    survivors = [h for h in range(placement.num_hosts) if h not in failed]
    if not survivors:
        raise RuntimeError("no surviving hosts")
    load = {h: 0 for h in survivors}
    for h in placement.assignment:
        if h in load:
            load[h] += 1
    new_assign = list(placement.assignment)
    for s, h in enumerate(placement.assignment):
        if h in failed:
            target = min(survivors, key=lambda x: (load[x], x))
            new_assign[s] = target
            load[target] += 1
    return ShardPlacement(
        num_hosts=placement.num_hosts,
        num_shards=placement.num_shards,
        generation=placement.generation + 1,
        assignment=tuple(new_assign),
        dead=tuple(sorted(failed)),
    )


@dataclasses.dataclass(frozen=True)
class MeshFallback:
    data: int
    model: int
    per_device_batch_scale: float


def escalation_plan(
    data_axis: int, model_axis: int, lost_devices: int
) -> Optional[MeshFallback]:
    """Shrink the data axis to the largest size whose mesh fits the surviving
    devices; model axis is preserved (TP groups must stay intact — losing one
    member kills the whole group, so lost devices round up to model-axis
    multiples)."""
    total = data_axis * model_axis
    lost_groups = -(-lost_devices // model_axis)
    surviving_groups = data_axis - lost_groups
    if surviving_groups <= 0:
        return None
    new_data = 1 << (surviving_groups.bit_length() - 1)  # floor pow2
    return MeshFallback(
        data=new_data,
        model=model_axis,
        per_device_batch_scale=data_axis / new_data,
    )


class StragglerMonitor:
    """EWMA step times per host; flags hosts slower than ratio x median."""

    def __init__(self, num_hosts: int, alpha: float = 0.2, ratio: float = 1.5,
                 min_samples: int = 5):
        self.ewma = np.zeros(num_hosts)
        self.count = np.zeros(num_hosts, dtype=np.int64)
        self.alpha = alpha
        self.ratio = ratio
        self.min_samples = min_samples

    def observe(self, host: int, step_seconds: float):
        if self.count[host] == 0:
            self.ewma[host] = step_seconds
        else:
            self.ewma[host] = (
                self.alpha * step_seconds + (1 - self.alpha) * self.ewma[host]
            )
        self.count[host] += 1

    def stragglers(self):
        ready = self.count >= self.min_samples
        if ready.sum() < 2:
            return []
        med = np.median(self.ewma[ready])
        return [
            int(h)
            for h in np.nonzero(ready & (self.ewma > self.ratio * med))[0]
        ]

    def speculative_duplicates(self, placement: ShardPlacement):
        """For each straggler, duplicate its shards onto the fastest host —
        serving-safe (idempotent reads); the broker takes the first answer."""
        stragglers = self.stragglers()
        if not stragglers:
            return {}
        ready = self.count >= self.min_samples
        fastest = int(np.argmin(np.where(ready, self.ewma, np.inf)))
        return {
            s: fastest
            for h in stragglers
            for s in placement.shards_of(h)
            if fastest != h
        }

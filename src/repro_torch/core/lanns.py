"""LannsIndex — the end-to-end LANNS platform object (paper §5), scan engine.

  1. ``fit``: learn ONE segmenter on a uniform subsample (§5.1), host numpy.
  2. ``build``: two-level partition (hash shard -> segment); each
     (shard, segment) corpus is uploaded once and stays on the device.
  3. ``query``: route, scan only the routed segments with the fused
     distance + top-k kernel, merge (§5.3.2).  A query batch is uploaded
     once; the host reads the routing mask once and the results once.

Ported: ``engine="scan"`` with ``quantized="none"`` (fp32 scan, K1) and
``quantized="q8"`` (int8 two-stage scan: K2 candidates, exact fp32
re-rank), metrics l2/ip/cos/mips, virtual and physical spill, per-request
``topk`` arrays.  Not yet ported (each raises ``NotImplementedError``
naming its ROADMAP item): the HNSW engine (and with it the q8 beam),
telemetry, the build process pool and persistence.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import Timer, resolve_device
from repro_torch.core.merge import per_shard_topk
from repro_torch.core.plan import QueryPlanExecutor, choose_merge_path, knob_groups, query_stats
from repro_torch.core.segmenter import SegmenterConfig
from repro_torch.core.sharding import TwoLevelPartitioner
from repro_torch.kernels import ops
from repro_torch.quant.codec import Q8Corpus, quantize_q8
from repro_torch.quant.twostage import QuantizedScanExecutor, _Q8Partition


@dataclasses.dataclass(frozen=True)
class LannsConfig:
    """(n, m)-partitioning in the paper's notation: n shards x m segments.

    The fields are those of ``repro.core.lanns.LannsConfig``, so
    ``LannsConfig(**dataclasses.asdict(reference_config))`` constructs one.
    metric: 'l2' | 'ip' | 'cos' | 'mips' ('mips' serves max-inner-product as
    L2 over corpus rows augmented with sqrt(M^2 - |x|^2); returned
    distances are negated inner products).
    """

    num_shards: int = 1
    num_segments: int = 8
    segmenter: str = "rh"  # 'rs' | 'rh' | 'apd'
    alpha: float = 0.15
    spill: str = "virtual"  # 'virtual' | 'physical'
    metric: str = "l2"
    engine: str = "hnsw"  # 'hnsw' | 'scan'
    hnsw_m: int = 16
    ef_construction: int = 100
    ef_search: int = 100
    topk_confidence: float = 0.95
    seed: int = 0
    segmenter_sample: int = 250_000
    quantized: str = "none"  # 'none' | 'q8'
    rerank_factor: int = 2
    rerank_store: str = "auto"  # 'auto' | 'host' | 'device'

    def segmenter_config(self) -> SegmenterConfig:
        return SegmenterConfig(
            kind=self.segmenter,
            num_segments=self.num_segments,
            alpha=self.alpha,
            spill=self.spill,
            seed=self.seed,
            sample_size=self.segmenter_sample,
        )


def _scan_metric(config: LannsConfig) -> str:
    """The metric partitions are scanned and encoded with: mips rows are
    augmented at build and served as l2."""
    return "l2" if config.metric == "mips" else config.metric


def _host_map(fn, items: list) -> list:
    """``[fn(x) for x in items]`` on host threads, one item per thread at a
    time: the partition row gathers and int8 encodes are numpy array loops,
    which release the GIL, and each result is the same as a serial call's."""
    if not items:
        return []
    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _summarize_seconds(secs: list) -> dict:
    if not secs:
        return {}
    return {
        "min": float(np.min(secs)),
        "median": float(np.median(secs)),
        "max": float(np.max(secs)),
        "total": float(np.sum(secs)),
        "count": len(secs),
    }


class _Partition:
    """A built (shard, segment) scan engine.

    fp32 (``quantized="none"``): the corpus and keys are resident on the
    device.  q8: the keys are, and ``q8`` holds the int8 encoding; the fp32
    rows stay on the host (``host_vectors``) for the exact re-rank store and
    are never uploaded for scanning.
    """

    def __init__(self, vectors, keys, config: LannsConfig, device: torch.device,
                 q8: Optional[Q8Corpus] = None):
        self.config = config
        vectors = np.asarray(vectors, np.float32)
        self.n = vectors.shape[0]
        self.keys = torch.as_tensor(np.asarray(keys, np.int64)).to(device)
        self.vectors = None
        self.host_vectors = None
        self.q8 = None
        if config.quantized == "q8":
            self.host_vectors = vectors
            if self.n > 0:
                self.q8 = q8 if q8 is not None else quantize_q8(vectors, _scan_metric(config))
        else:
            self.vectors = torch.as_tensor(vectors).to(device)

    @property
    def size(self) -> int:
        return self.n

    def search(self, queries: torch.Tensor, k: int):
        """(dists (B, k) float32, keys (B, k) int64) on the device; (inf, -1)
        past the partition's size.  fp32 partitions only: q8 partitions are
        searched by the two-stage executor."""
        B = queries.shape[0]
        dev = queries.device
        if self.size == 0:
            return (
                torch.full((B, k), float("inf"), device=dev),
                torch.full((B, k), -1, dtype=torch.int64, device=dev),
            )
        k_eff = min(k, self.size)
        d, i = ops.distance_topk(queries, self.vectors, k_eff, _scan_metric(self.config))
        i = i.to(torch.int64)
        i = torch.where(i >= 0, self.keys[i.clamp_min(0)], -1)
        if k_eff < k:
            d = torch.cat([d, torch.full((B, k - k_eff), float("inf"), device=dev)], 1)
            i = torch.cat([i, torch.full((B, k - k_eff), -1, dtype=torch.int64, device=dev)], 1)
        return d, i


class LannsIndex:
    """End-to-end LANNS index: fit -> build -> query, on ``device`` (CUDA
    unless the caller names another)."""

    def __init__(self, config: LannsConfig, device=None):
        if config.quantized not in ("none", "q8"):
            raise ValueError(f"quantized={config.quantized!r} — expected 'none' or 'q8'")
        if config.rerank_store not in ("auto", "host", "device"):
            raise ValueError(
                f"rerank_store={config.rerank_store!r} — expected 'auto', 'host' or 'device'"
            )
        if config.engine == "hnsw":
            raise NotImplementedError(
                "engine='hnsw' is not ported yet (ROADMAP 'Modules to port' item 5); "
                "use engine='scan'"
            )
        if config.engine != "scan":
            raise ValueError(f"engine={config.engine!r} — expected 'hnsw' or 'scan'")
        self.config = config
        self.device = resolve_device(device)
        self.partitioner = TwoLevelPartitioner(
            config.num_shards, config.segmenter_config(), self.device
        )
        self.partitions: dict[tuple, _Partition] = {}
        self.build_stats: dict = {}
        self._q8_exec = None  # the two-stage executor, built at first use
        self._exec = QueryPlanExecutor(self)

    def attach_telemetry(self, telemetry) -> "LannsIndex":
        raise NotImplementedError(
            "telemetry is not ported yet (ROADMAP 'Modules to port' item 8)"
        )

    def _q8_executor(self):
        """Two-stage quantized scan executor over every non-empty partition
        (codes upload once, at the first call, and stay on the device)."""
        if self._q8_exec is None:
            metric = _scan_metric(self.config)
            parts = {
                sg: _Q8Partition(p.q8, p.host_vectors, p.keys, metric, self.device)
                for sg, p in sorted(self.partitions.items())
                if p.size > 0 and p.q8 is not None
            }
            self._q8_exec = QuantizedScanExecutor(
                parts, metric, self.config.rerank_factor, self.config.rerank_store, self.device
            )
        return self._q8_exec

    # -- build ---------------------------------------------------------------

    def fit(self, data: np.ndarray) -> "LannsIndex":
        with Timer() as t:
            self.partitioner.fit(data)
        self.build_stats["segmenter_fit_seconds"] = t.seconds
        return self

    def build(self, data: np.ndarray, keys: Optional[np.ndarray] = None, *, workers: int = 0):
        """Partition ``data`` (host numpy) and upload each (shard, segment)
        corpus to the device once — for ``quantized="q8"`` its int8 codes,
        encoded here on the host.  In-process only: ``workers > 0`` raises."""
        if workers:
            raise NotImplementedError(
                "build(workers>0): the process pool is not ported yet "
                "(ROADMAP 'Modules to port' item 6, with persistence)"
            )
        cfg = self.config
        data = np.asarray(data, dtype=np.float32)
        if cfg.metric == "mips":
            # augmented-vector MIPS->L2 reduction; see LannsConfig docstring
            norms2 = np.einsum("nd,nd->n", data, data)
            self._mips_M2 = float(norms2.max())
            aug = np.sqrt(np.maximum(self._mips_M2 - norms2, 0.0))
            data = np.concatenate([data, aug[:, None]], axis=1)
        n = data.shape[0]
        if keys is None:
            keys = np.arange(n, dtype=np.int64)
        if not self.partitioner._fitted:
            self.fit(data)
        with Timer() as t_assign:
            assignment = self.partitioner.assign(data, keys)
        per_partition_seconds = {}
        sgs = [(s, g) for s in range(cfg.num_shards) for g in range(cfg.num_segments)]
        with Timer() as t_build:
            vecs = dict(zip(sgs, _host_map(lambda sg: data[assignment.rows[sg[0]][sg[1]]], sgs)))
            q8s = {}
            with Timer() as t_encode:
                if cfg.quantized == "q8":
                    todo = [sg for sg in sgs if len(vecs[sg])]
                    q8s = dict(zip(todo, _host_map(
                        lambda sg: quantize_q8(vecs[sg], _scan_metric(cfg)), todo
                    )))
            for s, g in sgs:
                rows = assignment.rows[s][g]
                t0 = time.perf_counter()
                self.partitions[(s, g)] = _Partition(
                    vecs[(s, g)], keys[rows], cfg, self.device, q8=q8s.get((s, g))
                )
                per_partition_seconds[f"{s}/{g}"] = time.perf_counter() - t0
            del vecs
            self._q8_exec = None
            if cfg.quantized == "q8":
                self._q8_executor()  # upload the codes now, not at the first query
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if cfg.quantized == "q8":
            self.build_stats["q8_encode_seconds"] = t_encode.seconds
        self.build_stats.update(
            assign_seconds=t_assign.seconds,
            build_wall_seconds=t_build.seconds,
            per_partition_seconds=per_partition_seconds,
            per_partition_seconds_summary=_summarize_seconds(list(per_partition_seconds.values())),
            partition_sizes=assignment.partition_sizes().tolist(),
            total_stored=assignment.total_stored,
            n_input=n,
            duplication_factor=assignment.total_stored / max(n, 1),
            build_workers=workers,
        )
        return self

    # -- query ---------------------------------------------------------------

    def query(self, queries, topk, *, ef=None, return_stats: bool = False):
        """Two-level partitioned search with perShardTopK (paper §5.3).

        ``topk`` is a scalar or a per-request array of shape (B,); with mixed
        ``topk`` the outputs are (B, max(topk)) and row r carries topk[r]
        results then (+inf, -1).  ``ef`` is the HNSW beam knob: the scan
        engine ignores it.  Returns host numpy (dists float32, ids int64),
        and optionally the routing stats.
        """
        cfg = self.config
        queries = np.asarray(queries, dtype=np.float32)
        if cfg.metric == "mips":
            if not hasattr(self, "_mips_M2"):
                raise RuntimeError("metric='mips' index has no stored M^2 — build() it first")
            queries = np.concatenate(
                [queries, np.zeros((queries.shape[0], 1), np.float32)], axis=1
            )
        B = queries.shape[0]
        q_dev = torch.from_numpy(queries).to(self.device)  # the batch's one upload
        scalar, groups = knob_groups(topk, None, B)
        if scalar:
            tk, _, _ = groups[0]
            return self._query_group(q_dev, tk, return_stats)
        k_max = max((tk for tk, _, _ in groups), default=0)
        out_d = np.full((B, k_max), np.inf, np.float32)
        out_i = np.full((B, k_max), -1, np.int64)
        group_stats = []
        for tk, _, rows in groups:
            res = self._query_group(
                q_dev.index_select(0, torch.from_numpy(rows).to(self.device)), tk, return_stats
            )
            if return_stats:
                d, i, st = res
                group_stats.append((tk, len(rows), st))
            else:
                d, i = res
            out_d[rows, :tk] = d
            out_i[rows, :tk] = i
        if not return_stats:
            return out_d, out_i
        return out_d, out_i, self._combine_group_stats(group_stats, B)

    def _query_group(self, queries: torch.Tensor, topk: int, return_stats: bool):
        """One homogeneous topk group through the staged executor."""
        cfg = self.config
        pstk = per_shard_topk(topk, cfg.num_shards, cfg.topk_confidence)
        if queries.shape[0] == 0:
            out_d = np.full((0, topk), np.inf, np.float32)
            out_i = np.full((0, topk), -1, np.int64)
            if return_stats:
                return out_d, out_i, query_stats(
                    pstk, np.zeros((0,), np.int64), choose_merge_path(cfg)
                )
            return out_d, out_i
        out_d, out_i, plan = self._exec.execute(queries, topk)
        out_d, out_i = out_d.cpu().numpy(), out_i.cpu().numpy()  # the results' one sync
        if return_stats:
            return out_d, out_i, query_stats(pstk, plan.segments_visited, plan.merge_path)
        return out_d, out_i

    def _combine_group_stats(self, group_stats, B):
        """Fold per-group stats into one batch-level dict (same schema)."""
        if not group_stats:
            return query_stats(
                0, np.zeros((0,), np.int64), choose_merge_path(self.config),
                knob_groups_count=0,
            )
        stats = dict(group_stats[-1][2])
        paths = {st["merge_path"] for _, _, st in group_stats}
        stats["merge_path"] = paths.pop() if len(paths) == 1 else "mixed"
        stats["knob_groups"] = len(group_stats)
        stats["per_shard_topk"] = max(st["per_shard_topk"] for _, _, st in group_stats)
        stats["mean_segments_visited"] = (
            sum(st["mean_segments_visited"] * n for _, n, st in group_stats) / max(B, 1)
        )
        stats["max_segments_visited"] = max(st["max_segments_visited"] for _, _, st in group_stats)
        return stats

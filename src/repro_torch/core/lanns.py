"""LannsIndex — the end-to-end LANNS platform object (paper §5).

  1. ``fit``: learn ONE segmenter on a uniform subsample (§5.1), host numpy.
  2. ``build``: two-level partition (hash shard -> segment), then one engine
     per (shard, segment).  'scan': the partition's corpus (or its int8
     codes) is uploaded once and stays on the device.  'hnsw' (the paper's
     engine and the default): the numpy wavefront builder, in-process or in
     a process pool (``workers``), then every partition's frozen graph is
     packed into one flat stack and uploaded once.
  3. ``query``: route, search only the routed segments — the fused distance
     + top-k kernel per partition (scan) or one batched beam over every
     (partition, routed query) lane (hnsw) — and merge (§5.3.2).  A query
     batch is uploaded once; the host reads the routing mask once and the
     results once.

  4. ``save`` / ``load`` / ``build(resume_dir=)``: the reference's artifact,
     byte for byte in layout — one ``shard{s:04d}_seg{g:04d}.npz`` per
     partition, each written atomically, plus ``manifest.json``
     (``format_version`` 2) and ``segmenter.npz`` — so an artifact written
     by either package loads in the other.  A resumed build loads the
     partitions already on disk and saves each new one as soon as it is
     built.

Ported: both engines, ``quantized="none"`` and ``"q8"`` (int8 two-stage
scan; quantized beam + exact re-rank), metrics l2/ip/cos/mips, virtual and
physical spill, per-request ``topk`` and ``ef`` arrays, ``hnsw_mode``
stacked / partition / legacy, the build process pool, persistence and
resume, ``warm_traces`` and telemetry (``attach_telemetry``).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import Timer, next_pow2, resolve_device
from repro_torch.core.hnsw import (
    DEFAULT_BUILD_CHUNK,
    FrozenHNSW,
    HNSWConfig,
    HNSWIndex,
    stack_upper_adj,
)
from repro_torch.core.merge import per_shard_topk
from repro_torch.core.plan import QueryPlanExecutor, choose_merge_path, knob_groups, query_stats
from repro_torch.core.segmenter import SegmenterConfig
from repro_torch.core.sharding import TwoLevelPartitioner
from repro_torch.kernels import _build, ops
from repro_torch.quant.codec import Q8Corpus, quantize_q8
from repro_torch.quant.rerank import ExactStore, resolve_store_mode
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

    def hnsw_config(self) -> HNSWConfig:
        return HNSWConfig(
            M=self.hnsw_m,
            ef_construction=self.ef_construction,
            ef_search=self.ef_search,
            metric="l2" if self.metric == "mips" else self.metric,
            seed=self.seed,
        )


#: flattened HNSW rows (lane offsets, adjacency entries) are int32 on the
#: device lattice: every ``pi * n_pad + row`` must stay below this
_INT32_MAX = np.iinfo(np.int32).max


def _build_one_partition(args):
    """Worker: build one (shard, segment) engine.  Top-level for pickling;
    host numpy only."""
    (s, g, vectors, keys, engine, hnsw_cfg, chunk) = args
    t0 = time.perf_counter()
    if engine == "hnsw" and len(vectors) > 0:
        idx = HNSWIndex(hnsw_cfg, vectors.shape[1])
        idx.add_batch(vectors, keys, chunk=chunk)
        frozen = idx.freeze()
        payload = {
            "kind": "hnsw",
            "vectors": frozen.vectors,
            "levels": frozen.levels,
            "adj0": frozen.adj0,
            "entry": frozen.entry,
            "keys": frozen.keys,
            "upper_adj": frozen.upper_adj,
        }
    else:
        payload = {"kind": "scan", "vectors": vectors, "keys": keys}
    return s, g, payload, time.perf_counter() - t0


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
    """Compact build-cost summary persisted in manifests in place of the
    raw per-partition timing dict (which scales with partition count)."""
    if not secs:
        return {}
    return {
        "min": float(np.min(secs)),
        "median": float(np.median(secs)),
        "max": float(np.max(secs)),
        "total": float(np.sum(secs)),
        "count": len(secs),
    }


def _merge_seconds_summary(prior: dict, cur: dict) -> dict:
    """min/max/total/count merge exactly across build runs; the merged
    median is count-weighted (raw times are deliberately not persisted)."""
    if not prior or not prior.get("count"):
        return cur
    if not cur or not cur.get("count"):
        return prior
    n0, n1 = prior["count"], cur["count"]
    return {
        "min": min(prior["min"], cur["min"]),
        "median": (prior["median"] * n0 + cur["median"] * n1) / (n0 + n1),
        "max": max(prior["max"], cur["max"]),
        "total": prior["total"] + cur["total"],
        "count": n0 + n1,
    }


class _Partition:
    """A built (shard, segment) scan engine.

    fp32 (``quantized="none"``): the corpus and keys are resident on the
    device.  q8: the keys are, and ``q8`` holds the int8 encoding; the fp32
    rows stay on the host (``host_vectors``) for the exact re-rank store and
    are never uploaded for scanning.  An HNSW index keeps its EMPTY
    partitions as scan partitions of size 0, as the reference does.
    """

    kind = "scan"

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
        return _pad_lanes(d, i, k)


def _pad_lanes(d: torch.Tensor, i: torch.Tensor, k: int):
    """Pad (B, k_eff) lane results to width k with (inf, -1)."""
    B, k_eff = d.shape
    if k_eff < k:
        d = torch.cat([d, d.new_full((B, k - k_eff), float("inf"))], 1)
        i = torch.cat([i, i.new_full((B, k - k_eff), -1)], 1)
    return d, i


class _HNSWPartition:
    """A built (shard, segment) HNSW engine.

    The frozen graph stays on the host; the device copy is the index's flat
    stack (``LannsIndex._hnsw_stack``), or, in the per-partition modes, the
    frozen graph's own cached ``device_arrays``.  For ``quantized="q8"``
    ``q8`` holds the int8 encoding of the frozen vectors (already
    metric-prepped: cos rows normalized at build, mips rows augmented), so
    it encodes as 'l2' or, for cos and ip, as 'ip'.
    """

    kind = "hnsw"

    def __init__(self, payload: dict, config: LannsConfig):
        self.config = config
        self.frozen = FrozenHNSW(
            config=config.hnsw_config(),
            vectors=np.asarray(payload["vectors"], np.float32),
            levels=np.asarray(payload["levels"]),
            adj0=np.asarray(payload["adj0"], np.int32),
            upper_adj=np.asarray(payload["upper_adj"], np.int32),
            entry=int(payload["entry"]),
            keys=None if payload.get("keys") is None else np.asarray(payload["keys"], np.int64),
        )
        self.q8 = None
        if config.quantized == "q8" and self.size > 0:
            q8_metric = "l2" if config.hnsw_config().metric == "l2" else "ip"
            if payload.get("q8_codes") is not None:
                self.q8 = Q8Corpus(codes=payload["q8_codes"], scales=payload["q8_scales"],
                                   norms2=payload["q8_norms2"], metric=q8_metric)
            else:
                self.q8 = quantize_q8(self.frozen.vectors, q8_metric)

    @property
    def size(self) -> int:
        return self.frozen.size

    def search(self, queries: torch.Tensor, k: int, ef: Optional[int] = None, *,
               n_pad: Optional[int] = None, l_pad: Optional[int] = None, legacy: bool = False):
        """(dists (B, k), keys (B, k)) on the queries' device, (inf, -1)
        padded.  ``legacy``: the graph is uploaded for this call only and
        the batch is not padded (the reference's before/after baseline);
        else the cached device arrays padded to (n_pad, l_pad)."""
        if legacy:
            d, i = self.frozen.search(queries, min(k, self.size), ef=ef, cached=False,
                                      pad_queries=False)
            return _pad_lanes(d, i, k)
        # full k even when size < k: the beam's (inf, -1) slots are the padding
        return self.frozen.search(queries, k, ef=ef, n_pad=n_pad, l_pad=l_pad)


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
        if config.engine not in ("hnsw", "scan"):
            raise ValueError(f"engine={config.engine!r} — expected 'hnsw' or 'scan'")
        self.config = config
        self.device = resolve_device(device)
        self.partitioner = TwoLevelPartitioner(
            config.num_shards, config.segmenter_config(), self.device
        )
        self.partitions: dict[tuple, object] = {}
        self.build_stats: dict = {}
        # the flat HNSW device stacks, keyed by the quantized flag
        self._stack: dict[bool, Optional[dict]] = {}
        self._q8_exec = None  # the two-stage scan executor, built at first use
        self._exec = QueryPlanExecutor(self)
        # optional obs.Telemetry bundle; None (default) = untimed serving
        self.telemetry = None

    def attach_telemetry(self, telemetry) -> "LannsIndex":
        """Attach (or, with None, detach) an ``obs.Telemetry`` bundle.

        Attached, the staged executor times its route/candidates/rerank/
        merge boundaries (CUDA events on the card, read after the batch's
        results sync, so no host sync is added; the telemetry clock on the
        CPU) into the bundle's registry and span sink, labeled by
        engine/quantized/merge_path/pow2 batch bucket.  Detached — the
        default — the executor reads no clock and records no event, so
        results are bit-identical either way.
        """
        self.telemetry = telemetry
        return self

    # -- cached device state ---------------------------------------------------

    def _invalidate_stack(self):
        self._stack = {}
        self._q8_exec = None

    def _q8_executor(self):
        """Two-stage quantized scan executor over every non-empty scan
        partition (codes upload once, at the first call, and stay on the
        device)."""
        if self._q8_exec is None:
            metric = _scan_metric(self.config)
            parts = {
                sg: _Q8Partition(p.q8, p.host_vectors, p.keys, metric, self.device)
                for sg, p in sorted(self.partitions.items())
                if p.kind == "scan" and p.size > 0 and p.q8 is not None
            }
            self._q8_exec = QuantizedScanExecutor(
                parts, metric, self.config.rerank_factor, self.config.rerank_store, self.device
            )
        return self._q8_exec

    def _hnsw_parts(self):
        """Servable HNSW partitions, sorted by (shard, segment): the one
        eligibility rule of the stacked and per-partition modes and of the
        shared pads."""
        return sorted(
            (sg, p) for sg, p in self.partitions.items() if p.kind == "hnsw" and p.size > 0
        )

    def _hnsw_stack(self, quantized: bool = False) -> dict:
        """Flat device tensors over every non-empty HNSW partition.

        Partition p owns rows [p*n_pad, p*n_pad + size) of vectors
        (P*n_pad, d), adj0 (P*n_pad, 2M) and upper_adj (l_pad, P*n_pad, M),
        so one ``beam_search_flat`` call serves any mix of (partition,
        query) lanes.  Built on the host and uploaded ONCE, then cached for
        the life of the partitions; {} when there is no HNSW partition.

        ``quantized=True``: ``vectors`` holds the int8 codes and ``norms2``
        the dequantized squared norms (no fp32 vectors are uploaded for the
        walk), with the per-partition ``scales`` (P, d) on the device and
        the exact re-rank ``stores`` (fp32 originals on the host, uploaded
        at first use in 'device' mode).
        """
        key = bool(quantized)
        if self._stack.get(key) is not None:
            return self._stack[key]
        items = self._hnsw_parts()
        if not items or (quantized and items[0][1].q8 is None):
            self._stack[key] = {}
            return self._stack[key]
        P = len(items)
        n_pad, l_pad = self._hnsw_pads(items)
        if P * n_pad > _INT32_MAX:
            raise OverflowError(
                f"flat HNSW stack spans {P * n_pad} rows (P={P} x n_pad={n_pad}) — exceeds "
                "the int32 row lattice; shard the index across hosts instead"
            )
        dim = items[0][1].frozen.vectors.shape[1]
        m0 = items[0][1].frozen.adj0.shape[1]
        M = items[0][1].frozen.upper_adj.shape[2]
        adj0 = np.full((P * n_pad, m0), -1, np.int32)
        upper = np.full((l_pad, P * n_pad, M), -1, np.int32)
        entry = np.zeros((P,), np.int64)
        keys = np.full((P * n_pad,), -1, np.int64)
        if quantized:
            vecs = np.zeros((P * n_pad, dim), np.int8)
            norms2 = np.zeros((P * n_pad,), np.float32)
            scales = np.ones((P, dim), np.float32)
        else:
            vecs = np.zeros((P * n_pad, dim), np.float32)
        for pi, (_, p) in enumerate(items):
            fr = p.frozen
            n = fr.size
            off = pi * n_pad
            if quantized:
                vecs[off: off + n] = p.q8.codes
                norms2[off: off + n] = p.q8.norms2
                scales[pi] = p.q8.scales
            else:
                vecs[off: off + n] = fr.vectors
            adj0[off: off + n] = fr.adj0
            upper[: fr.num_upper_levels, off: off + n] = fr.upper_adj
            entry[pi] = fr.entry
            keys[off: off + n] = fr.keys if fr.keys is not None else np.arange(n, dtype=np.int64)
        up = lambda a: torch.from_numpy(a).to(self.device)
        arrs = {"vectors": up(vecs), "adj0": up(adj0), "upper_adj": up(upper)}
        stack = {
            "arrs": arrs,
            "entry": entry,  # per-partition local entry node (host)
            "keys": up(keys),
            "index": {sg: pi for pi, (sg, _) in enumerate(items)},
            "n_pad": n_pad,
            "l_pad": l_pad,
        }
        if quantized:
            arrs["norms2"] = up(norms2)
            stack["scales"] = up(scales)
            stack["stores"] = [ExactStore(p.frozen.vectors, p.frozen.keys) for _, p in items]
            stack["store_mode"] = resolve_store_mode(self.config.rerank_store, self.device)
        self._stack[key] = stack
        return stack

    def _hnsw_pads(self, items=None):
        """Shared (n_pad, l_pad) corpus buckets over the servable partitions."""
        if items is None:
            items = self._hnsw_parts()
        if not items:
            return None, None
        return (
            next_pow2(max(p.size for _, p in items)),
            max(p.frozen.num_upper_levels for _, p in items),
        )

    def hnsw_resident_bytes(self) -> int:
        """Device bytes of the built HNSW stacks: vectors (or codes and
        norms2) + adj0 + upper_adj + keys (+ scales).  The exact re-rank
        store's device copy is not counted."""
        total = 0
        for stack in self._stack.values():
            if stack:
                tensors = [*stack["arrs"].values(), stack["keys"]]
                if "scales" in stack:
                    tensors.append(stack["scales"])
                total += sum(t.numel() * t.element_size() for t in tensors)
        return total

    # -- build ---------------------------------------------------------------

    def fit(self, data: np.ndarray) -> "LannsIndex":
        with Timer() as t:
            self.partitioner.fit(data)
        self.build_stats["segmenter_fit_seconds"] = t.seconds
        return self

    def build(self, data: np.ndarray, keys: Optional[np.ndarray] = None, *, workers: int = 0,
              resume_dir: Optional[str] = None, chunk: int = DEFAULT_BUILD_CHUNK):
        """Partition ``data`` (host numpy) and build every (shard, segment).

        'scan': each corpus is uploaded to the device once — for
        ``quantized="q8"`` its int8 codes, encoded here on the host.
        'hnsw': the numpy wavefront builder per partition, in-process
        (``workers=0``) or in a pool of ``workers`` processes (started with
        'spawn', so a CUDA context in this process is never forked; the
        workers run numpy only), then one upload of the flat stack.
        ``chunk`` is the wavefront batch size.  The built graphs are
        bit-identical for any ``chunk`` >= 1 and any worker count.

        ``resume_dir`` checkpoints the build: partitions already saved there
        are loaded instead of built, and each partition built now is saved
        there atomically as soon as it is built (as the pool returns it), so
        a build that dies restarts where it stopped.  ``build_stats
        ["per_partition_seconds"]`` holds the partitions built by this call
        only; the persisted summary folds in the earlier runs'.
        """
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
        sgs = [(s, g) for s in range(cfg.num_shards) for g in range(cfg.num_segments)]
        todo = []
        for s, g in sgs:
            if resume_dir and self._partition_done(resume_dir, s, g):
                self.partitions[(s, g)] = self._load_partition(resume_dir, s, g)
            else:
                todo.append((s, g))
        with Timer() as t_build:
            if cfg.engine == "hnsw":
                per_partition_seconds = self._build_hnsw(data, keys, assignment, todo, workers,
                                                         chunk, resume_dir)
            else:
                per_partition_seconds = self._build_scan(data, keys, assignment, todo,
                                                         resume_dir)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        summary = _summarize_seconds(list(per_partition_seconds.values()))
        if resume_dir:
            # resumed builds keep their build-cost provenance: fold the
            # previous runs' summary (persisted in the manifest) into this
            # run's — per-partition times themselves are not persisted.
            summary = _merge_seconds_summary(self._prior_seconds_summary(resume_dir), summary)
        self.build_stats.update(
            assign_seconds=t_assign.seconds,
            build_wall_seconds=t_build.seconds,
            per_partition_seconds=per_partition_seconds,
            per_partition_seconds_summary=summary,
            partition_sizes=assignment.partition_sizes().tolist(),
            total_stored=assignment.total_stored,
            n_input=n,
            duplication_factor=assignment.total_stored / max(n, 1),
            build_workers=workers,
            build_chunk=chunk,
        )
        return self

    def _build_hnsw(self, data, keys, assignment, sgs, workers: int, chunk: int,
                    resume_dir: Optional[str]) -> dict:
        cfg = self.config
        jobs = [(s, g, data[assignment.rows[s][g]], keys[assignment.rows[s][g]], cfg.engine,
                 cfg.hnsw_config(), chunk) for s, g in sgs]
        results = {}

        def done(res):
            s, g, payload, _ = res
            results[(s, g)] = res
            if resume_dir:
                self._save_partition(resume_dir, s, g, payload)

        if workers and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
                for fut in as_completed([pool.submit(_build_one_partition, j) for j in jobs]):
                    done(fut.result())
        else:
            for j in jobs:
                done(_build_one_partition(j))
        per_partition_seconds = {}
        for sg in sgs:
            s, g, payload, secs = results[sg]
            self.partitions[sg] = self._partition_from_payload(payload)
            per_partition_seconds[f"{s}/{g}"] = secs
        self._invalidate_stack()
        self._hnsw_stack(quantized=cfg.quantized == "q8")  # the one upload, now
        return per_partition_seconds

    def _build_scan(self, data, keys, assignment, sgs, resume_dir: Optional[str]) -> dict:
        cfg = self.config
        per_partition_seconds = {}
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
            if resume_dir:
                # the build payload, as the reference's resume saves it
                self._save_partition(resume_dir, s, g, {"kind": "scan", "vectors": vecs[(s, g)],
                                                        "keys": keys[rows]})
        del vecs
        self._invalidate_stack()
        if cfg.quantized == "q8":
            self.build_stats["q8_encode_seconds"] = t_encode.seconds
            self._q8_executor()  # upload the codes now, not at the first query
        return per_partition_seconds

    @staticmethod
    def _prior_seconds_summary(resume_dir: str) -> dict:
        manifest_path = os.path.join(resume_dir, "manifest.json")
        if not os.path.exists(manifest_path):
            return {}
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return {}
        stats = manifest.get("build_stats") or {}
        return stats.get("per_partition_seconds_summary") or {}

    # -- query ---------------------------------------------------------------

    def warm_traces(self, max_batch: int, topk: int, *, ef: Optional[int] = None,
                    knobs=None) -> "LannsIndex":
        """Take the first-use stalls off the serving path for batches up to
        ``max_batch`` (the reference's name and signature).

        There is no jit in the port.  What stalls the first live traffic
        instead is the ``nvcc`` build and ``ctypes`` load of a kernel
        library at its first use (``kernels/_build.py``), and CUDA
        caching-allocator growth for an unseen (batch bucket, topk, ef)
        shape.  So this loads every kernel library the index's path launches
        (K1 for the fp32 scan, K2 for the q8 scan; the HNSW beam launches
        none), then runs one ``query`` per pow2 batch bucket up to
        ``next_pow2(max_batch)`` for each knob pair — ``(topk, ef)`` and
        every pair of ``knobs`` (an iterable of ``(topk, ef)``, None entries
        meaning the defaults above) — and, for fp32 scan partitions, one
        direct search per (pow2 subset, partition), as the reference does.
        ``analysis.sentinels.RetraceSentinel`` checks what is left.
        """
        parts = [p for p in self.partitions.values() if p.size > 0]
        if not parts or max_batch < 1:
            return self
        cfg = self.config
        if self.device.type == "cuda" and cfg.engine == "scan":
            _build.load("distance_topk_q8.cu" if cfg.quantized == "q8" else "distance_topk.cu")
        p0 = parts[0]
        if p0.kind == "hnsw":
            dim = p0.frozen.vectors.shape[1]
        else:
            dim = (p0.host_vectors if p0.vectors is None else p0.vectors).shape[1]
        qdim = dim - 1 if cfg.metric == "mips" else dim
        rng = np.random.default_rng(0)
        # pow2 buckets up to next_pow2(max_batch): a non-pow2 max_batch's
        # own size pads to the top bucket in the reference
        b_top = next_pow2(max_batch)
        dummy = rng.standard_normal((b_top, qdim)).astype(np.float32)
        pairs = [(topk, ef)]
        for tk_k, ef_k in knobs or ():
            pair = (topk if tk_k is None else int(tk_k), ef if ef_k is None else int(ef_k))
            if pair not in pairs:
                pairs.append(pair)
        for tk_w, ef_w in pairs:
            b = 1
            while b <= b_top:
                self.query(dummy[:b], tk_w, ef=ef_w)
                b *= 2
        if cfg.engine == "scan" and cfg.quantized == "none":
            full = dummy
            if cfg.metric == "mips":
                full = np.concatenate([dummy, np.zeros((len(dummy), 1), np.float32)], axis=1)
            full = torch.from_numpy(full).to(self.device)
            for tk_w, _ in pairs:
                pstk = per_shard_topk(tk_w, cfg.num_shards, cfg.topk_confidence)
                for p in parts:
                    b = 1
                    while b <= b_top:
                        p.search(full[:b], pstk)
                        b *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def query(self, queries, topk, *, ef=None, return_stats: bool = False,
              hnsw_mode: str = "stacked"):
        """Two-level partitioned search with perShardTopK (paper §5.3).

        ``topk`` and ``ef`` are scalars or per-request arrays of shape (B,);
        ``ef`` entries <= 0 mean the index default, and the scan engine
        ignores ``ef``.  With mixed ``topk`` the outputs are (B, max(topk))
        and row r carries topk[r] results then (+inf, -1).  ``hnsw_mode``:
        'stacked' (one beam over every (partition, query) lane of the flat
        stack), 'partition' (one beam per partition on cached device arrays
        padded to shared buckets) or 'legacy' (the graph uploaded per call);
        all three give the same answers, and q8 serves only 'stacked'.
        Returns host numpy (dists float32, ids int64), and optionally the
        routing stats.
        """
        if hnsw_mode not in ("stacked", "partition", "legacy"):
            raise ValueError(
                f"hnsw_mode={hnsw_mode!r} — expected 'stacked', 'partition' or 'legacy'"
            )
        cfg = self.config
        if cfg.quantized == "q8" and cfg.engine == "hnsw" and hnsw_mode != "stacked":
            raise ValueError(
                "quantized='q8' with engine='hnsw' serves only hnsw_mode='stacked' "
                "(the flat quantized beam)"
            )
        queries = np.asarray(queries, dtype=np.float32)
        if cfg.metric == "mips":
            if not hasattr(self, "_mips_M2"):
                raise RuntimeError("metric='mips' index has no stored M^2 — build() it first")
            queries = np.concatenate(
                [queries, np.zeros((queries.shape[0], 1), np.float32)], axis=1
            )
        B = queries.shape[0]
        if cfg.engine != "hnsw":
            # ef is an HNSW beam knob: dropping it BEFORE grouping keeps a
            # batch whole instead of splitting it into identical groups
            ef = None
        q_dev = torch.from_numpy(queries).to(self.device)  # the batch's one upload
        scalar, groups = knob_groups(topk, ef, B)
        if scalar:
            tk, efv, _ = groups[0]
            return self._query_group(q_dev, tk, efv, return_stats, hnsw_mode)
        k_max = max((tk for tk, _, _ in groups), default=0)
        out_d = np.full((B, k_max), np.inf, np.float32)
        out_i = np.full((B, k_max), -1, np.int64)
        group_stats = []
        for tk, efv, rows in groups:
            res = self._query_group(
                q_dev.index_select(0, torch.from_numpy(rows).to(self.device)), tk, efv,
                return_stats, hnsw_mode,
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

    def _query_group(self, queries: torch.Tensor, topk: int, ef, return_stats: bool,
                     hnsw_mode: str):
        """One homogeneous (topk, ef) group through the staged executor."""
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
        out_d, out_i, plan = self._exec.execute(queries, topk, ef, hnsw_mode)
        out_d, out_i = out_d.cpu().numpy(), out_i.cpu().numpy()  # the results' one sync
        self._exec.report(plan)  # the stage marks, now complete (telemetry only)
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

    # -- persistence (atomic, resumable) --------------------------------------

    @staticmethod
    def _partition_path(root, s, g):
        return os.path.join(root, f"shard{s:04d}_seg{g:04d}.npz")

    def _partition_done(self, root, s, g):
        return os.path.exists(self._partition_path(root, s, g))

    def _save_partition(self, root, s, g, payload):
        """Write one partition's payload as ``.npz``, atomically: a list
        value ``key`` becomes ``key__0``, ``key__1``, ... and ``key__len``."""
        os.makedirs(root, exist_ok=True)
        path = self._partition_path(root, s, g)
        arrays = {"kind": np.array(payload["kind"])}
        for key, val in payload.items():
            if key == "kind" or val is None:
                continue
            if isinstance(val, list):
                for li, arr in enumerate(val):
                    arrays[f"{key}__{li}"] = arr
                arrays[f"{key}__len"] = np.array(len(val))
            else:
                arrays[key] = np.asarray(val)
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        os.close(fd)
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # atomic publish

    def _load_payload(self, root, s, g) -> dict:
        """One partition's saved payload, its ragged ``key__i`` lists joined
        back; a legacy HNSW artifact (ragged ``level_nodes`` / ``level_adj``,
        no ``upper_adj``) gets its (L, n, M) stack rebuilt."""
        with np.load(self._partition_path(root, s, g), allow_pickle=False) as z:
            payload = {}
            lists: dict[str, dict[int, np.ndarray]] = {}
            for key in z.files:
                if "__" in key:
                    base, idx = key.rsplit("__", 1)
                    if idx == "len":
                        payload.setdefault(base, [None] * int(z[key]))
                    else:
                        lists.setdefault(base, {})[int(idx)] = z[key]
                elif key == "kind":
                    payload["kind"] = str(z[key])
                else:
                    payload[key] = z[key]
            for base, items in lists.items():
                payload.setdefault(base, [None] * len(items))
                for idx, arr in items.items():
                    payload[base][idx] = arr
        if payload.get("kind") == "hnsw" and "upper_adj" not in payload:
            payload["upper_adj"] = stack_upper_adj(
                payload.get("level_nodes", []),
                payload.get("level_adj", []),
                payload["vectors"].shape[0],
                self.config.hnsw_config().M,
            )
        return payload

    def _partition_from_payload(self, payload: dict):
        """A partition object from a build or artifact payload.  Saved q8
        codes are used as they are; an fp32 payload under a q8 config is
        quantized here (deterministically: equal to a q8 build's codes)."""
        cfg = self.config
        if payload["kind"] == "hnsw":
            return _HNSWPartition(payload, cfg)
        vectors = np.asarray(payload["vectors"], np.float32)
        keys = payload.get("keys")
        if keys is None:
            keys = np.arange(vectors.shape[0], dtype=np.int64)
        q8 = None
        if cfg.quantized == "q8" and payload.get("q8_codes") is not None:
            q8 = Q8Corpus(codes=payload["q8_codes"], scales=payload["q8_scales"],
                          norms2=payload["q8_norms2"], metric=_scan_metric(cfg))
        return _Partition(vectors, keys, cfg, self.device, q8=q8)

    def _load_partition(self, root, s, g):
        return self._partition_from_payload(self._load_payload(root, s, g))

    @staticmethod
    def _save_payload(part) -> dict:
        """The artifact payload of a built partition.  A scan partition's
        device corpus is read back once; a q8 partition's host fp32 rows are
        its exact re-rank store and are saved as its ``vectors``."""
        if part.kind == "hnsw":
            fr = part.frozen
            payload = {"kind": "hnsw", "vectors": fr.vectors, "keys": fr.keys,
                       "levels": fr.levels, "adj0": fr.adj0, "entry": fr.entry,
                       "upper_adj": fr.upper_adj}
        else:
            vectors = part.host_vectors if part.vectors is None else part.vectors.cpu().numpy()
            payload = {"kind": "scan", "vectors": vectors, "keys": part.keys.cpu().numpy()}
        if part.q8 is not None:
            # int8 codes + per-dim scales + per-vector norm corrections; the
            # fp32 ``vectors`` above double as the exact re-rank store
            payload.update(q8_codes=part.q8.codes, q8_scales=part.q8.scales,
                           q8_norms2=part.q8.norms2)
        return payload

    def save(self, root: str):
        """Write the index under ``root``: every partition not already there
        (one ``.npz`` each, atomic), ``manifest.json`` and, for a tree
        segmenter, ``segmenter.npz``."""
        os.makedirs(root, exist_ok=True)
        for (s, g), part in self.partitions.items():
            if not self._partition_done(root, s, g):
                self._save_partition(root, s, g, self._save_payload(part))
        tree = self.partitioner.segmenter.tree_arrays()
        manifest = {
            # v2 adds the optional q8_* arrays per partition (and the
            # quantized/rerank_* config knobs); v1 artifacts load unchanged
            "format_version": 2,
            "config": dataclasses.asdict(self.config),
            "partitions": sorted([f"{s}/{g}" for s, g in self.partitions]),
            "build_stats": {
                k: v for k, v in self.build_stats.items() if k != "per_partition_seconds"
            },
            # mips needs the corpus max-norm M^2 to convert augmented-L2
            # distances back to inner products at query time
            "mips_M2": getattr(self, "_mips_M2", None),
        }
        with open(os.path.join(root, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        if tree is not None:
            np.savez(
                os.path.join(root, "segmenter.npz"),
                hyperplanes=tree["hyperplanes"], split=tree["split"],
                lo=tree["lo"], hi=tree["hi"],
            )

    @classmethod
    def load(cls, root: str, device=None) -> "LannsIndex":
        """The index saved under ``root`` (by either package), on ``device``
        (CUDA unless the caller names another).  An HNSW index ends with one
        upload of its flat stack, a q8 scan index with one of its codes, as
        ``build`` does; fp32 scan partitions upload as they load."""
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        version = int(manifest.get("format_version", 1))
        if version > 2:
            raise ValueError(
                f"artifact format_version={version} is newer than this build understands (max 2)"
            )
        config = LannsConfig(**manifest["config"])
        index = cls(config, device=device)
        if manifest.get("mips_M2") is not None:
            index._mips_M2 = float(manifest["mips_M2"])
        seg_path = os.path.join(root, "segmenter.npz")
        if os.path.exists(seg_path):
            with np.load(seg_path) as z:
                # set_tree drops the segmenter's cached device copies
                index.partitioner.segmenter.set_tree(z["hyperplanes"], z["split"], z["lo"],
                                                     z["hi"])
        index.partitioner._fitted = True
        for pstr in manifest["partitions"]:
            s, g = (int(v) for v in pstr.split("/"))
            index.partitions[(s, g)] = index._load_partition(root, s, g)
        index.build_stats = manifest.get("build_stats", {})
        index._invalidate_stack()
        if config.engine == "hnsw":
            index._hnsw_stack(quantized=config.quantized == "q8")  # the one upload
        elif config.quantized == "q8":
            index._q8_executor()  # the codes' one upload
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        return index

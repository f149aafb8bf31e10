"""Hierarchical Navigable Small World (HNSW) index — array form, torch beam.

The port of ``repro.core.hnsw``.  LANNS (§3) uses HNSW [Malkov & Yashunin
2016] as the per-partition ANN engine, in two halves that mirror the
paper's offline/online split:

* **Build** (offline, host numpy): Algorithms 1-4 of the HNSW paper as the
  reference's wavefront builder (``HNSWIndex``): flat preallocated int32
  adjacency with degree counters, level draws batched per call, the
  phase-1 greedy descent of a run of level-0 points as one vectorized walk
  against the frozen spine, and the order-dependent connect/prune phase
  sequential within the chunk.  It is the reference's code, so a frozen
  graph is bit-identical to the reference's for the same data, config and
  seed, whatever the chunk size, the ``add_batch`` splits or the worker
  count.  LANNS gets its build parallelism across partitions
  (``core/lanns.py``'s process pool).

* **Search** (online, the serving hot path): the frozen index is a set of
  fixed-shape int32 adjacency tensors on the device, and ``beam_search`` /
  ``beam_search_flat`` walk a batch of lanes at once with batched torch
  ops: a greedy walk per upper level, then a best-first beam of width
  ``ef`` at level 0 kept as dense (ids, dists, frontier flags), where each
  iteration expands every active lane's best unexpanded entry with one
  batched gather + distance block.  Lanes stop on their own (no frontier,
  or ``max_iters``) and keep their state, as the reference's vmapped
  ``while_loop`` does; the host reads the "any lane still active?" flag
  only every ``_SYNC_EVERY`` iterations.

Frozen layout
-------------
``vectors``      (n, d)  float32   — corpus (cosine-normalized if metric=cos)
``adj0``         (n, 2M) int32     — level-0 adjacency, -1 padded
``upper_adj``    (L, n, M) int32   — adjacency at levels 1..L, indexed by
                                     GLOBAL id (-1 rows for nodes absent at
                                     that level)
``entry``        int               — entry point (top-level node)

``FrozenHNSW.device_arrays`` pads ``n`` and ``L`` to caller-chosen buckets
and caches the device tensors on the index, so the graph uploads
host->device once per (n_pad, l_pad, device).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import next_pow2_quarter, pad_axis_to, pad_to, resolve_device

_INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Build/search parameters (HNSW paper notation).

    M:                max out-degree at levels >= 1 (level 0 uses 2M).
    ef_construction:  beam width during insertion.
    ef_search:        default beam width during search (>= k).
    metric:           'l2' (squared euclidean), 'ip' (inner product, maximize),
                      'cos' (cosine; vectors are L2-normalized at build/query).
    extend_candidates / keep_pruned: Algorithm 4 switches.
    """

    M: int = 16
    ef_construction: int = 100
    ef_search: int = 100
    metric: str = "l2"
    seed: int = 0
    extend_candidates: bool = False
    keep_pruned: bool = True
    max_level_cap: int = 12

    @property
    def m_l(self) -> float:
        return 1.0 / math.log(self.M)

    @property
    def m_max0(self) -> int:
        return 2 * self.M


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def pairwise_dist(metric: str, q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Distance from one query vector to rows of x.  Lower is better."""
    if metric == "l2":
        diff = x - q
        return np.einsum("nd,nd->n", diff, diff)
    # ip / cos: score = -<q, x> so "lower is better" stays uniform.
    return -(x @ q)


#: default wavefront chunk: the max number of consecutive level-0 points
#: whose phase-1 descent is batched into one vectorized walk.  Any value
#: yields the same graph (descent of a level-0 run is a pure function of the
#: frozen spine); 256 amortizes the numpy dispatch overhead without making
#: the (chunk, M, d) gather buffers large.
DEFAULT_BUILD_CHUNK = 256

#: best-first expansion batch: per beam round, up to this many candidate
#: nodes are popped together and their neighborhoods scored in one
#: vectorized block.  Deterministic (pops follow the same (dist, id) heap
#: order) and per-query local, so it never affects chunk/worker invariance;
#: it trades a few extra distance evaluations for ~B fewer numpy dispatches
#: per round, which dominates single-core build time.
_EXPAND_BATCH = 16

_MIN_CAP = 1024
_MIN_UPPER_CAP = 64


class HNSWIndex:
    """A single HNSW graph over one data partition (bulk wavefront builder).

    Storage is flat preallocated arrays with amortized-doubling growth, so
    repeated ``add_batch`` calls (the streaming-mutability precursor) are
    linear instead of re-concatenating the corpus per call:

    ``_vstack``  (cap, d) float32  corpus rows (cos rows pre-normalized)
    ``_adj0``    (cap, 2M) int32   level-0 adjacency, -1 beyond ``_deg0``
    ``_uadj[l]`` (cap_l, M) int32  level-(l+1) adjacency rows (slot-compact:
                                   only the ~n/M^(l+1) nodes present at that
                                   level own a row; ``_uslot[l]`` maps global
                                   id -> row, -1 when absent)

    Determinism contract: for a fixed config seed and insertion order, the
    built graph is bit-identical regardless of the wavefront ``chunk`` size
    and of how many process-pool workers build sibling partitions — and an
    ``add_batch(a); add_batch(b)`` sequence equals ``add_batch(a + b)``
    (level draws consume the generator stream element-wise).
    """

    def __init__(self, config: HNSWConfig, dim: int):
        self.config = config
        self.dim = dim
        self._n = 0
        self._cap = 0
        # adjacency rows carry slack beyond m_max (Vamana-style deferred
        # pruning): appends are plain writes until the row physically fills,
        # then one heuristic prune compacts it back to m_max.  freeze()
        # prunes any row still above m_max down to the frozen width.
        self._w0 = config.m_max0 + config.M
        self._wu = config.M + max(config.M // 2, 1)
        self._vstack = np.zeros((0, dim), dtype=np.float32)
        self._norms = np.zeros((0,), dtype=np.float32)
        self._levels = np.zeros((0,), dtype=np.int32)
        self._adj0 = np.zeros((0, self._w0), dtype=np.int32)
        self._deg0 = np.zeros((0,), dtype=np.int32)
        # upper levels (index ul = level - 1), slot-compact
        self._uslot: list[np.ndarray] = []  # (cap,) int32 global id -> row
        self._uadj: list[np.ndarray] = []   # (cap_l, M) int32 global ids
        self._udeg: list[np.ndarray] = []   # (cap_l,) int32
        self._ucount: list[int] = []        # rows in use per upper level
        self.entry: int = -1
        self.max_level: int = -1
        self._rng = np.random.default_rng(config.seed)
        self._frozen = None
        self._visited = np.zeros(0, dtype=np.int64)
        self._visit_gen = 0
        self.keys: Optional[np.ndarray] = None  # original (global) keys

    # ------------------------------------------------------------------
    # Storage growth (amortized doubling)
    # ------------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._n

    def _ensure_capacity(self, n_total: int) -> None:
        if n_total <= self._cap:
            return
        cap = max(self._cap * 2, n_total, _MIN_CAP)
        n = self._n

        def grown(old, shape_tail, fill, dtype):
            new = np.full((cap, *shape_tail), fill, dtype=dtype)
            new[:n] = old[:n]
            return new

        self._vstack = grown(self._vstack, (self.dim,), 0.0, np.float32)
        self._norms = grown(self._norms, (), 0.0, np.float32)
        self._levels = grown(self._levels, (), 0, np.int32)
        self._adj0 = grown(self._adj0, (self._w0,), -1, np.int32)
        self._deg0 = grown(self._deg0, (), 0, np.int32)
        # visited stamps survive growth: new rows are 0 = never visited, and
        # the generation counter is never reset.  One sentinel slot rides at
        # index `cap`: -1 adjacency padding wraps onto it under
        # ``take(mode="wrap")`` and it is pre-stamped per search, so padding
        # is dropped by the same filter as visited nodes.
        visited = np.zeros(cap + 1, dtype=np.int64)
        visited[:n] = self._visited[:n]
        self._visited = visited
        self._uslot = [grown(s, (), -1, np.int32) for s in self._uslot]
        self._cap = cap

    def _register_upper(self, i: int, lvl: int) -> None:
        """Give node ``i`` an adjacency row at every level 1..lvl (creating
        levels that did not exist yet).  Slot order == insertion order."""
        wu = self._wu
        while len(self._uadj) < lvl:
            self._uslot.append(np.full(self._cap, -1, dtype=np.int32))
            self._uadj.append(
                np.full((_MIN_UPPER_CAP, wu), -1, dtype=np.int32)
            )
            self._udeg.append(np.zeros(_MIN_UPPER_CAP, dtype=np.int32))
            self._ucount.append(0)
        for ul in range(lvl):
            row = self._ucount[ul]
            if row == self._uadj[ul].shape[0]:
                cap_l = row * 2
                new_adj = np.full((cap_l, wu), -1, dtype=np.int32)
                new_adj[:row] = self._uadj[ul]
                self._uadj[ul] = new_adj
                new_deg = np.zeros(cap_l, dtype=np.int32)
                new_deg[:row] = self._udeg[ul]
                self._udeg[ul] = new_deg
            self._uslot[ul][i] = row
            self._ucount[ul] = row + 1

    # ------------------------------------------------------------------
    # Distance / adjacency primitives (build hot path)
    # ------------------------------------------------------------------

    def _dist(self, q: np.ndarray, ids: np.ndarray, q2: float) -> np.ndarray:
        """Distances from ``q`` (with precomputed ``q2 = <q, q>``) to rows
        ``ids``.  Lower is better; 'l2' returns true squared distances."""
        vecs = self._vstack[ids]
        if self.config.metric == "l2":
            return self._norms[ids] - 2.0 * (vecs @ q) + q2
        return -(vecs @ q)

    def _q2(self, q: np.ndarray) -> float:
        return float(q @ q) if self.config.metric == "l2" else 0.0

    # ------------------------------------------------------------------
    # Phase 1: vectorized wavefront greedy descent (spine levels)
    # ------------------------------------------------------------------

    def _descend(self, Q: np.ndarray, stops: np.ndarray, upper=None):
        """Greedy descent for a whole chunk in one batched walk.

        Lane ``c`` of ``Q`` walks levels ``max_level .. stops[c]+1``, moving
        to its best-improving neighbor until a local minimum, exactly like
        the serving path's upper-level loop (``_beam_search_lanes``).  Only
        nodes with level >= 1 ("spine" nodes) own upper-level adjacency and
        only spine insertions mutate it, so for a run of level-0 points this
        is a pure function of the frozen spine graph — the batched result is
        bit-identical to descending each point alone, whatever the chunk
        size.  Scores are rank-equivalent surrogates (l2 drops the constant
        ``<q, q>`` term); callers re-score entry points exactly.

        Returns ``(ep, ep_d)``: per-lane entry node and surrogate score.
        """
        C = Q.shape[0]
        ep = np.full(C, self.entry, dtype=np.int64)
        ve = self._vstack[self.entry]
        if self.config.metric == "l2":
            ep_d = self._norms[self.entry] - 2.0 * (Q @ ve)
        else:
            ep_d = -(Q @ ve)
        for level in range(self.max_level, 0, -1):
            act = np.flatnonzero(stops < level)
            if act.size == 0:
                continue
            ul = level - 1
            if upper is None:
                slot, adj = self._uslot[ul], self._uadj[ul]
            else:  # frozen upper adjacency: global-id indexed, no slots
                slot, adj = None, upper[ul]
            while act.size:
                rows = ep[act] if slot is None else slot[ep[act]]
                nbrs = adj[rows]  # (a, M) global ids, -1 padded
                safe = np.clip(nbrs, 0, None)
                dots = np.matmul(
                    self._vstack[safe], Q[act][:, :, None]
                )[:, :, 0]
                if self.config.metric == "l2":
                    dn = self._norms[safe] - 2.0 * dots
                else:
                    dn = -dots
                dn[nbrs < 0] = np.inf
                j = np.argmin(dn, axis=1)
                ar = np.arange(act.size)
                bd = dn[ar, j]
                better = bd < ep_d[act]
                if not better.any():
                    break
                moved = act[better]
                ep[moved] = nbrs[ar[better], j[better]]
                ep_d[moved] = bd[better]
                act = moved
        return ep, ep_d

    # ------------------------------------------------------------------
    # Algorithm 2 — beam search at one level (sequential, vectorized inner)
    # ------------------------------------------------------------------

    def _search_layer(self, q, entry_points, ef, level, adj0=None):
        """Best-first beam of width ``ef``.  Returns (dists, ids) ascending.

        Same W-set semantics as the classic heapq formulation, with two
        single-core throughput changes: per round, up to ``_EXPAND_BATCH``
        heap candidates are popped together (same (dist, id) pop order) and
        their joint neighborhood is visited-filtered + scored in ONE
        vectorized block, and once the beam is full only neighbors beating
        the current worst are pushed.
        """
        visited = self._visited
        self._visit_gen += 1
        gen = self._visit_gen
        q2 = self._q2(q)
        vstack = self._vstack
        norms = self._norms
        l2 = self.config.metric == "l2"
        heappush, heappop = heapq.heappush, heapq.heappop
        heapreplace = heapq.heapreplace
        if level == 0:
            adj, slot = (self._adj0 if adj0 is None else adj0), None
        else:
            ul = level - 1
            adj, slot = self._uadj[ul], self._uslot[ul]

        eps = np.asarray(entry_points, dtype=np.int64)
        if eps.size > 1:
            eps = np.unique(eps)
        if l2:
            d0 = norms[eps] - 2.0 * (vstack[eps] @ q) + q2
        else:
            d0 = -(vstack[eps] @ q)
        visited[eps] = gen
        visited[self._cap] = gen  # sentinel: -1 padding wraps onto it
        cand = list(zip(d0.tolist(), eps.tolist()))  # min-heap by dist
        heapq.heapify(cand)
        best = [(-d, e) for d, e in cand]  # max-heap by -dist (the W set)
        heapq.heapify(best)
        while len(best) > ef:
            heappop(best)
        full = len(best) >= ef
        d_worst = -best[0][0]
        batch = np.empty(_EXPAND_BATCH, dtype=np.int64)

        while cand:
            nb = 0
            while cand and nb < _EXPAND_BATCH:
                d_c = cand[0][0]
                if d_c > d_worst and full:
                    break
                batch[nb] = heappop(cand)[1]
                nb += 1
            if nb == 0:
                break
            rows = batch[:nb]
            nbrs = (adj[rows] if slot is None else adj[slot[rows]]).ravel()
            # -1 padding wraps to the pre-stamped sentinel slot, so one
            # filter drops both padding and already-visited nodes
            nbrs = nbrs[visited.take(nbrs, mode="wrap") != gen]
            if nbrs.size == 0:
                continue
            if nb > 1:  # batch rows can share neighbors: sorted dedup
                nbrs.sort()
                if nbrs[0] != nbrs[-1]:
                    keep = np.empty(nbrs.size, dtype=bool)
                    keep[0] = True
                    np.not_equal(nbrs[1:], nbrs[:-1], out=keep[1:])
                    nbrs = nbrs[keep]
                else:
                    nbrs = nbrs[:1]
            visited[nbrs] = gen
            vecs = np.take(vstack, nbrs, axis=0)
            if l2:
                dn = vecs @ q
                dn *= -2.0
                dn += np.take(norms, nbrs)
                dn += q2
            else:
                dn = vecs @ q
                dn *= -1.0
            if full:
                # only candidates beating the current worst can enter the
                # beam; the exact per-item check below still runs.
                keep = dn < d_worst
                nbrs = nbrs[keep]
                dn = dn[keep]
                if nbrs.size == 0:
                    continue
            if dn.size > 8:
                # process ascending: d_worst tightens fastest, and once one
                # neighbor misses the beam every later one must too — the
                # loop breaks instead of heap-churning through the tail.
                # (stable sort: ids are ascending after dedup, so ties are
                # deterministic.)
                o = np.argsort(dn, kind="stable")
                dn = dn[o]
                nbrs = nbrs[o]
                srt = True
            else:
                srt = False
            for d, u in zip(dn.tolist(), nbrs.tolist()):
                if not full:
                    heappush(cand, (d, u))
                    heappush(best, (-d, u))
                    if len(best) >= ef:
                        full = True
                        d_worst = -best[0][0]
                elif d < d_worst:
                    heappush(cand, (d, u))
                    heapreplace(best, (-d, u))
                    d_worst = -best[0][0]
                elif srt:
                    break
        out = sorted((-nd, i) for nd, i in best)
        return (
            np.asarray([d for d, _ in out], dtype=np.float64),
            np.asarray([i for _, i in out], dtype=np.int64),
        )

    # ------------------------------------------------------------------
    # Algorithm 4 — heuristic neighbor selection
    # ------------------------------------------------------------------

    def _select_neighbors(self, cand_dists, cand_ids, m):
        """Distance-diversity selection (Algorithm 4).

        One greedy pass over candidates sorted ascending, with the
        min-distance-to-selected vector materialized lazily in blocks: the
        pass usually fills its ``m`` slots within the first few dozen
        candidates, so pairwise distances are computed one examination
        window at a time (a (|selected|, block) rectangle each, plus a
        one-row refresh per in-block selection) instead of the full (c, c)
        matrix — and a window that runs dry continues into the next block
        carrying its selections, never restarting from scratch.  The
        acceptance sequence is identical to the textbook exhaustive pass.
        """
        cand_ids = np.asarray(cand_ids, dtype=np.int64)
        cand_dists = np.asarray(cand_dists)
        order = np.argsort(cand_dists, kind="stable")
        ids = cand_ids[order]
        c = ids.size
        if c <= 1:
            return ids[:m]
        dists = cand_dists[order]
        cfg = self.config
        l2 = cfg.metric == "l2"
        keep = cfg.keep_pruned
        V = self._vstack[ids]  # (c, d)
        norms = self._norms[ids] if l2 else None
        dl = dists.tolist()
        blk = max(4 * m, 64)
        selected: list[int] = []  # positions into `ids`
        pruned: list[int] = []
        lo = 0
        while lo < c and len(selected) < m:
            hi = min(lo + blk, c)
            Vb = V[lo:hi]
            if selected:
                G = V[selected] @ Vb.T  # (|selected|, hi - lo)
                if l2:
                    Db = (norms[selected][:, None] - 2.0 * G
                          + norms[lo:hi][None, :])
                else:
                    Db = -G
                mts = Db.min(axis=0)
            else:
                mts = np.full(hi - lo, np.inf)
            mtsl = mts.tolist()
            for i in range(lo, hi):
                if len(selected) >= m:
                    break
                j = i - lo
                if not selected or dl[i] < mtsl[j]:
                    selected.append(i)
                    if i + 1 < hi:
                        g = Vb[j + 1:] @ V[i]
                        if l2:
                            g *= -2.0
                            g += norms[i]
                            g += norms[i + 1: hi]
                        else:
                            np.negative(g, out=g)
                        np.minimum(mts[j + 1:], g, out=mts[j + 1:])
                        mtsl = mts.tolist()
                elif keep:
                    pruned.append(i)
            lo = hi
        if keep and len(selected) < m:
            selected.extend(pruned[: m - len(selected)])
        return ids[selected]

    # ------------------------------------------------------------------
    # Connect / prune (order-dependent, sequential within a chunk)
    # ------------------------------------------------------------------

    def _set_adjacency(self, i: int, level: int, sel: np.ndarray) -> None:
        if level == 0:
            self._adj0[i, : sel.size] = sel
            self._adj0[i, sel.size:] = -1
            self._deg0[i] = sel.size
            return
        ul = level - 1
        row = self._uslot[ul][i]
        self._uadj[ul][row, : sel.size] = sel
        self._uadj[ul][row, sel.size:] = -1
        self._udeg[ul][row] = sel.size

    def _add_reverse_edge(self, s: int, i: int, level: int) -> None:
        """Append ``i`` to s's adjacency; deferred heuristic prune.

        While the slack row has headroom the append is two scalar writes.
        Only when the row physically fills (m_max + slack entries) does the
        Algorithm-4 heuristic run, compacting back to m_max — amortizing
        the prune over ~slack appends instead of re-running it per edge on
        every saturated node (the dominant cost of the per-edge policy).
        """
        if level == 0:
            adj, deg, row, m_max = (
                self._adj0, self._deg0, s, self.config.m_max0
            )
        else:
            ul = level - 1
            row = self._uslot[ul][s]
            adj, deg, m_max = self._uadj[ul], self._udeg[ul], self.config.M
        d = deg[row]
        if d < adj.shape[1]:
            adj[row, d] = i
            deg[row] = d + 1
            return
        cand = np.empty(d + 1, dtype=np.int64)
        cand[:d] = adj[row, :d]
        cand[d] = i
        qv = self._vstack[s]
        dc = self._dist(qv, cand, float(self._norms[s]))
        sel = self._select_neighbors(dc, cand, m_max)
        adj[row, : sel.size] = sel
        adj[row, sel.size:] = -1
        deg[row] = sel.size

    def _candidates(self, q, dists, ids, level):
        """ef_construction beam results, optionally extended with the
        candidates' own neighbors (Algorithm 4's extendCandidates switch;
        np.unique order — deterministic)."""
        if not self.config.extend_candidates or ids.size == 0:
            return dists, ids
        if level == 0:
            rows = self._adj0[ids]
        else:
            ul = level - 1
            rows = self._uadj[ul][self._uslot[ul][ids]]
        ext = np.unique(rows[rows >= 0])
        ext = ext[~np.isin(ext, ids)]
        if ext.size == 0:
            return dists, ids
        d_ext = self._dist(q, ext, self._q2(q))
        return (
            np.concatenate([dists, d_ext.astype(dists.dtype)]),
            np.concatenate([ids, ext]),
        )

    def _connect(self, i: int, lvl: int, ep) -> None:
        """Phase 2 for node ``i``: ef_construction search + heuristic select
        + reverse edges with prune, at levels min(max_level, lvl) .. 0."""
        cfg = self.config
        x = self._vstack[i]
        for level in range(min(self.max_level, lvl), -1, -1):
            dists, ids = self._search_layer(x, ep, cfg.ef_construction, level)
            cand_d, cand_i = self._candidates(x, dists, ids, level)
            sel = self._select_neighbors(cand_d, cand_i, cfg.M)
            self._set_adjacency(i, level, sel)
            for s in sel.tolist():
                self._add_reverse_edge(s, i, level)
            ep = ids

    # ------------------------------------------------------------------
    # Bulk insert (the wavefront build loop)
    # ------------------------------------------------------------------

    def add_batch(
        self,
        vectors: np.ndarray,
        keys: Optional[np.ndarray] = None,
        *,
        chunk: int = DEFAULT_BUILD_CHUNK,
    ):
        """Bulk-insert ``vectors`` (HNSW build is order-dependent).

        Points are consumed in wavefront chunks: a maximal run of up to
        ``chunk`` consecutive level-0 points gets its phase-1 greedy descent
        in ONE vectorized batched walk (``_descend``) against the frozen
        spine, then the order-dependent connect/prune phase runs
        sequentially point-by-point.  Spine points (level >= 1, a ~1/M
        fraction) are inserted fully sequentially since they mutate the
        upper levels the descent reads.  The built graph is bit-identical
        for any ``chunk`` >= 1 and across ``add_batch`` call splits.
        """
        cfg = self.config
        if chunk < 1:
            raise ValueError(f"chunk={chunk} — expected >= 1")
        vectors = np.asarray(vectors, dtype=np.float32)
        if cfg.metric == "cos":
            vectors = _normalize_rows(vectors)
        n_new = vectors.shape[0]
        if keys is not None:
            keys = np.asarray(keys)
            if keys.shape[0] != n_new:
                raise ValueError(
                    f"keys length {keys.shape[0]} != vectors {n_new}"
                )
            self.keys = (
                keys if self.keys is None
                else np.concatenate([self.keys, keys])
            )
        if n_new == 0:
            return self
        base = self._n
        self._ensure_capacity(base + n_new)
        self._n = base + n_new
        self._vstack[base: base + n_new] = vectors
        self._norms[base: base + n_new] = np.einsum(
            "nd,nd->n", vectors, vectors
        )
        # batched level draws: element-wise identical to per-point .random()
        # draws from the same generator state, so call-split boundaries do
        # not move the level sequence.
        u = self._rng.random(n_new)
        lvls = np.minimum(
            (-np.log(np.maximum(u, 1e-12)) * cfg.m_l).astype(np.int64),
            cfg.max_level_cap,
        ).astype(np.int32)
        self._levels[base: base + n_new] = lvls

        r = 0
        while r < n_new:
            i = base + r
            lvl = int(lvls[r])
            if self.entry < 0:
                # very first point: becomes the entry at its drawn level
                self._register_upper(i, lvl)
                self.entry = i
                self.max_level = lvl
                r += 1
                continue
            if lvl == 0:
                r_end = r + 1
                while (
                    r_end < n_new
                    and lvls[r_end] == 0
                    and r_end - r < chunk
                ):
                    r_end += 1
                eps, _ = self._descend(
                    vectors[r:r_end],
                    np.zeros(r_end - r, dtype=np.int32),
                )
                for j, ep in enumerate(eps.tolist()):
                    self._connect(base + r + j, 0, [ep])
                r = r_end
            else:
                self._register_upper(i, lvl)
                eps, _ = self._descend(
                    vectors[r: r + 1], np.asarray([lvl], dtype=np.int32)
                )
                self._connect(i, lvl, [int(eps[0])])
                if lvl > self.max_level:
                    self.max_level = lvl
                    self.entry = i
                r += 1
        self._frozen = None
        return self

    # ------------------------------------------------------------------
    # Freeze to arrays
    # ------------------------------------------------------------------

    def freeze(self) -> "FrozenHNSW":
        """Snapshot to frozen arrays; slack rows still above m_max get one
        final heuristic prune down to the frozen width.  Operates on copies
        — build state is untouched, so interleaving freeze() with further
        ``add_batch`` calls cannot perturb the graph."""
        if self._frozen is not None:
            return self._frozen
        cfg = self.config
        n = self._n
        m0 = cfg.m_max0
        M = cfg.M
        deg0 = self._deg0[:n]
        adj0 = np.full((n, m0), -1, dtype=np.int32)
        ok = np.flatnonzero(deg0 <= m0)
        adj0[ok] = self._adj0[ok, :m0]
        for s in np.flatnonzero(deg0 > m0).tolist():
            cand = self._adj0[s, : deg0[s]].astype(np.int64)
            dc = self._dist(self._vstack[s], cand, float(self._norms[s]))
            sel = self._select_neighbors(dc, cand, m0)
            adj0[s, : sel.size] = sel
        n_upper = len(self._uadj)
        upper_adj = np.full((n_upper, n, M), -1, dtype=np.int32)
        for ul in range(n_upper):
            slot = self._uslot[ul][:n]
            nodes = np.flatnonzero(slot >= 0)
            rows = slot[nodes]
            deg = self._udeg[ul][rows]
            src = self._uadj[ul][rows]
            sub = np.full((nodes.size, M), -1, dtype=np.int32)
            okm = deg <= M
            sub[okm] = src[okm, :M]
            for j in np.flatnonzero(~okm).tolist():
                s = int(nodes[j])
                cand = src[j, : deg[j]].astype(np.int64)
                dc = self._dist(self._vstack[s], cand, float(self._norms[s]))
                sel = self._select_neighbors(dc, cand, M)
                sub[j, : sel.size] = sel
            upper_adj[ul, nodes] = sub
        self._frozen = FrozenHNSW(
            config=cfg,
            vectors=self._vstack[:n].copy(),
            levels=self._levels[:n].copy(),
            adj0=adj0,
            upper_adj=upper_adj,
            entry=self.entry,
            keys=self.keys,
        )
        return self._frozen

    # convenience: numpy reference search (exact same algorithm as build
    # beam), over the FROZEN graph — the serving artifact — so its results
    # are comparable with the torch beam's modulo tie-breaks.
    def search_np(self, queries: np.ndarray, k: int, ef: Optional[int] = None):
        cfg = self.config
        ef = max(ef or cfg.ef_search, k)
        queries = np.asarray(queries, dtype=np.float32)
        if cfg.metric == "cos":
            queries = _normalize_rows(queries)
        B = len(queries)
        out_d = np.full((B, k), _INF, dtype=np.float32)
        out_i = np.full((B, k), -1, dtype=np.int64)
        if self._n == 0 or B == 0:
            return out_d, out_i
        frozen = self.freeze()
        eps, _ = self._descend(
            queries, np.zeros(B, dtype=np.int32), upper=frozen.upper_adj
        )
        for qi, q in enumerate(queries):
            dists, ids = self._search_layer(
                q, [int(eps[qi])], ef, 0, adj0=frozen.adj0
            )
            m = min(k, len(ids))
            out_d[qi, :m] = dists[:m]
            out_i[qi, :m] = ids[:m]
        if self.keys is not None:
            valid = out_i >= 0
            out_i = np.where(valid, self.keys[np.clip(out_i, 0, None)], -1)
        return out_d, out_i


def stack_upper_adj(
    level_nodes: list, level_adj: list, n: int, M: int
) -> np.ndarray:
    """Convert the legacy ragged (level_nodes, level_adj) lists to the
    stacked (L, n, M) global-id adjacency (used when loading old artifacts)."""
    L = len(level_adj)
    upper = np.full((L, n, M), -1, dtype=np.int32)
    for l in range(L):
        ids = np.asarray(level_nodes[l], dtype=np.int64)
        a = np.asarray(level_adj[l], dtype=np.int32)
        m = min(a.shape[1], M) if a.size else 0
        if len(ids):
            upper[l, ids, :m] = a[:, :m]
    return upper


@dataclasses.dataclass
class FrozenHNSW:
    """Immutable array-form HNSW: host numpy arrays, device copies on demand."""

    config: HNSWConfig
    vectors: np.ndarray
    levels: np.ndarray
    adj0: np.ndarray
    upper_adj: np.ndarray  # (L, n, M) global-id adjacency, -1 padded
    entry: int
    keys: Optional[np.ndarray] = None

    def __post_init__(self):
        self._device_cache: dict = {}

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    @property
    def num_upper_levels(self) -> int:
        return self.upper_adj.shape[0]

    def device_arrays(self, n_pad: Optional[int] = None, l_pad: Optional[int] = None, *,
                      cached: bool = True, device=None) -> dict:
        """The tensors ``beam_search`` walks, on ``device`` (CUDA unless named).

        ``n_pad``/``l_pad`` pad the corpus rows / upper-level count to shared
        bucket sizes (padding rows are -1 adjacency = unreachable, zero
        vectors = never scored; a padding level is a no-op walk).  Built and
        uploaded ONCE per (n_pad, l_pad, device) and cached on the index;
        ``cached=False`` rebuilds them per call (the ``legacy`` mode).
        """
        n = self.size
        n_pad = n if n_pad is None else n_pad
        l_pad = self.num_upper_levels if l_pad is None else l_pad
        if n_pad < n or l_pad < self.num_upper_levels:
            raise ValueError(
                f"pad ({n_pad}, {l_pad}) smaller than index ({n}, {self.num_upper_levels})"
            )
        dev = resolve_device(device)
        key = (n_pad, l_pad, str(dev))
        if cached and key in self._device_cache:
            return self._device_cache[key]
        upper = pad_axis_to(self.upper_adj, 1, n_pad, fill=-1)
        arrs = {
            "vectors": torch.from_numpy(np.ascontiguousarray(pad_to(self.vectors, n_pad))).to(dev),
            "adj0": torch.from_numpy(np.ascontiguousarray(pad_to(self.adj0, n_pad, fill=-1))).to(dev),
            "upper_adj": torch.from_numpy(np.ascontiguousarray(pad_to(upper, l_pad, fill=-1))).to(dev),
            "entry": int(self.entry),
        }
        if cached:
            self._device_cache[key] = arrs
        return arrs

    def _device_keys(self, device: torch.device) -> torch.Tensor:
        key = ("keys", str(device))
        if key not in self._device_cache:
            self._device_cache[key] = torch.from_numpy(np.asarray(self.keys, np.int64)).to(device)
        return self._device_cache[key]

    def search(self, queries, k: int, ef: Optional[int] = None, max_iters: int = 0, *,
               n_pad: Optional[int] = None, l_pad: Optional[int] = None, cached: bool = True,
               pad_queries: bool = True, device=None):
        """Batched beam search.  Returns (dists (B, k) float32, ids (B, k)
        int64 — keys when the index has them) on the device.

        ``queries`` is host numpy or a tensor; the device is ``device``, else
        the tensor's, else CUDA.  ``pad_queries=True`` pads the batch to its
        quarter-pow2 bucket with padding lanes that exit at once (the
        reference's trace bucket; the answers do not depend on it).
        """
        cfg = self.config
        ef = max(ef or cfg.ef_search, k)
        if max_iters <= 0:
            max_iters = ef + 2 * cfg.M
        if device is None and isinstance(queries, torch.Tensor):
            device = queries.device
        dev = resolve_device(device)
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        B = q.shape[0]
        if B == 0:
            return (torch.full((0, k), float("inf"), device=dev),
                    torch.full((0, k), -1, dtype=torch.int64, device=dev))
        if cfg.metric == "cos":
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        valid = None
        if pad_queries:
            B_pad = next_pow2_quarter(B)
            if B_pad != B:
                q = torch.cat([q, q.new_zeros((B_pad - B, q.shape[1]))])
                valid = torch.arange(B_pad, device=dev) < B
        arrs = self.device_arrays(n_pad, l_pad, cached=cached, device=dev)
        d, i = beam_search(arrs, q, valid, k=k, ef=ef, max_iters=max_iters,
                           metric="l2" if cfg.metric == "l2" else "ip")
        d, i = d[:B], i[:B]
        if self.keys is not None:
            i = torch.where(i >= 0, self._device_keys(dev)[i.clamp_min(0)], -1)
        return d, i


# ---------------------------------------------------------------------------
# Beam search (serving hot path): batched torch ops over lanes
# ---------------------------------------------------------------------------

#: the level-0 loop reads its "any lane still active?" flag back once every
#: this many iterations, and then drops the lanes that have stopped from the
#: batch; between reads a stopped lane is masked and keeps its state, so the
#: answers do not depend on this number.
_SYNC_EVERY = 16
#: the same for the greedy upper-level walk, where a stopped lane is a fixed
#: point (it re-reads the same neighbours and finds nothing better)
_UPPER_SYNC_EVERY = 4

#: per-process counters of the beam: calls, lanes walked, level-0
#: iterations, lanes in the batch summed over those iterations (the work
#: left after dropping stopped lanes), upper-level walk steps and host
#: reads of a stopping flag
BEAM_COUNTERS = {"calls": 0, "lanes": 0, "iterations": 0, "lane_iterations": 0,
                 "upper_steps": 0, "syncs": 0}


def reset_beam_counters() -> None:
    for name in BEAM_COUNTERS:
        BEAM_COUNTERS[name] = 0


def _make_row_dist(arrs, metric):
    """Batched distance closure: (q (t, d), rows (t, m) int64) -> (t, m)
    scores, lower is better.

    fp32 (no ``norms2`` in ``arrs``): the exact ``sum((x - q)^2)`` for 'l2'
    (true squared distances), ``-<q, x>`` otherwise.  Quantized
    (``arrs['norms2']`` present): ``vectors`` holds int8 codes and each
    lane's query arrives with its partition's per-dim scales folded in, so
    the float32 dot with the cast codes is ``<q, x_hat>``; 'l2' scores are
    ``||x_hat||^2 - 2<q, x_hat>`` (the per-query ||q||^2 constant omitted:
    the beam only compares the distances of one lane).  The dots are an
    elementwise product and a sum over d: a batched matmul of (m, d) by
    (d, 1) per lane is the slower route on the card.
    """
    vectors = arrs["vectors"]
    norms2 = arrs.get("norms2")
    if norms2 is None:
        if metric == "l2":
            def dist(q, rows):
                x = vectors[rows]
                x.sub_(q[:, None, :])
                return x.square_().sum(-1)
            return dist
        return lambda q, rows: -(vectors[rows] * q[:, None, :]).sum(-1)

    def dist_q8(q, rows):
        dots = (vectors[rows].to(torch.float32).mul_(q[:, None, :])).sum(-1)
        if metric == "l2":
            return norms2[rows] - 2.0 * dots
        return -dots

    return dist_q8


def _to_rows(nbrs: torch.Tensor, off: torch.Tensor):
    """Partition-local adjacency entries -> (flat int64 rows with -1 kept,
    the mask of real entries)."""
    ok = nbrs >= 0
    return torch.where(ok, nbrs + off[:, None], -1), ok


def _beam_search_lanes(arrs, queries, entry_rows, offsets, valid, *, k, ef, max_iters, metric):
    """The beam-search core, in flat row space, over a batch of lanes.

    Upper levels: a greedy walk per level over the (L, n, M) row-indexed
    stack, each lane moving to its best-improving neighbour until none
    improves; a padding level (all -1 rows) is a no-op.  Level 0: a
    best-first beam of width ``ef`` per lane; each iteration expands the
    lane's best unexpanded entry, drops neighbours already in the beam and
    keeps the best ``ef`` of ``ef + m0`` by a stable sort (ties keep the
    lower position, as ``lax.top_k`` does).  A lane stops when its beam has
    no unexpanded entry or after ``max_iters`` iterations, and a stopped
    lane's beam no longer changes.  Expanded-set semantics: a node evicted
    from the beam may come back and be expanded again (no visited set).

    Each lane walks rows [off, off + n_partition) of the flat tensors: the
    adjacency is partition-local and every gathered neighbour is shifted by
    the lane's offset.  An invalid (padding) lane starts with a -inf entry
    distance and an empty beam, so it stops at once.  Returns (dists (T, k)
    float32, rows (T, k) int64), ascending per lane.
    """
    adj0 = arrs["adj0"]
    upper_adj = arrs["upper_adj"]
    dev = adj0.device
    T = queries.shape[0]
    BEAM_COUNTERS["calls"] += 1
    BEAM_COUNTERS["lanes"] += T
    if T == 0:
        return (torch.full((0, k), float("inf"), device=dev),
                torch.full((0, k), -1, dtype=torch.int64, device=dev))
    row_dist = _make_row_dist(arrs, metric)
    inf = float("inf")
    q = queries.to(device=dev, dtype=torch.float32).contiguous()
    off = offsets.to(device=dev, dtype=torch.int64)
    v = valid.to(device=dev, dtype=torch.bool)
    ep = entry_rows.to(device=dev, dtype=torch.int64)

    # ---- upper levels: greedy walk to a local minimum per level
    ep_d = torch.where(v, row_dist(q, ep.clamp_min(0)[:, None])[:, 0], -inf)
    ep = torch.where(v, ep, -1)
    for l in range(upper_adj.shape[0] - 1, -1, -1):
        adj = upper_adj[l]
        step = 0
        while True:
            nbrs, ok = _to_rows(adj[ep.clamp_min(0)], off)
            nd = torch.where(ok, row_dist(q, nbrs.clamp_min(0)), inf)
            j = nd.argmin(1, keepdim=True)
            bd = nd.gather(1, j)[:, 0]
            better = bd < ep_d
            ep = torch.where(better, nbrs.gather(1, j)[:, 0], ep)
            ep_d = torch.where(better, bd, ep_d)
            step += 1
            if step % _UPPER_SYNC_EVERY == 0:
                BEAM_COUNTERS["syncs"] += 1
                if not bool(better.any()):
                    break
        BEAM_COUNTERS["upper_steps"] += step

    # ---- level 0 beam: ids, dists and the frontier flags (a real entry
    # not yet expanded), best first
    ids = torch.full((T, ef), -1, dtype=torch.int64, device=dev)
    ids[:, 0] = ep
    d = torch.full((T, ef), inf, device=dev)
    d[:, 0] = ep_d
    front = ids >= 0
    out_ids, out_d = ids.clone(), d.clone()
    lane = torch.arange(T, device=dev)  # position of each batch row among the T lanes
    it = 0
    while it < max_iters:
        active = front.any(1)
        if it % _SYNC_EVERY == 0:
            BEAM_COUNTERS["syncs"] += 1
            keep = active.nonzero()[:, 0]
            if keep.numel() < lane.numel():
                out_ids[lane], out_d[lane] = ids, d
                lane, q, off, ids, d, front, active = (
                    t[keep] for t in (lane, q, off, ids, d, front, active))
            if keep.numel() == 0:
                break
        # A stopped lane merges no neighbour: its beam is sorted, so the
        # stable merge with m0 (inf, -1) entries gives it back as it was,
        # and its pick (the first slot: no slot is a frontier) clears a
        # flag that is already clear.  So stopped lanes keep their state
        # without a masked update.
        b = torch.where(front, d, inf).argmin(1, keepdim=True)
        nbrs, ok = _to_rows(adj0[ids.gather(1, b)[:, 0].clamp_min(0)], off)
        dup = (nbrs[:, :, None] == ids[:, None, :]).any(2)
        fresh = ok & ~dup & active[:, None]  # neighbours that enter the merge
        nd = torch.where(fresh, row_dist(q, nbrs.clamp_min(0)), inf)
        all_ids = torch.cat([ids, torch.where(fresh, nbrs, -1)], 1)
        all_front = torch.cat([front.scatter(1, b, False), fresh], 1)
        d, order = torch.sort(torch.cat([d, nd], 1), dim=1, stable=True)
        d, order = d[:, :ef], order[:, :ef]
        ids = all_ids.gather(1, order)
        front = all_front.gather(1, order)
        it += 1
        BEAM_COUNTERS["lane_iterations"] += lane.numel()
    BEAM_COUNTERS["iterations"] += it
    out_ids[lane], out_d[lane] = ids, d
    # every beam is sorted ascending (each merge keeps the best ef in
    # order), so its first k entries are its top k
    return out_d[:, :k], out_ids[:, :k]


def beam_search(arrs, queries, valid=None, *, k, ef, max_iters, metric):
    """One partition, queries (B, d) -> ((B, k), (B, k)) on ``arrs``'s
    device.  ``valid`` (B,) marks real rows of a padded batch; padding rows
    exit at once instead of walking the graph."""
    dev = arrs["adj0"].device
    B = queries.shape[0]
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=dev)
    entry_rows = torch.full((B,), int(arrs["entry"]), dtype=torch.int64, device=dev)
    offsets = torch.zeros((B,), dtype=torch.int64, device=dev)
    return _beam_search_lanes(
        {k_: arrs[k_] for k_ in ("vectors", "adj0", "upper_adj")},
        queries, entry_rows, offsets, valid, k=k, ef=ef, max_iters=max_iters, metric=metric,
    )


def beam_search_flat(arrs, queries, entry_rows, offsets, valid, *, k, ef, max_iters, metric):
    """Multi-partition search over FLATTENED partition tensors.

    ``arrs`` holds every partition's rows concatenated: vectors (P*n, d),
    adj0 (P*n, 2M), upper_adj (L, P*n, M); adjacency entries stay
    partition-LOCAL.  Each lane of ``queries`` (T, d) carries its partition
    via ``offsets`` (T,) — the partition's first row — and starts at
    ``entry_rows`` (T,) (the partition's entry point, already offset), so
    one call serves any mix of (partition, query) pairs.  Returns (dists
    (T, k), rows (T, k)) with rows in flat space.

    Quantized corpora: int8 codes as ``vectors`` plus a ``norms2`` leaf, and
    each lane's query pre-folded with its partition's scales
    (``_make_row_dist``).
    """
    return _beam_search_lanes(arrs, queries, entry_rows, offsets, valid,
                              k=k, ef=ef, max_iters=max_iters, metric=metric)

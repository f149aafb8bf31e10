"""Staged query executor: route -> candidates -> merge.

The port of ``repro.core.plan``, both engines, fp32 and q8:

    route       virtual-spill segment routing on the device, the compact
                per-route slot layout and perShardTopK.  The host reads the
                (B, m) routing mask back once, to size the per-segment
                launches and the beam's lanes.
    candidates  one stage per engine x precision:
                  * fp32 scan: for each (shard, segment) partition, one
                    fused distance + top-k call (K1) over the segment's
                    routed queries;
                  * q8 scan: the two-stage executor (``quant/twostage.py``:
                    K2 candidates, exact re-rank);
                  * fp32 hnsw: ONE ``beam_search_flat`` call over every
                    (partition, routed query) lane of the flat device stack;
                  * q8 hnsw: the same beam over int8 codes (each lane's
                    query pre-folded with its partition's scales), then the
                    shared exact re-rank (``quant/rerank.py``).
                ``hnsw_mode`` 'partition' / 'legacy' run one beam per
                partition instead.  Results scatter into device candidate
                buffers (B, S, max_routes, lane_width).
    merge       the merge-path decision (``choose_merge_path``), the
                dedup-free or two-level merge on the device, the q8 ||q||^2
                add-back, then the mips augmented-L2 -> inner-product
                conversion.

Stage timing (``LannsIndex.attach_telemetry``): a ``StageTimer`` marks the
stage boundaries and each exact re-rank.  On the card a host clock at a
boundary would measure dispatch, not work, so each mark is a CUDA event
recorded on the index's stream, read after the batch's one results sync;
on the CPU a mark is a read of the telemetry clock.  Detached, the executor
makes no mark at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hnsw import beam_search_flat
from repro_torch.core.merge import merge_topk_disjoint, merge_topk_vec, per_shard_topk
from repro_torch.quant.rerank import exact_candidate_distances

# Scale-safety contract for the beam-lane assembly (checked statically by
# repro_torch.analysis.scalecheck at these bounds): up to 4096 partitions
# of up to 2^25 pow2-padded rows each, 2048-d vectors, <=16k routed lanes
# per batch, per-request topk <= 200.
# lanns: dims[n_pad<=33_554_432, pi<=4095, T<=16_384, dim<=2048, pstk<=200]
#: the flat HNSW row lattice (lane offsets, adjacency entries) is int32 on
#: the device: every flattened row must stay below this
_INT32_MAX = np.iinfo(np.int32).max


def knob_groups(topk, ef, B: int):
    """Normalize (topk, ef) — scalars or per-request arrays — into groups.

    Returns ``(scalar, groups)``: ``scalar`` True with ``[(topk, ef, None)]``
    when the whole batch shares one knob pair (all-equal arrays collapse
    here); else ``[(topk, ef, rows)]`` sorted by ``(topk, ef)`` with
    ``rows`` ascending.  ``ef`` entries <= 0 (or None) mean "index
    default"; ``topk`` entries must be >= 1.
    """
    topk_arr = np.asarray(topk)
    ef_arr = None if ef is None else np.asarray(ef)
    mixed = topk_arr.ndim > 0 or (ef_arr is not None and ef_arr.ndim > 0)
    if not mixed:
        tk = int(topk_arr)
        if tk < 1:
            raise ValueError(f"topk={tk} must be >= 1")
        efv = None if ef is None else int(ef_arr)
        if efv is not None and efv <= 0:
            efv = None
        return True, [(tk, efv, None)]
    tks = (
        np.broadcast_to(topk_arr, (B,)).astype(np.int64)
        if topk_arr.ndim == 0
        else topk_arr.astype(np.int64)
    )
    if tks.shape != (B,):
        raise ValueError(f"per-request topk has shape {tks.shape} — expected ({B},)")
    if B and tks.min() < 1:
        raise ValueError("per-request topk entries must be >= 1")
    if ef_arr is None:
        efs = np.zeros((B,), np.int64)
    else:
        if ef_arr.ndim > 0 and ef_arr.shape != (B,):
            raise ValueError(f"per-request ef has shape {ef_arr.shape} — expected ({B},)")
        efs = np.maximum(np.broadcast_to(ef_arr, (B,)).astype(np.int64), 0)
    groups = []
    for tk, efv in sorted({(int(t), int(e)) for t, e in zip(tks, efs)}):
        rows = np.nonzero((tks == tk) & (efs == efv))[0]
        groups.append((tk, efv if efv > 0 else None, rows))
    if len(groups) == 1:
        tk, efv, _ = groups[0]
        return True, [(tk, efv, None)]
    return False, groups


def choose_merge_path(config, handled=None, partitions=None) -> str:
    """'disjoint' (dedup-free top-k) vs 'two_level' (dedup merge).

    Virtual spill stores each point in exactly ONE (shard, segment), so scan
    candidates are disjoint across lanes and need no dedup; physical spill
    duplicates ids across segments, and the HNSW engine keeps the two-level
    merge.  A q8 scan batch takes 'disjoint' only when the two-stage
    executor handled EVERY non-empty partition (its lanes are
    candidate-wide); pass ``handled``/``partitions`` to apply that rule.
    """
    if config.engine != "scan" or config.spill != "virtual":
        return "two_level"
    if config.quantized == "q8" and handled is not None and partitions is not None:
        nonempty = {sg for sg, p in partitions.items() if p.size > 0}
        if not handled >= nonempty:
            return "two_level"
    return "disjoint"


def query_stats(pstk, segments_visited, merge_path="two_level", knob_groups_count=1):
    """Routing stats — the schema of ``repro.core.plan.query_stats``.  The
    four ``*_traces`` keys count jit traces there; eager PyTorch keeps no
    trace cache, so they report -1 (unavailable)."""
    empty = segments_visited.size == 0
    return {
        "per_shard_topk": pstk,
        "merge_path": merge_path,
        "knob_groups": knob_groups_count,
        "mean_segments_visited": 0.0 if empty else float(segments_visited.mean()),
        "max_segments_visited": 0 if empty else int(segments_visited.max()),
        "beam_traces": -1,
        "beam_traces_flat": -1,
        "scan_traces": -1,
        "scan_traces_q8": -1,
    }


class StageTimer:
    """Marks at the executor's stage boundaries, read after the results
    sync: CUDA events on ``device``'s current stream, or reads of ``clock``
    on the CPU.  ``bounds`` holds the four stage boundaries, ``rerank`` the
    (start, end) pair of every exact re-rank inside the candidates stage."""

    def __init__(self, device: torch.device, telemetry):
        self.cuda = device.type == "cuda"
        self.device = device
        self.telemetry = telemetry
        self.bounds: list = []
        self.rerank: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return self.telemetry.clock()

    def seconds(self, a, b) -> float:
        """Seconds from mark ``a`` to mark ``b``; on the card both events
        must have completed (the caller has synced the results)."""
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def stage_seconds(self) -> dict:
        """{route, candidates, rerank, merge} seconds; the re-rank's share is
        taken out of the candidates stage."""
        m0, m1, m2, m3 = self.bounds
        rr = sum(self.seconds(a, b) for a, b in self.rerank)
        return {
            "route": self.seconds(m0, m1),
            "candidates": max(self.seconds(m1, m2) - rr, 0.0),
            "rerank": rr,
            "merge": self.seconds(m2, m3),
        }


@dataclasses.dataclass
class QueryPlan:
    """Routing result + the batch's (topk, ef) flowing through the stages."""

    queries: torch.Tensor  # (B, d) fp32 on the device, mips-augmented
    topk: int
    pstk: int
    lane_width: int  # candidate slots per (query, shard, route) lane
    slot: torch.Tensor  # (B, m) position of segment among the query's routes
    sels: list  # per-segment routed query rows (device int64)
    segments_visited: np.ndarray  # (B,) host
    max_routes: int
    cand_d: torch.Tensor  # (B, S, max_routes, lane_width)
    cand_i: torch.Tensor
    handled: set = dataclasses.field(default_factory=set)
    merge_path: str = ""
    ef: Optional[int] = None  # the HNSW beam width (None: the index default)
    hnsw_mode: str = "stacked"
    # set only while telemetry is attached: the stage marks, then (after the
    # results sync, ``QueryPlanExecutor.report``) the per-stage seconds
    timer: Optional[StageTimer] = None
    stage_s: Optional[dict] = None


class QueryPlanExecutor:
    """Runs ``QueryPlan``s against one ``LannsIndex``'s partitions."""

    def __init__(self, index):
        self.index = index

    def plan(self, queries: torch.Tensor, topk: int, ef: Optional[int] = None,
             hnsw_mode: str = "stacked") -> QueryPlan:
        """Route the batch and lay out the compact candidate slots."""
        index = self.index
        cfg = index.config
        dev = queries.device
        B = queries.shape[0]
        S = cfg.num_shards
        pstk = per_shard_topk(topk, S, cfg.topk_confidence)
        seg_mask = index.partitioner.route_queries(queries)  # (B, m)
        mask_h = seg_mask.cpu().numpy()  # lanns: noqa[LANNS003] -- the plan's one designed host read of the (B, m) routing mask: it sizes the per-segment launches and the beam's lanes
        segments_visited = mask_h.sum(axis=1)
        slot = torch.cumsum(seg_mask.to(torch.int64), dim=1) - 1
        max_routes = max(int(segments_visited.max()), 1)
        # q8 scan lanes stay candidate-wide (rerank_factor * pstk exactly
        # scored rows each) so the dedup-free merge sees every candidate;
        # all other lanes are trimmed to pstk.
        lane_w = pstk
        if cfg.quantized == "q8" and cfg.engine == "scan" and cfg.spill == "virtual":
            lane_w = min(
                cfg.rerank_factor * pstk,
                max((p.size for p in index.partitions.values()), default=pstk),
            )
            lane_w = max(lane_w, pstk)
        cand_d = torch.full((B, S, max_routes, lane_w), float("inf"), device=dev)
        cand_i = torch.full((B, S, max_routes, lane_w), -1, dtype=torch.int64, device=dev)
        sels = [
            torch.from_numpy(np.nonzero(mask_h[:, g])[0]).to(dev)
            for g in range(cfg.num_segments)
        ]
        return QueryPlan(
            queries=queries, topk=topk, pstk=pstk, lane_width=lane_w, slot=slot, sels=sels,
            segments_visited=segments_visited, max_routes=max_routes,
            cand_d=cand_d, cand_i=cand_i, ef=ef, hnsw_mode=hnsw_mode,
        )

    def candidates(self, plan: QueryPlan) -> QueryPlan:
        """Fill the plan's candidate slots; every partition exactly once."""
        index = self.index
        cfg = index.config
        if plan.hnsw_mode == "stacked":
            if cfg.quantized == "q8":
                plan.handled |= self._candidates_hnsw_q8(plan)
            else:
                plan.handled |= self._candidates_hnsw_fp32(plan)
        if cfg.quantized == "q8" and cfg.engine == "scan":
            plan.handled |= index._q8_executor().run(
                plan.queries, plan.sels, plan.slot, plan.cand_d, plan.cand_i, plan.pstk,
                lane_width=plan.lane_width, timer=plan.timer,
            )
        n_pad = l_pad = None
        if plan.hnsw_mode == "partition":
            n_pad, l_pad = index._hnsw_pads()
        for g in range(cfg.num_segments):
            sel = plan.sels[g]
            if sel.numel() == 0:
                continue
            q_sel = plan.queries.index_select(0, sel)
            sl = plan.slot[sel, g]
            for s in range(cfg.num_shards):
                if (s, g) in plan.handled:
                    continue
                part = index.partitions.get((s, g))
                if part is None or part.size == 0:
                    continue
                # the SHARD-level perShardTopK propagates to the segments
                # (never a per-segment trim) — §5.3.2.
                if part.kind == "hnsw":
                    d, i = part.search(q_sel, plan.pstk, ef=plan.ef, n_pad=n_pad, l_pad=l_pad,
                                       legacy=plan.hnsw_mode == "legacy")
                else:
                    d, i = part.search(q_sel, plan.pstk)
                plan.cand_d[:, s][sel, sl] = d
                plan.cand_i[:, s][sel, sl] = i
        return plan

    def _assemble_beam_lanes(self, plan: QueryPlan, stack: dict, q_eff: torch.Tensor,
                             scales=None):
        """The (partition, routed query) lanes of a flat beam.

        Partition (s, g) searches the routed subset of segment g (the same
        in every shard); lanes are laid out in (shard, segment) order.
        ``scales`` (P, d), when given, folds each partition's per-dim
        quantization scales into its lanes' queries (the q8 beam).  The
        reference pads the lanes to a quarter-pow2 bucket for its jit
        traces; eager lanes are independent, so the port does not pad.
        Returns ``(blocks, handled, Q, OFF, EP, V, T)`` with blocks
        ``(s, g, pi, lane_start, count)``; Q/OFF/EP/V are None when no lane
        routed (T == 0).
        """
        n_pad = stack["n_pad"]
        blocks = []
        q_blocks, off_blocks, ep_blocks = [], [], []
        T = 0
        for (s, g), pi in sorted(stack["index"].items()):
            sel = plan.sels[g]
            cnt = sel.numel()
            if cnt == 0:
                continue
            blocks.append((s, g, pi, T, cnt))
            q_blk = q_eff.index_select(0, sel)
            if scales is not None:
                q_blk = q_blk * scales[pi][None, :]
            q_blocks.append(q_blk)
            off = pi * n_pad
            if off + n_pad > _INT32_MAX:
                raise OverflowError(
                    f"beam lane offset {off} + n_pad {n_pad} exceeds the int32 flat row "
                    "lattice — shard the index"
                )
            off_blocks.append(np.full(cnt, off, np.int64))
            ep_blocks.append(np.full(cnt, stack["entry"][pi] + off, np.int64))
            T += cnt
        handled = set(stack["index"])
        if T == 0:
            return blocks, handled, None, None, None, None, 0
        dev = q_eff.device
        Q = torch.cat(q_blocks)
        OFF = torch.from_numpy(np.concatenate(off_blocks)).to(dev)
        EP = torch.from_numpy(np.concatenate(ep_blocks)).to(dev)
        V = torch.ones((T,), dtype=torch.bool, device=dev)
        return blocks, handled, Q, OFF, EP, V, T

    @staticmethod
    def _cos_normalize(q_eff: torch.Tensor, hcfg) -> torch.Tensor:
        if hcfg.metric != "cos":
            return q_eff
        return q_eff / q_eff.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    def _candidates_hnsw_fp32(self, plan: QueryPlan) -> set:
        """One ``beam_search_flat`` call covering every HNSW partition;
        results scatter into the plan's per-route candidate slots.  Returns
        the set of (shard, segment) partitions served."""
        index = self.index
        stack = index._hnsw_stack()
        if not stack:
            return set()
        hcfg = index.config.hnsw_config()
        pstk = plan.pstk
        q_eff = self._cos_normalize(plan.queries, hcfg)
        blocks, handled, Q, OFF, EP, V, T = self._assemble_beam_lanes(plan, stack, q_eff)
        if T == 0:
            return handled
        ef_eff = max(plan.ef or hcfg.ef_search, pstk)
        d_all, i_all = beam_search_flat(
            stack["arrs"], Q, EP, OFF, V, k=pstk, ef=ef_eff, max_iters=ef_eff + 2 * hcfg.M,
            metric="l2" if hcfg.metric == "l2" else "ip",
        )
        i_all = torch.where(i_all >= 0, stack["keys"][i_all.clamp_min(0)], -1)
        for (s, g, _pi, start, cnt) in blocks:
            sel = plan.sels[g]
            sl = plan.slot[sel, g]
            plan.cand_d[:, s][sel, sl] = d_all[start: start + cnt]
            plan.cand_i[:, s][sel, sl] = i_all[start: start + cnt]
        return handled

    def _candidates_hnsw_q8(self, plan: QueryPlan) -> set:
        """Quantized HNSW beam + shared exact re-rank.

        The same flat beam as the fp32 stage, over the int8-code stack: each
        lane's query is pre-folded with its partition's per-dim scales, so
        every in-walk distance is a dot against the dequantized row at a
        quarter of the gather bytes.  The beam returns ``C = min(
        rerank_factor * pstk, ef)`` candidates per lane by quantized
        distance; the exact re-rank re-scores them against the fp32
        originals and the best ``pstk`` (by a stable sort) land in the plan
        slots, so the merged distances carry no quantization error.
        """
        index = self.index
        stack = index._hnsw_stack(quantized=True)
        if not stack:
            return set()
        cfg = index.config
        hcfg = cfg.hnsw_config()
        pstk = plan.pstk
        # the walk and the re-rank both use the beam's metric: 'cos' rows
        # were normalized at build, so their exact scores reduce to 'ip'
        rmetric = "l2" if hcfg.metric == "l2" else "ip"
        q_eff = self._cos_normalize(plan.queries, hcfg)
        n_pad = stack["n_pad"]
        ef_eff = max(plan.ef or hcfg.ef_search, pstk)
        C = max(min(cfg.rerank_factor * pstk, ef_eff), pstk)
        blocks, handled, Q, OFF, EP, V, T = self._assemble_beam_lanes(
            plan, stack, q_eff, scales=stack["scales"]
        )
        if T == 0:
            return handled
        _, i_all = beam_search_flat(
            stack["arrs"], Q, EP, OFF, V, k=C, ef=ef_eff, max_iters=ef_eff + 2 * hcfg.M,
            metric=rmetric,
        )
        timer = plan.timer
        kk = min(pstk, C)
        for (s, g, pi, start, cnt) in blocks:
            sel = plan.sels[g]
            store = stack["stores"][pi]
            rows = i_all[start: start + cnt]  # (b, C) flat rows, -1 padded
            invalid = rows < 0
            cand = (rows - pi * n_pad).clamp(0, store.size - 1)
            t_rr = None if timer is None else timer.mark()
            ex = exact_candidate_distances(q_eff.index_select(0, sel), cand, store, rmetric,
                                           mode=stack["store_mode"])
            if t_rr is not None:
                timer.rerank.append((t_rr, timer.mark()))
            ex = torch.where(invalid, float("inf"), ex)  # lanns: noqa[LANNS004] -- one exact re-rank per partition store (P iterations, not per query); the reference loops over the partitions the same way
            if kk < C:
                order = torch.sort(ex, dim=1, stable=True).indices[:, :kk]  # lanns: noqa[LANNS004] -- one exact re-rank per partition store (P iterations, not per query); the reference loops over the partitions the same way
                d_lane, cand_sel = ex.gather(1, order), cand.gather(1, order)
            else:
                d_lane, cand_sel = ex, cand
            i_lane = torch.where(torch.isinf(d_lane), -1, stack["keys"][cand_sel + pi * n_pad])  # lanns: noqa[LANNS004] -- one exact re-rank per partition store (P iterations, not per query); the reference loops over the partitions the same way
            sl = plan.slot[sel, g]
            plan.cand_d[sel, s, sl, :kk] = d_lane
            plan.cand_i[sel, s, sl, :kk] = i_lane
        return handled

    def merge(self, plan: QueryPlan):
        """Dedup-free or two-level merge + the mips conversion."""
        index = self.index
        cfg = index.config
        B = plan.queries.shape[0]
        S = cfg.num_shards
        plan.merge_path = choose_merge_path(cfg, plan.handled, index.partitions)
        if plan.merge_path == "disjoint":
            out_d, out_i = merge_topk_disjoint(
                plan.cand_d.reshape(B, -1), plan.cand_i.reshape(B, -1), plan.topk
            )
        else:
            # level 1: segment merge inside each shard; level 2: broker
            shard_d, shard_i = merge_topk_vec(
                plan.cand_d.reshape(B * S, -1), plan.cand_i.reshape(B * S, -1), plan.pstk
            )
            out_d, out_i = merge_topk_vec(
                shard_d.reshape(B, S * plan.pstk), shard_i.reshape(B, S * plan.pstk),
                plan.topk,
            )
        if cfg.quantized == "q8" and cfg.metric in ("l2", "mips"):
            # q8 lane distances omit the per-query ||q||^2 constant (it
            # cannot change any within-query ordering); restore true squared
            # distances with one (B, topk) add.
            qn8 = (plan.queries * plan.queries).sum(-1)
            out_d = torch.where(torch.isfinite(out_d), out_d + qn8[:, None], out_d)
        if cfg.metric == "mips":
            # augmented-L2 back to negated inner products:
            #   d^2 = M^2 + |q|^2 - 2<q, x>  =>  -<q, x> = (d^2 - M^2 - |q|^2) / 2
            q_raw = plan.queries[:, :-1]
            qn = (q_raw * q_raw).sum(-1)
            out_d = torch.where(
                torch.isfinite(out_d),
                (out_d - index._mips_M2 - qn[:, None]) / 2.0,
                float("inf"),
            )
        return out_d, out_i

    # lanns: hotpath
    def execute(self, queries: torch.Tensor, topk: int, ef: Optional[int] = None,
                hnsw_mode: str = "stacked"):
        """route -> candidates -> merge for ONE (topk, ef) group; device
        outputs.

        With ``index.telemetry`` attached the plan carries a ``StageTimer``
        with the stage marks; the caller syncs the results, then calls
        ``report(plan)``.  Detached, no mark is made."""
        tel = self.index.telemetry
        if tel is None:
            plan = self.plan(queries, topk, ef, hnsw_mode)
            self.candidates(plan)
            out_d, out_i = self.merge(plan)
            return out_d, out_i, plan
        timer = StageTimer(queries.device, tel)
        m0 = timer.mark()
        plan = self.plan(queries, topk, ef, hnsw_mode)
        plan.timer = timer
        m1 = timer.mark()
        self.candidates(plan)
        m2 = timer.mark()
        out_d, out_i = self.merge(plan)
        timer.bounds = [m0, m1, m2, timer.mark()]
        return out_d, out_i, plan

    def report(self, plan: QueryPlan) -> None:
        """Read the plan's stage marks into ``plan.stage_s`` and report them
        to the telemetry (labeled by engine / quantized / merge path / pow2
        batch bucket).  Call after the results' sync, which on the card has
        completed every marked event; a no-op for an untimed plan."""
        timer = plan.timer
        if timer is None:
            return
        plan.stage_s = timer.stage_seconds()
        cfg = self.index.config
        timer.telemetry.on_execute(
            engine=cfg.engine, quantized=cfg.quantized, merge_path=plan.merge_path,
            batch=plan.queries.shape[0], stage_s=plan.stage_s,
        )

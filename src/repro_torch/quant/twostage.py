"""Two-stage (int8 scan -> exact re-rank) executor for the scan engine.

The port of ``repro.quant.twostage``.  Stage 1 ranks each routed (shard,
segment)'s int8 corpus and keeps ``C = rerank_factor * perShardTopK``
candidates per (query, partition) lane; stage 2 computes EXACT fp32
distances for just those candidates, and the executor scatters the lanes
into the plan's candidate buffers for the merge.

Stage 1 is one fused K2 call per routed partition
(``kernels/ops.py::distance_topk_q8_codes``): the int8 scores and their
top-C selection never leave the device, where the reference scores a full
(L, N) matrix and selects on the host with ``np.argpartition``.  K2's
scores are bit-equal to the reference's ``_stage1_scores``, so the two
candidate sets differ only at exact ties at the C-th score.  With
``rerank_store`` on the device the host reads nothing per partition.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.utils import round_up
from repro_torch.kernels import ops
from repro_torch.quant.codec import Q8Corpus, quantize_queries_q8_t
from repro_torch.quant.rerank import ExactStore, exact_candidate_distances, resolve_store_mode


class _Q8Partition:
    """Device state for one quantized (shard, segment) partition: the int8
    codes (zero-padded along D to a multiple of 4, which leaves every dot
    exact), the per-dim scales and a per-row bias — the dequantized norms2
    for l2, zeros for ip — resident on the device; the fp32 originals in an
    ``ExactStore``."""

    def __init__(self, qc: Q8Corpus, vectors: np.ndarray, keys: torch.Tensor, metric: str,
                 device: torch.device):
        self.n = qc.size
        self.dim = qc.dim
        self.metric = metric
        d4 = round_up(self.dim, 4)
        codes = np.asarray(qc.codes, np.int8)
        if d4 != self.dim:
            codes = np.pad(codes, ((0, 0), (0, d4 - self.dim)))
        self.codes = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
        self.scales = torch.from_numpy(np.asarray(qc.scales, np.float32)).to(device)
        bias = np.asarray(qc.norms2, np.float32) if metric == "l2" else np.zeros(self.n, np.float32)
        self.bias = torch.from_numpy(bias).to(device)
        self.keys = keys  # (n,) int64 on the device
        self.store = ExactStore(vectors, keys.cpu().numpy())

    def resident_bytes(self) -> int:
        """Scan-resident device bytes: codes + scales + bias + keys."""
        return sum(t.numel() * t.element_size() for t in (self.codes, self.scales, self.bias,
                                                           self.keys))

    def stage1(self, q_lane: torch.Tensor, C: int) -> torch.Tensor:
        """(b, C) int32 rows of this partition: each query's C best by
        quantized score (K2 on CUDA, its plain version on the CPU)."""
        q_codes, q_scale = quantize_queries_q8_t(q_lane, self.scales)
        pad = self.codes.shape[1] - self.dim
        if pad:
            q_codes = torch.nn.functional.pad(q_codes, (0, pad))
        metric_k = "l2" if self.metric == "l2" else "ip"
        _, cand = ops.distance_topk_q8_codes(q_codes, self.codes, q_scale, self.bias, C, metric_k)
        return cand


class QuantizedScanExecutor:
    """Runs the two-stage search for every quantized scan partition.

    Built once per index (codes upload once) and reused across query
    batches; ``run`` scatters per-lane exact results into the plan's
    compact route slots.
    """

    def __init__(self, parts, metric: str, rerank_factor: int, rerank_store: str,
                 device: torch.device):
        # parts: {(s, g): _Q8Partition}
        self.parts = parts
        self.metric = metric
        self.rerank_factor = max(int(rerank_factor), 1)
        self.rerank_store = resolve_store_mode(rerank_store, device)

    def resident_bytes(self) -> int:
        return sum(p.resident_bytes() for p in self.parts.values())

    def exact_store_bytes(self) -> int:
        return sum(p.store.nbytes() for p in self.parts.values())

    def exact_store_device_bytes(self) -> int:
        return sum(p.store.device_nbytes() for p in self.parts.values())

    def run(self, queries: torch.Tensor, sels, slot: torch.Tensor, cand_d: torch.Tensor,
            cand_i: torch.Tensor, pstk: int, *, lane_width=None, timer=None):
        """Search every quantized partition; returns the handled set.

        ``queries`` are the fp32 queries on the device (mips augmentation
        already applied by the caller; metric == 'l2' then).  Lane results
        land in ``cand_d``/``cand_i`` route slots of width ``lane_width``
        (default ``pstk``): the dedup-free merge path passes the full
        candidate width so the merge sees every exactly-scored candidate.

        For metric 'l2' the scattered distances OMIT the per-query ||q||^2
        constant; the caller adds it back after its merge.

        ``timer``: a ``core.plan.StageTimer``; when given, the exact re-rank
        of every partition is marked into ``timer.rerank``.
        """
        handled = set(self.parts)
        W = pstk if lane_width is None else lane_width
        q_eff = queries
        if self.metric == "cos":
            q_eff = queries / queries.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        for (s, g), part in sorted(self.parts.items()):
            sel = sels[g]
            b = sel.numel()
            if b == 0 or part.n == 0:
                continue
            q_lane = q_eff.index_select(0, sel)
            C = min(self.rerank_factor * pstk, part.n)
            if C < part.n:
                cand = part.stage1(q_lane, C)
            else:  # C == n: every row is a candidate
                cand = torch.arange(C, dtype=torch.int32, device=q_lane.device).expand(b, C)
            t_rr = None if timer is None else timer.mark()
            ex = exact_candidate_distances(q_lane, cand, part.store, self.metric,
                                           mode=self.rerank_store)
            if t_rr is not None:
                timer.rerank.append((t_rr, timer.mark()))
            kk = min(W, C)
            if kk < C:
                d_lane, loc = torch.topk(ex, kk, dim=1, largest=False)
                rows = torch.gather(cand, 1, loc)
            else:
                d_lane, rows = ex, cand
            i_lane = part.keys[rows.to(torch.int64)]
            sl = slot[sel, g]
            cand_d[sel, s, sl, :kk] = d_lane
            cand_i[sel, s, sl, :kk] = i_lane
        return handled

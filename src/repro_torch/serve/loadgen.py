"""Arrival-process load generation over the async ANN front end.

The port of ``repro.serve.loadgen`` (host Python and numpy; the gap
sequences equal the reference's for the same arguments).

The paper's headline serving numbers (Table 8: ~2.5K QPS/node with few-ms
p99, degrading as offered load approaches saturation) are statements about
latency UNDER A LIVE ARRIVAL PROCESS, not about closed-loop batch
throughput.  This module supplies that arrival process:

* ``poisson`` — open loop, exponential inter-arrival gaps at ``rate_qps``
  (memoryless arrivals, the standard web-traffic model and what Table 8's
  offered-load axis means);
* ``fixed`` — open loop, deterministic ``1/rate_qps`` gaps (isolates
  queueing effects from arrival burstiness);
* ``mmpp`` — open loop, two-state ON/OFF Markov-modulated Poisson: Poisson
  arrivals at ``rate_qps / mmpp_on_frac`` during exponentially-distributed
  ON periods, silence during OFF periods, mean rate ``rate_qps``.  The
  standard bursty-traffic model: same offered load as ``poisson`` but
  arrivals clump, so queues build during bursts and the p99 gap vs the
  matching Poisson point is pure burstiness effect;
* ``closed`` — ``concurrency`` synchronous clients, each submitting its
  next query the moment the previous one completes.  Offered load is
  implicit; the achieved QPS at high concurrency IS the saturation
  throughput, which anchors the open-loop sweep's load axis.

Open-loop generation is the honest protocol for percentiles: arrivals keep
coming while the system is slow, so queueing delay lands in the measured
latencies instead of silently throttling the generator (the coordinated-
omission trap of closed-loop measurement).

Gap sequences are pure functions of ``(process, rate, n, seed)`` —
``arrival_gaps`` is reproducible across runs and machines (seeding asserted
in tests/test_torch_serve.py); only the service times vary with the host.  Every completed request carries end-to-end timestamps from
``AsyncAnnFrontend``, so a ``LoadResult`` reports p50/p95/p99 latency,
achieved QPS, and the formed-batch histogram per offered-load point.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.spans import stage_breakdown
from repro_torch.serve.controller import SLOController
from repro_torch.serve.engine import AsyncAnnFrontend

PROCESSES = ("poisson", "fixed", "mmpp", "closed")


def arrival_gaps(
    process: str,
    rate_qps: float,
    n: int,
    seed: int = 0,
    *,
    mmpp_on_frac: float = 0.4,
    mmpp_cycle_s: float = 0.2,
) -> np.ndarray:
    """(n,) inter-arrival gaps in seconds; deterministic in ``seed``.

    ``mmpp`` knobs (ignored for other processes): ``mmpp_on_frac`` is the
    long-run fraction of time the source is ON (arrivals run at
    ``rate_qps / mmpp_on_frac`` while ON, so the mean rate stays
    ``rate_qps``); ``mmpp_cycle_s`` is the mean ON + mean OFF sojourn
    (exponential holding times — ``on_frac=1`` degenerates to plain
    Poisson).  Like the other open-loop processes, the sequence is a pure
    function of its arguments.
    """
    if process not in ("poisson", "fixed", "mmpp"):
        raise ValueError(
            f"process={process!r} has no gap sequence — expected 'poisson', "
            "'fixed' or 'mmpp' ('closed' is driven by completions, not a "
            "clock)"
        )
    if rate_qps <= 0:
        raise ValueError(f"rate_qps={rate_qps} must be > 0")
    if process == "fixed":
        return np.full(n, 1.0 / rate_qps)
    rng = np.random.default_rng(seed)
    if process == "poisson":
        return rng.exponential(1.0 / rate_qps, n)
    # mmpp: alternate exponential ON/OFF sojourns; arrivals are a Poisson
    # stream at lam_on inside ON windows.  A draw that crosses the window
    # edge is discarded and redrawn in the next ON window — valid by the
    # memorylessness of the exponential, and it keeps the generator a
    # simple forward walk.
    if not 0.0 < mmpp_on_frac <= 1.0:
        raise ValueError(f"mmpp_on_frac={mmpp_on_frac} must be in (0, 1]")
    if mmpp_cycle_s <= 0:
        raise ValueError(f"mmpp_cycle_s={mmpp_cycle_s} must be > 0")
    lam_on = rate_qps / mmpp_on_frac
    mean_on = mmpp_on_frac * mmpp_cycle_s
    mean_off = (1.0 - mmpp_on_frac) * mmpp_cycle_s
    gaps = np.empty(n, np.float64)
    t = last = 0.0
    on_end = rng.exponential(mean_on)
    i = 0
    while i < n:
        g = rng.exponential(1.0 / lam_on)
        if t + g <= on_end:
            t += g
            gaps[i] = t - last
            last = t
            i += 1
        else:
            t = on_end
            if mean_off > 0:
                t += rng.exponential(mean_off)
            on_end = t + rng.exponential(mean_on)
    return gaps


@dataclasses.dataclass
class LoadResult:
    """One offered-load point: what the bench JSON and the sweep report."""

    process: str
    offered_qps: float  # nan for closed loop (load is implicit)
    concurrency: int  # 0 for open loop
    duration_s: float  # submission window (drain time excluded)
    elapsed_s: float  # window + drain — the QPS denominator
    submitted: int
    completed: int
    cancelled: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    mean_queue_ms: float  # batching/queueing share of the latency
    achieved_qps: float
    mean_batch: float
    batch_hist: dict[int, int]
    mean_exec_ms: float = float("nan")  # execution share (latency - queue)
    # per-stage percentiles from telemetry spans — {} without telemetry;
    # {stage: {p50_ms, p95_ms, p99_ms, mean_ms, n}} with (see
    # obs.spans.stage_breakdown).
    stage_breakdown: dict = dataclasses.field(default_factory=dict)
    # SLO accounting (populated when the point ran with slo_ms set):
    # attainment is the fraction of completed requests within slo_ms,
    # degraded counts requests the controller served with a reduced ef.
    slo_ms: float = float("nan")
    slo_attainment: float = float("nan")
    degraded: int = 0
    controller_on: bool = False
    # mean recall@topk vs a ground-truth id table (open-loop points with
    # gt_ids only; nan otherwise)
    mean_recall: float = float("nan")

    def row(self) -> dict:
        """Strict-JSON-ready dict: batch_hist keys stringified, non-finite
        floats (closed-loop offered_qps, empty-percentile NaNs) -> null."""

        def _clean(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: _clean(x) for k, x in v.items()}
            return v

        out = {
            k: _clean(v) for k, v in dataclasses.asdict(self).items()
        }
        out["batch_hist"] = {str(k): v for k, v in sorted(
            self.batch_hist.items()
        )}
        return out


def _summarize(
    fe: AsyncAnnFrontend,
    *,
    process: str,
    offered_qps: float,
    concurrency: int,
    duration_s: float,
    elapsed_s: float,
    telemetry=None,
    span_since: int = 0,
    slo_ms: Optional[float] = None,
    controller_on: bool = False,
    gt_ids: Optional[np.ndarray] = None,
    n_pool: int = 0,
) -> LoadResult:
    done = [r for r in fe.completed if r.done]
    lat = np.array([r.latency_s for r in done], np.float64)
    queue = np.array([r.queue_s for r in done], np.float64)
    has = lat.size > 0
    slo_attainment = float("nan")
    if slo_ms is not None and has:
        slo_attainment = float(np.mean(lat <= slo_ms / 1e3))
    mean_recall = float("nan")
    if gt_ids is not None and n_pool > 0 and done:
        # open-loop points submit sequentially from one thread, so uid ==
        # arrival index == query-pool index mod n_pool (the caller skips
        # gt for closed loop, where per-client interleaving breaks this).
        per_req = [
            np.intersect1d(r.ids, gt_ids[r.uid % n_pool, : len(r.ids)]).size
            / max(len(r.ids), 1)
            for r in done
        ]
        mean_recall = float(np.mean(per_req))
    pct = (
        np.percentile(lat, (50, 95, 99)) if has else np.full(3, np.nan)
    )
    breakdown: dict = {}
    if telemetry is not None:
        # only this load point's executor spans: the sink is shared across
        # points, so filter by the seq watermark taken before submission.
        plan_events = telemetry.spans.events(kind="plan", since=span_since)
        breakdown = stage_breakdown(
            plan_events, extra={"queue": queue.tolist()}
        )
    return LoadResult(
        process=process,
        offered_qps=float(offered_qps),
        concurrency=concurrency,
        duration_s=float(duration_s),
        elapsed_s=float(elapsed_s),
        submitted=fe.stats["submitted"],
        completed=len(done),
        cancelled=fe.stats["submitted"] - len(done),
        p50_ms=1e3 * float(pct[0]),
        p95_ms=1e3 * float(pct[1]),
        p99_ms=1e3 * float(pct[2]),
        mean_ms=1e3 * float(lat.mean()) if has else float("nan"),
        max_ms=1e3 * float(lat.max()) if has else float("nan"),
        mean_queue_ms=1e3 * float(queue.mean()) if has else float("nan"),
        achieved_qps=len(done) / max(elapsed_s, 1e-12),
        mean_batch=fe.mean_batch_size,
        batch_hist=dict(fe.batch_hist),
        mean_exec_ms=(
            1e3 * float((lat - queue).mean()) if has else float("nan")
        ),
        stage_breakdown=breakdown,
        slo_ms=float("nan") if slo_ms is None else float(slo_ms),
        slo_attainment=slo_attainment,
        degraded=sum(1 for r in done if r.degraded),
        controller_on=controller_on,
        mean_recall=mean_recall,
    )


def run_load_point(
    index,
    queries: np.ndarray,
    *,
    process: str = "poisson",
    rate_qps: Optional[float] = None,
    concurrency: int = 8,
    duration_s: float = 1.0,
    seed: int = 0,
    topk: int = 100,
    max_batch: int = 64,
    max_wait_ms: float = 2.0,
    ef: Optional[int] = None,
    collect_stats: bool = False,
    knob_mix: Optional[Sequence[tuple]] = None,
    telemetry=None,
    controller=None,
    deadline_ms: Optional[float] = None,
    slo_ms: Optional[float] = None,
    gt_ids: Optional[np.ndarray] = None,
) -> LoadResult:
    """Drive one offered-load point end to end and summarize it.

    Builds a fresh ``AsyncAnnFrontend`` (clean stats), submits arrivals for
    ``duration_s`` seconds under the chosen process, then drains — so every
    submitted query's completion (including queueing built up past
    saturation) is measured.  Queries cycle through ``queries`` rows.

    ``knob_mix`` generates a MIXED workload: a sequence of per-request
    ``(topk, ef)`` overrides (entries may be None -> the frontend default)
    that arrivals cycle through deterministically — arrival j carries
    ``knob_mix[j % len(knob_mix)]``, so the workload is reproducible and
    every formed micro-batch exercises the executor's knob-group path.

    ``telemetry`` (an ``obs.Telemetry``) instruments the point: it is
    attached to ``index`` for the duration (previous attachment restored on
    exit), wired into the frontend, and the result gains a per-stage
    ``stage_breakdown`` computed from the executor spans this point
    produced (isolated via the span-sink seq watermark, so one shared
    telemetry can serve a whole sweep).

    ``controller`` (a fresh ``SLOController``) closes the loop for this
    point: the frontend binds it, its retune thread runs for the
    submission window, and degrade stays active through the drain.
    ``deadline_ms`` stamps every submitted request with that latency
    budget; ``slo_ms`` adds SLO-attainment accounting to the result
    (independent knobs: a controller-off point typically sets both
    ``deadline_ms`` and ``slo_ms`` to measure the baseline).  ``gt_ids``
    (n_pool, >= topk) enables mean recall@topk accounting for open-loop
    points — under degrade, recall is the other half of the A/B verdict.
    """
    if process not in PROCESSES:
        raise ValueError(f"process={process!r} — expected one of {PROCESSES}")
    fe = AsyncAnnFrontend(
        index, topk=topk, max_batch=max_batch, max_wait_ms=max_wait_ms,
        ef=ef, collect_stats=collect_stats, telemetry=telemetry,
        controller=controller,
    )
    span_since = 0
    prev_telemetry = getattr(index, "telemetry", None)
    if telemetry is not None:
        span_since = telemetry.spans.next_seq
        index.attach_telemetry(telemetry)
    n_pool = len(queries)

    def _submit(j: int):
        if knob_mix:
            tk, efv = knob_mix[j % len(knob_mix)]
            return fe.submit(
                queries[j % n_pool], topk=tk, ef=efv, deadline_ms=deadline_ms
            )
        return fe.submit(queries[j % n_pool], deadline_ms=deadline_ms)

    fe.start()
    if controller is not None:
        controller.start()
    t0 = time.perf_counter()
    try:
        if process == "closed":
            stop_at = t0 + duration_s

            def client(ci: int):
                qi = ci
                while time.perf_counter() < stop_at:
                    req = _submit(qi)
                    qi += concurrency
                    req.wait()

            threads = [
                threading.Thread(target=client, args=(ci,), daemon=True)
                for ci in range(concurrency)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            if rate_qps is None:
                raise ValueError(f"process={process!r} requires rate_qps")
            concurrency = 0
            # pre-draw the schedule (reproducible); recycle if the window
            # overruns the draw (only when achieved arrivals exceed 1.5x
            # the expected count).
            n_gaps = max(16, math.ceil(1.5 * rate_qps * duration_s))
            gaps = arrival_gaps(process, rate_qps, n_gaps, seed)
            deadline = t0 + duration_s
            t_next = t0 + gaps[0]
            gi, qi = 1, 0
            while True:
                now = time.perf_counter()
                if now >= deadline:
                    break
                if now >= t_next:
                    _submit(qi)
                    qi += 1
                    t_next += gaps[gi % len(gaps)]
                    gi += 1
                else:
                    time.sleep(min(t_next - now, 2e-3))
    finally:
        try:
            if controller is not None:
                # retune thread off first; degrade (frontend-driven) still
                # covers the drain batches below
                controller.stop()
        finally:
            fe.stop(drain=True)
            if telemetry is not None:
                index.attach_telemetry(prev_telemetry)
    elapsed = time.perf_counter() - t0
    return _summarize(
        fe,
        process=process,
        offered_qps=float("nan") if process == "closed" else rate_qps,
        concurrency=concurrency,
        duration_s=duration_s,
        elapsed_s=elapsed,
        telemetry=telemetry,
        span_since=span_since,
        slo_ms=slo_ms,
        controller_on=controller is not None,
        gt_ids=None if process == "closed" else gt_ids,
        n_pool=n_pool,
    )


def measure_saturation_qps(
    index,
    queries: np.ndarray,
    *,
    duration_s: float = 1.0,
    concurrency: Optional[int] = None,
    **kw,
) -> LoadResult:
    """Closed-loop saturation point: anchors the open-loop sweep's axis.

    With enough synchronous clients to keep full micro-batches forming
    (default 2x max_batch), the achieved QPS is the node's capacity; open-
    loop points are then swept as fractions of it.
    """
    mb = kw.get("max_batch", 64)
    return run_load_point(
        index, queries, process="closed",
        concurrency=concurrency or 2 * mb, duration_s=duration_s, **kw,
    )


def sweep_load(
    index,
    queries: np.ndarray,
    *,
    load_fracs: Sequence[float] = (0.25, 0.5, 0.75, 0.9, 1.1),
    process: str = "poisson",
    duration_s: float = 1.0,
    saturation: Optional[LoadResult] = None,
    seed: int = 0,
    **kw,
) -> tuple[LoadResult, list[LoadResult]]:
    """Measure saturation, then sweep offered load as fractions of it.

    Returns ``(saturation_point, open_loop_points)`` — the raw material of
    the paper's Table 8 (p99 vs offered load, including one point past
    saturation where queueing delay dominates).
    """
    if saturation is None:
        saturation = measure_saturation_qps(
            index, queries, duration_s=duration_s, **kw
        )
    points = [
        run_load_point(
            index, queries, process=process,
            rate_qps=max(frac * saturation.achieved_qps, 1.0),
            duration_s=duration_s, seed=seed + pi, **kw,
        )
        for pi, frac in enumerate(load_fracs)
    ]
    return saturation, points


def run_controller_ab(
    index,
    queries: np.ndarray,
    *,
    rate_qps: float,
    slo_ms: float,
    ef_ladder: Sequence[int],
    process: str = "mmpp",
    duration_s: float = 1.0,
    seed: int = 0,
    gt_ids: Optional[np.ndarray] = None,
    controller_kw: Optional[dict] = None,
    **kw,
) -> tuple[LoadResult, LoadResult, SLOController]:
    """Paired controller-off / controller-on load points (the controller's
    acceptance experiment: an MMPP burst at 0.9x saturation, on beats off
    on p99 without a recall cliff).

    Both points run the SAME seeded arrival schedule, knobs, and
    per-request ``deadline_ms = slo_ms``, so the only difference is the
    bound controller (fresh per call — a controller binds one frontend).
    Returns ``(off, on, controller)``; ``controller.snapshot()`` has the
    decision counters behind the ``on`` point.
    """
    off = run_load_point(
        index, queries, process=process, rate_qps=rate_qps,
        duration_s=duration_s, seed=seed, deadline_ms=slo_ms, slo_ms=slo_ms,
        gt_ids=gt_ids, **kw,
    )
    ctrl = SLOController(
        slo_ms=slo_ms, ef_ladder=ef_ladder, **(controller_kw or {})
    )
    on = run_load_point(
        index, queries, process=process, rate_qps=rate_qps,
        duration_s=duration_s, seed=seed, deadline_ms=slo_ms, slo_ms=slo_ms,
        gt_ids=gt_ids, controller=ctrl, **kw,
    )
    return off, on, ctrl

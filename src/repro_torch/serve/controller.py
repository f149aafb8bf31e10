"""Closed-loop SLO controller over the async ANN serving front end.

The port of ``repro.serve.controller`` (pure Python, the same policy).

The paper's deployment story (§7: few-ms p99 at ~2.5K QPS/node) only holds
while the knobs — micro-batch deadline, batch size, HNSW ``ef`` — match the
offered load, and real traffic is bursty (the MMPP points in
serve/loadgen.py).  ``SLOController`` closes the loop that the telemetry
substrate (``obs/``) was built to judge:

* **auto-tune** (a background thread, one tick per ``interval_s``): reads
  the ``batch`` spans the frontend's telemetry emitted since the last tick
  plus the live queue depth, and adapts ``max_wait_ms`` AIMD-style —
  tighten (multiplicative) when observed worst-case latency blows the SLO
  or the queue is deep, relax (multiplicative, capped at the configured
  base) when the system runs cold.  ``ef`` per Malkov & Yashunin is the
  accuracy/latency dial; ``max_wait_ms`` is the batching-delay dial — the
  controller moves the cheap dial continuously and the accuracy dial only
  per-request, only past deadline.
* **deadline-aware degrade** (called inline by the frontend at batch
  formation): a request already past its latency budget gets a reduced
  ``ef`` from a small descending ladder — one rung per whole budget
  already elapsed — instead of blowing the p99 for full-accuracy results
  nobody is waiting for.  Per-request ``(topk, ef)`` mixed batches mean a
  degraded request rides the same formed batch; the ladder is warmed via
  ``LannsIndex.warm_traces(knobs=ctrl.warm_knobs())``, so a controller
  decision meets no first-use stall on the serving path.

The controller is pure policy over existing substrate: it calls only
``frontend.retune()`` (knob store under the frontend's own lock) and reads
only ``Telemetry`` signals.  It never raises from ``on_batch_formed`` by
construction — every policy input is validated in ``__init__`` — because
an exception there would crash the batcher thread and cancel every
in-flight request.

Concurrency contract (the JAX package's ``repro.analysis`` LANNS010-013
rules): every mutable field is guarded by ``_lock`` per the
``_GUARDED_BY`` registry below.  The
controller NEVER holds ``_lock`` while calling into the frontend or
telemetry (both take their own locks), so the process-wide held-before
graph stays acyclic — ``_LOCK_ORDER`` records ``_lock`` as a leaf.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = ["SLOController"]


class SLOController:
    """Telemetry-driven auto-tune + deadline-aware ``ef`` degrade.

    Construct standalone, then hand it to the frontend —
    ``AsyncAnnFrontend(index, controller=ctrl, telemetry=tel)`` calls
    ``bind()`` — and ``start()`` the retune thread (optional: degrade
    works passively without it).  One controller binds ONE frontend.

    Parameters
    ----------
    slo_ms:
        The latency objective. Requests without an explicit per-request
        ``deadline_ms`` fall back to ``default_deadline_ms`` (which itself
        defaults to ``slo_ms``), and the retune tick compares observed
        worst-case latency against ``slo_ms``.
    ef_ladder:
        Strictly-descending ``ef`` rungs for degrade.  A request a whole
        budget late gets rung 0, two budgets late rung 1, ... clamped to
        the last rung.  Warm every rung: ``index.warm_traces(max_batch,
        topk, knobs=ctrl.warm_knobs())``.
    default_deadline_ms:
        Budget for requests that carry no ``deadline_ms``.  ``None``
        disables the fallback (only explicit deadlines degrade); the
        default mirrors ``slo_ms``.
    interval_s / min_wait_ms / tighten_factor / relax_factor / relax_margin:
        Retune cadence and AIMD shape: tighten multiplies ``max_wait_ms``
        by ``tighten_factor`` (floored at ``min_wait_ms``) when worst
        observed latency exceeds ``slo_ms`` or depth exceeds 2x
        ``max_batch``; relax multiplies by ``relax_factor`` (capped at the
        bind-time base) when worst latency sits under ``relax_margin *
        slo_ms`` and the queue is shallow.
    """

    _GUARDED_BY = {
        "frontend": "_lock",
        "telemetry": "_lock",
        "_thread": "_lock",
        "_stopping": "_lock",
        "_watermark": "_lock",
        "cur_wait_ms": "_lock",
        "_base_wait_ms": "_lock",
        "stats": "_lock",
    }
    # leaf lock: never held across frontend.retune()/telemetry calls
    _LOCK_ORDER = ("_lock",)

    def __init__(
        self,
        *,
        slo_ms: float,
        ef_ladder: Sequence[int] = (64, 32, 16),
        default_deadline_ms: object = "slo",
        interval_s: float = 0.05,
        min_wait_ms: float = 0.1,
        tighten_factor: float = 0.5,
        relax_factor: float = 1.5,
        relax_margin: float = 0.5,
        clock: Callable[[], float] = time.perf_counter,
    ):
        slo_ms = float(slo_ms)
        if not math.isfinite(slo_ms) or slo_ms <= 0:
            raise ValueError(f"slo_ms={slo_ms} must be finite and > 0")
        ladder = tuple(int(e) for e in ef_ladder)
        if not ladder:
            raise ValueError("ef_ladder must have at least one rung")
        if any(e < 1 for e in ladder):
            raise ValueError(f"ef_ladder={ladder} rungs must be >= 1")
        if any(a <= b for a, b in zip(ladder, ladder[1:])):
            raise ValueError(
                f"ef_ladder={ladder} must be strictly descending (rung i is "
                "the ef for a request i+1 budgets past deadline)"
            )
        if default_deadline_ms == "slo":
            default_deadline_ms = slo_ms
        elif default_deadline_ms is not None:
            default_deadline_ms = float(default_deadline_ms)
            if not math.isfinite(default_deadline_ms) or default_deadline_ms <= 0:
                raise ValueError(
                    f"default_deadline_ms={default_deadline_ms} must be "
                    "finite and > 0 (or None to degrade only explicit "
                    "deadlines)"
                )
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        if min_wait_ms <= 0:
            raise ValueError(f"min_wait_ms={min_wait_ms} must be > 0")
        if not 0.0 < tighten_factor < 1.0:
            raise ValueError(f"tighten_factor={tighten_factor} not in (0, 1)")
        if relax_factor <= 1.0:
            raise ValueError(f"relax_factor={relax_factor} must be > 1")
        if not 0.0 < relax_margin < 1.0:
            raise ValueError(f"relax_margin={relax_margin} not in (0, 1)")
        self.slo_ms = slo_ms
        self.ef_ladder = ladder
        self.default_deadline_ms = default_deadline_ms
        self.interval_s = float(interval_s)
        self.min_wait_ms = float(min_wait_ms)
        self.tighten_factor = float(tighten_factor)
        self.relax_factor = float(relax_factor)
        self.relax_margin = float(relax_margin)
        self.clock = clock
        self._lock = threading.Condition()
        self.frontend = None
        self.telemetry = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._watermark = 0  # span-sink seq consumed by the last tick
        self.cur_wait_ms = float("nan")  # set at bind()
        self._base_wait_ms = float("nan")
        self.stats = {
            "degraded": 0, "ticks": 0, "tighten": 0, "relax": 0, "hold": 0,
        }

    # -- wiring --------------------------------------------------------------

    def bind(self, frontend) -> "SLOController":
        """Attach to a frontend (called by ``AnnFrontend.__init__`` when the
        frontend is constructed with ``controller=``).  Captures the
        frontend's configured ``max_wait_ms`` as the relax ceiling and its
        telemetry bundle as the signal source."""
        with self._lock:
            if self.frontend is not None and self.frontend is not frontend:
                raise RuntimeError(
                    "SLOController is already bound to a frontend; build one "
                    "controller per frontend"
                )
            self.frontend = frontend
            self.telemetry = frontend.telemetry
            self._base_wait_ms = frontend.max_wait_s * 1e3
            self.cur_wait_ms = self._base_wait_ms
        return self

    def warm_knobs(self, topk: Optional[int] = None) -> list[tuple]:
        """``(topk, ef)`` pairs covering the degrade ladder, ready for
        ``LannsIndex.warm_traces(max_batch, topk, knobs=...)`` — warming
        them is what lets ``on_batch_formed`` switch ``ef`` mid-traffic
        without a first-use stall."""
        return [(topk, ef) for ef in self.ef_ladder]

    # -- degrade (called inline by the frontend at batch formation) ----------

    def on_batch_formed(self, batch, now: float) -> Optional[list]:
        """Per-request ``ef`` overrides for a just-formed micro-batch.

        ``now`` is the frontend's batch-formation timestamp (its own
        ``clock`` domain, matching ``r.t_submit``).  Returns ``None`` when
        nothing degrades (the common case — zero allocation), else a list
        aligned with ``batch`` whose non-None entries replace that
        request's effective ``ef``.  A request's own explicit ``ef`` is
        only ever REDUCED, never raised.
        """
        ladder = self.ef_ladder
        n_rungs = len(ladder)
        default_budget = self.default_deadline_ms
        overrides: Optional[list] = None
        by_ef: dict[int, int] = {}
        for j, r in enumerate(batch):
            budget = r.deadline_ms if r.deadline_ms is not None else default_budget
            if budget is None:
                continue
            elapsed_ms = (now - r.t_submit) * 1e3
            if elapsed_ms < budget:
                continue
            rung = min(int(elapsed_ms // budget), n_rungs) - 1
            ef = ladder[rung]
            if r.ef is not None and r.ef <= ef:
                continue  # already cheaper than the rung: leave it
            if overrides is None:
                overrides = [None] * len(batch)
            overrides[j] = ef
            by_ef[ef] = by_ef.get(ef, 0) + 1
        if overrides is None:
            return None
        n = sum(by_ef.values())
        with self._lock:
            self.stats["degraded"] += n
            tel = self.telemetry
        if tel is not None:
            for ef, count in sorted(by_ef.items()):
                tel.on_degrade(ef, count)
        return overrides

    # -- auto-tune -----------------------------------------------------------

    def retune_once(self) -> str:
        """One controller tick; returns the decision taken.

        Signals: the worst end-to-end latency implied by the ``batch``
        spans emitted since the previous tick (``queue_max_s + exec_s`` —
        the slowest request of each formed batch), and the instantaneous
        queue depth.  The decision is computed under ``_lock`` but APPLIED
        outside it (``frontend.retune`` takes the frontend's lock;
        telemetry takes its leaf locks) — the lock graph stays acyclic.
        """
        with self._lock:
            fe = self.frontend
            tel = self.telemetry
            since = self._watermark
        if fe is None:
            return "unbound"
        worst_ms = float("nan")
        new_mark = since
        if tel is not None:
            events = tel.spans.events(kind="batch", since=since)
            new_mark = tel.spans.next_seq
            if events:
                worst_ms = 1e3 * max(
                    ev.get("queue_max_s", 0.0) + ev.get("exec_s", 0.0)
                    for ev in events
                )
        depth = fe.depth if hasattr(fe, "depth") else len(fe.pending)
        max_batch = fe.max_batch
        with self._lock:
            self._watermark = new_mark
            cur = self.cur_wait_ms
            base = self._base_wait_ms
            hot = (
                (math.isfinite(worst_ms) and worst_ms > self.slo_ms)
                or depth > 2 * max_batch
            )
            cold = (
                not math.isfinite(worst_ms)
                or worst_ms < self.relax_margin * self.slo_ms
            ) and depth <= max_batch
            if hot and cur > self.min_wait_ms:
                action = "tighten"
                new_wait = max(cur * self.tighten_factor, self.min_wait_ms)
            elif cold and cur < base:
                action = "relax"
                new_wait = min(cur * self.relax_factor, base)
            else:
                action = "hold"
                new_wait = cur
            self.cur_wait_ms = new_wait
            self.stats["ticks"] += 1
            self.stats[action] = self.stats.get(action, 0) + 1
        if new_wait != cur:
            fe.retune(max_wait_ms=new_wait)
        if tel is not None:
            tel.on_retune(
                action=action, max_wait_ms=new_wait, max_batch=max_batch,
                worst_ms=worst_ms, depth=depth,
            )
        return action

    def snapshot(self) -> dict:
        """Decision counters + current knob values (thread-safe copy)."""
        with self._lock:
            out = dict(self.stats)
            out["max_wait_ms"] = self.cur_wait_ms
        return out

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def start(self) -> "SLOController":
        """Spawn the retune thread (one tick per ``interval_s``)."""
        with self._lock:
            if self.frontend is None:
                raise RuntimeError(
                    "bind() a frontend (AnnFrontend(..., controller=ctrl)) "
                    "before start()"
                )
            if self._thread is not None:
                raise RuntimeError("controller already started")
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="slo-controller", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> "SLOController":
        """Stop the retune thread; a no-op when not running.  Degrade keeps
        working after stop() — it is driven by the frontend, not this
        thread."""
        with self._lock:
            thread = self._thread
            if thread is None:
                return self
            self._stopping = True
            self._lock.notify_all()
        thread.join(timeout)
        if thread.is_alive():
            raise RuntimeError("controller thread did not stop in time")
        with self._lock:
            self._thread = None
        return self

    def __enter__(self) -> "SLOController":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
                self._lock.wait(self.interval_s)
                if self._stopping:
                    return
            self.retune_once()

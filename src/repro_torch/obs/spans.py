"""Bounded span/event sink + the per-stage latency breakdown helpers.

The port's own copy of ``repro.obs.spans`` (numpy only).

Spans are plain dicts (``kind`` + payload) appended to a bounded in-memory
ring: the sink NEVER grows past ``capacity`` events — under sustained
traffic old events fall off the front and ``dropped`` counts them, so
attaching telemetry to a long-lived server cannot leak memory.  Three
event kinds flow through it in this repo:

* ``plan``  — one per executed knob group: engine/quantized/merge_path
  labels, the pow2 batch bucket, and ``stage_s`` with the
  route/candidates/rerank/merge wall-clock split (from
  ``QueryPlanExecutor.execute``);
* ``batch`` — one per formed micro-batch: batch kind (full/deadline/
  forced), size, and the queue/exec decomposition of its requests (from
  ``AnnFrontend._execute``);
* ``retrace`` — a watched first-use stall on serving traffic (from
  ``RetraceSentinel`` deltas, polled on every batch: in the port a kernel
  library built or loaded, or a new allocator segment) — the event an
  operator alerts on, because a warmed serving path must not stall;
* ``controller`` — one per SLO-controller retune tick: the decision
  (tighten/relax/hold), the knob values applied, and the worst-latency /
  queue-depth signals the decision saw (from
  ``serve.controller.SLOController`` via ``Telemetry.on_retune``).

Export surface: ``to_jsonl()`` / ``dump_jsonl(path)`` — one JSON object
per line, the load-sweep artifact format (``BENCH_stage_breakdown.jsonl``).

``stage_breakdown`` reduces plan events to the per-stage p50/p95/p99 table
the load sweeps report; percentiles are EXACT (``np.percentile`` over the
retained per-event durations), unlike the bucket-interpolated quantiles of
the exposition histograms.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

#: canonical pipeline stages, reporting order: queue wait (request-level),
#: then the executor's route -> candidates -> rerank -> merge split.
STAGES: tuple[str, ...] = ("queue", "route", "candidates", "rerank", "merge")


class SpanSink:
    """Bounded ring of event dicts with a monotonic sequence number.

    ``emit`` returns the event's ``seq``; ``events(since=seq)`` filters to
    events emitted at-or-after a watermark, which is how a load sweep
    isolates one offered-load point's spans out of a shared sink.
    """

    _GUARDED_BY = {"_events": "_lock", "_seq": "_lock", "_dropped": "_lock"}

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.time):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self.clock = clock  # wall-clock stamp; injectable for tests
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0

    def emit(self, kind: str, **fields) -> int:
        ev = {"kind": kind, "ts": float(self.clock()), **fields}
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        return ev["seq"]

    @property
    def next_seq(self) -> int:
        """Watermark: the seq the NEXT emitted event will carry."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted from the ring since construction."""
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self, kind: Optional[str] = None,
               since: Optional[int] = None) -> list[dict]:
        """Retained events, oldest first, optionally filtered."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if since is not None:
            evs = [e for e in evs if e["seq"] >= since]
        return evs

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- JSONL export ------------------------------------------------------

    def to_jsonl(self) -> str:
        evs = self.events()
        return "".join(json.dumps(e, sort_keys=True) + "\n" for e in evs)

    def dump_jsonl(self, path: str) -> int:
        """Write the retained events to ``path``; returns lines written."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return text.count("\n")


def percentiles_ms(values) -> dict:
    """{p50_ms, p95_ms, p99_ms, mean_ms, n} of a seconds array."""
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        nan = float("nan")
        return {"p50_ms": nan, "p95_ms": nan, "p99_ms": nan,
                "mean_ms": nan, "n": 0}
    pct = np.percentile(v, (50, 95, 99))
    return {
        "p50_ms": 1e3 * float(pct[0]),
        "p95_ms": 1e3 * float(pct[1]),
        "p99_ms": 1e3 * float(pct[2]),
        "mean_ms": 1e3 * float(v.mean()),
        "n": int(v.size),
    }


def stage_breakdown(events, *, extra: Optional[dict] = None) -> dict:
    """Per-stage percentile table from ``plan`` span events.

    ``events`` is any iterable of event dicts; only ``kind == 'plan'``
    entries with a ``stage_s`` payload contribute — each contributes one
    duration per stage (per executed knob group).  ``extra`` merges
    caller-supplied stages measured elsewhere (the load generator passes
    ``{"queue": per_request_queue_seconds}`` — queue wait is request-level
    and never visible to the executor).  Returns ``{stage:
    percentiles_ms(...)}`` ordered canonically (STAGES first).
    """
    vals: dict[str, list] = {}
    for ev in events:
        st = ev.get("stage_s")
        if ev.get("kind") != "plan" or not st:
            continue
        for stage, secs in st.items():
            vals.setdefault(stage, []).append(float(secs))
    if extra:
        for stage, secs in extra.items():
            vals.setdefault(stage, []).extend(np.asarray(secs).ravel())
    order = [s for s in STAGES if s in vals] + sorted(set(vals) - set(STAGES))
    return {stage: percentiles_ms(vals[stage]) for stage in order}


def format_stage_table(breakdown: dict, indent: str = "  ") -> str:
    """Fixed-width text table of a ``stage_breakdown`` result."""
    cols = ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "n")
    head = f"{indent}{'stage':<12}" + "".join(f"{c:>10}" for c in cols)
    rows = [head]
    for stage, d in breakdown.items():
        cells = []
        for c in cols:
            v = d.get(c, float("nan"))
            cells.append(f"{v:>10d}" if c == "n" else f"{v:>10.3f}")
        rows.append(f"{indent}{stage:<12}" + "".join(cells))
    return "\n".join(rows)

"""The ``Telemetry`` bundle: registry + span sink + retrace sentinel.

The port of ``repro.obs.telemetry``.  One object threads through the
serving stack:

* ``LannsIndex.attach_telemetry(tel)`` makes the staged plan executor time
  its route/candidates/rerank/merge boundaries into ``tel``: with CUDA
  events recorded on the index's stream, read after the batch's one results
  sync, on the card; with ``tel.clock`` on the CPU.  Detached — the
  default — the executor reads no clock and records no event, so the
  instrumentation-off path is the pre-telemetry pipeline;
* ``AnnFrontend(..., telemetry=tel)`` records the per-request queue/exec/
  end-to-end decomposition of every formed micro-batch, and polls the
  ``RetraceSentinel`` so a first-use stall on warmed traffic (a kernel
  library built or loaded, a new allocator segment) becomes a counter bump
  + a ``retrace`` span event;
* ``ServeEngine(..., telemetry=tel)`` registers its ``stats`` dict as pull
  gauges, so ONE ``tel.registry.expose_text()`` call covers both engines.

The hooks hold no locks of their own beyond the metric/sink internals
(each an uncontended leaf lock around a dict/array update), and they never
call back into the index or frontend, so attaching telemetry cannot
introduce a lock cycle with the serving locks.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.common.utils import next_pow2
from repro_torch.obs.metrics import (
    BATCH_SIZE_BUCKETS,
    MetricsRegistry,
)
from repro_torch.obs.spans import SpanSink


class Telemetry:
    """Serving-telemetry bundle; share one instance across components.

    ``clock`` is the duration clock for the executor's stage spans on the
    CPU (injectable for tests; defaults to ``time.perf_counter`` — the same
    domain as the frontend request timestamps); on the card the stages are
    timed with CUDA events.  ``sentinel`` defaults to a fresh
    ``RetraceSentinel`` over the current CUDA device (unavailable without
    one); any object with ``retraced()``/``reset()`` substitutes (tests
    stub it).
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        spans: Optional[SpanSink] = None,
        sentinel=None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.spans = spans if spans is not None else SpanSink()
        if sentinel is None:
            from repro_torch.analysis.sentinels import RetraceSentinel

            sentinel = RetraceSentinel()
        self.sentinel = sentinel
        self.clock = clock
        reg = self.registry
        # -- metric catalog (documented in README "Observability") ---------
        self.requests_total = reg.counter(
            "lanns_requests_total",
            "ANN requests completed, by micro-batch kind",
            ("kind",),
        )
        self.batches_total = reg.counter(
            "lanns_batches_total",
            "Micro-batches formed, by flush kind",
            ("kind",),
        )
        self.queue_seconds = reg.histogram(
            "lanns_queue_seconds",
            "Per-request batching/queueing delay (t_start - t_submit)",
        )
        self.exec_seconds = reg.histogram(
            "lanns_exec_seconds",
            "Per-request batched execution time (t_done - t_start)",
        )
        self.latency_seconds = reg.histogram(
            "lanns_request_latency_seconds",
            "Per-request end-to-end latency (t_done - t_submit)",
        )
        self.batch_size = reg.histogram(
            "lanns_batch_size",
            "Formed micro-batch sizes",
            buckets=BATCH_SIZE_BUCKETS,
        )
        self.stage_seconds = reg.histogram(
            "lanns_stage_seconds",
            "Query-plan stage wall clock per executed knob group",
            ("stage", "engine", "quantized", "merge_path", "batch_bucket"),
        )
        self.retraces_total = reg.counter(
            "lanns_jit_retraces_total",
            "Watched first-use stalls (kernel-library loads, allocator "
            "segments) observed on serving traffic",
            ("fn",),
        )
        # SLO-controller decision metrics (serve/controller.py): the policy
        # is itself observable, so a controller A/B can be judged from one
        # exposition — degrades by ladder rung, retune ticks by decision,
        # and the knob values the controller last applied/saw.
        self.controller_degraded = reg.counter(
            "lanns_controller_degraded_total",
            "Requests served with a deadline-degraded ef, by ladder ef",
            ("ef",),
        )
        self.controller_retunes = reg.counter(
            "lanns_controller_retunes_total",
            "Controller retune ticks, by decision",
            ("action",),
        )
        self.controller_max_wait_ms = reg.gauge(
            "lanns_controller_max_wait_ms",
            "Frontend max_wait_ms as last set by the controller",
        )
        self.controller_max_batch = reg.gauge(
            "lanns_controller_max_batch",
            "Frontend max_batch as last observed by the controller",
        )

    # -- pipeline hooks ----------------------------------------------------

    def on_execute(self, *, engine: str, quantized: str, merge_path: str,
                   batch: int, stage_s: dict) -> None:
        """One executed knob group (called by ``QueryPlanExecutor``)."""
        bucket = str(next_pow2(max(int(batch), 1)))
        for stage, secs in stage_s.items():
            self.stage_seconds.labels(
                stage=stage, engine=engine, quantized=quantized,
                merge_path=merge_path, batch_bucket=bucket,
            ).observe(float(secs))
        self.spans.emit(
            "plan",
            b=int(batch),
            batch_bucket=int(bucket),
            engine=str(engine),
            quantized=str(quantized),
            merge_path=str(merge_path),
            stage_s={k: float(v) for k, v in stage_s.items()},
        )

    def on_batch(self, batch, kind: str) -> None:
        """One formed micro-batch of completed ``AnnRequest``s (called by
        ``AnnFrontend._execute`` AFTER results are published)."""
        b = len(batch)
        if b == 0:
            return
        queue = np.array([r.t_start - r.t_submit for r in batch], np.float64)
        execs = np.array([r.t_done - r.t_start for r in batch], np.float64)
        e2e = np.array([r.t_done - r.t_submit for r in batch], np.float64)
        self.queue_seconds.observe_many(queue)
        self.exec_seconds.observe_many(execs)
        self.latency_seconds.observe_many(e2e)
        self.batch_size.observe(float(b))
        self.batches_total.labels(kind).inc()
        self.requests_total.labels(kind).inc(b)
        self.spans.emit(
            "batch",
            batch_kind=str(kind),
            b=int(b),
            exec_s=float(execs[0]),  # shared by the whole batch
            queue_mean_s=float(queue.mean()),
            queue_max_s=float(queue.max()),
        )
        self.poll_retraces()

    def on_degrade(self, ef: int, n: int = 1) -> None:
        """``n`` requests in a formed batch degraded to ladder rung ``ef``
        (called by ``SLOController.on_batch_formed`` on the batcher
        thread; one labeled counter bump, no span — the batch span that
        follows carries the batch context)."""
        self.controller_degraded.labels(str(int(ef))).inc(int(n))

    def on_retune(self, *, action: str, max_wait_ms: float, max_batch: int,
                  worst_ms: float, depth: int) -> None:
        """One controller tick: decision counter, knob gauges, and a
        ``controller`` span with the signal values the decision saw
        (``worst_ms`` is None in the span when the tick's window held no
        batch events)."""
        self.controller_retunes.labels(str(action)).inc()
        self.controller_max_wait_ms.set(float(max_wait_ms))
        self.controller_max_batch.set(float(max_batch))
        worst = float(worst_ms)
        self.spans.emit(
            "controller",
            action=str(action),
            max_wait_ms=float(max_wait_ms),
            max_batch=int(max_batch),
            worst_ms=worst if math.isfinite(worst) else None,
            depth=int(depth),
        )

    def poll_retraces(self) -> dict:
        """Fold the sentinel's deltas into the retrace counter + events.

        Returns the {fn: new_compiles} dict observed this poll (empty when
        nothing retraced or no sentinel is wired)."""
        sentinel = self.sentinel
        if sentinel is None:
            return {}
        hot = sentinel.retraced()
        if hot:
            for fn, n in sorted(hot.items()):
                self.retraces_total.labels(fn).inc(n)
                self.spans.emit("retrace", fn=str(fn), count=int(n))
            sentinel.reset()  # next poll counts fresh compiles only
        return hot

    # -- component registration -------------------------------------------

    def register_serve_engine(self, engine, prefix: str = "serve_engine"):
        """Register an engine-like object's ``stats`` dict as pull gauges.

        Each key becomes ``<prefix>_<key>`` read at collection time — no
        push call on the engine's loop.  Works for ``ServeEngine`` (and any
        object with a ``stats`` mapping of numbers)."""
        for key in sorted(engine.stats):
            gauge = self.registry.gauge(
                f"{prefix}_{key}", f"{type(engine).__name__}.stats[{key!r}]"
            )
            gauge.set_function(
                lambda e=engine, k=key: float(e.stats.get(k, 0))
            )
        return self

    def attach(self, index) -> "Telemetry":
        """Convenience: ``Telemetry().attach(idx)`` wires the executor."""
        index.attach_telemetry(self)
        return self

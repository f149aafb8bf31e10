"""Serving telemetry: metrics registry, span sink, pipeline instrumentation.

The port of ``repro.obs``.  Quickstart::

    from repro_torch.obs import Telemetry

    tel = Telemetry()
    idx.attach_telemetry(tel)                   # stage spans from the executor
    fe = AnnFrontend(idx, telemetry=tel)        # queue/exec decomposition
    ...serve...
    print(tel.registry.expose_text())           # Prometheus text exposition
    tel.spans.dump_jsonl("events.jsonl")        # bounded JSONL event log

Instrumentation-off (no attach, ``telemetry=None``) and -on paths return
bit-identical results — the hooks only observe.  Detached, the executor
reads no clock and records no CUDA event.
"""

from repro_torch.obs.metrics import (
    BATCH_SIZE_BUCKETS,
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    CounterFamily,
    Gauge,
    GaugeFamily,
    Histogram,
    HistogramFamily,
    MetricsRegistry,
)
from repro_torch.obs.spans import (
    STAGES,
    SpanSink,
    format_stage_table,
    percentiles_ms,
    stage_breakdown,
)
from repro_torch.obs.telemetry import Telemetry

__all__ = [
    "BATCH_SIZE_BUCKETS",
    "DEFAULT_LATENCY_BUCKETS_S",
    "Counter",
    "CounterFamily",
    "Gauge",
    "GaugeFamily",
    "Histogram",
    "HistogramFamily",
    "MetricsRegistry",
    "STAGES",
    "SpanSink",
    "Telemetry",
    "format_stage_table",
    "percentiles_ms",
    "stage_breakdown",
]

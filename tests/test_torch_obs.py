"""The port's telemetry (``repro_torch.obs``) vs the JAX package's
(``tests/test_obs.py``).

Telemetry OBSERVES, never participates: attaching it to the port's index
changes no result bit, and every aggregate it keeps is bounded.  The
registry and span sink are the reference's, copied: the same observations
render the same exposition text in both packages.  The port's retrace
sentinel counts first-use stalls (kernel-library loads, allocator segments)
and is unavailable on the CPU.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Telemetry as JTelemetry
from repro.obs import stage_breakdown as jstage_breakdown
from repro.data.synthetic import clustered_vectors
from repro_torch.analysis import RetraceSentinel
from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.core.plan import StageTimer
from repro_torch.kernels import _build
from repro_torch.obs import (
    STAGES,
    Histogram,
    MetricsRegistry,
    SpanSink,
    Telemetry,
    format_stage_table,
    percentiles_ms,
    stage_breakdown,
)
from repro_torch.serve.engine import AnnFrontend


@pytest.fixture(scope="module")
def data():
    return clustered_vectors(1200, 16, n_clusters=8, seed=0)


@pytest.fixture(scope="module")
def small_index(data):
    cfg = LannsConfig(num_shards=1, num_segments=4, segmenter="apd", engine="scan")
    return LannsIndex(cfg, device="cpu").build(data)


@pytest.fixture(scope="module")
def queries():
    return clustered_vectors(32, 16, n_clusters=8, seed=1)


class _FakeSentinel:
    """retraced()/reset() stub: one pending retrace, then quiet."""

    def __init__(self):
        self.hot = {"kernel_library_loads": 2}
        self.resets = 0

    def retraced(self):
        return dict(self.hot)

    def reset(self):
        self.hot = {}
        self.resets += 1


# ---------------------------------------------------------------------------
# histograms, registry, span sink (the reference's, copied)
# ---------------------------------------------------------------------------


def test_histogram_exact_boundary_lands_in_bucket():
    h = Histogram(buckets=(1.0, 2.0, 5.0))
    h.observe(1.0)
    h.observe(2.0)
    h.observe(1.5)
    counts, total, count = h.snapshot()
    assert counts.tolist() == [1, 2, 0, 0]
    assert count == 3 and total == pytest.approx(4.5)


def test_histogram_overflow_bucket():
    h = Histogram(buckets=(1.0, 2.0))
    h.observe(2.0000001)
    h.observe(1e9)
    counts, _, count = h.snapshot()
    assert counts.tolist() == [0, 0, 2]
    assert count == 2
    assert h.quantile(0.5) == 2.0


def test_histogram_observe_many_matches_loop():
    vals = [0.0003, 0.0005, 0.001, 0.0011, 0.049, 0.05, 0.051, 7.0]
    h1, h2 = Histogram(), Histogram()
    h1.observe_many(vals)
    for v in vals:
        h2.observe(v)
    c1, s1, n1 = h1.snapshot()
    c2, s2, n2 = h2.snapshot()
    assert np.array_equal(c1, c2) and n1 == n2 == len(vals)
    assert s1 == pytest.approx(s2)
    h1.observe_many([])
    assert h1.snapshot()[2] == len(vals)


def test_histogram_quantile_and_bounds():
    h = Histogram(buckets=(1.0, 2.0, 4.0))
    h.observe_many([0.5] * 50 + [3.0] * 50)
    assert h.quantile(0.25) == pytest.approx(0.5)
    assert 2.0 <= h.quantile(0.9) <= 4.0
    assert np.isnan(Histogram().quantile(0.5))
    with pytest.raises(ValueError):
        h.quantile(1.5)
    for bad in ((), (1.0, 1.0), (2.0, 1.0), (1.0, float("inf"))):
        with pytest.raises(ValueError):
            Histogram(buckets=bad)


def test_registry_idempotent_counters_gauges_labels():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", "help", ("a",))
    assert reg.counter("x_total", "other help", ("a",)) is c1
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", labelnames=("a", "b"))
    with pytest.raises(ValueError):
        reg.counter("9bad-name")
    c = reg.counter("ops_total")
    c.inc()
    c.inc(2.5)
    assert c.value == pytest.approx(3.5)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = reg.gauge("depth")
    state = {"v": 7}
    g.set_function(lambda: state["v"])
    state["v"] = 9
    assert g.value == 9.0
    g.set(1.0)
    assert g.value == 1.0
    fam = reg.counter("req_total", labelnames=("kind", "engine"))
    fam.labels("full", "scan").inc()
    fam.labels(kind="full", engine="scan").inc(2)
    assert fam.labels("full", "scan").value == 3.0
    with pytest.raises(ValueError):
        fam.labels("full")


def _populate(reg):
    reg.counter("req_total", "requests", ("kind",)).labels("full").inc(4)
    reg.gauge("depth", "queue depth").set(3.0)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe_many([0.05, 0.5, 2.0])
    reg.histogram("stage_seconds", "stages", ("stage",)).labels("route").observe(0.002)


def test_exposition_equals_reference():
    """The same observations render the same Prometheus text and JSON
    snapshot in both packages."""
    ours, theirs = MetricsRegistry(), JRegistry()
    _populate(ours)
    _populate(theirs)
    text = ours.expose_text()
    assert text == theirs.expose_text()
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text and text.endswith("\n")
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())


def test_telemetry_exposition_equals_reference():
    """Telemetry's metric catalog and hooks render the reference's text for
    the same hook calls; the one line that differs is the help of the
    retrace counter, which counts first-use stalls in the port."""

    class Req:
        def __init__(self, t_submit, t_start, t_done):
            self.t_submit, self.t_start, self.t_done = t_submit, t_start, t_done

    texts = []
    for cls in (Telemetry, JTelemetry):
        tel = cls(sentinel=_FakeSentinel())
        tel.on_execute(engine="hnsw", quantized="q8", merge_path="two_level", batch=300,
                       stage_s={"route": 0.001, "candidates": 0.05, "rerank": 0.002,
                                "merge": 0.003})
        tel.on_batch([Req(0.0, 0.002, 0.05), Req(0.001, 0.002, 0.05)], "deadline_batches")
        tel.on_degrade(32, 3)
        tel.on_retune(action="tighten", max_wait_ms=1.0, max_batch=64, worst_ms=12.5, depth=9)
        texts.append(tel.registry.expose_text().splitlines())
    ours, theirs = texts
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs)
    assert diff == [(
        "# HELP lanns_jit_retraces_total Watched first-use stalls (kernel-library loads, "
        "allocator segments) observed on serving traffic",
        "# HELP lanns_jit_retraces_total Watched jit recompiles observed on serving traffic",
    )]
    assert 'lanns_jit_retraces_total{fn="kernel_library_loads"} 2' in ours


def test_registry_concurrent_updates_are_exact():
    reg = MetricsRegistry()
    c = reg.counter("n_total")
    h = reg.histogram("v_seconds", buckets=(0.5,))

    def work():
        for _ in range(500):
            c.inc()
            h.observe(0.1)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 2000.0
    assert h._default().snapshot()[2] == 2000


def test_span_sink_bounded_filters_and_jsonl(tmp_path):
    sink = SpanSink(capacity=4, clock=lambda: 123.0)
    for i in range(7):
        sink.emit("plan", i=i)
    assert len(sink) == 4 and sink.dropped == 3
    assert [e["i"] for e in sink.events()] == [3, 4, 5, 6]
    with pytest.raises(ValueError):
        SpanSink(capacity=0)
    sink = SpanSink(capacity=16)
    sink.emit("plan", x=1)
    mark = sink.next_seq
    sink.emit("batch", x=2)
    sink.emit("plan", x=3)
    assert [e["x"] for e in sink.events(kind="plan", since=mark)] == [3]
    path = tmp_path / "spans.jsonl"
    assert sink.dump_jsonl(str(path)) == 3
    assert json.loads(path.read_text().splitlines()[1])["x"] == 2
    sink.clear()
    assert len(sink) == 0 and sink.next_seq == 3


def test_stage_breakdown_equals_reference():
    events = [
        {"kind": "plan", "stage_s": {"route": 0.001, "merge": 0.002}},
        {"kind": "plan", "stage_s": {"route": 0.003, "merge": 0.004}},
        {"kind": "batch", "b": 4},
    ]
    bd = stage_breakdown(events, extra={"queue": [0.01, 0.02]})
    assert bd == jstage_breakdown(events, extra={"queue": [0.01, 0.02]})
    assert list(bd) == ["queue", "route", "merge"]
    assert "p99_ms" in format_stage_table(bd)
    assert percentiles_ms([])["n"] == 0


# ---------------------------------------------------------------------------
# the bundle on the port's index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,quantized", [("scan", "none"), ("scan", "q8"),
                                              ("hnsw", "none"), ("hnsw", "q8")])
def test_attach_telemetry_bit_identical(data, queries, engine, quantized):
    """Instrumentation-off and -on return the same bits, and the executor
    records a plan span with the full stage split (the q8 paths' re-rank
    share included)."""
    cfg = LannsConfig(num_shards=2, num_segments=2, segmenter="rh", engine=engine,
                      quantized=quantized, hnsw_m=8, ef_construction=40, ef_search=40)
    idx = LannsIndex(cfg, device="cpu").build(data)
    d0, i0 = idx.query(queries, 10)
    ticks = iter(range(10_000))
    tel = Telemetry(sentinel=_FakeSentinel(), clock=lambda: float(next(ticks)))
    idx.attach_telemetry(tel)
    try:
        d1, i1 = idx.query(queries, 10)
        d2, i2 = idx.query(queries, np.where(np.arange(32) % 2, 5, 10))
    finally:
        idx.attach_telemetry(None)
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)
    d3, i3 = idx.query(queries, np.where(np.arange(32) % 2, 5, 10))
    assert np.array_equal(d2, d3) and np.array_equal(i2, i3)
    plans = tel.spans.events(kind="plan")
    assert len(plans) == 3  # one scalar group, then two knob groups
    for ev in plans:
        st = ev["stage_s"]
        assert set(st) == {"route", "candidates", "rerank", "merge"}
        assert ev["engine"] == engine and ev["quantized"] == quantized
        assert st["route"] == 1.0 and st["merge"] == 1.0  # one clock tick each
        assert (st["rerank"] > 0) == (quantized == "q8")
    assert "lanns_stage_seconds" in tel.registry.expose_text()


def test_detached_executor_makes_no_mark(small_index, queries):
    """Detached, a plan carries no timer and no stage split: no clock read,
    no event."""
    assert small_index.telemetry is None
    q = torch.from_numpy(queries)
    _, _, plan = small_index._exec.execute(q, 10)
    assert plan.timer is None and plan.stage_s is None
    small_index._exec.report(plan)  # a no-op
    assert plan.stage_s is None


def test_stage_timer_on_cpu_reads_the_clock():
    clock = iter([0.0, 1.0, 3.0, 3.5, 4.0]).__next__

    class Tel:
        pass

    tel = Tel()
    tel.clock = clock
    timer = StageTimer(torch.device("cpu"), tel)
    m0, m1 = timer.mark(), timer.mark()
    a, b = timer.mark(), timer.mark()  # one re-rank inside the candidates stage
    timer.rerank.append((a, b))
    m2, m3 = timer.mark(), 7.0
    timer.bounds = [m0, m1, m2, m3]
    assert timer.stage_seconds() == {"route": 1.0, "candidates": 2.5, "rerank": 0.5,
                                     "merge": 3.0}


def test_frontend_on_batch_counters(small_index, queries):
    idx = small_index
    tel = Telemetry(sentinel=_FakeSentinel())
    fe = AnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=1e9, telemetry=tel)
    idx.attach_telemetry(tel)
    try:
        for q in queries[:16]:
            fe.submit(q)
        fe.step()  # two full batches
    finally:
        idx.attach_telemetry(None)
    assert tel.requests_total.labels("full_batches").value == 16.0
    assert tel.batches_total.labels("full_batches").value == 2.0
    batch_evs = tel.spans.events(kind="batch")
    assert [e["b"] for e in batch_evs] == [8, 8]
    for e in batch_evs:
        assert e["queue_max_s"] >= e["queue_mean_s"] >= 0.0
    assert tel.queue_seconds._default().snapshot()[2] == 16
    assert tel.latency_seconds._default().snapshot()[2] == 16
    # the fake sentinel's pending stall was folded in at the first batch
    assert tel.retraces_total.labels("kernel_library_loads").value == 2.0


def test_retrace_poll_plumbing():
    sent = _FakeSentinel()
    tel = Telemetry(sentinel=sent)
    assert tel.poll_retraces() == {"kernel_library_loads": 2}
    assert sent.resets == 1
    assert tel.poll_retraces() == {}
    assert sent.resets == 1
    evs = tel.spans.events(kind="retrace")
    assert len(evs) == 1 and evs[0]["fn"] == "kernel_library_loads"


def test_register_serve_engine_pull_gauges():
    class Stub:
        def __init__(self):
            self.stats = {"served": 5, "rejected": 0}

    eng = Stub()
    tel = Telemetry(sentinel=_FakeSentinel())
    tel.register_serve_engine(eng, prefix="stub")
    assert "stub_served 5" in tel.registry.expose_text()
    eng.stats["served"] = 11
    assert "stub_served 11" in tel.registry.expose_text()


def test_recent_query_stats_ring(small_index, queries):
    idx = small_index
    fe = AnnFrontend(idx, topk=5, max_batch=4, max_wait_ms=1e9, collect_stats=True,
                     recent_stats_depth=3)
    for q in queries[:20]:
        fe.submit(q)
    fe.step()
    recent = fe.recent_query_stats()
    assert len(recent) == 3
    assert fe.last_query_stats is recent[-1]
    assert fe.recent_query_stats(2) == recent[-2:]
    assert fe.recent_query_stats(99) == recent
    assert fe.recent_query_stats(0) == []
    with pytest.raises(ValueError):
        AnnFrontend(idx, recent_stats_depth=0)
    fe2 = AnnFrontend(idx, topk=5, max_batch=4)
    fe2.submit(queries[0])
    fe2.flush()
    assert fe2.last_query_stats is None


# ---------------------------------------------------------------------------
# the port's retrace sentinel
# ---------------------------------------------------------------------------


def test_sentinel_unavailable_on_cpu():
    sent = RetraceSentinel(torch.device("cpu"))
    assert not sent.available
    assert sent.snapshot() == {} and sent.retraced() == {}
    sent.assert_no_retrace("cpu")  # vacuous, as the reference's without counters


def test_sentinel_counts_extra_counters():
    state = {"n": 5}
    sent = RetraceSentinel(torch.device("cpu"), extra={"stalls": lambda: state["n"]})
    assert sent.available and sent.deltas() == {"stalls": 0}
    state["n"] = 7
    assert sent.retraced() == {"stalls": 2}
    with pytest.raises(AssertionError, match="first-use stalls during serving"):
        sent.assert_no_retrace("serving")
    with sent.expect_no_retrace("quiet window"):
        pass
    with pytest.raises(AssertionError):
        with sent.expect_no_retrace("loud window"):
            state["n"] += 1


def test_build_load_count_moves_only_on_first_load(monkeypatch):
    """``_build.load`` counts a library the first time this process loads
    it, never on a cache hit: the counter the sentinel watches."""
    loaded = []
    monkeypatch.setattr(_build, "build_all", lambda sources: loaded.append(sources) or {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_LIBS", {})
    before = _build.load_count()
    first = _build.load("distance_topk.cu")
    assert _build.load_count() == before + 1
    assert _build.load("distance_topk.cu") is first
    assert _build.load_count() == before + 1 and len(loaded) == 1


def test_default_sentinel_watches_the_card_or_nothing():
    sent = Telemetry().sentinel
    assert isinstance(sent, RetraceSentinel)
    assert sent.available == torch.cuda.is_available()
    assert set(STAGES) == {"queue", "route", "candidates", "rerank", "merge"}

"""The port's ANN serving stack vs the JAX package's (``tests/test_frontend.py``,
``tests/test_async_frontend.py``, ``tests/test_controller.py``).

* ``AnnFrontend`` micro-batching, driven deterministically by a fake clock;
  its results equal ``index.query`` on the same formed batches, and over an
  index carrying the reference's graphs they equal the reference frontend's
  on the same formed batches;
* ``AsyncAnnFrontend``: bit-identical to the sync ``step()`` path, knobs
  rejected at submit, a crashed query releases every waiter, drain and
  no-drain stop, restart;
* ``SLOController``: the degrade ladder under a shared fake clock, the AIMD
  retune over fabricated telemetry, lifecycle;
* ``loadgen``: seeded poisson / fixed / mmpp gaps equal to the reference's
  ``arrival_gaps``, and short load points end to end.

Every wait takes a timeout, so a wedged batcher fails the test instead of
hanging the run.
"""

import json
import math
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.data.synthetic import clustered_vectors
from repro.serve.engine import AnnFrontend as JFrontend
from repro.serve.loadgen import arrival_gaps as jarrival_gaps
from repro_torch.analysis import RetraceSentinel
from repro_torch.convert import index_from_numpy_state
from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk
from repro_torch.kernels import _build
from repro_torch.obs import STAGES, Telemetry
from repro_torch.serve import (
    AnnFrontend,
    AnnRequest,
    AsyncAnnFrontend,
    SLOController,
    arrival_gaps,
    measure_saturation_qps,
    run_controller_ab,
    run_load_point,
)

# every wait bounds a thread the test has already made runnable, so the
# timeout only matters on a wedged box
WAIT_S = 30.0
LADDER = (32, 16)
TOPK = 10
TOL = 3e-4


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def scan_world():
    data = clustered_vectors(1500, 16, n_clusters=16, seed=0)
    queries = clustered_vectors(48, 16, n_clusters=16, seed=1)
    cfg = LannsConfig(num_shards=1, num_segments=4, segmenter="apd", engine="scan")
    idx = LannsIndex(cfg, device="cpu").build(data)
    idx.warm_traces(8, TOPK)
    return idx, queries


@pytest.fixture(scope="module")
def hnsw_world():
    """Single-segment HNSW index (ef matters), warmed for the ladder."""
    data = clustered_vectors(2000, 16, n_clusters=16, seed=0)
    queries = clustered_vectors(48, 16, n_clusters=16, seed=1)
    cfg = LannsConfig(num_shards=1, num_segments=1, segmenter="apd", engine="hnsw",
                      hnsw_m=8, ef_construction=50, ef_search=64)
    idx = LannsIndex(cfg, device="cpu").build(data)
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER)
    idx.warm_traces(8, TOPK, knobs=ctrl.warm_knobs(topk=TOPK))
    return idx, data, queries


def _stack(reqs, field):
    return np.stack([getattr(r, field) for r in reqs])


# ---------------------------------------------------------------------------
# the sync front end (fake clock)
# ---------------------------------------------------------------------------


def test_no_flush_before_deadline_or_max_batch(scan_world):
    idx, queries = scan_world
    fe = AnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=2.0, clock=FakeClock())
    for q in queries[:3]:
        fe.submit(q)
    assert fe.step() == []
    assert len(fe.pending) == 3


def test_flush_at_max_batch(scan_world):
    idx, queries = scan_world
    fe = AnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=1e9, clock=FakeClock())
    reqs = [fe.submit(q) for q in queries[:17]]
    done = fe.step()
    assert len(done) == 16
    assert fe.stats["full_batches"] == 2
    assert len(fe.pending) == 1
    assert all(r.done for r in reqs[:16]) and not reqs[16].done


def test_flush_at_deadline(scan_world):
    idx, queries = scan_world
    clock = FakeClock()
    fe = AnnFrontend(idx, topk=5, max_batch=64, max_wait_ms=2.0, clock=clock)
    req = fe.submit(queries[0])
    clock.advance(0.001)
    assert fe.step() == []
    clock.advance(0.0015)
    done = fe.step()
    assert done == [req] and req.done
    assert fe.stats["deadline_batches"] == 1
    assert req.queue_s == pytest.approx(0.0025) and req.latency_s == pytest.approx(0.0025)


def test_results_match_direct_query(scan_world):
    idx, queries = scan_world
    fe = AnnFrontend(idx, topk=TOPK, max_batch=16, max_wait_ms=1e9, clock=FakeClock())
    reqs = [fe.submit(q) for q in queries[:16]]
    fe.step()
    want_d, want_i = idx.query(queries[:16], TOPK)
    assert np.array_equal(_stack(reqs, "ids"), want_i)
    assert np.array_equal(_stack(reqs, "dists"), want_d)


def test_collect_stats_surfaces_routing(scan_world):
    idx, queries = scan_world
    fe = AnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=1e9, clock=FakeClock(),
                     collect_stats=True)
    for q in queries[:8]:
        fe.submit(q)
    assert len(fe.step()) == 8
    assert fe.last_query_stats["per_shard_topk"] <= 5
    assert fe.last_query_stats["beam_traces"] == -1  # no jit in the port
    assert 1.0 <= fe.mean_segments_visited <= idx.config.num_segments


def test_flush_drains_everything(scan_world):
    idx, queries = scan_world
    fe = AnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=1e9, clock=FakeClock())
    reqs = [fe.submit(q) for q in queries[:5]]
    done = fe.flush()
    assert len(done) == 5 and all(r.done for r in reqs)
    assert fe.pending == []
    assert fe.stats["forced_batches"] == 1 and fe.stats["completed"] == 5
    assert fe.mean_batch_size == 5.0


@pytest.fixture(scope="module")
def carried():
    """The reference's HNSW index and the port's index carrying its
    partitions and graphs (not rebuilt)."""
    data = clustered_vectors(1500, 16, n_clusters=16, seed=3)
    queries = clustered_vectors(40, 16, n_clusters=16, seed=4)
    cfg = dict(num_shards=2, num_segments=2, segmenter="rh", engine="hnsw", hnsw_m=8,
               ef_construction=40, ef_search=40)
    ref = JIndex(JConfig(**cfg)).build(data)
    parts = {}
    for sg, p in ref.partitions.items():
        parts[sg] = {"kind": p.kind, "vectors": p.vectors, "keys": p.keys}
        if p.kind == "hnsw":
            fr = p.frozen
            parts[sg].update(levels=fr.levels, adj0=fr.adj0, upper_adj=fr.upper_adj,
                             entry=fr.entry)
    port = index_from_numpy_state(cfg, ref.partitioner.segmenter.tree_arrays(), parts,
                                  device="cpu")
    return ref, port, queries


@pytest.mark.parametrize("mixed", [False, True])
def test_frontend_matches_reference_frontend(carried, mixed):
    """Over the same partitions and graphs, the same submissions form the
    same batches in both packages' front ends and give the same ids
    (distances within the parity tolerance)."""
    ref, port, queries = carried
    results = []
    for cls, idx in ((JFrontend, ref), (AnnFrontend, port)):
        clock = FakeClock()
        fe = cls(idx, topk=TOPK, max_batch=8, max_wait_ms=2.0, clock=clock)
        reqs = []
        for j, q in enumerate(queries[:37]):
            kw = {"topk": 5 + j % 3, "ef": 24 if j % 4 == 0 else None} if mixed else {}
            reqs.append(fe.submit(q, **kw))
            clock.advance(1e-4)
        fe.step()  # four full batches; five pending, not yet due
        clock.advance(3e-3)
        fe.step()  # the deadline batch
        assert fe.stats["full_batches"] == 4 and fe.stats["deadline_batches"] == 1
        results.append(reqs)
    for jr, pr in zip(*results):
        assert jr.batch_size == pr.batch_size and jr.ef_used == pr.ef_used
        np.testing.assert_array_equal(pr.ids, jr.ids)
        np.testing.assert_allclose(pr.dists, jr.dists, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the async front end
# ---------------------------------------------------------------------------


def test_bit_identical_to_sync_step(scan_world):
    """Same formed batches (FIFO slices of max_batch) => bit-identical
    results against both the sync frontend and the direct query."""
    idx, queries = scan_world
    sync = AnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9)
    sreqs = [sync.submit(q) for q in queries[:40]]
    sync.step()
    with AsyncAnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9) as fe:
        areqs = [fe.submit(q) for q in queries[:40]]
        assert all(r.wait(WAIT_S) for r in areqs)
    assert all(r.done for r in areqs)
    for a, s in zip(areqs, sreqs):
        assert np.array_equal(a.ids, s.ids) and np.array_equal(a.dists, s.dists)
    for lo in range(0, 40, 8):
        d, i = idx.query(queries[lo: lo + 8], TOPK)
        assert np.array_equal(_stack(areqs[lo: lo + 8], "ids"), i)
        assert np.array_equal(_stack(areqs[lo: lo + 8], "dists"), d)


def test_async_hnsw_bit_identical_with_telemetry(hnsw_world):
    """The HNSW index through the async front end, telemetry attached:
    every request equals ``index.query`` on its formed batch, detached."""
    idx, _, queries = hnsw_world
    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    idx.attach_telemetry(tel)
    try:
        with AsyncAnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9,
                              telemetry=tel) as fe:
            reqs = [fe.submit(q) for q in queries[:24]]
            assert all(r.wait(WAIT_S) for r in reqs)
    finally:
        idx.attach_telemetry(None)
    for lo in range(0, 24, 8):
        d, i = idx.query(queries[lo: lo + 8], TOPK)
        assert np.array_equal(_stack(reqs[lo: lo + 8], "ids"), i)
        assert np.array_equal(_stack(reqs[lo: lo + 8], "dists"), d)
    assert len(tel.spans.events(kind="plan")) == 3
    assert tel.batches_total.labels("full_batches").value == 3.0


def test_deadline_flush_without_new_submits(scan_world):
    """The batcher thread wakes itself at the max_wait deadline."""
    idx, queries = scan_world
    fe = AsyncAnnFrontend(idx, topk=5, max_batch=64, max_wait_ms=20.0)
    fe.start()
    try:
        reqs = [fe.submit(q) for q in queries[:3]]
        assert all(r.wait(WAIT_S) for r in reqs)
        assert all(r.done for r in reqs)
        assert fe.stats["deadline_batches"] >= 1
    finally:
        fe.stop(timeout=WAIT_S)


def test_timestamps_ordered(scan_world):
    idx, queries = scan_world
    with AsyncAnnFrontend(idx, topk=5, max_batch=4, max_wait_ms=5.0) as fe:
        reqs = [fe.submit(q) for q in queries[:4]]
        assert all(r.wait(WAIT_S) for r in reqs)
    for r in reqs:
        assert r.t_submit <= r.t_start <= r.t_done
        assert r.latency_s >= r.queue_s >= 0.0


def test_graceful_drain_with_in_flight(scan_world):
    idx, queries = scan_world
    fe = AsyncAnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=1e9)
    fe.start()
    reqs = [fe.submit(q) for q in queries[:21]]
    completed = fe.stop(drain=True, timeout=WAIT_S)
    assert all(r.done for r in reqs) and not any(r.cancelled for r in reqs)
    assert len(completed) == 21
    assert fe.batch_hist.get(8) == 2 and fe.batch_hist.get(5) == 1


def test_stop_without_drain_cancels(scan_world):
    idx, queries = scan_world
    fe = AsyncAnnFrontend(idx, topk=5, max_batch=64, max_wait_ms=1e9)
    fe.start()
    reqs = [fe.submit(q) for q in queries[:3]]
    fe.stop(drain=False, timeout=WAIT_S)
    assert all(r.wait(WAIT_S) for r in reqs)
    assert all(r.cancelled and not r.done for r in reqs)
    with pytest.raises(RuntimeError):
        fe.submit(queries[0])


def test_stop_without_drain_beats_full_queue(scan_world):
    """With >= max_batch pending, stop(drain=False) cancels instead of
    serving full batches.  A gate holds the first batch inside
    ``index.query`` until the stop has landed, so the rest are pending."""
    idx, queries = scan_world
    entered, gate = threading.Event(), threading.Event()

    class Gated:
        def query(self, *a, **kw):
            entered.set()
            assert gate.wait(WAIT_S)
            return idx.query(*a, **kw)

    fe = AsyncAnnFrontend(Gated(), topk=5, max_batch=4, max_wait_ms=1e9)
    fe.start()
    reqs = [fe.submit(q) for q in queries[:32]]
    assert entered.wait(WAIT_S)
    stopper = threading.Thread(target=fe.stop, kwargs={"drain": False, "timeout": WAIT_S})
    stopper.start()
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        with fe._cond:
            if fe._stopping:
                break
        time.sleep(1e-3)
    gate.set()
    stopper.join(WAIT_S)
    assert not stopper.is_alive()
    assert all(r.wait(WAIT_S) for r in reqs)
    for r in reqs:
        assert r.done != r.cancelled  # exactly one outcome, none stranded
    assert [r.done for r in reqs] == [True] * 4 + [False] * 28  # only the gated batch ran


def test_lifecycle_errors(scan_world):
    idx, queries = scan_world
    fe = AsyncAnnFrontend(idx, topk=5, max_batch=8)
    with pytest.raises(RuntimeError):
        fe.submit(queries[0])
    fe.start()
    with pytest.raises(RuntimeError):
        fe.start()
    with pytest.raises(RuntimeError):
        fe.step()
    with pytest.raises(RuntimeError):
        fe.flush()
    fe.stop(timeout=WAIT_S)
    fe.start()
    req = fe.submit(queries[0])
    fe.stop(drain=True, timeout=WAIT_S)
    assert req.done


def test_batcher_crash_releases_all_waiters(scan_world):
    """A query() crash cancels the in-flight batch AND everything still
    pending, surfaces on the next submit, and never hangs.  The crash waits
    on a gate until every submission is in, instead of sleeping."""
    _, queries = scan_world
    gate = threading.Event()

    class Boom:
        def query(self, *a, **kw):
            assert gate.wait(WAIT_S)
            raise ValueError("boom")

    fe = AsyncAnnFrontend(Boom(), topk=5, max_batch=2, max_wait_ms=1e9)
    fe.start()
    reqs = [fe.submit(q) for q in queries[:5]]
    gate.set()
    assert all(r.wait(WAIT_S) for r in reqs)
    assert all(r.cancelled and not r.done for r in reqs)
    with pytest.raises(RuntimeError, match="batcher thread died"):
        fe.submit(queries[0])
    fe.stop(timeout=WAIT_S)


def test_device_setup_failure_releases_all_waiters(scan_world, monkeypatch):
    """The batcher makes the index's CUDA device its own before serving; if
    that fails, every waiter is released and the error surfaces at submit
    (the loop must never die leaving requests blocked)."""
    idx, queries = scan_world
    gate = threading.Event()

    def set_device(dev):
        assert gate.wait(WAIT_S)
        raise RuntimeError("no such device")

    monkeypatch.setattr(torch.cuda, "set_device", set_device)

    class OnCard:
        device = torch.device("cuda", 0)

        def query(self, *a, **kw):
            return idx.query(*a, **kw)

    fe = AsyncAnnFrontend(OnCard(), topk=5, max_batch=2, max_wait_ms=1e9)
    fe.start()
    reqs = [fe.submit(q) for q in queries[:3]]
    gate.set()
    assert all(r.wait(WAIT_S) for r in reqs)
    assert all(r.cancelled and not r.done for r in reqs)
    with pytest.raises(RuntimeError, match="batcher thread died"):
        fe.submit(queries[0])
    fe.stop(timeout=WAIT_S)


def test_restart_after_crash_is_clean(scan_world):
    idx, queries = scan_world

    class Flaky:
        def __init__(self, real):
            self.real, self.broken = real, True

        def query(self, *a, **kw):
            if self.broken:
                raise ValueError("boom")
            return self.real.query(*a, **kw)

    flaky = Flaky(idx)
    fe = AsyncAnnFrontend(flaky, topk=5, max_batch=2, max_wait_ms=1e9)
    fe.start()
    bad = [fe.submit(q) for q in queries[:2]]
    assert all(r.wait(WAIT_S) for r in bad) and fe.error is not None
    fe.stop(timeout=WAIT_S)
    flaky.broken = False
    fe.start()
    assert fe.error is None and fe.completed == []
    good = fe.submit(queries[0])
    completed = fe.stop(drain=True, timeout=WAIT_S)
    assert good.done and not good.cancelled
    assert completed == [good]


def test_collect_stats_flow_through(scan_world):
    idx, queries = scan_world
    with AsyncAnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=5.0,
                          collect_stats=True) as fe:
        reqs = [fe.submit(q) for q in queries[:8]]
        assert all(r.wait(WAIT_S) for r in reqs)
    qs = fe.last_query_stats
    assert qs["merge_path"] == "disjoint"
    assert "beam_traces" in qs and "scan_traces" in qs
    assert 1.0 <= fe.mean_segments_visited <= idx.config.num_segments


def test_concurrent_submitters(scan_world):
    idx, queries = scan_world
    out: list = []
    lock = threading.Lock()
    with AsyncAnnFrontend(idx, topk=5, max_batch=8, max_wait_ms=2.0) as fe:

        def producer(ci):
            reqs = [fe.submit(queries[(ci * 12 + j) % len(queries)]) for j in range(12)]
            with lock:
                out.extend(reqs)

        threads = [threading.Thread(target=producer, args=(ci,)) for ci in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert all(r.wait(WAIT_S) for r in out)
    assert len(out) == 48 and all(r.done for r in out)
    assert len({r.uid for r in out}) == 48
    assert fe.stats["completed"] == 48
    assert sum(b * c for b, c in fe.batch_hist.items()) == 48


def test_async_per_request_knobs_bit_identical(hnsw_world):
    idx, _, queries = hnsw_world
    with AsyncAnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9) as fe:
        reqs = [fe.submit(queries[j], topk=(5 if j % 2 else None),
                          ef=(32 if j in (2, 3) else None)) for j in range(8)]
        assert all(r.wait(WAIT_S) for r in reqs)
    tk = np.array([TOPK if r.topk is None else r.topk for r in reqs])
    ef = np.array([0 if r.ef is None else r.ef for r in reqs])
    d, i = idx.query(queries[:8], tk, ef=ef)
    for j, r in enumerate(reqs):
        assert r.ids.shape == (tk[j],)
        assert np.array_equal(r.ids, i[j, : tk[j]]) and np.array_equal(r.dists, d[j, : tk[j]])


def test_invalid_knobs_fail_at_submit_not_in_batcher(scan_world):
    idx, queries = scan_world
    with AsyncAnnFrontend(idx, topk=TOPK, max_batch=4, max_wait_ms=5.0) as fe:
        with pytest.raises(ValueError, match="topk"):
            fe.submit(queries[0], topk=0)
        with pytest.raises(ValueError, match="ef"):
            fe.submit(queries[0], ef=-5)
        for bad in (-1.0, float("nan"), 0.0, float("inf")):
            with pytest.raises(ValueError, match="deadline_ms"):
                fe.submit(queries[0], deadline_ms=bad)
        good = fe.submit(queries[1], topk=3, deadline_ms=50.0)
        assert good.wait(WAIT_S) and good.done and good.deadline_ms == 50.0
        assert fe.error is None
    sync = AnnFrontend(idx, topk=TOPK, max_batch=4)
    with pytest.raises(ValueError, match="topk"):
        sync.submit(queries[0], topk=0)


def test_retune_validation():
    with pytest.raises(ValueError, match="max_batch"):
        AnnFrontend.retune(AnnFrontend.__new__(AnnFrontend), max_batch=0)
    with pytest.raises(ValueError, match="max_wait_ms"):
        AnnFrontend.retune(AnnFrontend.__new__(AnnFrontend), max_wait_ms=float("nan"))


def test_published_fields_in_assignment_order():
    """Waiters read the published fields lock-free once the event fires:
    the timestamps come before ``dists``/``ids`` (``done`` flips on ids)."""
    f = AnnRequest._PUBLISHED_FIELDS
    assert f.index("t_start") < f.index("dists") < f.index("ids")
    assert f.index("t_done") < f.index("ids") and f.index("batch_size") < f.index("ids")


def test_batcher_thread_runs_on_the_index_device(scan_world):
    """The batcher thread alone calls ``index.query``; on the CPU index it
    leaves the (per-thread) current CUDA device alone."""
    idx, queries = scan_world
    seen = []

    class Spy:
        device = idx.device

        def query(self, *a, **kw):
            seen.append(threading.current_thread().name)
            return idx.query(*a, **kw)

    with AsyncAnnFrontend(Spy(), topk=5, max_batch=2, max_wait_ms=1e9) as fe:
        reqs = [fe.submit(q) for q in queries[:4]]
        assert all(r.wait(WAIT_S) for r in reqs)
    assert seen == ["ann-batcher", "ann-batcher"]


# ---------------------------------------------------------------------------
# the SLO controller (fake clock)
# ---------------------------------------------------------------------------


def test_degrade_bit_identical_to_handbuilt_mixed_batch(hnsw_world):
    idx, _, queries = hnsw_world
    clk = FakeClock()
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER, clock=clk)
    fe = AnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9, clock=clk, controller=ctrl)
    r0 = fe.submit(queries[0], deadline_ms=5.0)
    clk.advance(4e-3)
    r1 = fe.submit(queries[1], deadline_ms=20.0)
    r2 = fe.submit(queries[2])
    r3 = fe.submit(queries[3], ef=8, deadline_ms=1.0)
    clk.advance(8e-3)
    fe.flush()
    assert [r.degraded for r in (r0, r1, r2, r3)] == [True, False, False, False]
    assert r0.ef_used == LADDER[1]
    assert r1.ef_used is None and r2.ef_used is None
    assert r3.ef_used == 8
    assert ctrl.snapshot()["degraded"] == 1
    q = np.stack([queries[j] for j in range(4)])
    d, i = idx.query(q, np.full(4, TOPK, np.int64), ef=np.array([LADDER[1], 0, 0, 8], np.int64))
    for j, r in enumerate((r0, r1, r2, r3)):
        assert np.array_equal(r.ids, i[j]) and np.array_equal(r.dists, d[j])


def test_degrade_rung_deepens_with_lateness(hnsw_world):
    idx, _, queries = hnsw_world
    clk = FakeClock()
    ctrl = SLOController(slo_ms=1e6, ef_ladder=LADDER, clock=clk)
    fe = AnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9, clock=clk, controller=ctrl)
    r_rung0 = fe.submit(queries[0], deadline_ms=10.0)
    r_clamp = fe.submit(queries[1], deadline_ms=2.0)
    clk.advance(15e-3)
    fe.flush()
    assert r_rung0.ef_used == LADDER[0]
    assert r_clamp.ef_used == LADDER[-1]


def test_controller_ef_switch_loads_no_kernel_library(hnsw_world):
    """After ``warm_traces(knobs=ctrl.warm_knobs())``, controller-driven ef
    switches load no kernel library (the sentinel's watched counter; the
    allocator counter exists only on the card)."""
    idx, _, queries = hnsw_world
    clk = FakeClock()
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER, clock=clk)
    fe = AnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=1e9, clock=clk, controller=ctrl)
    sentinel = RetraceSentinel(idx.device, extra={"kernel_library_loads": _build.load_count})
    for late in ({0, 3}, {2, 7}):
        reqs = [fe.submit(queries[j], deadline_ms=1.0 if j in late else 1e6) for j in range(8)]
        clk.advance(3.5e-3)
        fe.flush()
        assert sum(r.degraded for r in reqs) == 2
    sentinel.assert_no_retrace("controller-driven ef switch")


def test_degrade_disabled_without_budget(scan_world):
    idx, queries = scan_world
    clk = FakeClock()
    ctrl = SLOController(slo_ms=1.0, ef_ladder=LADDER, default_deadline_ms=None, clock=clk)
    fe = AnnFrontend(idx, topk=TOPK, max_batch=4, max_wait_ms=1e9, clock=clk, controller=ctrl)
    r = fe.submit(queries[0])
    clk.advance(5.0)
    fe.flush()
    assert not r.degraded and ctrl.snapshot()["degraded"] == 0


def test_retune_tighten_relax_hold_cycle(scan_world):
    idx, _ = scan_world
    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER, min_wait_ms=0.5)
    fe = AsyncAnnFrontend(idx, topk=TOPK, max_batch=8, max_wait_ms=4.0, telemetry=tel,
                          controller=ctrl)
    assert ctrl.retune_once() == "hold"
    tel.spans.emit("batch", batch_kind="full_batches", b=8, exec_s=20e-3, queue_mean_s=1e-3,
                   queue_max_s=5e-3)
    assert ctrl.retune_once() == "tighten"
    assert fe.max_wait_s == pytest.approx(2e-3)
    assert ctrl.retune_once() == "relax"
    assert fe.max_wait_s == pytest.approx(3e-3)
    assert ctrl.retune_once() == "relax"
    assert fe.max_wait_s == pytest.approx(4e-3)
    assert ctrl.retune_once() == "hold"
    snap = ctrl.snapshot()
    assert snap["ticks"] == 5 and snap["tighten"] == 1 and snap["relax"] == 2
    assert len(tel.spans.events(kind="controller")) == 5
    assert 'lanns_controller_retunes_total{action="tighten"} 1' in tel.registry.expose_text()
    for _ in range(10):
        tel.spans.emit("batch", batch_kind="full_batches", b=8, exec_s=50e-3,
                       queue_mean_s=0.0, queue_max_s=0.0)
        ctrl.retune_once()
    assert fe.max_wait_s == pytest.approx(0.5e-3)


def test_retune_tightens_on_queue_depth_alone(scan_world):
    idx, queries = scan_world
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER)
    fe = AsyncAnnFrontend(idx, topk=TOPK, max_batch=4, max_wait_ms=4.0, controller=ctrl)
    with fe._cond:
        fe.pending.extend(AnnRequest(j, queries[0], 0.0) for j in range(9))
    assert ctrl.retune_once() == "tighten"
    assert fe.max_wait_s == pytest.approx(2e-3)


def test_controller_constructor_validation():
    good = dict(slo_ms=10.0, ef_ladder=(32, 16))
    SLOController(**good)
    for bad in (
        dict(good, slo_ms=0.0), dict(good, slo_ms=float("nan")), dict(good, ef_ladder=()),
        dict(good, ef_ladder=(16, 32)), dict(good, ef_ladder=(16, 16)),
        dict(good, ef_ladder=(16, 0)), dict(good, default_deadline_ms=-1.0),
        dict(good, interval_s=0.0), dict(good, min_wait_ms=0.0),
        dict(good, tighten_factor=1.0), dict(good, relax_factor=1.0),
        dict(good, relax_margin=1.5),
    ):
        with pytest.raises(ValueError):
            SLOController(**bad)
    ctrl = SLOController(slo_ms=5.0, ef_ladder=(48, 24, 12))
    assert ctrl.warm_knobs() == [(None, 48), (None, 24), (None, 12)]
    assert ctrl.warm_knobs(topk=20) == [(20, 48), (20, 24), (20, 12)]


def test_controller_lifecycle_and_binding(scan_world):
    idx, queries = scan_world
    ctrl = SLOController(slo_ms=10.0, ef_ladder=LADDER, interval_s=0.01)
    with pytest.raises(RuntimeError, match="bind"):
        ctrl.start()
    assert ctrl.retune_once() == "unbound"
    fe = AsyncAnnFrontend(idx, topk=TOPK, max_batch=4, max_wait_ms=1.0, controller=ctrl)
    assert fe.controller is ctrl and ctrl.frontend is fe
    with pytest.raises(RuntimeError, match="already bound"):
        AsyncAnnFrontend(idx, topk=TOPK, controller=ctrl)
    ctrl.bind(fe)
    with fe, ctrl:
        with pytest.raises(RuntimeError, match="already started"):
            ctrl.start()
        req = fe.submit(queries[0], deadline_ms=100.0)
        assert req.wait(WAIT_S)
    assert not ctrl.running
    ctrl.stop(timeout=WAIT_S)
    ctrl.start()
    ctrl.stop(timeout=WAIT_S)
    assert not ctrl.running


# ---------------------------------------------------------------------------
# load generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("process,kw", [
    ("poisson", {}), ("fixed", {}), ("mmpp", {}),
    ("mmpp", {"mmpp_on_frac": 1.0}), ("mmpp", {"mmpp_on_frac": 0.25, "mmpp_cycle_s": 0.05}),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_gaps_equal_reference(process, kw, seed):
    g = arrival_gaps(process, 400.0, 3000, seed=seed, **kw)
    assert np.array_equal(g, jarrival_gaps(process, 400.0, 3000, seed=seed, **kw))


def test_arrival_gaps_seeded_and_validated():
    g1 = arrival_gaps("poisson", 100.0, 64, seed=7)
    assert np.array_equal(g1, arrival_gaps("poisson", 100.0, 64, seed=7))
    assert not np.array_equal(g1, arrival_gaps("poisson", 100.0, 64, seed=8))
    assert (g1 > 0).all()
    gm = arrival_gaps("mmpp", 400.0, 3000, seed=11)
    gp = arrival_gaps("poisson", 400.0, 3000, seed=11)
    assert (gm.std() / gm.mean()) ** 2 > 3.0 * (gp.std() / gp.mean()) ** 2
    for args, kw in ((("closed", 100.0, 8), {}), (("poisson", 0.0, 8), {}),
                     (("weibull", 100.0, 8), {}), (("mmpp", 100.0, 8), {"mmpp_on_frac": 0.0}),
                     (("mmpp", 100.0, 8), {"mmpp_cycle_s": 0.0})):
        with pytest.raises(ValueError):
            arrival_gaps(*args, **kw)


def test_run_load_point_poisson_with_telemetry(scan_world):
    idx, queries = scan_world
    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    res = run_load_point(idx, queries, process="poisson", rate_qps=300.0, duration_s=0.3,
                         topk=5, max_batch=8, max_wait_ms=2.0, seed=3, telemetry=tel)
    assert idx.telemetry is None  # restored after the point
    assert res.completed > 0 and res.cancelled == 0 and res.completed == res.submitted
    assert res.p50_ms <= res.p95_ms <= res.p99_ms
    assert sum(b * c for b, c in res.batch_hist.items()) == res.completed
    assert set(STAGES) <= set(res.stage_breakdown)
    assert res.stage_breakdown["queue"]["n"] == res.completed
    assert res.mean_queue_ms + res.mean_exec_ms == pytest.approx(res.mean_ms, rel=1e-6)
    assert "p99_ms" in json.dumps(res.row())


def test_run_load_point_closed_and_validation(scan_world):
    idx, queries = scan_world
    res = measure_saturation_qps(idx, queries, duration_s=0.3, topk=5, max_batch=8,
                                 max_wait_ms=2.0, concurrency=4)
    assert res.process == "closed" and res.concurrency == 4
    assert np.isnan(res.offered_qps)
    assert res.completed > 0 and res.cancelled == 0 and res.mean_batch <= 8
    with pytest.raises(ValueError):
        run_load_point(idx, queries, process="poisson", rate_qps=None)
    with pytest.raises(ValueError):
        run_load_point(idx, queries, process="uniform", rate_qps=10.0)


def test_run_load_point_mmpp_with_knob_mix(hnsw_world):
    idx, _, queries = hnsw_world
    res = run_load_point(idx, queries, process="mmpp", rate_qps=300.0, duration_s=0.3,
                         topk=TOPK, max_batch=8, max_wait_ms=2.0, seed=5,
                         knob_mix=[(None, None), (5, None), (20, 48)])
    assert res.completed > 0 and res.completed == res.submitted


def test_run_controller_ab_smoke(hnsw_world):
    idx, data, queries = hnsw_world
    gt_ids = brute_force_topk(queries, data, TOPK, device="cpu")[1]
    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    off, on, ctrl = run_controller_ab(
        idx, queries, rate_qps=200.0, slo_ms=8.0, ef_ladder=LADDER, duration_s=0.3, seed=3,
        topk=TOPK, max_batch=8, max_wait_ms=2.0, gt_ids=gt_ids, telemetry=tel,
    )
    for res in (off, on):
        assert res.completed > 0 and res.completed == res.submitted
        assert res.slo_ms == 8.0 and 0.0 <= res.slo_attainment <= 1.0
        assert 0.0 <= res.mean_recall <= 1.0
        json.dumps(res.row())
    assert not off.controller_on and on.controller_on and off.degraded == 0
    assert ctrl.snapshot()["ticks"] > 0 and ctrl.snapshot()["degraded"] == on.degraded


def test_run_load_point_slo_accounting_without_controller(scan_world):
    idx, queries = scan_world
    res = run_load_point(idx, queries, process="poisson", rate_qps=200.0, duration_s=0.2,
                         topk=TOPK, max_batch=8, max_wait_ms=1.0, seed=7, deadline_ms=1e6,
                         slo_ms=1e6)
    assert res.completed > 0 and res.slo_attainment == 1.0
    assert res.degraded == 0 and not res.controller_on and math.isnan(res.mean_recall)

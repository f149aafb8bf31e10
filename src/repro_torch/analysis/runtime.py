"""Runtime concurrency instrumentation: lock-order recording + race stress.

The port of ``repro.analysis.runtime``, over the port's ``AsyncAnnFrontend``
and ``SLOController``.  One divergence: ``race_stress`` takes an optional
``queries=`` array (and a ``device``), so that it can drive an index of any
width — on the card, the paper cell's d = 128 — where the reference always
draws 8-wide queries.  With ``queries=None`` it draws the reference's.

``InstrumentedLock`` wraps an RLock and reports every acquisition to a
process-wide ``LockOrderRegistry``, which maintains the directed
held-before graph across threads; a cycle in that graph is a potential
deadlock even if the schedule that would deadlock never ran.  The wrapper
implements ``_release_save``/``_acquire_restore``/``_is_owned`` so it can
back a ``threading.Condition`` (``wait()`` keeps the held-stack honest).

``instrument_frontend`` swaps an ``AsyncAnnFrontend``'s locks for
instrumented ones (BEFORE ``start()``) and wraps its guarded dicts in
``GuardedDict``, which asserts the declared lock is held on every mutation
— the runtime twin of the static LANNS010 pass.

``race_stress`` is the seeded multi-submitter churn driver used by
``python -m repro_torch.analysis --race-stress``, the tests and the card's
smoke run: repeated
submit/stop(drain)/restart cycles under N submitter threads, with lock
orders recorded and invariants checked after every cycle.

None of this is imported by serving code: production frontends run plain
``threading`` primitives with zero analysis overhead.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class LockOrderRegistry:
    """Held-before edges across all instrumented locks, per process."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.edges: dict[tuple[str, str], int] = {}

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def on_acquire_attempt(self, name: str) -> None:
        held = self._held()
        if name in held:  # re-entrant re-acquire: no new ordering fact
            return
        if held:
            with self._mu:
                for h in set(held):
                    self.edges[(h, name)] = self.edges.get((h, name), 0) + 1

    def on_acquired(self, name: str) -> None:
        self._held().append(name)

    def on_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def cycles(self) -> list[list[str]]:
        """Every elementary cycle in the held-before graph (DFS)."""
        with self._mu:
            adj: dict[str, set[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, set()).add(b)
        out: list[list[str]] = []
        state: dict[str, int] = {}  # 0 unvisited / 1 on stack / 2 done
        stack: list[str] = []

        def dfs(node: str) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in sorted(adj.get(node, ())):
                if state.get(nxt, 0) == 1:
                    out.append(stack[stack.index(nxt):] + [nxt])
                elif state.get(nxt, 0) == 0:
                    dfs(nxt)
            stack.pop()
            state[node] = 2

        for node in sorted(adj):
            if state.get(node, 0) == 0:
                dfs(node)
        return out

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            raise AssertionError(
                f"lock-order cycles detected: {cyc} (edges={self.edges})"
            )


class InstrumentedLock:
    """RLock wrapper reporting to a LockOrderRegistry; Condition-capable."""

    def __init__(self, name: str, registry: LockOrderRegistry) -> None:
        self.name = name
        self.registry = registry
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self.registry.on_acquire_attempt(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self.registry.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self.registry.on_released(self.name)

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition integration: wait() parks via _release_save and re-enters
    # via _acquire_restore; both must keep the registry's held-stack honest.
    def _release_save(self):
        state = self._lock._release_save()
        self.registry.on_released(self.name)
        return state

    def _acquire_restore(self, state) -> None:
        self.registry.on_acquire_attempt(self.name)
        self._lock._acquire_restore(state)
        self.registry.on_acquired(self.name)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()


class GuardedDict(dict):
    """Dict that asserts its lock is held on every mutation."""

    def __init__(self, data: dict, lock: InstrumentedLock, name: str) -> None:
        super().__init__(data)
        self._lock = lock
        self._name = name
        self.violations: list[str] = []

    def _check(self, op: str) -> None:
        if not self._lock._is_owned():
            self.violations.append(
                f"{self._name}.{op} without holding {self._lock.name} "
                f"(thread {threading.current_thread().name})"
            )

    def __setitem__(self, k, v) -> None:
        self._check(f"__setitem__[{k!r}]")
        super().__setitem__(k, v)

    def __delitem__(self, k) -> None:
        self._check(f"__delitem__[{k!r}]")
        super().__delitem__(k)


def instrument_frontend(fe, registry: LockOrderRegistry):
    """Swap an (unstarted) AsyncAnnFrontend's locks for instrumented ones
    and wrap its guarded dicts.  Returns the list the guarded-mutation
    violations accumulate into."""
    if getattr(fe, "_thread", None) is not None:
        raise RuntimeError("instrument before start(): the batcher thread "
                           "must only ever see the instrumented locks")
    fe._cond = threading.Condition(InstrumentedLock("_cond", registry))
    fe._stats_lock = InstrumentedLock("_stats_lock", registry)
    stats = GuardedDict(fe.stats, fe._stats_lock, "stats")
    hist = GuardedDict(fe.batch_hist, fe._stats_lock, "batch_hist")
    fe.stats, fe.batch_hist = stats, hist
    violations = stats.violations
    hist.violations = violations  # shared sink
    return violations


def instrument_controller(ctrl, registry: LockOrderRegistry):
    """Same treatment for an (unstarted) ``SLOController``: its ``_lock``
    condition becomes instrumented (named ``ctrl_lock`` so the held-before
    graph separates it from the frontend's ``_cond``) and its ``stats``
    dict asserts the lock on every mutation.  Must run before
    ``ctrl.start()`` AND before the bound frontend ``start()``s — both
    threads must only ever see the instrumented lock."""
    if getattr(ctrl, "_thread", None) is not None:
        raise RuntimeError("instrument before start(): the controller "
                           "thread must only ever see the instrumented lock")
    inner = InstrumentedLock("ctrl_lock", registry)
    ctrl._lock = threading.Condition(inner)
    stats = GuardedDict(ctrl.stats, inner, "ctrl.stats")
    ctrl.stats = stats
    return stats.violations


@dataclass
class StressReport:
    cycles_run: int = 0
    submitted: int = 0
    completed: int = 0
    cancelled: int = 0
    retunes: int = 0
    degraded: int = 0
    lock_edges: dict = field(default_factory=dict)
    lock_cycles: list = field(default_factory=list)
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.lock_cycles and not self.violations

    def render(self) -> str:
        lines = [
            f"race-stress: {self.cycles_run} lifecycle cycles, "
            f"{self.submitted} submitted, {self.completed} completed, "
            f"{self.cancelled} cancelled, {self.retunes} controller ticks, "
            f"{self.degraded} deadline degrades",
            f"lock-order edges observed: "
            f"{sorted(self.lock_edges) or '(none)'}",
        ]
        if self.lock_cycles:
            lines.append(f"LOCK-ORDER CYCLES: {self.lock_cycles}")
        lines.extend(f"VIOLATION: {v}" for v in self.violations)
        if self.ok:
            lines.append("no lock-order cycles, no guarded-attribute "
                         "violations")
        return "\n".join(lines)


def _check_invariants(fe, report: StressReport) -> None:
    """Counter consistency that torn (unlocked) updates would break."""
    stats = fe.stats
    if sum(fe.batch_hist.values()) != stats["batches"]:
        report.violations.append(
            f"batch_hist total {sum(fe.batch_hist.values())} != "
            f"stats['batches'] {stats['batches']}"
        )
    if sum(b * n for b, n in fe.batch_hist.items()) != stats["completed"]:
        report.violations.append(
            "batch_hist-weighted completion count != stats['completed']"
        )
    if len(fe.completed) != stats["completed"]:
        report.violations.append(
            f"completed list {len(fe.completed)} != stats['completed'] "
            f"{stats['completed']}"
        )
    for r in fe.completed:
        if r.ids is None or r.dists is None or r.batch_size < 1:
            report.violations.append(
                f"request {r.uid} completed but half-published"
            )


def race_stress(threads: int = 8, duration_s: float = 30.0, seed: int = 0,
                index=None, progress=None, *, queries=None,
                device=None) -> StressReport:
    """Seeded submit/stop/drain churn over an instrumented frontend
    + bound SLO controller.

    Each lifecycle cycle builds a fresh ``AsyncAnnFrontend`` with a bound
    ``SLOController`` over a shared small index, instruments both, runs
    ``threads`` seeded submitters (some requests carrying tight
    ``deadline_ms`` budgets, so the degrade path runs concurrently with
    submission) for a slice of the budget, churns the controller thread
    mid-slice (stop / manual retune / live ``fe.retune`` / restart), then
    stops everything — alternating drain=True/False AND controller-stop
    before/after frontend-stop — and checks counter invariants plus
    request publication integrity.  Lock orders accumulate in one registry
    across all cycles.

    ``index=None`` builds the reference's small scan index on ``device``
    (the card unless the caller names another); ``queries=None`` draws the
    reference's 256 queries of width 8, else rows of ``queries`` (numpy,
    the index's width) are submitted.
    """
    import numpy as np

    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.serve.controller import SLOController
    from repro_torch.serve.engine import AsyncAnnFrontend

    if index is None:
        from repro_torch.core import LannsConfig, LannsIndex

        data = clustered_vectors(600, 8, n_clusters=8, seed=seed)
        cfg = LannsConfig(num_shards=1, num_segments=2, segmenter="apd",
                          engine="scan")
        index = LannsIndex(cfg, device=device).build(data)
    if queries is None:
        queries = clustered_vectors(256, 8, n_clusters=8, seed=seed + 1)
    queries = np.asarray(queries, np.float32)

    registry = LockOrderRegistry()
    report = StressReport()
    telemetry = Telemetry()  # shared: the span ring is bounded by design
    deadline = time.monotonic() + duration_s
    cycle = 0
    while time.monotonic() < deadline:
        drain = cycle % 2 == 0
        ctrl = SLOController(slo_ms=3.0, ef_ladder=(12, 6),
                             interval_s=0.01, min_wait_ms=0.05)
        fe = AsyncAnnFrontend(index, topk=10, max_batch=8, max_wait_ms=1.0,
                              telemetry=telemetry, controller=ctrl)
        violations = instrument_frontend(fe, registry)
        ctrl_violations = instrument_controller(ctrl, registry)
        fe.start()
        ctrl.start()
        stop_flag = threading.Event()
        counts = [0] * threads

        def submitter(tid: int, fe=fe, stop_flag=stop_flag, counts=counts,
                      cycle=cycle):
            rng = np.random.default_rng(seed * 1000 + cycle * 100 + tid)
            while not stop_flag.is_set():
                q = queries[rng.integers(len(queries))]
                # half the requests carry a budget; 0.5 ms is already blown
                # at formation, so degrades happen under live churn
                ddl = (
                    float(rng.choice([0.5, 3.0, 20.0]))
                    if rng.random() < 0.5 else None
                )
                try:
                    req = fe.submit(q, topk=int(rng.choice([5, 10])),
                                    deadline_ms=ddl)
                except RuntimeError:
                    return  # frontend stopping/stopped: expected during churn
                counts[tid] += 1
                if rng.random() < 0.3:
                    req.wait(timeout=5.0)

        workers = [
            threading.Thread(target=submitter, args=(t,), daemon=True)
            for t in range(threads)
        ]
        for w in workers:
            w.start()
        slice_s = min(1.0, max(0.2, deadline - time.monotonic()))
        time.sleep(slice_s / 2)
        # controller churn under live traffic: thread restart, a manual
        # tick while it is down, and an operator-style live retune
        ctrl.stop()
        ctrl.retune_once()
        fe.retune(max_wait_ms=0.8)
        ctrl.start()
        time.sleep(slice_s / 2)
        stop_flag.set()
        if cycle % 2 == 0:  # alternate controller-stop vs frontend-stop order
            ctrl.stop()
            completed = fe.stop(drain=drain)
        else:
            completed = fe.stop(drain=drain)
            ctrl.stop()
        for w in workers:
            w.join(timeout=10.0)
            if w.is_alive():
                report.violations.append("submitter thread failed to exit")
        if fe.error is not None:
            report.violations.append(f"batcher died: {fe.error!r}")
        _check_invariants(fe, report)
        snap = ctrl.snapshot()
        report.cycles_run += 1
        report.submitted += sum(counts)
        report.completed += len(completed)
        report.cancelled += sum(counts) - len(completed)
        report.retunes += snap["ticks"]
        report.degraded += snap["degraded"]
        report.violations.extend(violations)
        report.violations.extend(ctrl_violations)
        if progress is not None:
            progress(report)
        cycle += 1
    report.lock_edges = dict(registry.edges)
    report.lock_cycles = registry.cycles()
    return report

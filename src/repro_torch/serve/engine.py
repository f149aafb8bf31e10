"""Serving engines: the port of ``repro.serve.engine`` — LM continuous
batching and the ANN micro-batching front ends.

``ServeEngine`` keeps a slot-based batch: requests occupy fixed cache slots,
and a finished request frees its slot for the next queued one (continuous
batching a la Orca/vLLM, in the static-shape form of the reference: the
decode step always runs the full (slots, 1) batch, with inactive slots
masked).  Prefill runs per slot on the prompt right-padded to a power-of-two
bucket; above ``cfg.q_chunk`` tokens its attention is K3.  PyTorch runs
eagerly, so there is no jit: ``stats["prefill_traces"]`` counts the distinct
prefill buckets, which are what the reference's traces are keyed on.  The KV
cache is updated in place.  ``telemetry=`` registers ``stats`` as pull
gauges.

``AnnFrontend`` is the LANNS §7 online-serving front end: single-query
arrivals are micro-batched (up to ``max_batch`` queries or ``max_wait_ms``
of queueing, whichever first) and executed through the same batched
``LannsIndex.query`` executor the offline benchmarks measure.
``AsyncAnnFrontend`` runs the same batching policy on its own thread, so
arrivals generated by a live load process (``serve/loadgen.py``) are served
concurrently with submission and every request carries end-to-end
timestamps.  Only the batcher thread calls ``index.query``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.utils import next_pow2
from repro_torch.distributed.sharding_rules import NULL_CTX
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False


def make_prefill_fn(cfg: tf.TransformerConfig, ctx=NULL_CTX):
    """(params, tokens (B, S), cache) -> (next_token_logits (B, V), cache).
    ``ctx``: the sharding rules of a mesh (``distributed.sharding_rules``;
    DTensor params and tokens), as ``transformer.forward`` takes them."""

    def prefill(params, tokens, cache):
        logits, cache, _ = tf.apply(params, cfg, tokens, cache=cache, cache_offset=0, ctx=ctx)
        return logits[:, -1], cache

    return prefill


def make_bucketed_prefill_fn(cfg: tf.TransformerConfig):
    """Prefill over a length-bucketed prompt: tokens (B, S_bucket) is the
    prompt right-padded to its bucket and ``last`` the index of the final
    real token.  Right padding is attention-valid under the causal mask: a
    pad token at position p > last cannot influence the logits at ``last``,
    and pad rows written to the cache sit at positions >= the true length,
    which decode masks out (kv_pos <= q_pos) and then overwrites in place.
    """

    def prefill(params, tokens, cache, last):
        logits, cache, _ = tf.apply(params, cfg, tokens, cache=cache, cache_offset=0)
        return logits[:, last], cache

    return prefill


def make_decode_fn(cfg: tf.TransformerConfig, ctx=NULL_CTX):
    """(params, token (B, 1), cache, offset) -> (logits (B, V), cache): one
    new token per row against a KV cache of length ``offset``; ``ctx`` as
    :func:`make_prefill_fn` takes it."""

    def decode(params, token, cache, offset):
        logits, cache, _ = tf.apply(params, cfg, token, cache=cache, cache_offset=offset,
                                    ctx=ctx)
        return logits[:, -1], cache

    return decode


class ServeEngine:
    """Host-side continuous batching over fixed cache slots.  Runs on the
    device of ``params``."""

    def __init__(
        self,
        cfg: tf.TransformerConfig,
        params: tf.Transformer,
        *,
        slots: int = 8,
        max_seq: int = 512,
        cache_dtype=torch.float32,
        greedy: bool = True,
        seed: int = 0,
        prefill_bucket_min: int = 16,
        telemetry=None,
    ):
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.slots = slots
        self.max_seq = max_seq
        self.cache = tf.make_cache(cfg, slots, max_seq, dtype=cache_dtype, device=self.device)
        self.offsets = np.zeros(slots, dtype=np.int64)  # per-slot position
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.prefill_bucket_min = prefill_bucket_min
        self._prefill = make_bucketed_prefill_fn(cfg)
        self._decode = make_decode_fn(cfg)
        self._buckets: set[int] = set()
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "completed": 0,
                      "prefill_traces": 0}
        # obs.Telemetry: the stats dict registers as serve_engine_* pull
        # gauges, so one registry exposition covers the LM engine alongside
        # the ANN frontend's counters (no push call on the decode loop).
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.register_serve_engine(self)

    def submit(self, req: Request):
        self.queue.append(req)

    def _prompt_bucket(self, length: int) -> int:
        """Power-of-two length bucket, clamped to the cache extent."""
        return min(max(next_pow2(length), self.prefill_bucket_min),
                   max(self.max_seq, length))

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # per-slot prefill: batch of 1 into this slot's cache rows
                # (views, written in place), prompt right-padded to its bucket
                L = len(req.prompt)
                S_pad = self._prompt_bucket(L)
                toks = np.zeros((1, S_pad), np.int64)
                toks[0, :L] = req.prompt
                slot_cache = {name: c[:, s: s + 1] for name, c in self.cache.items()}
                logits, _ = self._prefill(self.params, torch.from_numpy(toks).to(self.device),
                                          slot_cache, L - 1)
                self.offsets[s] = L
                req.tokens_out.append(self._sample(logits[0].float().cpu().numpy()))
                self.stats["prefill_tokens"] += L
                self._buckets.add(S_pad)
                self.stats["prefill_traces"] = len(self._buckets)

    def _sample(self, logits: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits))
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def step(self):
        """One engine tick: admit waiting requests, decode all active slots."""
        self._admit()
        if not any(self.active):
            return False
        last = np.zeros((self.slots, 1), dtype=np.int64)
        for s, req in enumerate(self.active):
            if req is not None and req.tokens_out:
                last[s, 0] = req.tokens_out[-1]
        # per-slot offsets: slots decode at their own cache positions
        offset = torch.tensor(self.offsets, device=self.device)
        logits, _ = self._decode(self.params, torch.from_numpy(last).to(self.device),
                                 self.cache, offset)
        logits = logits.float().cpu().numpy()
        self.stats["decode_steps"] += 1
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.offsets[s] += 1
            req.tokens_out.append(self._sample(logits[s]))
            if len(req.tokens_out) >= req.max_new_tokens or self.offsets[s] >= self.max_seq - 1:
                req.done = True
                self.stats["completed"] += 1
                self.active[s] = None
                self.offsets[s] = 0
        return True

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.stats


# ---------------------------------------------------------------------------
# ANN micro-batching front end (LANNS §7 online serving)
# ---------------------------------------------------------------------------


def _validate_knobs(topk, ef, deadline_ms=None):
    """Reject bad per-request knobs in the SUBMITTER's thread.

    The async batcher executes batches on its own thread, where an invalid
    knob would crash the loop and cancel every in-flight request — so the
    one misbehaving caller must fail at submit() instead.  ``deadline_ms``
    is knob-like for this purpose: a NaN or negative budget would poison
    the controller's degrade arithmetic at batch formation, which runs on
    the batcher thread.
    """
    if topk is not None and int(topk) < 1:
        raise ValueError(f"per-request topk={topk} must be >= 1")
    if ef is not None and int(ef) < 1:
        raise ValueError(
            f"per-request ef={ef} must be >= 1 (omit it for the default)"
        )
    if deadline_ms is not None and not (
        math.isfinite(float(deadline_ms)) and float(deadline_ms) > 0
    ):
        raise ValueError(
            f"per-request deadline_ms={deadline_ms} must be finite and > 0 "
            "(omit it for no deadline)"
        )


def _validate_retune(max_batch, max_wait_ms):
    """Reject bad live-retune knobs in the CALLER's thread (controller or
    operator), before they reach the batcher's policy loop."""
    if max_batch is not None and int(max_batch) < 1:
        raise ValueError(f"max_batch={max_batch} must be >= 1")
    if max_wait_ms is not None and not (
        math.isfinite(float(max_wait_ms)) and float(max_wait_ms) > 0
    ):
        raise ValueError(
            f"max_wait_ms={max_wait_ms} must be finite and > 0"
        )


@dataclasses.dataclass
class AnnRequest:
    """One in-flight ANN query; results land in place when its batch runs.

    Timestamps (in the owning frontend's ``clock`` domain) split the
    end-to-end latency into its two serving components: ``t_start -
    t_submit`` is batching/queueing delay, ``t_done - t_start`` is batched
    execution.  ``event`` is set (async frontend only) when the request
    completes or is cancelled, so load-generator clients can block on it.

    ``topk``/``ef`` are PER-REQUEST knobs (None -> the frontend default):
    requests with different knobs ride the same formed micro-batch — the
    index executor groups them into homogeneous knob groups internally, so
    mixing costs no extra batches.  ``deadline_ms`` is the request's
    latency budget: it changes NOTHING by itself, but a bound
    ``SLOController`` degrades the effective ``ef`` of requests already
    past it at batch formation (``ef_used``/``degraded`` record what
    actually ran).
    """

    # publication protocol (the JAX package's LANNS013 rule), in the order
    # ``_execute`` assigns them: the timestamps and knobs before
    # ``dists``/``ids`` (``done`` flips on ``ids``), and ``event.set()``
    # last — waiters read every field lock-free the moment the event fires.
    _PUBLISHED_FIELDS = ("t_start", "t_done", "batch_size", "ef_used", "degraded",
                         "dists", "ids", "cancelled")

    uid: int
    query: np.ndarray  # (d,) float32
    t_submit: float
    topk: Optional[int] = None  # per-request override (None = frontend's)
    ef: Optional[int] = None  # per-request override (None = frontend's)
    deadline_ms: Optional[float] = None  # latency budget (None = none)
    dists: Optional[np.ndarray] = None  # (topk,) when done
    ids: Optional[np.ndarray] = None  # (topk,) when done
    t_start: float = float("nan")  # micro-batch execution began
    t_done: float = float("nan")  # results materialized
    batch_size: int = 0  # size of the micro-batch that served it
    cancelled: bool = False  # dropped by a non-draining shutdown
    ef_used: Optional[int] = None  # effective ef executed (None = default)
    degraded: bool = False  # controller reduced ef (past deadline)
    event: Optional[threading.Event] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def done(self) -> bool:
        return self.ids is not None

    @property
    def latency_s(self) -> float:
        """End-to-end: submission -> results visible."""
        return self.t_done - self.t_submit

    @property
    def queue_s(self) -> float:
        """Time spent waiting for the micro-batch to form."""
        return self.t_start - self.t_submit

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until completed/cancelled (async frontend requests only)."""
        if self.event is None:
            return self.done
        return self.event.wait(timeout)


class AnnFrontend:
    """Micro-batching broker front end over a ``LannsIndex``-like object.

    Queries arrive one at a time (``submit``); the front end coalesces them
    and fires ONE batched ``index.query`` per micro-batch, when either
    ``max_batch`` queries are pending (throughput bound) or the oldest has
    queued for ``max_wait_ms`` (latency bound).  Amortizing the per-call
    routing/merge overhead over the batch is what makes the paper's
    single-node QPS claim reachable; see benchmarks/bench_online_qps.py.

    ``clock`` is injectable so tests can drive deadlines deterministically.

    ``telemetry`` (an ``obs.Telemetry``) records every formed batch's
    queue/exec/end-to-end decomposition into the shared metrics registry
    and span sink, and polls the retrace sentinel (first-use stalls: kernel
    libraries loaded, allocator segments) — pass the same bundle to
    ``index.attach_telemetry`` for the executor's stage spans.  None (the
    default) records nothing.

    ``controller`` (a ``serve.controller.SLOController``) is consulted at
    batch formation: it may return per-request ``ef`` overrides (deadline-
    aware degrade) and may live-``retune()`` the batching knobs from its
    own thread.  The frontend ``bind()``s it at construction; None (the
    default) keeps the frontend fully static.

    Concurrency contract (the ``_GUARDED_BY`` registry below):
    ``stats``/``batch_hist``/``_recent_qstats`` are shared with the async
    subclass's batcher thread, so every mutation holds ``_stats_lock``
    (uncontended and held only for dict updates — the ``index.query`` call
    itself runs outside it).  Telemetry hooks run OUTSIDE the serving locks:
    the obs internals take only their own leaf locks.
    """

    _GUARDED_BY = {
        "stats": "_stats_lock",
        "batch_hist": "_stats_lock",
        "_recent_qstats": "_stats_lock",
    }
    _LOCK_ORDER = ("_cond", "_stats_lock")  # _cond first, always

    def __init__(
        self,
        index,
        *,
        topk: int = 100,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        ef: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        collect_stats: bool = False,
        telemetry=None,
        controller=None,
        recent_stats_depth: int = 64,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if recent_stats_depth < 1:
            raise ValueError("recent_stats_depth must be >= 1")
        self.index = index
        self.topk = topk
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.ef = ef
        self.clock = clock
        self.collect_stats = collect_stats
        self.telemetry = telemetry
        self.pending: list[AnnRequest] = []
        self._uid = 0
        self._stats_lock = threading.Lock()
        self.stats = {
            "submitted": 0, "completed": 0, "batches": 0,
            "full_batches": 0, "deadline_batches": 0, "forced_batches": 0,
            "segments_visited": 0.0,
        }
        self.batch_hist: dict[int, int] = {}  # formed batch size -> count
        # routing stats ring of the most recent batches (collect_stats=True):
        # perShardTopK, segments visited and the merge path (the reference's
        # trace counters read -1 in the port: no jit).  Bounded at
        # recent_stats_depth so post-hoc burst analysis keeps a window, not
        # just the last batch; read via last_query_stats /
        # recent_query_stats(n).
        self._recent_qstats: deque = deque(maxlen=recent_stats_depth)
        # bound last: bind() reads max_wait_s/telemetry set above
        self.controller = controller
        if controller is not None:
            controller.bind(self)

    def submit(
        self,
        query: np.ndarray,
        *,
        topk: Optional[int] = None,
        ef: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ) -> AnnRequest:
        _validate_knobs(topk, ef, deadline_ms)
        req = AnnRequest(
            self._uid, np.asarray(query, np.float32), self.clock(),
            topk=topk, ef=ef, deadline_ms=deadline_ms,
        )
        self._uid += 1
        self.pending.append(req)
        with self._stats_lock:
            self.stats["submitted"] += 1
        return req

    def step(self) -> list[AnnRequest]:
        """Flush every due micro-batch; returns the completed requests."""
        done: list[AnnRequest] = []
        while len(self.pending) >= self.max_batch:
            done += self._execute(self.pending[: self.max_batch], "full_batches")
            self.pending = self.pending[self.max_batch:]
        if self.pending and (
            self.clock() - self.pending[0].t_submit >= self.max_wait_s
        ):
            done += self._execute(self.pending, "deadline_batches")
            self.pending = []
        return done

    def flush(self) -> list[AnnRequest]:
        """Drain everything pending regardless of deadlines (shutdown path)."""
        done: list[AnnRequest] = []
        while self.pending:
            batch = self.pending[: self.max_batch]
            self.pending = self.pending[self.max_batch:]
            done += self._execute(batch, "forced_batches")
        return done

    def retune(
        self,
        *,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
    ) -> None:
        """Adjust the batching knobs on a live frontend (controller hook).

        Keep ``max_batch`` at or below the value the index was warmed for
        (``warm_traces``) — past the warmed bucket grid the first batches
        would grow the allocator on the serving path.
        """
        _validate_retune(max_batch, max_wait_ms)
        if max_batch is not None:
            self.max_batch = int(max_batch)
        if max_wait_ms is not None:
            self.max_wait_s = float(max_wait_ms) / 1e3

    @property
    def mean_batch_size(self) -> float:
        with self._stats_lock:
            return self.stats["completed"] / max(self.stats["batches"], 1)

    @property
    def mean_segments_visited(self) -> float:
        with self._stats_lock:
            return (
                self.stats["segments_visited"]
                / max(self.stats["completed"], 1)
            )

    @property
    def last_query_stats(self) -> Optional[dict]:
        """Routing/trace stats of the most recent batch (None before any)."""
        with self._stats_lock:
            return self._recent_qstats[-1] if self._recent_qstats else None

    def recent_query_stats(self, n: Optional[int] = None) -> list[dict]:
        """Up to the last ``recent_stats_depth`` per-batch stats dicts,
        oldest first; ``n`` trims to the newest n.  Populated only with
        ``collect_stats=True``."""
        with self._stats_lock:
            out = list(self._recent_qstats)
        if n is None:
            return out
        return out[len(out) - min(int(n), len(out)):] if n > 0 else []

    # lanns: dims[B<=4096, topk<=200, ef<=1024]
    def _execute(self, batch: list[AnnRequest], kind: str) -> list[AnnRequest]:  # lanns: hotpath
        t_start = self.clock()
        q = np.stack([r.query for r in batch])
        # deadline-aware degrade: the controller may hand back per-request
        # ef overrides for requests already past budget at formation time.
        # Runs lock-light on this (batcher) thread; ef values come from the
        # controller's pre-warmed ladder (``warm_traces(knobs=...)``).
        ctrl = self.controller
        degrade = (
            ctrl.on_batch_formed(batch, t_start) if ctrl is not None else None
        )
        # per-request knob overrides ride the same formed batch: pass the
        # knob VECTORS through and let the index executor group them
        # (homogeneous batches keep the scalar fast path).
        topk_arg, ef_arg = self.topk, self.ef
        if degrade is not None or any(
            r.topk is not None or r.ef is not None for r in batch
        ):
            topk_arg = np.array(
                [self.topk if r.topk is None else r.topk for r in batch],
                np.int64,
            )
            # 0 == "index default" in the executor's per-request ef encoding
            ef_default = 0 if self.ef is None else self.ef
            ef_arg = np.array(
                [ef_default if r.ef is None else r.ef for r in batch],
                np.int64,
            )
            if degrade is not None:
                for j, ef_d in enumerate(degrade):
                    if ef_d is not None:
                        ef_arg[j] = ef_d
        if self.collect_stats:
            # the (blocking) index.query runs OUTSIDE _stats_lock: the lock
            # covers only the dict updates (LANNS011)
            d, i, qstats = self.index.query(
                q, topk_arg, ef=ef_arg, return_stats=True
            )
            with self._stats_lock:
                self._recent_qstats.append(qstats)
                self.stats["segments_visited"] += (
                    qstats.get("mean_segments_visited", 0.0) * len(batch)
                )
        else:
            d, i = self.index.query(q, topk_arg, ef=ef_arg)
        d, i = np.asarray(d), np.asarray(i)
        t_done = self.clock()
        for j, r in enumerate(batch):
            tk = self.topk if r.topk is None else r.topk
            # timestamps/batch_size/knob record BEFORE dists/ids: `done`
            # flips true on the ids assignment, and a done-poller must
            # never read NaN latencies; the event fires last.
            r.t_start, r.t_done, r.batch_size = t_start, t_done, len(batch)
            if isinstance(ef_arg, np.ndarray):
                ef_j = int(ef_arg[j])
                r.ef_used = ef_j if ef_j > 0 else None  # 0 = index default
            else:
                r.ef_used = ef_arg
            r.degraded = degrade is not None and degrade[j] is not None
            r.dists, r.ids = d[j, :tk], i[j, :tk]
            if r.event is not None:
                r.event.set()
        b = len(batch)
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats[kind] += 1
            self.stats["completed"] += b
            self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
        if self.telemetry is not None:
            # observes only (counters/histograms/spans from the request
            # timestamps set above); results are already published.
            self.telemetry.on_batch(batch, kind)
        return list(batch)


class AsyncAnnFrontend(AnnFrontend):
    """Threaded ``AnnFrontend``: a batcher thread owns the host loop.

    ``submit`` is thread-safe and returns immediately; the batcher thread
    forms micro-batches under the SAME policy as the synchronous ``step()``
    (``max_batch`` queries or ``max_wait_ms`` of queueing, FIFO slices) and
    runs them through the SAME ``_execute``, so identical formed batches
    give bit-identical results (asserted in tests/test_torch_serve.py).
    Requests complete asynchronously: callers block on ``req.wait()`` or
    poll ``req.done``; completions also accumulate in ``self.completed``
    (appended only by the batcher thread; read it after ``stop()``).

    Lifecycle: ``start()`` spawns the thread, ``stop(drain=True)`` flushes
    everything still pending before joining (graceful shutdown), while
    ``stop(drain=False)`` cancels pending requests (their ``event`` fires
    with ``cancelled=True``).  Usable as a context manager — ``with
    AsyncAnnFrontend(idx) as fe: ...`` drains on exit.

    Only the batcher thread ever touches ``index.query``; the condition
    variable guards the pending queue, lifecycle flags, and the completed
    list, while ``stats``/``batch_hist``/``_recent_qstats`` — mutated by
    the batcher thread AND read/bumped by submitters — take the base
    class's ``_stats_lock``.  The full guarded-attribute map is the
    ``_GUARDED_BY`` registry below; lock ORDER is ``_cond`` before
    ``_stats_lock``, recorded in ``_LOCK_ORDER``.

    The batcher thread makes the index's device its current CUDA device
    before its first batch: the current device is per thread, and the
    executor's events and syncs follow it.
    """

    _GUARDED_BY = {
        "pending": "_cond",
        "completed": "_cond",
        "error": "_cond",
        "_uid": "_cond",
        "_thread": "_cond",
        "_stopping": "_cond",
        "_drain": "_cond",
        # live-retunable batching knobs: written by the controller thread
        # (retune()), read by the batcher's formation policy — both under
        # _cond once the frontend is async.
        "max_batch": "_cond",
        "max_wait_s": "_cond",
    }

    def __init__(self, index, **kw):
        super().__init__(index, **kw)
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain = True
        self.completed: list[AnnRequest] = []
        self.error: Optional[BaseException] = None  # fatal batcher failure

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncAnnFrontend":
        with self._cond:
            if self._thread is not None:
                raise RuntimeError("frontend already started")
            self._stopping = False
            self.error = None  # a restart gets a clean slate
            self.completed = []  # prior-run results stay with their holders
            self._thread = threading.Thread(
                target=self._loop, name="ann-batcher", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Shut the batcher down; returns the completed-request list.

        drain=True serves every pending request first (forced batches, like
        the sync ``flush()``); drain=False cancels them — their ``event``
        is set with ``cancelled=True`` and no results.
        """
        with self._cond:
            if self._thread is None:
                return self.completed
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
            thread = self._thread
        thread.join(timeout)
        if thread.is_alive():
            raise RuntimeError("batcher thread did not stop in time")
        with self._cond:
            leftover, self.pending = self.pending, []
            self._thread = None
            completed = self.completed
        for r in leftover:  # only reachable with drain=False
            r.cancelled = True
            if r.event is not None:
                r.event.set()
        return completed

    def __enter__(self) -> "AsyncAnnFrontend":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- producer side -------------------------------------------------------

    def submit(
        self,
        query: np.ndarray,
        *,
        topk: Optional[int] = None,
        ef: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ) -> AnnRequest:
        # fail HERE, never in the batcher thread (deadline_ms included: a
        # NaN budget would otherwise blow up in the controller's degrade
        # arithmetic at batch formation)
        _validate_knobs(topk, ef, deadline_ms)
        with self._cond:
            if self.error is not None:
                raise RuntimeError("batcher thread died") from self.error
            if self._thread is None or self._stopping:
                raise RuntimeError("frontend is not accepting submissions")
            req = AnnRequest(
                self._uid, np.asarray(query, np.float32), self.clock(),
                topk=topk, ef=ef, deadline_ms=deadline_ms,
                event=threading.Event(),
            )
            self._uid += 1
            self.pending.append(req)
            self._cond.notify()
        with self._stats_lock:
            self.stats["submitted"] += 1
        return req

    def step(self):
        raise RuntimeError(
            "AsyncAnnFrontend is driven by its batcher thread; submit() and "
            "wait on the returned request (or stop(drain=True)) instead of "
            "calling step()/flush()"
        )

    flush = step

    def retune(
        self,
        *,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
    ) -> None:
        """Thread-safe live retune: the knobs are batcher policy state, so
        writes take ``_cond`` and wake the batcher — a tightened deadline
        applies to the batch already waiting, not just the next one."""
        _validate_retune(max_batch, max_wait_ms)
        with self._cond:
            if max_batch is not None:
                self.max_batch = int(max_batch)
            if max_wait_ms is not None:
                self.max_wait_s = float(max_wait_ms) / 1e3
            self._cond.notify_all()

    @property
    def depth(self) -> int:
        """Instantaneous queue depth (pending, not yet batched)."""
        with self._cond:
            return len(self.pending)

    # -- batcher thread ------------------------------------------------------

    # lanns: holds[_cond]
    def _take(self, kind: str) -> tuple[list[AnnRequest], str]:
        batch = self.pending[: self.max_batch]
        del self.pending[: self.max_batch]
        return batch, kind

    def _fail(self, error: BaseException, batch: list[AnnRequest]) -> None:
        """Record a fatal batcher error (re-raised by the next submit) and
        cancel ``batch`` and everything still pending: no waiter is left
        blocked."""
        with self._cond:
            self.error = error
            leftover, self.pending = self.pending, []
        for r in batch + leftover:
            r.cancelled = True
            if r.event is not None:
                r.event.set()

    def _loop(self):
        dev = getattr(self.index, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            try:
                torch.cuda.set_device(dev)  # the current device is per thread
            except BaseException as e:
                self._fail(e, [])
                return
        while True:
            batch = None
            with self._cond:
                while batch is None:
                    if self._stopping and not self._drain:
                        # cancel-stop beats a full queue: stop(drain=False)
                        # must never keep serving batches it was told to drop
                        return
                    if len(self.pending) >= self.max_batch:
                        batch, kind = self._take("full_batches")
                    elif self._stopping:
                        if not self.pending:
                            return
                        batch, kind = self._take("forced_batches")
                    elif self.pending:
                        wait = self.max_wait_s - (
                            self.clock() - self.pending[0].t_submit
                        )
                        if wait <= 0:
                            batch, kind = self._take("deadline_batches")
                        else:
                            # cap the sleep so an injected clock that moves
                            # independently of wall time still gets polled
                            self._cond.wait(min(wait, 0.05))
                    else:
                        self._cond.wait()
            try:
                done = self._execute(batch, kind)
            except BaseException as e:
                # a crashed query must not leave ANY waiter blocked forever:
                # cancel the in-flight batch AND everything still pending,
                # and shut the loop down.
                self._fail(e, batch)
                return
            # completed is read by stop()/submitters -> under the lock
            with self._cond:
                self.completed += done

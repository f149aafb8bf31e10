"""Metrics registry: counters, gauges, fixed-bucket histograms, exposition.

The port's own copy of ``repro.obs.metrics`` (numpy only), so the two
packages render the same exposition text for the same observations.

The serving-telemetry substrate (the closed-loop SLO controller reads the
telemetry it exports).  Three metric kinds, each a
FAMILY that fans out into labeled series:

* ``Counter`` — monotonic; ``inc(amount)`` rejects negative amounts.
* ``Gauge`` — last-write-wins value, or a pull callback
  (``set_function``) read at collection time — how ``ServeEngine.stats``
  registers without a push call on its hot loop.
* ``Histogram`` — fixed upper-bound buckets with Prometheus ``le``
  semantics (upper-INCLUSIVE bounds, implicit ``+Inf`` overflow bucket)
  plus ``_sum``/``_count``; ``observe_many`` ingests a whole micro-batch
  of values with ONE ``np.searchsorted`` + ONE lock acquisition, so the
  per-batch instrumentation cost stays microseconds at ``B=1024``.

Export surfaces: ``MetricsRegistry.expose_text()`` renders the standard
Prometheus text format (``# HELP``/``# TYPE``, cumulative ``_bucket{le=}``
lines); ``to_dict()`` is the JSON-friendly snapshot the bench artifacts
embed.

Lock discipline (the JAX package's ``repro.analysis`` LANNS010-013 rules):
every mutable aggregate declares its
``_GUARDED_BY`` registry and takes its own uncontended ``threading.Lock``
for the dict/array update only — no metric method ever calls into torch,
the index, or anything blocking while holding a lock, so telemetry can
never participate in a lock cycle with the serving locks.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Callable, Optional, Sequence

import numpy as np

#: default latency buckets (seconds): 0.5 ms .. 5 s, roughly log-spaced —
#: covers micro-batch execution on one node through past-saturation queueing.
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0,
)

#: pow2 batch-size buckets matching the serving trace buckets (a formed
#: micro-batch pads to the next pow2 before execution).
BATCH_SIZE_BUCKETS: tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
)


def _escape_label(value: object) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    """Prometheus sample-value formatting: integral floats stay integral."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series_suffix(labelnames: Sequence[str], key: tuple) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, key)
    )
    return "{" + pairs + "}"


class Counter:
    """One monotonic series.  ``inc`` only; negative amounts raise."""

    _GUARDED_BY = {"_value": "_lock"}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} must be >= 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """One settable series; ``set_function`` switches it to pull mode."""

    _GUARDED_BY = {"_value": "_lock", "_fn": "_lock"}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read ``fn()`` at every collection instead of a stored value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            stored = self._value
        # the callback runs OUTSIDE the lock: it is caller code and must
        # not be able to deadlock collection against its own locks
        return float(fn()) if fn is not None else stored


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (upper-incl.) bounds.

    A value exactly on a bound lands IN that bound's bucket; anything past
    the last bound lands in the implicit ``+Inf`` overflow bucket (both
    asserted in tests/test_obs.py).  ``observe_many`` is the batched hot
    path: one vectorized bin + one lock acquisition per call.
    """

    _GUARDED_BY = {"_counts": "_lock", "_sum": "_lock", "_count": "_lock"}

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        bounds = np.asarray(tuple(buckets), np.float64)
        if bounds.size == 0:
            raise ValueError("histogram needs at least one bucket bound")
        if not np.all(np.isfinite(bounds)):
            raise ValueError("bucket bounds must be finite (+Inf is implicit)")
        if np.any(np.diff(bounds) <= 0):
            raise ValueError(f"bucket bounds must be increasing: {buckets}")
        self._bounds = bounds  # immutable after init — read lock-free
        self._lock = threading.Lock()
        self._counts = np.zeros(bounds.size + 1, np.int64)
        self._sum = 0.0
        self._count = 0

    @property
    def bounds(self) -> tuple[float, ...]:
        return tuple(self._bounds)

    def observe(self, value: float) -> None:
        self.observe_many((value,))

    def observe_many(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        # side='left': first bound >= v — exactly the upper-inclusive `le`
        # bucket; v past the last bound indexes the overflow slot.
        idx = np.searchsorted(self._bounds, v, side="left")
        add = np.bincount(idx, minlength=self._bounds.size + 1)
        total = float(v.sum())
        n = int(v.size)
        with self._lock:
            self._counts += add
            self._sum += total
            self._count += n

    def snapshot(self) -> tuple[np.ndarray, float, int]:
        """(per-bucket counts incl. overflow, sum, count) — consistent."""
        with self._lock:
            return self._counts.copy(), self._sum, self._count

    def quantile(self, q: float) -> float:
        """Prometheus-style ``histogram_quantile``: linear interpolation
        inside the winning bucket; overflow-bucket answers clamp to the
        last finite bound.  NaN on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q={q} must be in [0, 1]")
        counts, _, count = self.snapshot()
        if count == 0:
            return float("nan")
        target = q * count
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= self._bounds.size:  # landed in the +Inf overflow bucket
            return float(self._bounds[-1])
        lo = 0.0 if i == 0 else float(self._bounds[i - 1])
        hi = float(self._bounds[i])
        inside = counts[i]
        if inside == 0:
            return hi
        frac = (target - (cum[i] - inside)) / inside
        return lo + (hi - lo) * float(min(max(frac, 0.0), 1.0))


class _Family:
    """One named metric fanning out into labeled child series."""

    kind = "untyped"

    _GUARDED_BY = {"_series": "_lock"}

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """The child series for one label-value tuple (created on first
        use, cached after).  Positional values follow ``labelnames`` order;
        keywords must cover exactly the declared names."""
        if kv:
            if values or set(kv) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: labels expect exactly {self.labelnames}, "
                    f"got args={values} kwargs={sorted(kv)}"
                )
            key = tuple(str(kv[n]) for n in self.labelnames)
        else:
            if len(values) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected {len(self.labelnames)} label "
                    f"value(s) {self.labelnames}, got {len(values)}"
                )
            key = tuple(str(v) for v in values)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._make_child()
                self._series[key] = child
        return child

    def series(self) -> dict[tuple, object]:
        """Stable snapshot of the label -> child map, sorted by labels."""
        with self._lock:
            items = list(self._series.items())
        return dict(sorted(items))

    # unlabeled convenience: family with labelnames=() delegates to the
    # single () child, so `registry.counter("x").inc()` just works.

    def _default(self):
        return self.labels()


class CounterFamily(_Family):
    kind = "counter"

    def _make_child(self):
        return Counter()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class GaugeFamily(_Family):
    kind = "gauge"

    def _make_child(self):
        return Gauge()

    def set(self, value: float) -> None:
        self._default().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(buckets)
        Histogram(self.buckets)  # validate bounds once, at registration

    def _make_child(self):
        return Histogram(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def observe_many(self, values) -> None:
        self._default().observe_many(values)

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)


_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _validate_name(name: str) -> None:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")


class MetricsRegistry:
    """Named family registry + the two snapshot/exposition surfaces.

    Registration is idempotent: re-registering the same (name, kind,
    labelnames) returns the EXISTING family — so independently constructed
    components (frontend, engine, benches) can all declare their metrics
    against one shared registry without an ownership protocol.  A kind or
    label-schema mismatch on an existing name raises.
    """

    _GUARDED_BY = {"_families": "_lock"}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> _Family:
        _validate_name(name)
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kw)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls) or fam.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames} — asked for {cls.kind} with "
                f"{labelnames}"
            )
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> CounterFamily:
        return self._register(CounterFamily, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> GaugeFamily:
        return self._register(GaugeFamily, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  ) -> HistogramFamily:
        return self._register(HistogramFamily, name, help, labelnames,
                              buckets=buckets)

    def families(self) -> list[_Family]:
        with self._lock:
            fams = list(self._families.values())
        return sorted(fams, key=lambda f: f.name)

    # -- exposition --------------------------------------------------------

    def expose_text(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4)."""
        out: list[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.series().items():
                suffix = _series_suffix(fam.labelnames, key)
                if isinstance(child, Histogram):
                    counts, total, count = child.snapshot()
                    cum = 0
                    for bound, c in zip(child.bounds, counts):
                        cum += int(c)
                        le = _series_suffix(
                            fam.labelnames + ("le",),
                            key + (_fmt_value(bound),),
                        )
                        out.append(f"{fam.name}_bucket{le} {cum}")
                    le = _series_suffix(
                        fam.labelnames + ("le",), key + ("+Inf",)
                    )
                    out.append(f"{fam.name}_bucket{le} {count}")
                    out.append(
                        f"{fam.name}_sum{suffix} {_fmt_value(total)}"
                    )
                    out.append(f"{fam.name}_count{suffix} {count}")
                else:
                    out.append(
                        f"{fam.name}{suffix} {_fmt_value(child.value)}"
                    )
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """JSON-friendly snapshot: {name: {kind, labels, series}}."""
        out: dict = {}
        for fam in self.families():
            series = {}
            for key, child in fam.series().items():
                skey = ",".join(key) if key else ""
                if isinstance(child, Histogram):
                    counts, total, count = child.snapshot()
                    series[skey] = {
                        "buckets": list(child.bounds),
                        "counts": [int(c) for c in counts],
                        "sum": total,
                        "count": int(count),
                    }
                else:
                    series[skey] = child.value
            out[fam.name] = {
                "kind": fam.kind,
                "labels": list(fam.labelnames),
                "series": series,
            }
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

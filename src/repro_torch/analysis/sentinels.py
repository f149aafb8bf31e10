"""Retrace sentinel: assert that a warmed serving path does not stall.

The port of ``repro.analysis.sentinels``, with the same API (``reset``,
``snapshot``, ``deltas``, ``retraced``, ``assert_no_retrace``,
``expect_no_retrace``, ``available``).

What "retrace" means here.  PyTorch runs eagerly, so there is no jit trace
to recompile.  What stalls the first live traffic of a shape in the port
is different, and that is what the sentinel counts:

* ``kernel_library_loads`` — a CUDA kernel library built with ``nvcc`` and
  loaded with ``ctypes`` at its first use (``kernels/_build.load``): seconds
  to minutes, the port's counterpart of a first compile;
* ``allocator_segments`` — a new segment of PyTorch's CUDA caching
  allocator on the watched device (``torch.cuda.memory_stats()
  ["segment.all.allocated"]``, a cumulative count of ``cudaMalloc`` calls):
  an unseen (batch bucket, topk, ef) shape that outgrows the cached blocks.

Usage:

    idx.warm_traces(...)
    sentinel = RetraceSentinel(idx.device)
    idx.query(serving_workload)
    sentinel.assert_no_retrace("mixed-knob serving")

On the CPU neither counter exists (no kernel library loads there and no
caching allocator), so ``available`` is False and the assertions pass
vacuously, as the reference's do without jax's cache-size API (callers
should skip instead if the counter is the point of the test).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import _build


def _counters(device: Optional[torch.device]) -> dict[str, Callable[[], int]]:
    if device is None or device.type != "cuda":
        return {}
    return {
        "kernel_library_loads": _build.load_count,
        "allocator_segments": lambda: int(
            torch.cuda.memory_stats(device).get("segment.all.allocated", 0)
        ),
    }


class RetraceSentinel:
    """Snapshot/delta view over the watched first-use counters.

    ``device``: the CUDA device whose allocator is watched (the serving
    index's ``device``); None means the current CUDA device when there is
    one.  ``extra``: more ``{name: zero-argument callable returning a
    cumulative count}`` to watch.
    """

    def __init__(self, device=None, extra: Optional[dict] = None) -> None:
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = None if device is None else torch.device(device)
        self._fns = _counters(self.device)
        if extra:
            self._fns.update(extra)
        self._base: dict[str, int] = {}
        self.reset()

    @property
    def available(self) -> bool:
        """True if at least one counter is watched."""
        return bool(self._fns)

    def snapshot(self) -> dict[str, int]:
        return {name: int(fn()) for name, fn in self._fns.items()}

    def reset(self) -> dict[str, int]:
        self._base = self.snapshot()
        return self._base

    def deltas(self) -> dict[str, int]:
        """New events per counter since ``reset()``."""
        now = self.snapshot()
        return {name: max(now[name] - self._base.get(name, now[name]), 0) for name in now}

    def retraced(self) -> dict[str, int]:
        return {k: v for k, v in self.deltas().items() if v > 0}

    def assert_no_retrace(self, context: str = "") -> None:
        hot = self.retraced()
        if hot:
            where = f" during {context}" if context else ""
            raise AssertionError(
                f"unexpected first-use stalls{where}: {hot} — a warmed serving path "
                "must load no kernel library and grow no allocator segment"
            )

    # `with sentinel.expect_no_retrace("mixed-knob"):` asserts on exit
    def expect_no_retrace(self, context: str = "") -> "_NoRetrace":
        return _NoRetrace(self, context)


class _NoRetrace:
    def __init__(self, sentinel: RetraceSentinel, context: str) -> None:
        self._s = sentinel
        self._ctx = context

    def __enter__(self) -> RetraceSentinel:
        self._s.reset()
        return self._s

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self._s.assert_no_retrace(self._ctx)

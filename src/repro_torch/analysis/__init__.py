"""Runtime invariant checks for the port's serving stack: the retrace
sentinel (``sentinels.py``).  The JAX package's static passes (trace lint,
lock discipline, kernel and scale checks) are not ported (ROADMAP item 10)."""

from repro_torch.analysis.sentinels import RetraceSentinel

__all__ = ["RetraceSentinel"]

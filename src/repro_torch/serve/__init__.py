"""Serving in the port: the LM engine (continuous batching over cache slots)."""

from repro_torch.serve.engine import (
    Request,
    ServeEngine,
    make_bucketed_prefill_fn,
    make_decode_fn,
    make_prefill_fn,
)

__all__ = ["Request", "ServeEngine", "make_bucketed_prefill_fn", "make_decode_fn",
           "make_prefill_fn"]

"""Serving in the port: the LM engine (continuous batching over cache
slots), the ANN micro-batching front ends (sync + threaded async), the SLO
controller, and arrival-process load generation for p99-vs-load sweeps."""

from repro_torch.serve.controller import SLOController
from repro_torch.serve.engine import (
    AnnFrontend,
    AnnRequest,
    AsyncAnnFrontend,
    Request,
    ServeEngine,
    make_bucketed_prefill_fn,
    make_decode_fn,
    make_prefill_fn,
)
from repro_torch.serve.loadgen import (
    LoadResult,
    arrival_gaps,
    measure_saturation_qps,
    run_controller_ab,
    run_load_point,
    sweep_load,
)

__all__ = [
    "AnnFrontend",
    "AnnRequest",
    "AsyncAnnFrontend",
    "LoadResult",
    "Request",
    "SLOController",
    "ServeEngine",
    "arrival_gaps",
    "make_bucketed_prefill_fn",
    "make_decode_fn",
    "make_prefill_fn",
    "measure_saturation_qps",
    "run_controller_ab",
    "run_load_point",
    "sweep_load",
]

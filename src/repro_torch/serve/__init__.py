"""Serving in the port: the LM engine (continuous batching over cache
slots), the ANN micro-batching front ends (sync + threaded async), the SLO
controller, arrival-process load generation for p99-vs-load sweeps, and
the distributed serve step over a ``torch.distributed`` mesh
(``retrieval``), and the recsys retrieval_cand step through K1
(``recsys``)."""

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
from repro_torch.serve.recsys import retrieval_step, scan_candidates, user_vector
from repro_torch.serve.retrieval import (
    DeviceIndex,
    build_device_index,
    make_serve_fn,
    route_queries_tree,
    shard_arrays,
)

__all__ = [
    "AnnFrontend",
    "AnnRequest",
    "AsyncAnnFrontend",
    "DeviceIndex",
    "LoadResult",
    "Request",
    "SLOController",
    "ServeEngine",
    "arrival_gaps",
    "build_device_index",
    "make_bucketed_prefill_fn",
    "make_decode_fn",
    "make_prefill_fn",
    "make_serve_fn",
    "measure_saturation_qps",
    "retrieval_step",
    "run_controller_ab",
    "route_queries_tree",
    "run_load_point",
    "scan_candidates",
    "shard_arrays",
    "sweep_load",
    "user_vector",
]

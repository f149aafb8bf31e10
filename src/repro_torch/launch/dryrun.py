"""The dry run: trace every (arch x cell x mesh) step on a fake world.

The port of ``repro.launch.dryrun`` (and of the jobs of
``launch/hlo_cost.py``).  The reference lowers and compiles each cell for
512 placeholder devices and reads XLA's memory and cost analyses.  Here
each cell runs once, on rank 0 of a world of ``"fake"`` process groups
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once), over a named mesh from ``init_device_mesh``, with the cell's
arguments DTensors of fake tensors (``configs.families.build_cell``, under
``FakeTensorMode``): nothing is allocated and no kernel runs (the kernels
are custom ops with shape functions, ``kernels/ops.py``).  A dispatch mode
below DTensor sees each rank-local op and records, per rank:

  * ``memory.argument_bytes`` — the arguments' local shards;
  * ``memory.peak_bytes`` — the most bytes of live tensors at any op
    boundary (arguments, activations, saved tensors, grads, moments);
  * ``cost.flops`` — ``torch.utils.flop_counter``'s formulas on the local
    shapes (a DTensor op counted by ``FlopCounterMode`` above DTensor
    would count the whole logical product), K3 / K3-bwd / K1 / K2 by their
    registered formulas;
  * ``collectives`` — each kind's count (``CommDebugMode``) and its bytes
    (the output that lands on the rank, from the rank-local collective);
  * ``model_flops_per_step``, ``fits`` (peak within the card's memory) and
    the seconds.

A microbatched train step is traced over its first microbatch (forward,
backward, the f32 grad accumulators) and the optimizer once; its flops are
scaled by ``num_micro`` (the reference's loop-aware cost multiplies scan
trips the same way), its memory is that trace's.  The peak is counted from
tensors, not from an allocator, so fragmentation and the allocator's cache
are outside it (PERF.md holds its calibration against the card).

Not carried over from the reference (they read XLA's compiled program):
``hlo_lines``, ``scan_trips``, ``generated_code_bytes`` and
``temp_bytes_tpu_estimate``.  ``launch/reanalyze.py`` re-reads saved HLO
and has no port.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --cell ... --mesh 2x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --lanns    # LANNS serve cells
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the card's memory, bytes (NVIDIA H100 80GB HBM3: 80 GB)
CARD_BYTES = 80 * 10**9

_OP_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_KIND_OF = {"all_gather": "all-gather", "allgather": "all-gather", "_allgather": "all-gather",
            "all_reduce": "all-reduce",
            "allreduce": "all-reduce", "reduce_scatter": "reduce-scatter",
            "_reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "alltoall": "all-to-all", "broadcast": "collective-permute",
            "send": "collective-permute", "recv": "collective-permute"}

_PROPAGATING = threading.local()


@contextlib.contextmanager
def _marking_propagation():
    """Mark the sharding propagator's own fake calls (global-shape tensors
    made only to infer an output's metadata) so the counter skips them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def marked(self, *a, **kw):
        prev = getattr(_PROPAGATING, "on", False)
        _PROPAGATING.on = True
        try:
            return orig(self, *a, **kw)
        finally:
            _PROPAGATING.on = prev

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    base = func._opname.rstrip("_")
    for key, kind in _KIND_OF.items():
        if base.startswith(key):
            return kind
    return None


class RankCounter(TorchDispatchMode):
    """Per-rank flops, live bytes and collective bytes of the ops a rank
    runs: DTensor ops pass down (``NotImplemented``) to DTensor, whose
    rank-local ops come back here."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.coll = {k: {"count": 0, "bytes": 0} for k in _OP_KINDS}
        self._seen = weakref.WeakKeyDictionary()

    def track(self, t) -> int:
        """Count ``t``'s storage as live until it is freed; its bytes (0 if
        already counted)."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "on", False):
            return out
        if any(isinstance(a, torch.Tensor) and a.device.type == "meta" for a in flat):
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        kind = _collective_kind(func)
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if kind is not None and not func._opname.startswith("wait"):
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += sum(o.numel() * o.element_size() for o in outs)
        for o in outs:
            self.track(o)
        return out


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def fake_mesh(shape, axes):
    """A named CPU mesh of ``prod(shape)`` ranks on a fake world, this
    process rank 0 (the world is made anew when its size changes)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def mesh_for(multi_pod: bool = False, mesh: str | None = None):
    """(mesh, its name): 16x16 (data, model), 2x16x16 (pod, data, model),
    or ``mesh`` as "DxM" / "PxDxM"."""
    if mesh:
        shape = tuple(int(s) for s in mesh.lower().split("x"))
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        return fake_mesh(shape, axes), mesh.lower()
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model")), "2x16x16"
    return fake_mesh((16, 16), ("data", "model")), "16x16"


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            n += _local_bytes(list(t.parameters()))
            continue
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


def _flat_args(args):
    """Every tensor of the args, a module's parameters included."""
    out = []
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.nn.Module):
            out.extend(t.parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def trace(fn, args, fake_mode, *, scale: int = 1) -> dict:
    """Run ``fn(*args)`` once under ``fake_mode`` with a :class:`RankCounter`
    and ``CommDebugMode``; returns the record's memory, cost and
    collectives (flops times ``scale``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    counter = RankCounter()
    arg_bytes = _local_bytes(args)
    with fake_mode, _marking_propagation():
        for t in _flat_args(args):
            counter.track(t)
        with CommDebugMode() as comm, counter:
            out = fn(*args)
        del out
    coll = {k: dict(v) for k, v in counter.coll.items()}
    counts = {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}
    coll["total_bytes"] = sum(v["bytes"] for k, v in coll.items() if k in _OP_KINDS)
    return {"memory": {"argument_bytes": arg_bytes, "peak_bytes": counter.peak},
            "cost": {"flops": float(counter.flops * scale)},
            "collectives": coll, "comm_counts": counts}


# ---------------------------------------------------------------------------
# cell runners
# ---------------------------------------------------------------------------


def _write(rec: dict, out_dir: str, tag: str):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag.replace("/", "_") + ".json"), "w") as f:
            json.dump(rec, f, indent=2)


def run_cell(arch_id: str, cell_name: str, *, multi_pod: bool = False, out_dir: str = "",
             num_micro: int = 0, label: str = "", mesh: str | None = None, arch=None,
             cell=None) -> dict:
    """Dry-run one cell; ``arch`` / ``cell`` override the registry's (a
    test's reduced twin)."""
    import copy

    from repro_torch.configs.families import get_arch

    m, mesh_name = mesh_for(multi_pod, mesh)
    arch = arch or get_arch(arch_id)
    if num_micro:
        arch = copy.copy(arch)
        arch.num_micro = num_micro
    cell = cell or arch.cells[cell_name]
    rec = {"arch": arch_id, "cell": cell_name + label, "label": label, "mesh": mesh_name,
           "n_devices": math.prod(m.shape), "status": "error", "card_bytes": CARD_BYTES}
    t0 = time.time()
    try:
        spec = arch.build_cell(cell, m)
        rec["build_seconds"] = time.time() - t0
        t1 = time.time()
        micro = spec.trace_fn is not None and spec.num_micro > 1
        rec.update(trace(spec.trace_fn if micro else spec.fn, spec.args, spec.fake_mode,
                         scale=spec.num_micro if micro else 1))
        rec["trace_seconds"] = time.time() - t1
        rec["num_micro"] = spec.num_micro
        rec["traced_microbatches"] = 1 if micro else spec.num_micro
        rec["model_flops_per_step"] = spec.model_flops_per_step
        rec["note"] = spec.note
        rec.update(spec.aux_info)
        rec["fits"] = rec["memory"]["peak_bytes"] <= CARD_BYTES
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the matrix
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_seconds"] = time.time() - t0
    _write(rec, out_dir, f"{arch_id}__{cell_name}{label}__{mesh_name}")
    return rec


def run_lanns_cell(*, multi_pod: bool = False, out_dir: str = "", mode: str = "routed",
                   corpus_n: int = 180_000_000, dim: int = 50, batch_per_device: int = 64,
                   topk: int = 100, use_pstk: bool = True, num_segments: int = 8,
                   scan_dtype: str = "float32", capacity_factor: float = 1.5,
                   block_n: int = 2048, label: str = "", pod_sharded_corpus: bool = False,
                   mesh: str | None = None) -> dict:
    """Dry-run the distributed LANNS serve step at paper scale (People:
    180M x 50d) through ``serve.retrieval.make_serve_fn``: rank 0's shard of
    the corpus and its block of queries as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.lanns import LannsConfig
    from repro_torch.serve.retrieval import make_serve_fn

    m, mesh_name = mesh_for(multi_pod, mesh)
    shape = dict(zip(m.mesh_dim_names, m.shape))
    corpus_axes = ("pod", "model") if ("pod" in shape and pod_sharded_corpus) else ("model",)
    S = math.prod(shape[a] for a in corpus_axes)
    data_axes = ("pod", "data") if ("pod" in shape and not pod_sharded_corpus) else ("data",)
    cfg = LannsConfig(num_shards=S, num_segments=num_segments, segmenter="apd", alpha=0.15,
                      metric="l2", engine="scan")
    n_seg = int(math.ceil(corpus_n / S / num_segments / 8)) * 8
    rec = {"arch": "lanns-people180m",
           "cell": f"serve_{mode}" + ("" if use_pstk else "_nopstk") + label,
           "mesh": mesh_name, "n_devices": math.prod(m.shape), "status": "error",
           "corpus_n": corpus_n, "dim": dim, "topk": topk, "card_bytes": CARD_BYTES}
    t0 = time.time()
    try:
        serve_fn, sh = make_serve_fn(
            m, cfg, topk=topk, mode=mode, batch_per_device=batch_per_device,
            use_per_shard_topk=use_pstk, query_axes=data_axes, corpus_axes=corpus_axes,
            capacity_factor=capacity_factor, block_n=block_n)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}[scan_dtype]
        n_int = num_segments - 1
        with fake_mode:
            args = (torch.empty((batch_per_device, dim)),
                    torch.empty((1, num_segments, n_seg, dim), dtype=dt),
                    torch.empty((1, num_segments, n_seg), dtype=torch.int32),
                    torch.empty((1, num_segments, n_seg)),
                    {"hyperplanes": torch.empty((n_int, dim)), "split": torch.empty(n_int),
                     "lo": torch.empty(n_int), "hi": torch.empty(n_int)} if mode == "routed"
                    else None)
            if scan_dtype == "int8":
                args = args + (torch.empty(dim),)
        rec.update(trace(serve_fn, args, fake_mode))
        rec["per_shard_topk"] = sh["per_shard_topk"]
        rec["capacity"] = sh["capacity"]
        rec["model_flops_per_step"] = (
            2.0 * batch_per_device * math.prod(shape[a] for a in data_axes) * dim
            * (corpus_n / S)
            * (1.0 if mode == "full" else
               (1 + 2 * cfg.alpha) ** int(math.log2(num_segments)) / num_segments))
        rec["fits"] = rec["memory"]["peak_bytes"] <= CARD_BYTES
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_seconds"] = time.time() - t0
    _write(rec, out_dir, f"lanns__{rec['cell']}__{mesh_name}")
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--cell", default=None)
    p.add_argument("--num-micro", type=int, default=0)
    p.add_argument("--label", default="")
    p.add_argument("--all", action="store_true")
    p.add_argument("--lanns", action="store_true")
    p.add_argument("--lanns-mode", default="routed")
    p.add_argument("--no-pstk", action="store_true")
    p.add_argument("--lanns-dtype", default="float32")
    p.add_argument("--lanns-cf", type=float, default=1.5)
    p.add_argument("--lanns-block", type=int, default=2048)
    p.add_argument("--lanns-label", default="")
    p.add_argument("--lanns-pod-sharded", action="store_true")
    p.add_argument("--lanns-segments", type=int, default=8)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--mesh", default=None, help='a mesh such as "2x4" (data x model)')
    p.add_argument("--out", default="results/dryrun_torch")
    args = p.parse_args(argv)

    from repro_torch.configs.families import ARCH_IDS, get_arch

    results = []
    if args.lanns:
        results.append(run_lanns_cell(
            multi_pod=args.multi_pod, out_dir=args.out, mode=args.lanns_mode,
            use_pstk=not args.no_pstk, scan_dtype=args.lanns_dtype,
            capacity_factor=args.lanns_cf, block_n=args.lanns_block, label=args.lanns_label,
            pod_sharded_corpus=args.lanns_pod_sharded, num_segments=args.lanns_segments,
            mesh=args.mesh))
    elif args.all:
        for aid in ARCH_IDS:
            for cname in get_arch(aid).cell_names():
                rec = run_cell(aid, cname, multi_pod=args.multi_pod, out_dir=args.out,
                               mesh=args.mesh)
                print(f"[{rec['status']:5s}] {aid:22s} {cname:14s} "
                      f"{rec['total_seconds']:6.1f}s  {rec.get('error', '')[:80]}", flush=True)
                results.append(rec)
    else:
        if not args.arch or not args.cell:
            p.error("--arch and --cell required (or --all / --lanns)")
        results.append(run_cell(args.arch, args.cell, multi_pod=args.multi_pod,
                                out_dir=args.out, num_micro=args.num_micro, label=args.label,
                                mesh=args.mesh))

    ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{ok}/{len(results)} cells OK")
    for r in results:
        if r["status"] == "ok":
            mem = r["memory"]
            print(f"  {r['arch']:22s} {r['cell']:14s} {r['mesh']:8s} "
                  f"flops/rank={r['cost']['flops']:.3e} "
                  f"mem(arg/peak)={mem['argument_bytes'] / 2**30:.2f}/"
                  f"{mem['peak_bytes'] / 2**30:.2f} GiB "
                  f"coll={r['collectives']['total_bytes'] / 2**20:.1f} MiB")
        else:
            print(f"  FAIL {r['arch']} {r['cell']}: {r.get('error')}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())

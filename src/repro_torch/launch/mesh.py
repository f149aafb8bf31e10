"""Named meshes over the ranks of a ``torch.distributed`` world.

The port of ``repro.launch.mesh``.  A mesh is PyTorch's own named mesh,
``torch.distributed.device_mesh.init_device_mesh(device_type, shape,
mesh_dim_names=axes)``: each axis has its own process group
(``mesh.get_group(axis)``), and a rank's place on an axis is
``mesh.get_local_rank(axis)``.  Building a mesh touches no device state
beyond the world it is built on: the world comes first (``init_world``),
from the caller or from ``run_world``.

The device follows ``resolve_device``: CUDA unless the caller asks for the
CPU.  The backend follows the device: NCCL on CUDA, gloo on the CPU.  The
one exception is a world with more ranks than cards: NCCL refuses two ranks
of one communicator on one GPU, so such a world runs on gloo, and the
caller asks for it with ``backend="gloo"``; it is never chosen on its own.
"""

from __future__ import annotations

import math
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.utils import resolve_device


def init_world(rank: int, world_size: int, init_method: str, *, device=None,
               backend: str | None = None) -> torch.device:
    """Join this process to a world of ``world_size`` ranks as ``rank``;
    returns the rank's device (on CUDA card ``rank % cards``, made the
    current device before the world starts)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world_size > cards and backend != "gloo":
            raise ValueError(
                f"a world of {world_size} ranks on {cards} card(s) puts two ranks on one "
                "GPU, which NCCL refuses; pass backend='gloo' to run it on gloo"
            )
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
    elif backend not in (None, "gloo"):
        raise ValueError(f"backend {backend!r} on the CPU; the CPU world runs on gloo")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def compat_make_mesh(shape, axes, *, device=None):
    """A named mesh of ``shape`` over the whole world (row-major ranks:
    the last axis varies fastest, as ``jax.make_mesh`` lays out devices)."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: call init_world first")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
                         f"the world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: 'data' = batch axis, 'model' = shard axis, 'pod' = replicas (or
    extra corpus shards for LANNS serving)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device=device)


def make_debug_mesh(data: int = 2, model: int = 4, *, pod: int = 0, device=None):
    """A small mesh for tests (a world of data x model [x pod] ranks)."""
    if pod:
        return compat_make_mesh((pod, data, model), ("pod", "data", "model"), device=device)
    return compat_make_mesh((data, model), ("data", "model"), device=device)


def _rank_main(fn, rank, shape, axes, init_method, device, backend, args, results):
    """A spawned rank: join the world, build the mesh, run ``fn(mesh,
    *args)``, report its value or its traceback."""
    try:
        world = math.prod(shape)
        dev = init_world(rank, world, init_method, device=device, backend=backend)
        if dev.type == "cpu":  # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        mesh = compat_make_mesh(shape, axes, device=dev)
        results.put((rank, True, fn(mesh, *args)))
    except Exception:  # the parent raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, shape, axes, args=(), *, device=None, backend: str | None = None,
              timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a world of ``prod(shape)``
    spawned processes over the mesh ``shape`` x ``axes``; returns each
    rank's value, by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path, so a
    script that calls this needs an ``if __name__ == "__main__":``
    guard).  The ranks are daemonic: ``fn`` starts no processes of its
    own.  The ranks meet through a file store in a fresh temporary
    directory, so parallel worlds never share a rendezvous.  A rank that
    raises, or a world that outlives ``timeout`` seconds, ends every rank
    and raises here.
    """
    import multiprocessing

    shape, axes = tuple(shape), tuple(axes)
    device = str(resolve_device(device).type)
    world = math.prod(shape)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, shape, axes, init, device, backend, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, errors, reported = [None] * world, [], 0
        deadline = time.monotonic() + timeout
        try:
            while reported < world and not errors:  # drain before joining
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
                    if dead:
                        errors.append(f"ranks (rank, exit code) {dead} died without reporting")
                    elif time.monotonic() > deadline:
                        errors.append(f"the world of {world} ranks did not finish in "
                                      f"{timeout} s")
                    continue
                reported += 1
                if not ok:
                    errors.append(f"rank {rank}:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                if errors:
                    p.kill()
                p.join(timeout=60)
            alive = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("run_world: " + "\n".join(errors))
    if alive:
        raise RuntimeError(f"run_world: ranks {alive} did not exit after reporting")
    return out

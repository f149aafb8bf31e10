"""The port's arch families (``repro_torch.configs.families``) vs the JAX
package's ``repro.configs.families``.

* The cells, the reduced configs, the archs' flags and every cell's
  ``model_flops_per_step`` and note equal the reference's (the reference
  builds its cells on a 2 x 4 debug mesh in a child with 8 forced host
  devices; the port on a fake world of 8 ranks, without making any args).
* ``smoke`` passes on the CPU for every arch; smollm-360m's smoke losses
  from the reference's params carried across match the reference's smoke
  within 1e-5.
* In gloo worlds: DimeNet's lane loss on 4 ranks (the reference's
  ``test_gnn_shard_map_loss_matches_local`` setup, and an ``ogb_products``
  cell cut to small halo partitions with node targets and features)
  against one device, and each recsys arch's train step with its tables
  sharded by row over a 1 x 4 mesh against one device: loss, grads and
  params after one step within 1e-5.

Spawned ranks import this module, so JAX is imported inside the tests.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.families import (
    ARCH_IDS,
    GNN_CELLS,
    LM_CELLS,
    RECSYS_CELLS,
    Cell,
    get_arch,
)
from repro_torch.launch.mesh import run_world

ROOT = Path(__file__).resolve().parents[1]

_REF_CELLS = """
import json, dataclasses
from repro.configs import ARCH_IDS, get_arch
from repro.launch.mesh import make_debug_mesh

mesh = make_debug_mesh(2, 4)
out = {}
for aid in ARCH_IDS:
    arch = get_arch(aid)
    rec = {"family": arch.family, "cells": {}}
    for name, cell in arch.cells.items():
        spec = arch.build_cell(cell, mesh)
        rec["cells"][name] = {"cell": [cell.name, cell.kind, cell.global_batch,
                                       cell.seq_len, repr(cell.extra)],
                              "flops": spec.model_flops_per_step, "note": spec.note,
                              "aux": spec.aux_info}
    if arch.family == "lm":
        rec["flags"] = [arch.num_micro, arch.tp, arch.remat_group]
    if arch.family == "recsys":
        rec["flags"] = [arch.embed_dim_retrieval]
    rec["reduced"] = repr(arch.model_config(reduced=True))
    out[aid] = rec
print("CELLS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_cells():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_CELLS)],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("CELLS", 1)[1])


def test_arch_ids_and_cell_tables_match_reference(ref_cells):
    from repro.configs import families as rf

    assert list(ARCH_IDS) == list(ref_cells)
    for port, ref in ((LM_CELLS, rf.LM_CELLS), (GNN_CELLS, rf.GNN_CELLS),
                      (RECSYS_CELLS, rf.RECSYS_CELLS)):
        assert {k: dataclasses.astuple(v) for k, v in port.items()} == \
            {k: dataclasses.astuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_cells_flops_and_flags_match_reference(ref_cells, arch_id):
    from repro_torch.launch.dryrun import fake_mesh
    import torch.distributed as dist

    ref = ref_cells[arch_id]
    arch = get_arch(arch_id)
    assert arch.family == ref["family"]
    if arch.family == "lm":
        assert [arch.num_micro, arch.tp, arch.remat_group] == ref["flags"]
    if arch.family == "recsys":
        assert [arch.embed_dim_retrieval] == ref["flags"]
    try:
        mesh = fake_mesh((2, 4), ("data", "model"))
        assert list(arch.cells) == list(ref["cells"])
        for name, cell in arch.cells.items():
            spec = arch.build_cell(cell, mesh)  # no args are made here
            want = ref["cells"][name]
            assert [cell.name, cell.kind, cell.global_batch, cell.seq_len,
                    repr(cell.extra)] == want["cell"]
            assert spec.model_flops_per_step == pytest.approx(want["flops"], rel=1e-12), name
            assert spec.note == want["note"], name
            assert spec.aux_info == want["aux"], name
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_reduced_configs_match_reference(arch_id):
    from repro.configs import get_arch as ref_get_arch

    ref = ref_get_arch(arch_id).model_config(reduced=True)
    port = get_arch(arch_id).model_config(reduced=True)
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if dataclasses.is_dataclass(got):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, (arch_id, f.name)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_passes_on_cpu(arch_id):
    out = get_arch(arch_id).smoke(seed=0, device="cpu")
    assert all(np.isfinite(v) for v in out.values()), out


def test_lm_smoke_from_reference_params_matches_reference():
    """smollm-360m's smoke on the reference's params (carried across):
    both losses within 1e-5 of the reference's smoke."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf

    ref_arch = ref_get_arch("smollm-360m")
    ref = ref_arch.smoke(seed=0)
    params = jax.tree.map(np.asarray,
                          rtf.init(jax.random.PRNGKey(0), ref_arch.model_config(reduced=True)))
    got = get_arch("smollm-360m").smoke(seed=0, device="cpu", params=params)
    np.testing.assert_allclose(got["loss0"], ref["loss0"], rtol=1e-5)
    np.testing.assert_allclose(got["loss1"], ref["loss1"], rtol=1e-5)


# ---------------------------------------------------------------------------
# DimeNet's lanes on 4 ranks
# ---------------------------------------------------------------------------


def _mol_lanes():
    """The reference test's batch: 4 molecules of 10 atoms and 20 edges,
    triplets padded to 64 (``tests/test_distributed.py:92``)."""
    from repro_torch.data.synthetic import random_molecule_batch
    from repro_torch.models import dimenet as dn

    mols = random_molecule_batch(4, n_nodes=10, n_edges=20, seed=0)
    t_in = np.full((4, 64), -1, np.int32)
    t_out = np.full((4, 64), -1, np.int32)
    for b in range(4):
        ti, to = dn.build_triplets(mols["edge_index"][b], 10)
        m = min(64, len(ti))
        t_in[b, :m], t_out[b, :m] = ti[:m], to[:m]
    return {"positions": mols["positions"], "edge_index": mols["edge_index"], "t_in": t_in,
            "t_out": t_out, "z": mols["z"], "y": mols["y"]}


GNN_CFG = dict(n_blocks=2, d_hidden=16, n_bilinear=2, n_spherical=3, n_radial=3)
OGB_CUT = (("n_nodes", 2_449_029), ("n_edges", 61_859_140), ("d_feat", 8),
           ("triplet_cap", 4), ("n_loc", 24), ("e_loc", 64))


def _gnn_arch():
    from repro_torch.models.dimenet import DimeNetConfig

    arch = copy.copy(get_arch("dimenet"))
    arch._cfg_for_cell = lambda cell: DimeNetConfig(d_node_feat=cell.get("d_feat", 0) or 0,
                                                    **GNN_CFG)
    return arch


def _grads_and_step(loss_fn, params, batch):
    from repro_torch.common.tree import flatten
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import _accumulate_grads, make_train_step

    loss, grads, _ = _accumulate_grads(loss_fn, params, batch, 1)
    names = [n for n, _ in flatten(params)]
    step = make_train_step(loss_fn, AdamWConfig(lr=1e-3, total_steps=10_000))
    _, _, m = step(params, init_state(params), batch)
    return loss, dict(zip(names, grads)), m, params


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().to(torch.float32).numpy()


def _gnn_world(mesh, params_np, mol_batch):
    """The molecule lanes through ``dimenet_loss_fn`` on the mesh (lanes
    over both axes), and an ogb_products cell cut small through
    ``GNNArch.build_cell``: loss, grads and params after one step."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.common.tree import flatten, unflatten
    from repro_torch.configs.families import GNN_CELLS, make_ctx
    from repro_torch.convert import dimenet_params_from_jax
    from repro_torch.models.dimenet import DimeNetConfig
    from repro_torch.train.train_step import dimenet_loss_fn

    out = {}
    cfg = DimeNetConfig(**GNN_CFG)
    p = dimenet_params_from_jax(cfg, params_np, device="cpu")
    rep = [Replicate(), Replicate()]
    p = unflatten(p, [distribute_tensor(t, mesh, rep, src_data_rank=None)
                      for t in [x for _, x in flatten(p)]])
    lanes = [Shard(0), Shard(0)]
    b = {k: distribute_tensor(torch.as_tensor(v), mesh, lanes, src_data_rank=None)
         for k, v in mol_batch.items()}
    loss, grads, m, p = _grads_and_step(dimenet_loss_fn(cfg, make_ctx(mesh)), p, b)
    out["mol"] = {"loss": float(_full(loss)), "grads": {n: _full(g) for n, g in grads.items()}}

    arch = _gnn_arch()
    cell = dataclasses.replace(GNN_CELLS["ogb_products"], extra=OGB_CUT)
    spec = arch.build_cell(cell, mesh)
    params, st, batch = spec.make_args(seed=0, device="cpu")
    loss, grads, m, params = _grads_and_step(dimenet_loss_fn(arch._cfg_for_cell(cell),
                                                             make_ctx(mesh)), params, batch)
    out["ogb"] = {"loss": float(_full(loss)),
                  "grads": {n: _full(g) for n, g in grads.items()},
                  "params": {n: _full(x) for n, x in flatten(params)},
                  "batch": {k: _full(v) for k, v in batch.items()}}
    return out if mesh.get_rank() == 0 else None


@pytest.fixture(scope="module")
def gnn_world():
    import jax

    from repro.models import dimenet as rdn

    ref_params = rdn.init(jax.random.PRNGKey(0), rdn.DimeNetConfig(**GNN_CFG))
    params_np = jax.tree.map(np.asarray, ref_params)
    got = run_world(_gnn_world, (2, 2), ("data", "model"), (params_np, _mol_lanes()),
                    device="cpu")[0]
    return got, ref_params


def test_gnn_lane_loss_on_four_ranks_matches_reference(gnn_world):
    """The reference's ``local_loss`` (vmapped, one device) and its grads
    against the port's lane loss on 4 ranks."""
    import jax
    import jax.numpy as jnp

    from repro.models import dimenet as rdn

    got, ref_params = gnn_world
    cfg = rdn.DimeNetConfig(**GNN_CFG)
    batch = {k: jnp.asarray(v) for k, v in _mol_lanes().items()}

    def local_loss(p, batch):
        def one(pos, ei, ti, to, z):
            _, g = rdn.apply(p, cfg, positions=pos, edge_index=ei, t_in=ti, t_out=to, z=z)
            return g[0]

        pred = jax.vmap(one)(batch["positions"], batch["edge_index"], batch["t_in"],
                             batch["t_out"], batch["z"])
        return jnp.mean((pred - batch["y"]) ** 2)

    l0, g0 = jax.value_and_grad(local_loss)(ref_params, batch)
    np.testing.assert_allclose(got["mol"]["loss"], float(l0), rtol=1e-5)
    for path, g in jax.tree_util.tree_flatten_with_path(g0)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got["mol"]["grads"][name] - g).max()) <= 1e-5 * scale, name


def test_ogb_products_lanes_match_one_device(gnn_world):
    """An ogb_products cell cut to 4 halo partitions of 24 nodes (half
    owned) and 64 edges with bf16 features: the lane loss on 4 ranks
    against ``dimenet_loss_fn`` on one device over the same 4 lanes."""
    from repro_torch.common.tree import flatten
    from repro_torch.configs.families import GNN_CELLS
    from repro_torch.models import dimenet as dn
    from repro_torch.train.train_step import dimenet_loss_fn

    got = gnn_world[0]["ogb"]
    arch = _gnn_arch()
    cell = dataclasses.replace(GNN_CELLS["ogb_products"], extra=OGB_CUT)
    cfg = arch._cfg_for_cell(cell)
    params = dn.init(cfg, 0, "cpu")
    b = got["batch"]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch["features"] = batch["features"].to(torch.bfloat16)
    for k in ("edge_index", "t_in", "t_out"):
        batch[k] = batch[k].to(torch.int32)
    batch["node_mask"] = batch["node_mask"].bool()
    assert int(batch["node_mask"].sum()) == 4 * 12
    loss, grads, _, params = _grads_and_step(dimenet_loss_fn(cfg), params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for n, g in grads.items():
        g = g.detach().numpy()
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got["grads"][n] - g).max()) <= 1e-5 * scale, n
    for n, x in flatten(params):
        np.testing.assert_allclose(got["params"][n], x.detach().numpy(), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# recsys tables sharded by row over a 1 x 4 mesh
# ---------------------------------------------------------------------------

RS_B = 16


def _rs_arch(arch_id):
    """The reduced config with tables of 4,096 rows or more, so they shard
    (the reduced vocabs are 64 a field)."""
    from repro_torch.models import recsys as rs

    arch = copy.copy(get_arch(arch_id))
    cfg = arch.model_config(reduced=True)
    if isinstance(cfg, (rs.AutoIntConfig, rs.XDeepFMConfig)):
        cfg = dataclasses.replace(cfg, vocab_sizes=(128,) * cfg.n_sparse)
    elif isinstance(cfg, rs.DINConfig):
        cfg = dataclasses.replace(cfg, n_items=5000, context_vocab=600)
    else:
        cfg = dataclasses.replace(cfg, n_items=5000)
    arch._config = cfg
    arch._cell_config = lambda: cfg  # float32, so one device agrees within rounding
    return arch, cfg


def _recsys_world(mesh, arch_ids):
    from torch.distributed.tensor import Shard

    from repro_torch.common.tree import flatten
    from repro_torch.configs.families import make_ctx
    from repro_torch.train.train_step import recsys_loss_fn

    out = {}
    for aid in arch_ids:
        arch, cfg = _rs_arch(aid)
        spec = arch.build_cell(Cell("train_batch", "train", global_batch=RS_B), mesh)
        params, st, batch = spec.make_args(seed=0, device="cpu")
        sharded = [n for n, p in flatten(params) if any(isinstance(x, Shard)
                                                        for x in p.placements)]
        loss, grads, _, params = _grads_and_step(recsys_loss_fn(aid, cfg, make_ctx(mesh)),
                                                 params, batch)
        out[aid] = {"loss": float(_full(loss)), "sharded": sharded,
                    "grads": {n: _full(g) for n, g in grads.items()},
                    "params": {n: _full(x) for n, x in flatten(params)},
                    "batch": {k: _full(v) for k, v in batch.items()}}
    return out if mesh.get_rank() == 0 else None


RS_IDS = ("autoint", "din", "sasrec", "xdeepfm")


@pytest.fixture(scope="module")
def recsys_world():
    return run_world(_recsys_world, (1, 4), ("data", "model"), (RS_IDS,), device="cpu")[0]


@pytest.mark.parametrize("arch_id", RS_IDS)
def test_recsys_step_with_row_sharded_tables_matches_one_device(recsys_world, arch_id):
    from repro_torch.common.tree import flatten
    from repro_torch.models import recsys as rs
    from repro_torch.train.train_step import recsys_loss_fn

    got = recsys_world[arch_id]
    assert got["sharded"], "no table was sharded"
    _, cfg = _rs_arch(arch_id)
    params = rs.init(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in got["batch"].items()}
    batch = {k: v if k == "label" else v.to(torch.int32) for k, v in batch.items()}
    loss, grads, _, params = _grads_and_step(recsys_loss_fn(arch_id, cfg), params, batch)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for n, g in grads.items():
        g = g.detach().to(torch.float32).numpy()
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got["grads"][n] - g).max()) <= 1e-5 * scale + 1e-8, n
    for n, x in flatten(params):
        np.testing.assert_allclose(got["params"][n], x.detach().to(torch.float32).numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)

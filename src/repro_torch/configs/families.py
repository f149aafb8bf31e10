"""Arch families: everything needed to smoke-test and dry-run one cell.

The port of ``repro.configs.families``.  An ``Arch`` bundles:
  * the exact published model config (+ a reduced smoke twin),
  * its shape cells (name -> :class:`Cell`),
  * ``build_cell(cell, mesh)`` -> :class:`LoweredSpec`: the step function
    over DTensors on a named ``DeviceMesh`` (``launch/mesh.py``), its
    arguments as fake tensors (never allocated; ``launch/dryrun.py`` traces
    the step on them), their placements, and ``make_args`` for real ones of
    the same placements,
  * ``smoke(seed, device)``: the reference's reduced-config step with its
    asserts, on the card unless ``device="cpu"``.

Dtype policy: cells use bf16 params/compute with f32 optimizer moments
(production mixed precision); smoke tests run f32.

The sharded steps are the reference's layouts on DTensors: the LMs' FSDP +
TP params (``transformer.param_specs``), activations constrained where the
reference constrains them and MoE's expert-parallel layer under
``local_map``; DimeNet's lanes (one halo partition a rank on
``ogb_products``) under ``local_map`` with the loss's sums all-reduced;
the recsys tables of 4,096 rows or more sharded by row over 'model'.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property, lru_cache
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten, leaves, unflatten
from repro_torch.distributed.sharding_rules import ShardingCtx, flat_specs, mesh_shape
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import (
    dimenet_loss_fn,
    lm_loss_fn,
    make_train_step,
    recsys_loss_fn,
)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode' | 'forward' | 'retrieval'
    global_batch: int = 1
    seq_len: int = 0
    extra: tuple = ()  # extra (key, value) pairs

    def get(self, key, default=None):
        return dict(self.extra).get(key, default)


@dataclasses.dataclass
class LoweredSpec:
    """A cell's step on a mesh: what ``launch/dryrun.py`` traces.

    ``fn(*args)`` runs the step on every rank.  ``args`` are DTensors of
    fake tensors made (at first use) under ``fake_mode``, never allocated;
    ``make_args(seed, device)`` makes real ones of the same shapes and
    placements (random params, zero moments, a synthetic batch).
    ``placements`` holds, for each arg, {leaf name: placements}.  A
    microbatched train step also has ``trace_fn``, the same step over its
    first microbatch only, and ``num_micro``: the dry run traces that one
    and scales its flops."""

    fn: Callable
    build_args: Callable  # (seed, device, fake) -> (args, placements)
    device_type: str
    note: str = ""
    model_flops_per_step: float = 0.0  # 6*N*D (dense) / 6*N_active*D (MoE)
    donate: tuple = ()  # in-place args (params/opt/KV cache)
    aux_info: dict = dataclasses.field(default_factory=dict)
    trace_fn: Optional[Callable] = None
    num_micro: int = 1

    @cached_property
    def _fake(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            args, placements = self.build_args(0, self.device_type, fake=True)
        return mode, args, placements

    @property
    def fake_mode(self):
        return self._fake[0]

    @property
    def args(self) -> tuple:
        return self._fake[1]

    @property
    def placements(self) -> tuple:
        return self._fake[2]

    def make_args(self, seed: int = 0, device=None) -> tuple:
        return self.build_args(seed, device or self.device_type, fake=False)[0]


def make_ctx(mesh, *, pod_dp: bool = True) -> ShardingCtx:
    ctx = ShardingCtx(mesh=mesh)
    if mesh is not None and "pod" in mesh_shape(mesh) and pod_dp:
        rules = dict(ctx.rules)
        rules["batch"] = ("pod", "data")
        ctx = dataclasses.replace(ctx, rules=rules)
    return ctx


def _place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` (the same whole tensor on every rank) as a DTensor: each rank
    keeps its own shard, no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)


def _place_tree(tree, mesh, placements_of: Callable):
    """A tree of tensors as DTensors, ``placements_of(name)`` for each leaf;
    returns (tree, {name: placements})."""
    named = flatten(tree)
    pls = {name: placements_of(name) for name, _ in named}
    return unflatten(tree, [_place(t, mesh, pls[name]) for name, t in named]), pls


def _lane_placements(mesh, axes):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if a in axes else Replicate() for a in mesh.mesh_dim_names]


def _opt_state(params, pls):
    st = init_state(params)
    return st, {"step": [], "m": pls, "v": pls}


def _lower(build_args: Callable, mesh, **kw) -> LoweredSpec:
    return LoweredSpec(build_args=build_args, device_type=mesh.device_type, **kw)


class Arch:
    arch_id: str = ""
    family: str = ""
    cells: dict = {}

    # -- interface -----------------------------------------------------------
    def model_config(self, reduced: bool = False):
        raise NotImplementedError

    def build_cell(self, cell: Cell, mesh) -> LoweredSpec:
        raise NotImplementedError

    def smoke(self, seed: int = 0, device=None) -> dict:
        """Reduced-config forward + train step; returns metrics."""
        raise NotImplementedError

    def cell_names(self):
        return list(self.cells)


# ===========================================================================
# LM family
# ===========================================================================

LM_CELLS = {
    "train_4k": Cell("train_4k", "train", global_batch=256, seq_len=4096),
    "prefill_32k": Cell("prefill_32k", "prefill", global_batch=32, seq_len=32_768),
    "decode_32k": Cell("decode_32k", "decode", global_batch=128, seq_len=32_768),
    "long_500k": Cell("long_500k", "decode", global_batch=1, seq_len=524_288),
}


class LMArch(Arch):
    family = "lm"

    def __init__(self, arch_id: str, config, *, num_micro: int = 16, tp: bool = True,
                 remat_group: int = 0, smoke_overrides: Optional[dict] = None):
        """tp=False: pure FSDP/DP — the 'model' axis joins the batch/FSDP
        axes instead of tensor-parallelism (smollm: 15 heads divide no TP
        width)."""
        self.arch_id = arch_id
        self._config = config
        self.cells = dict(LM_CELLS)
        self.num_micro = num_micro
        self.tp = tp
        self.remat_group = remat_group
        self.smoke_overrides = smoke_overrides or {}

    def model_config(self, reduced: bool = False):
        from repro_torch.configs.registry import reduced_config

        if not reduced:
            return self._config
        return dataclasses.replace(reduced_config(self._config), **self.smoke_overrides)

    def _dryrun_model_cfg(self, cell: Cell):
        # chunked (flash, K3) attention everywhere except decode
        return dataclasses.replace(
            self._config, param_dtype="bfloat16", compute_dtype="bfloat16",
            remat=cell.kind == "train",
            remat_group=self.remat_group if cell.kind == "train" else 0,
            q_chunk=0 if cell.kind == "decode" else 1024, kv_chunk=2048,
        )

    def cell_ctx(self, cell: Cell, mesh) -> ShardingCtx:
        """The cell's rules: ``make_ctx``'s, and for tp=False nothing
        model-sharded — on train cells the model axis joins the batch axes
        (or, multi-pod, the FSDP axis)."""
        ctx = make_ctx(mesh)
        if self.tp:
            return ctx
        rules = dict(ctx.rules, model=(), vocab=(), expert=())
        if cell.kind == "train":
            if "pod" in mesh_shape(mesh):
                rules["batch"] = ("pod", "data")
                rules["fsdp"] = ("model",)
            else:
                rules["batch"] = ("data", "model")
        return dataclasses.replace(ctx, rules=rules)

    def build_cell(self, cell: Cell, mesh) -> LoweredSpec:
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import make_decode_fn, make_prefill_fn

        ctx = self.cell_ctx(cell, mesh)
        cfg = self._dryrun_model_cfg(cell)
        B, S = cell.global_batch, cell.seq_len
        n_active = cfg.num_active_params()
        batch_pl = ctx.placements((ctx.spec("batch")[0], None))

        def params_of(seed, device):
            params = tf.init(cfg, seed, device)
            specs = flat_specs(tf.layer_specs(params, cfg, ctx))
            pls = {n: ctx.placements(s) for n, s in specs.items()}
            tf.map_params(params, lambda n, t: _place(t, mesh, pls[n]))
            return params, pls

        if cell.kind == "train":
            opt_cfg = AdamWConfig(lr=3e-4, total_steps=10_000)
            loss = lm_loss_fn(cfg, ctx)
            num_micro = self.num_micro
            if not self.tp and "pod" in mesh_shape(mesh):
                num_micro = max(num_micro, 8)  # 32 batch lanes instead of 256

            def build(seed, device, fake):
                params, pls = params_of(seed, device)
                st, st_pl = _opt_state(params, pls)
                gen = torch.Generator(device="cpu").manual_seed(seed)
                toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen).to(
                    device=device, dtype=torch.int32)
                batch = {"tokens": _place(toks[:, :-1], mesh, batch_pl),
                         "labels": _place(toks[:, 1:], mesh, batch_pl)}
                return (params, st, batch), (pls, st_pl, {"tokens": batch_pl,
                                                          "labels": batch_pl})

            return _lower(
                build, mesh, fn=make_train_step(loss, opt_cfg, num_micro=num_micro),
                trace_fn=make_train_step(loss, opt_cfg, num_micro=num_micro, micro_limit=1),
                num_micro=num_micro, model_flops_per_step=6.0 * n_active * B * S,
                note=f"microbatch={num_micro}, remat, fsdp+tp", donate=(0, 1))

        # serving cells: a bf16 cache whose sequence dim is sharded per cell
        names = mesh_shape(mesh)
        batch_axes = tuple(a for a in ctx.rules["batch"] if a in names)
        if cell.name == "long_500k":  # the whole mesh serves one stream
            seq_axes, cache_batch = ("data", "model"), ()
        else:
            seq_axes, cache_batch = ("model",), batch_axes
        cache_spec = (None, cache_batch or None, seq_axes)
        if cfg.attention == "mla":
            cache_shapes = {"latent": (cfg.n_layers, B, S, cfg.mla_kv_lora_rank),
                            "k_rope": (cfg.n_layers, B, S, cfg.mla_qk_rope_head_dim)}
        else:
            kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
            cache_shapes = {"k": kv, "v": kv}
        n_dev_cache = 256 if "pod" in names else math.prod(names.values())
        cache_bytes_device = sum(math.prod(s) * 2 for s in cache_shapes.values()) // n_dev_cache
        cache_pl = ctx.placements(cache_spec)
        decode = cell.kind == "decode"
        tok_pl = batch_pl if (not decode or B > 1) else ctx.placements((None, None))

        def build(seed, device, fake):
            params, pls = params_of(seed, device)
            cache = {k: _place(torch.zeros(s, dtype=torch.bfloat16, device=device), mesh,
                               cache_pl) for k, s in cache_shapes.items()}
            gen = torch.Generator(device="cpu").manual_seed(seed)
            toks = torch.randint(0, cfg.vocab, (B, 1 if decode else S), generator=gen)
            toks = _place(toks.to(device=device, dtype=torch.int32), mesh, tok_pl)
            c_pl = {k: cache_pl for k in cache}
            if decode:
                return (params, toks, cache, S - 1), (pls, tok_pl, c_pl, None)
            return (params, toks, cache), (pls, tok_pl, c_pl)

        mf = 2.0 * n_active * (B if decode else B * S)
        return _lower(
            build, mesh, fn=(make_decode_fn if decode else make_prefill_fn)(cfg, ctx),
            model_flops_per_step=mf, donate=(2,),
            note=f"kv seq axes={seq_axes}" if decode else "chunked attention, bf16 cache",
            aux_info={"cache_bytes_device": cache_bytes_device})

    # -- smoke ------------------------------------------------------------------
    def smoke(self, seed: int = 0, device=None, params=None) -> dict:
        """The reference's smoke: logits of a (4, 16) batch, two train steps
        (2 microbatches) with the second loss below 1.5x the first, and
        decode against a cache equal to the full forward.  ``params``: the
        reference's params as numpy arrays, carried across (else random)."""
        from repro_torch.common.utils import resolve_device
        from repro_torch.convert import transformer_from_jax
        from repro_torch.data.synthetic import token_batch
        from repro_torch.models import transformer as tf

        dev = resolve_device(device)
        cfg = self.model_config(reduced=True)
        p = (tf.init(cfg, seed, dev) if params is None
             else transformer_from_jax(cfg, params, device=dev))
        toks, labels = token_batch(4, 16, cfg.vocab, seed=seed)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        logits, _, _ = tf.apply(p, cfg, batch["tokens"])
        assert tuple(logits.shape) == (4, 16, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        step = make_train_step(lm_loss_fn(cfg), opt_cfg, num_micro=2)
        st = init_state(p)
        _, st, m1 = step(p, st, batch)
        l1 = float(m1["loss"])
        _, _, m2 = step(p, st, batch)
        l2 = float(m2["loss"])
        assert np.isfinite(l1) and l2 < l1 * 1.5, (l1, l2)
        # decode parity with a cache
        cache = tf.make_cache(cfg, 2, 20, dtype=torch.float32, device=dev)
        tf.apply(p, cfg, batch["tokens"][:2, :8], cache=cache, cache_offset=0)
        lg_d, _, _ = tf.apply(p, cfg, batch["tokens"][:2, 8:9], cache=cache, cache_offset=8)
        lg_full, _, _ = tf.apply(p, cfg, batch["tokens"][:2, :9])
        err = float((lg_d[:, 0] - lg_full[:, 8]).abs().max())
        assert err < 1e-3, err
        return {"loss0": l1, "loss1": l2, "decode_err": err}


# ===========================================================================
# GNN family (DimeNet)
# ===========================================================================

GNN_CELLS = {
    # full-batch small graph (cora-scale): fits replicated, single step.
    "full_graph_sm": Cell(
        "full_graph_sm", "train",
        extra=(("n_nodes", 2708), ("n_edges", 10556), ("d_feat", 1433),
               ("triplet_cap", 8)),
    ),
    # sampled training on a reddit-scale graph: one padded subgraph a lane.
    "minibatch_lg": Cell(
        "minibatch_lg", "train",
        extra=(("n_nodes", 232_965), ("n_edges", 114_615_892),
               ("batch_nodes", 1024), ("fanout", (15, 10)),
               ("n_max", 16_384), ("e_max", 16_384), ("t_max", 32_768)),
    ),
    # full-batch LARGE graph: halo-partitioned data parallelism (DistDGL
    # style) — each rank owns one locality partition (nodes + halo, local
    # edges + capped triplets); only the loss's sums cross ranks.
    "ogb_products": Cell(
        "ogb_products", "train",
        extra=(("n_nodes", 2_449_029), ("n_edges", 61_859_140), ("d_feat", 100),
               ("triplet_cap", 4), ("n_loc", 16_384), ("e_loc", 262_144)),
    ),
    "molecule": Cell(
        "molecule", "train", global_batch=128,
        extra=(("n_nodes", 30), ("n_edges", 64), ("t_max", 256)),
    ),
}


def random_lane(n: int, E: int, T: int, *, seed: int, d_feat: int = 0, cap: int = 0,
                owned: int = 0, node_targets: bool = True) -> dict:
    """One padded graph lane of a GNN cell (numpy): n nodes at random
    positions, E random directed edges (no self-loops), their triplets
    (``build_triplets``, at most ``cap`` in-edges an edge when cap > 0)
    padded or cut to T with -1, species z (or features of width d_feat,
    bf16 values), and targets: y (n,) masked to the first ``owned`` nodes
    (all when 0; a halo partition's owned nodes), or one graph target."""
    from repro_torch.models.dimenet import build_triplets

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E)
    dst = (src + rng.integers(1, n, E)) % n
    ei = np.stack([src, dst]).astype(np.int32)
    t_in, t_out = build_triplets(ei, n, max_in_per_edge=cap or None)
    m = min(T, len(t_in))
    ti = np.full(T, -1, np.int32)
    to = np.full(T, -1, np.int32)
    ti[:m], to[:m] = t_in[:m], t_out[:m]
    lane = {"positions": (rng.standard_normal((n, 3)) * 2.0).astype(np.float32),
            "edge_index": ei, "t_in": ti, "t_out": to}
    if d_feat:
        feats = rng.standard_normal((n, d_feat)).astype(np.float32)
        lane["features"] = torch.from_numpy(feats).to(torch.bfloat16)
    else:
        lane["z"] = rng.integers(1, 10, n).astype(np.int32)
    if node_targets:
        lane["y"] = rng.standard_normal(n).astype(np.float32)
        lane["node_mask"] = np.arange(n) < (owned or n)
    else:
        lane["y"] = np.float32(rng.standard_normal())
    return lane


class GNNArch(Arch):
    family = "gnn"

    def __init__(self, arch_id: str, config):
        self.arch_id = arch_id
        self._config = config
        self.cells = dict(GNN_CELLS)

    def model_config(self, reduced: bool = False):
        from repro_torch.configs.registry import reduced_gnn_config

        return reduced_gnn_config(self._config) if reduced else self._config

    def _cfg_for_cell(self, cell: Cell):
        return dataclasses.replace(self._config, d_node_feat=cell.get("d_feat", 0) or 0,
                                   param_dtype="bfloat16", compute_dtype="bfloat16")

    def lane_shapes(self, cell: Cell, mesh) -> tuple:
        """(lane axes, lanes, per-lane shapes) of a cell on ``mesh``."""
        ctx = make_ctx(mesh)
        shape = mesh_shape(mesh)
        if cell.name == "molecule":
            axes = tuple(a for a in ctx.rules["batch"] if a in shape)
            return axes, cell.global_batch, (cell.get("n_nodes"), cell.get("n_edges"),
                                              cell.get("t_max"))
        if cell.name == "minibatch_lg":
            axes = tuple(a for a in ("pod", "data") if a in shape)
            return axes, math.prod(shape[a] for a in axes), (
                cell.get("n_max"), cell.get("e_max"), cell.get("t_max"))
        if cell.name == "ogb_products":  # one halo partition a rank
            axes = tuple(a for a in ("pod", "data", "model") if a in shape)
            e = cell.get("e_loc")
            return axes, math.prod(shape[a] for a in axes), (
                cell.get("n_loc"), e, e * cell.get("triplet_cap"))
        n, E = cell.get("n_nodes"), cell.get("n_edges")
        return (), 0, (n, E, E * cell.get("triplet_cap"))

    def build_cell(self, cell: Cell, mesh) -> LoweredSpec:
        from repro_torch.models import dimenet as dn

        ctx = make_ctx(mesh)
        cfg = self._cfg_for_cell(cell)
        axes, lanes, (n, E, T) = self.lane_shapes(cell, mesh)
        opt_cfg = AdamWConfig(lr=1e-3, total_steps=10_000)
        rep = _lane_placements(mesh, ())
        d_feat = cell.get("d_feat", 0)
        graph_targets = cell.name in ("molecule", "minibatch_lg")

        def batch_shapes():
            lead = (lanes,) if lanes else ()
            f32, i32 = torch.float32, torch.int32
            b = {"positions": ((*lead, n, 3), f32), "edge_index": ((*lead, 2, E), i32),
                 "t_in": ((*lead, T), i32), "t_out": ((*lead, T), i32)}
            if d_feat:
                b["features"] = ((*lead, n, d_feat), torch.bfloat16 if lanes else f32)
            else:
                b["z"] = ((*lead, n), i32)
            if graph_targets:
                b["y"] = ((lanes,), f32)
            else:
                b["y"] = ((*lead, n), f32)
                b["node_mask"] = ((*lead, n), torch.bool)
            return b

        def real_batch(seed):
            kw = dict(d_feat=d_feat, cap=cell.get("triplet_cap", 0),
                      node_targets=not graph_targets)
            if cell.name == "ogb_products":
                kw["owned"] = n // 2
            if not lanes:
                one = random_lane(n, E, T, seed=seed, **kw)
                return {k: torch.as_tensor(v) for k, v in one.items()}
            ls = [random_lane(n, E, T, seed=seed + i, **kw) for i in range(lanes)]
            return {k: torch.stack([torch.as_tensor(l[k]) for l in ls]) for k in ls[0]}

        b_pl = _lane_placements(mesh, axes)

        def build(seed, device, fake):
            params = dn.init(cfg, seed, device)
            params, pls = _place_tree(params, mesh, lambda name: rep)
            st, st_pl = _opt_state(params, pls)
            if fake:
                raw = {k: torch.empty(s, dtype=dt, device=device)
                       for k, (s, dt) in batch_shapes().items()}
            else:
                raw = {k: v.to(device) for k, v in real_batch(seed).items()}
            batch = {k: _place(v, mesh, b_pl) for k, v in raw.items()}
            return (params, st, batch), (pls, st_pl, {k: b_pl for k in batch})

        n_edges_step = {"molecule": cell.global_batch * cell.get("n_edges", 0),
                        "minibatch_lg": lanes * E, "ogb_products": lanes * E}.get(
                            cell.name, cell.get("n_edges", 1))
        per_edge_params = cfg.num_params() / max(cfg.n_blocks, 1)
        return _lower(
            build, mesh, fn=make_train_step(dimenet_loss_fn(cfg, ctx), opt_cfg),
            model_flops_per_step=6.0 * per_edge_params * max(n_edges_step, 1), donate=(0, 1),
            note=f"layout={cell.name}; triplet cap {cell.get('triplet_cap')}")

    def smoke(self, seed: int = 0, device=None, params=None) -> dict:
        """The reference's smoke: 6 steps on 4 molecules of 12 atoms, the
        last loss below the first."""
        from repro_torch.common.utils import resolve_device
        from repro_torch.convert import dimenet_params_from_jax
        from repro_torch.data.synthetic import random_molecule_batch
        from repro_torch.models import dimenet as dn

        dev = resolve_device(device)
        cfg = self.model_config(reduced=True)
        p = (dn.init(cfg, seed, dev) if params is None
             else dimenet_params_from_jax(cfg, params, device=dev))
        mols = random_molecule_batch(4, n_nodes=12, n_edges=24, seed=seed)
        t_in = np.full((4, 64), -1, np.int32)
        t_out = np.full((4, 64), -1, np.int32)
        for b in range(4):
            ti, to = dn.build_triplets(mols["edge_index"][b], 12)
            m = min(64, len(ti))
            t_in[b, :m], t_out[b, :m] = ti[:m], to[:m]
        batch = {"positions": mols["positions"], "edge_index": mols["edge_index"],
                 "t_in": t_in, "t_out": t_out, "z": mols["z"], "y": mols["y"]}
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}
        step = make_train_step(dimenet_loss_fn(cfg),
                               AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
        st = init_state(p)
        losses = []
        for _ in range(6):
            p, st, m = step(p, st, batch)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(l) for l in losses)
        assert losses[-1] < losses[0], losses
        return {"loss0": losses[0], "loss_last": losses[-1]}


# ===========================================================================
# RecSys family
# ===========================================================================

RECSYS_CELLS = {
    "train_batch": Cell("train_batch", "train", global_batch=65_536),
    "serve_p99": Cell("serve_p99", "forward", global_batch=512),
    "serve_bulk": Cell("serve_bulk", "forward", global_batch=262_144),
    "retrieval_cand": Cell(
        "retrieval_cand", "retrieval", global_batch=1,
        extra=(("n_candidates", 1_000_000),),
    ),
}


class RecsysArch(Arch):
    family = "recsys"

    def __init__(self, arch_id: str, config, *, embed_dim_retrieval: int = 0):
        self.arch_id = arch_id
        self._config = config
        self.cells = dict(RECSYS_CELLS)
        self.embed_dim_retrieval = embed_dim_retrieval

    def model_config(self, reduced: bool = False):
        from repro_torch.configs.registry import reduced_recsys_config

        return reduced_recsys_config(self._config) if reduced else self._config

    def _cell_config(self):
        """The cells' config: bf16 params and compute."""
        return dataclasses.replace(self._config, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")

    def _batch_shapes(self, cfg, B: int, for_loss: bool) -> dict:
        from repro_torch.models import recsys as rs

        if isinstance(cfg, (rs.AutoIntConfig, rs.XDeepFMConfig)):
            b = {"sparse_ids": (B, cfg.n_sparse)}
        elif isinstance(cfg, rs.DINConfig):
            b = {"history": (B, cfg.seq_len), "hist_len": (B,), "target_item": (B,),
                 "context_ids": (B, cfg.n_context)}
        elif isinstance(cfg, rs.SASRecConfig):
            b = {"item_seq": (B, cfg.seq_len)}
            if for_loss:
                b["next_items"] = (B, cfg.seq_len)
                b["neg_items"] = (B, cfg.seq_len)
        else:
            raise TypeError(type(cfg))
        b = {k: (s, torch.int32) for k, s in b.items()}
        if for_loss and not isinstance(cfg, rs.SASRecConfig):
            b["label"] = ((B,), torch.float32)
        return b

    def _param_specs(self, params) -> dict:
        """Embedding tables row-sharded over 'model' (LANNS level-1 applied
        to tables): a 2-d leaf named ``*table*`` (or under one) of 4,096
        rows or more; everything else replicated.  A tree of params' shape
        whose leaves are specs."""

        def spec_for(names, leaf):
            if "table" in names[-1] or (len(names) >= 2 and "table" in names[-2]):
                if leaf.ndim == 2 and leaf.shape[0] >= 4096:
                    return ("model", None)
            if names[-1] == "offsets":
                return ()
            return (None,) * leaf.ndim

        def walk(t, names):
            if isinstance(t, dict):
                return {k: walk(v, names + [k]) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [walk(v, names + [str(i)]) for i, v in enumerate(t)]
            return spec_for(names, t)

        return walk(params, [])

    def _active_params_per_example(self, cfg):
        """Params touched per example (embedding rows looked up + MLPs)."""
        from repro_torch.models import recsys as rs

        if isinstance(cfg, rs.AutoIntConfig):
            dh = cfg.d_attn * cfg.n_heads
            mlp = cfg.n_sparse * cfg.embed_dim * dh * 4 * cfg.n_attn_layers
            return cfg.n_sparse * cfg.embed_dim + mlp + cfg.n_sparse * dh
        if isinstance(cfg, rs.DINConfig):
            d = cfg.embed_dim
            att = 4 * d * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1]
            mlp_in = 2 * d + cfg.n_context * d
            mlp = mlp_in * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1]
            return (cfg.seq_len + 1 + cfg.n_context) * d + cfg.seq_len * att + mlp
        if isinstance(cfg, rs.SASRecConfig):
            d = cfg.embed_dim
            per = 6 * d * d
            return cfg.seq_len * d + cfg.n_blocks * cfg.seq_len * per / cfg.seq_len
        if isinstance(cfg, rs.XDeepFMConfig):
            d = cfg.embed_dim
            cin, hk_prev = 0, cfg.n_sparse
            for hk in cfg.cin_layers:
                cin += hk_prev * cfg.n_sparse * hk * d
                hk_prev = hk
            dims = (cfg.n_sparse * d,) + cfg.mlp + (1,)
            mlp = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
            return cfg.n_sparse * d + cin + mlp
        raise TypeError(type(cfg))

    def _real_batch(self, cfg, B: int, seed: int, for_loss: bool) -> dict:
        """A synthetic batch of the cell's keys (the reference's smoke
        data: ``criteo_like_batch``, SASRec sequences with sampled
        negatives)."""
        from repro_torch.data.synthetic import criteo_like_batch
        from repro_torch.models import recsys as rs

        rng = np.random.default_rng(seed)
        if isinstance(cfg, (rs.AutoIntConfig, rs.XDeepFMConfig)):
            d = criteo_like_batch(B, n_sparse=cfg.n_sparse, vocab_sizes=list(cfg.vocab_sizes),
                                  seed=seed)
            b = {"sparse_ids": d["sparse_ids"], "label": d["label"]}
        elif isinstance(cfg, rs.DINConfig):
            d = criteo_like_batch(B, n_sparse=cfg.n_context,
                                  vocab_sizes=[cfg.context_vocab] * cfg.n_context,
                                  hist_len=cfg.seq_len, n_items=cfg.n_items, seed=seed)
            b = {"history": d["history"], "hist_len": d["hist_len"],
                 "target_item": d["target_item"], "context_ids": d["sparse_ids"],
                 "label": d["label"]}
        else:
            seq = rng.integers(0, cfg.n_items, (B, cfg.seq_len + 1))
            b = {"item_seq": seq[:, :-1], "next_items": seq[:, 1:],
                 "neg_items": rng.integers(0, cfg.n_items, (B, cfg.seq_len))}
        keys = self._batch_shapes(cfg, B, for_loss)
        return {k: torch.as_tensor(np.asarray(b[k])).to(keys[k][1]) for k in keys}

    def build_cell(self, cell: Cell, mesh) -> LoweredSpec:
        from repro_torch.models import recsys as rs

        ctx = make_ctx(mesh)
        cfg = self._cell_config()
        batch_axes = tuple(a for a in ctx.rules["batch"] if a in mesh_shape(mesh))
        b_pl = _lane_placements(mesh, batch_axes)

        def params_of(seed, device):
            params = rs.init(cfg, seed, device)
            specs = flat_specs(self._param_specs(params))
            return _place_tree(params, mesh, lambda name: ctx.placements(specs[name]))

        def batch_of(B, seed, device, fake, for_loss, pl):
            shapes = self._batch_shapes(cfg, B, for_loss)
            if fake:
                raw = {k: torch.empty(s, dtype=dt, device=device) for k, (s, dt) in
                       shapes.items()}
            else:
                raw = {k: v.to(device) for k, v in
                       self._real_batch(cfg, B, seed, for_loss).items()}
            return {k: _place(v, mesh, pl) for k, v in raw.items()}

        per_example = self._active_params_per_example(cfg)
        if cell.kind == "train":
            B = cell.global_batch
            opt_cfg = AdamWConfig(lr=1e-3, total_steps=100_000)

            def build(seed, device, fake):
                params, pls = params_of(seed, device)
                st, st_pl = _opt_state(params, pls)
                batch = batch_of(B, seed, device, fake, True, b_pl)
                return (params, st, batch), (pls, st_pl, {k: b_pl for k in batch})

            return _lower(build, mesh,
                          fn=make_train_step(recsys_loss_fn(cfg.name, cfg, ctx), opt_cfg),
                          model_flops_per_step=6.0 * B * per_example,
                          note="tables row-sharded on model", donate=(0, 1))

        if cell.kind == "forward":
            B = cell.global_batch

            def build(seed, device, fake):
                params, pls = params_of(seed, device)
                batch = batch_of(B, seed, device, fake, False, b_pl)
                return (params, batch), (pls, {k: b_pl for k in batch})

            return _lower(build, mesh, fn=_sharded_forward(cfg, ctx),
                          model_flops_per_step=2.0 * B * per_example, note="online inference")

        # retrieval_cand: user tower (batch 1) + the candidate corpus sharded
        # over every rank, K1 on each shard, the shards' top-k merged
        from repro_torch.serve.recsys import padded_candidates

        n_cand = cell.get("n_candidates")
        n_pad = padded_candidates(n_cand)
        d_emb = self.embed_dim_retrieval or 64
        lane_axes = tuple(a for a in ("pod", "data", "model") if a in mesh_shape(mesh))
        c_pl = _lane_placements(mesh, lane_axes)
        rep = _lane_placements(mesh, ())
        ud = cfg.embed_dim if isinstance(cfg, rs.SASRecConfig) else 1

        def build(seed, device, fake):
            params, pls = params_of(seed, device)
            batch = batch_of(1, seed, device, fake, False, rep)
            gen = torch.Generator(device="cpu").manual_seed(seed)
            cand = torch.randn((n_pad, d_emb), generator=gen).to(torch.bfloat16)
            proj = torch.randn((ud, d_emb), generator=gen).to(torch.bfloat16)
            args = (params, batch, _place(cand.to(device), mesh, c_pl),
                    _place(proj.to(device), mesh, rep))
            return args, (pls, {k: rep for k in batch}, c_pl, rep)

        return _lower(build, mesh, fn=_sharded_retrieval(cfg, ctx, n_cand, lane_axes),
                      model_flops_per_step=2.0 * n_cand * d_emb,
                      note="candidate corpus sharded over all chips (LANNS shard scan)")

    def smoke(self, seed: int = 0, device=None, params=None) -> dict:
        """The reference's smoke: 9 steps on 32 rows of the reduced config,
        the last loss below the first."""
        from repro_torch.common.utils import resolve_device
        from repro_torch.convert import recsys_params_from_jax
        from repro_torch.models import recsys as rs

        dev = resolve_device(device)
        cfg = self.model_config(reduced=True)
        p = (rs.init(cfg, seed, dev) if params is None
             else recsys_params_from_jax(params, device=dev))
        if isinstance(cfg, rs.SASRecConfig):
            seq = np.random.default_rng(seed).integers(0, cfg.n_items, (32, cfg.seq_len + 1))
            batch = {"item_seq": seq[:, :-1].astype(np.int32),
                     "next_items": seq[:, 1:].astype(np.int32)}
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        else:
            batch = {k: v.to(dev) for k, v in self._real_batch(cfg, 32, seed, True).items()}
        step = make_train_step(recsys_loss_fn(cfg.name, cfg),
                               AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))
        st = init_state(p)
        losses = []
        for _ in range(9):
            p, st, m = step(p, st, batch)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(l) for l in losses), losses
        assert losses[-1] < losses[0], losses
        return {"loss0": losses[0], "loss_last": losses[-1]}


def _sharded_forward(cfg, ctx):
    """The serve forward of a recsys cell on a mesh: ``local_map`` over the
    batch shards, the tables by row (``models.recsys._lookup_rows``)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models import recsys as rs

    def fn(params, batch):
        mesh = ctx.mesh
        keys = sorted(batch)
        p_leaves = leaves(params)
        p_pl = [list(p.placements) for p in p_leaves]
        b_pl = list(batch[keys[0]].placements)

        def local(*flat):
            p_loc = flat[:len(p_leaves)]
            lctx = rs.row_shard_ctx(p_loc, p_pl, [p.shape[0] for p in p_leaves], mesh)
            with torch.no_grad():
                return rs.forward(unflatten(params, p_loc), cfg,
                                  dict(zip(keys, flat[len(p_leaves):])), lctx)

        return local_map(local, out_placements=b_pl,
                         in_placements=tuple(p_pl) + (b_pl,) * len(keys),
                         device_mesh=mesh, redistribute_inputs=True)(
                             *p_leaves, *(batch[k] for k in keys))

    return fn


def _sharded_retrieval(cfg, ctx, n_cand: int, lane_axes):
    """retrieval_cand on a mesh: every rank runs the user tower (batch 1)
    and K1 over its shard of the candidates (ids offset to the shard's
    first row, rows past ``n_cand`` padding), then the shards' top-k are
    gathered and merged (``serve.retrieval``'s broker)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.collectives import all_gather_stacked
    from repro_torch.distributed.sharding_rules import shard_start
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as rs
    from repro_torch.serve.recsys import TOPK

    def fn(params, batch, candidates, user_proj):
        mesh = ctx.mesh
        names = tuple(mesh.mesh_dim_names)
        keys = sorted(batch)
        p_leaves = leaves(params)
        p_pl = [list(p.placements) for p in p_leaves]
        rep = list(user_proj.placements)
        n_pad = candidates.shape[0]

        def local(*flat):
            p_loc = flat[:len(p_leaves)]
            b = dict(zip(keys, flat[len(p_leaves):-2]))
            cand, proj = flat[-2], flat[-1]
            lctx = rs.row_shard_ctx(p_loc, p_pl, [p.shape[0] for p in p_leaves], mesh)
            with torch.no_grad():
                u = rs.forward(unflatten(params, p_loc), cfg, b, lctx).reshape(1, -1)
                u = u.to(torch.bfloat16)
                u = (u @ proj.to(torch.bfloat16)).to(torch.float32)
                r0 = shard_start(mesh, lane_axes, n_pad)
                n_valid = max(0, min(cand.shape[0], n_cand - r0))
                d, i = ops.distance_topk(u, cand.to(torch.float32), TOPK, "ip",
                                         n_valid=n_valid)
                i = torch.where(i >= 0, i + r0, i)
                for a in reversed(lane_axes):
                    g = mesh.get_group(a)
                    d = all_gather_stacked(d, g).permute(1, 0, 2).reshape(1, -1)
                    i = all_gather_stacked(i, g).permute(1, 0, 2).reshape(1, -1)
                top = torch.topk(-d, TOPK, dim=1).indices
                return -torch.gather(d, 1, top), torch.gather(i, 1, top)

        c_pl = list(candidates.placements)
        out = local_map(local, out_placements=(rep, rep),
                        in_placements=tuple(p_pl) + (rep,) * len(keys) + (c_pl, rep),
                        device_mesh=mesh, redistribute_inputs=True)
        return out(*p_leaves, *(batch[k] for k in keys), candidates, user_proj)

    return fn


# ===========================================================================
# registry
# ===========================================================================

#: every arch of the reference's registry, in its order
ARCH_IDS = (
    "codeqwen1.5-7b",
    "qwen2-72b",
    "smollm-360m",
    "deepseek-moe-16b",
    "deepseek-v2-lite-16b",
    "dimenet",
    "autoint",
    "din",
    "sasrec",
    "xdeepfm",
)


@lru_cache(maxsize=None)
def get_arch(arch_id: str) -> Arch:
    """The arch of ``arch_id`` with the reference's flags: the LMs'
    microbatches and remat groups (``registry.NUM_MICRO``,
    ``REMAT_GROUP``), smollm-360m FSDP-only (tp=False), and the retrieval
    widths of DIN (18) and SASRec (50)."""
    from repro_torch.configs import registry as reg

    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = reg.get_config(arch_id)
    if arch_id in reg.ARCH_IDS:
        return LMArch(arch_id, cfg, num_micro=reg.NUM_MICRO[arch_id],
                      tp=arch_id != "smollm-360m", remat_group=reg.REMAT_GROUP[arch_id])
    if arch_id in reg.GNN_ARCH_IDS:
        return GNNArch(arch_id, cfg)
    return RecsysArch(arch_id, cfg,
                      embed_dim_retrieval={"din": 18, "sasrec": 50}.get(arch_id, 0))

"""Carry built state across from the JAX package's numpy state.

LANNS's counterpart of loading weights: the JAX index's config, fitted
segmenter tree and per-partition corpora (and, for the HNSW engine, its
frozen graphs) become a port ``LannsIndex`` without refitting,
re-partitioning or rebuilding, so both packages query the same partitions;
the JAX LM's params (and AdamW state) become the port's ``Transformer``
(and optimizer state), and back; and a recsys model's or DimeNet's params
(and AdamW state), plain trees in both packages, are carried leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.tree import leaves, unflatten
from repro_torch.common.utils import resolve_device
from repro_torch.core.lanns import (
    LannsConfig,
    LannsIndex,
    _HNSWPartition,
    _Partition,
    _scan_metric,
)
from repro_torch.models.transformer import Transformer, TransformerConfig, param_tree
from repro_torch.quant.codec import Q8Corpus


def index_from_numpy_state(config: dict, tree, partitions: dict, mips_M2=None, device=None):
    """Build a port index from numpy state.

    config: ``dataclasses.asdict`` of the reference ``LannsConfig``.
    tree: ``segmenter.tree_arrays()`` of the reference (None for RS).
    partitions: ``{(s, g): {"vectors": (n, d) float32, "keys": (n,) int}}``
    — every (shard, segment) the reference built, empty ones included.  For
    ``quantized="q8"`` an entry may add ``"q8_codes"``, ``"q8_scales"`` and
    ``"q8_norms2"`` (the reference partition's ``q8`` fields), so the port
    scans the reference's own codes; without them the port encodes.
    An HNSW partition is an entry with ``"kind": "hnsw"`` and the frozen
    graph's ``levels``, ``adj0``, ``upper_adj`` and ``entry`` beside its
    (frozen) ``vectors`` and ``keys`` — the reference's ``_build_one_partition``
    payload — plus the same optional q8 fields.
    mips_M2: the reference's stored ``_mips_M2`` (metric 'mips' only).
    """
    cfg = LannsConfig(**config)
    index = LannsIndex(cfg, device=device)
    if tree is not None:
        index.partitioner.segmenter.set_tree(tree["hyperplanes"], tree["split"], tree["lo"], tree["hi"])
    index.partitioner._fitted = True
    for (s, g), part in partitions.items():
        if part.get("kind") == "hnsw":
            index.partitions[(s, g)] = _HNSWPartition(part, cfg)
            continue
        q8 = None
        if cfg.quantized == "q8" and part.get("q8_codes") is not None:
            q8 = Q8Corpus(
                codes=part["q8_codes"], scales=part["q8_scales"], norms2=part["q8_norms2"],
                metric=_scan_metric(cfg),
            )
        index.partitions[(s, g)] = _Partition(part["vectors"], part["keys"], cfg, index.device,
                                              q8=q8)
    if mips_M2 is not None:
        index._mips_M2 = float(mips_M2)
    index._invalidate_stack()
    return index


def index_numpy_state(index: LannsIndex):
    """A built port index's state in the form ``index_from_numpy_state``
    takes: ``(config, tree, partitions, mips_M2)``.  HNSW partitions carry
    their frozen graphs, so an index made from this state — on another
    device, or with another ``quantized`` setting — serves the same graphs
    without rebuilding them."""
    parts = {}
    for sg, p in index.partitions.items():
        if p.kind == "hnsw":
            fr = p.frozen
            parts[sg] = {"kind": "hnsw", "vectors": fr.vectors, "keys": fr.keys,
                         "levels": fr.levels, "adj0": fr.adj0, "upper_adj": fr.upper_adj,
                         "entry": fr.entry}
        else:
            vecs = p.host_vectors if p.vectors is None else p.vectors.cpu().numpy()
            parts[sg] = {"vectors": vecs, "keys": p.keys.cpu().numpy()}
    return (dataclasses.asdict(index.config), index.partitioner.segmenter.tree_arrays(), parts,
            getattr(index, "_mips_M2", None))


def _layer(stacked: dict, l: int, t) -> dict:
    """Layer ``l`` of a stacked (L, ...) subtree, nested dicts kept, each
    leaf through ``t(name, array)``."""
    return {name: _layer(a, l, t) if isinstance(a, dict) else t(name, a[l])
            for name, a in stacked.items()}


def _stack(layers: list, f) -> dict:
    """Per-layer trees stacked into (L, ...) leaves, each through ``f``."""
    return {name: _stack([b[name] for b in layers], f) if isinstance(v, dict)
            else np.stack([f(b[name]) for b in layers]) for name, v in layers[0].items()}


def _per_layer(cfg: TransformerConfig, tree_np: dict, t) -> dict:
    """A tree in the reference's LM layout (params, or AdamW's ``m`` / ``v``)
    in the port's (``param_tree``'s): the stacked (L, ...) ``dense_blocks``
    (a MoE model's head layers) and ``blocks`` split into one dict per
    layer, nested groups (MLA's ``kv_norm``, MoE's ``shared``) kept, each
    leaf through ``t(name, array)``."""
    out = {"embed": t("embed", tree_np["embed"]),
           "final_norm": {"scale": t("scale", tree_np["final_norm"]["scale"])},
           "blocks": [_layer(tree_np["blocks"], l, t) for l in range(cfg.n_scan_layers)]}
    if "dense_blocks" in tree_np:
        out["dense_blocks"] = [_layer(tree_np["dense_blocks"], l, t)
                               for l in range(cfg.n_dense_layers)]
    if "lm_head" in tree_np:
        out["lm_head"] = t("lm_head", tree_np["lm_head"])
    return out


def tree_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`_per_layer`: a tree in the port's
    ``param_tree`` layout (params, grads or AdamW moments) as the
    reference's, float32 numpy arrays with the per-layer ``blocks`` (and
    ``dense_blocks``) stacked into (L, ...) leaves."""
    f = lambda t: t.detach().to(torch.float32).cpu().numpy()
    out = {"embed": f(tree["embed"]), "final_norm": {"scale": f(tree["final_norm"]["scale"])},
           "blocks": _stack(tree["blocks"], f)}
    if "dense_blocks" in tree:
        out["dense_blocks"] = _stack(tree["dense_blocks"], f)
    if "lm_head" in tree:
        out["lm_head"] = f(tree["lm_head"])
    return out


def transformer_from_jax(cfg: TransformerConfig, params_np: dict, device=None) -> Transformer:
    """The port's params from the reference's ``transformer.init`` pytree
    as numpy arrays (:func:`_per_layer`'s walk), each weight in
    ``cfg.param_dtype`` on the device but the MoE ``router``, float32 as in
    the reference."""
    dev = resolve_device(device)
    dtype = cfg.dtype()

    def t(name, a):
        leaf_dtype = torch.float32 if name == "router" else dtype
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=leaf_dtype)

    tree = _per_layer(cfg, params_np, t)
    return Transformer(tree["embed"], tree["final_norm"]["scale"], tree["blocks"],
                       tree.get("lm_head"), tree.get("dense_blocks", ()))


def transformer_to_numpy(params: Transformer) -> dict:
    """The inverse of :func:`transformer_from_jax`: the port's params as the
    reference's pytree of float32 numpy arrays, the per-layer blocks stacked
    into (L, ...) leaves."""
    return tree_to_numpy(param_tree(params))


def adamw_state_from_jax(cfg: TransformerConfig, state_np: dict, device=None) -> dict:
    """The port's AdamW state (``train.optimizer.init_state``'s layout) from
    the reference's as numpy arrays: ``step`` int32, and ``m`` / ``v``
    through :func:`_per_layer`'s walk as float32 trees of the port's
    ``param_tree`` structure (``dense_blocks`` and the nested groups
    included)."""
    dev = resolve_device(device)
    t = lambda name, a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    step = torch.tensor(int(np.asarray(state_np["step"])), dtype=torch.int32, device=dev)
    return {"step": step, "m": _per_layer(cfg, state_np["m"], t),
            "v": _per_layer(cfg, state_np["v"], t)}


def recsys_params_from_jax(params_np, dtype=torch.float32, device=None):
    """The port's recsys params from the reference's ``*_init`` pytree as
    numpy arrays: the same tree, each leaf a ``dtype`` tensor on the
    device."""
    dev = resolve_device(device)
    return unflatten(params_np, [torch.from_numpy(np.array(a, dtype=np.float32))
                                 .to(device=dev, dtype=dtype) for a in leaves(params_np)])


def recsys_params_to_numpy(params) -> dict:
    """The inverse of :func:`recsys_params_from_jax`: the tree as float32
    numpy arrays (AdamW's ``m`` / ``v`` trees too)."""
    return unflatten(params, [t.detach().to(torch.float32).cpu().numpy() for t in leaves(params)])


def recsys_adamw_state_from_jax(state_np: dict, device=None) -> dict:
    """The port's AdamW state from the reference's for a recsys model:
    ``step`` int32, ``m`` / ``v`` float32 trees of the params' structure."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(state_np["step"])), dtype=torch.int32, device=dev)
    return {"step": step, "m": recsys_params_from_jax(state_np["m"], device=dev),
            "v": recsys_params_from_jax(state_np["v"], device=dev)}


def dimenet_params_from_jax(cfg, params_np, device=None):
    """The port's DimeNet params from the reference's ``dimenet.init``
    pytree as numpy arrays: the same tree (``blocks`` stacked over the
    blocks in both), each leaf in ``cfg.param_dtype`` on the device.  Its
    AdamW state carries across with :func:`recsys_adamw_state_from_jax`."""
    return recsys_params_from_jax(params_np, dtype=cfg.dtype(), device=device)


#: the inverse of :func:`dimenet_params_from_jax` (float32 numpy leaves)
dimenet_params_to_numpy = recsys_params_to_numpy

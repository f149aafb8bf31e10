"""GNN neighbour sampler: the port of ``repro.data.sampler`` (numpy).

GraphSAGE-style layered sampling over a CSR adjacency: for the seed nodes,
sample ``fanout[0]`` neighbours each, then ``fanout[1]`` of each of those,
and so on.  The output is a padded subgraph of static shapes:
  nodes      (n_max,)    global ids, -1 padded (the seeds first)
  edge_index (2, e_max)  LOCAL indices into ``nodes``, -1 padded
  seed_mask  (n_max,)    True for the seeds (the loss is taken there)
  node_mask  (n_max,)    True for the real nodes
The same ``np.random.Generator`` state gives the reference's subgraph.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (n+1,)
    indices: np.ndarray  # (nnz,)

    @classmethod
    def from_edge_index(cls, edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edge_index[0], edge_index[1]
        valid = (src >= 0) & (dst >= 0)
        src, dst = src[valid], dst[valid]
        order = np.argsort(src, kind="stable")
        indices = dst[order].astype(np.int64)
        indptr = np.searchsorted(src[order], np.arange(n_nodes + 1)).astype(np.int64)
        return cls(indptr=indptr, indices=indices)

    @property
    def n_nodes(self):
        return len(self.indptr) - 1

    def degree(self, nodes):
        return self.indptr[nodes + 1] - self.indptr[nodes]


def sample_neighbors(graph: CSRGraph, nodes: np.ndarray, fanout: int, rng: np.random.Generator):
    """(len(nodes), fanout) sampled neighbour ids, -1 where the degree is 0.
    With replacement (GraphSAGE's default), one randint block."""
    deg = graph.degree(nodes)
    r = rng.integers(0, 2**63 - 1, size=(len(nodes), fanout))
    safe_deg = np.maximum(deg, 1)
    offs = (r % safe_deg[:, None]).astype(np.int64)
    nbrs = graph.indices[graph.indptr[nodes][:, None] + offs]
    return np.where(deg[:, None] > 0, nbrs, -1)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple,
    *,
    rng: np.random.Generator,
    n_max: int,
    e_max: int,
):
    """Layered fanout sample -> padded local subgraph (see the module doc):
    messages run from each sampled neighbour to its frontier node; nodes
    past ``n_max`` (the outermost hop's last) and edges past ``e_max`` are
    dropped."""
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    src_list, dst_list = [], []
    for f in fanout:
        nbrs = sample_neighbors(graph, frontier, f, rng)  # (len, f)
        src = np.repeat(frontier, f)
        dst = nbrs.reshape(-1)
        ok = dst >= 0
        # message direction: neighbour -> frontier node
        src_list.append(dst[ok])
        dst_list.append(src[ok])
        frontier = np.unique(dst[ok])
        all_nodes.append(frontier)
    nodes = np.concatenate(all_nodes)
    # dedup, seeds first (stable)
    _, first_idx = np.unique(nodes, return_index=True)
    nodes = nodes[np.sort(first_idx)]
    if len(nodes) > n_max:
        nodes = nodes[:n_max]  # seeds are first, trim the outermost hop
    lookup = {int(g): i for i, g in enumerate(nodes)}
    src = np.concatenate(src_list) if src_list else np.zeros(0, np.int64)
    dst = np.concatenate(dst_list) if dst_list else np.zeros(0, np.int64)
    loc_src = np.fromiter((lookup.get(int(s), -1) for s in src), np.int64, len(src))
    loc_dst = np.fromiter((lookup.get(int(d), -1) for d in dst), np.int64, len(dst))
    ok = (loc_src >= 0) & (loc_dst >= 0)
    loc_src, loc_dst = loc_src[ok], loc_dst[ok]
    if len(loc_src) > e_max:
        loc_src, loc_dst = loc_src[:e_max], loc_dst[:e_max]
    out_nodes = np.full(n_max, -1, np.int64)
    out_nodes[: len(nodes)] = nodes
    edge_index = np.full((2, e_max), -1, np.int32)
    edge_index[0, : len(loc_src)] = loc_src
    edge_index[1, : len(loc_dst)] = loc_dst
    seed_mask = np.zeros(n_max, bool)
    seed_mask[: len(seeds)] = True
    node_mask = out_nodes >= 0
    return {
        "nodes": out_nodes,
        "edge_index": edge_index,
        "seed_mask": seed_mask,
        "node_mask": node_mask,
    }

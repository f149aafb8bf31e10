"""The port's HNSW engine vs the JAX package's (``repro.core.hnsw``).

* graphs: the numpy wavefront builder is the reference's, so frozen graphs
  are bit-identical for the same data, config and seed, at any chunk size,
  ``add_batch`` split and worker count;
* beams: ``beam_search`` / ``beam_search_flat`` on the same frozen arrays
  (fp32 and q8 lanes, padding lanes, a padding level) give the same ids in
  >= 99% of entries, distances within rtol = atol = 1e-4 where the ids
  agree (``tests/test_hnsw.py``'s tolerance) and recall@k within 0.01;
  on integer data, where every distance is exact and ties are everywhere,
  the ids are equal;
* indexes: ``LannsIndex(engine="hnsw")`` fp32 and q8, four metrics, both
  spills, mixed per-request ``topk``/``ef`` and an empty batch, carried
  across from the reference's graphs, with the same acceptance; the three
  ``hnsw_mode``s agree; the process pool builds the same graphs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.core import hnsw as J
from repro.core.lanns import _Partition as JPartition
from repro.data.synthetic import sift_like
from repro.quant import rerank as jrerank
from repro.quant.codec import quantize_q8 as jquantize_q8
from repro_torch.common.utils import next_pow2, next_pow2_quarter
from repro_torch.convert import index_from_numpy_state, index_numpy_state
from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.core import hnsw as P
from repro_torch.quant import rerank as prerank

RTOL = ATOL = 1e-4  # tests/test_hnsw.py:33
D = 16
TOPK = 10


def _frozen_equal(a, b):
    assert a.entry == b.entry
    for name in ("vectors", "levels", "adj0", "upper_adj"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    if a.keys is not None or b.keys is not None:
        np.testing.assert_array_equal(a.keys, b.keys)


def _truth(data, queries, k, metric):
    """Exact top-k ids (numpy), lower-is-better scores."""
    if metric == "l2":
        s = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    else:
        if metric == "cos":
            data = data / np.linalg.norm(data, axis=1, keepdims=True)
            queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        s = -(queries @ data.T)
    return np.argsort(s, axis=1, kind="stable")[:, :k]


def _recall(ids, truth):
    k = truth.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, truth)]))


def _assert_beams_agree(d, i, d_r, i_r, truth=None):
    """The acceptance: ids equal in >= 99% of entries, distances within
    rtol = atol = 1e-4 where they are, recall@k gap <= 0.01."""
    d, i, d_r, i_r = (np.asarray(a) for a in (d, i, d_r, i_r))
    assert d.shape == d_r.shape and i.shape == i_r.shape
    same = i == i_r
    assert same.mean() >= 0.99, same.mean()
    fin = same & np.isfinite(d_r)
    np.testing.assert_allclose(d[fin], d_r[fin], rtol=RTOL, atol=ATOL)
    assert np.array_equal(np.isfinite(d[same]), np.isfinite(d_r[same]))
    if truth is not None:
        assert abs(_recall(i, truth) - _recall(i_r, truth)) <= 0.01


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    return rng.standard_normal((900, D)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_graphs(corpus):
    out = {}
    for metric in ("l2", "ip", "cos"):
        cfg = J.HNSWConfig(M=8, ef_construction=40, ef_search=40, metric=metric, seed=7)
        out[metric] = J.HNSWIndex(cfg, D).add_batch(corpus, np.arange(len(corpus)) * 3).freeze()
    return out


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("chunk", [1, 7, 256])
def test_graphs_bit_identical(corpus, ref_graphs, metric, chunk):
    cfg = P.HNSWConfig(M=8, ef_construction=40, ef_search=40, metric=metric, seed=7)
    frozen = P.HNSWIndex(cfg, D).add_batch(corpus, np.arange(len(corpus)) * 3,
                                           chunk=chunk).freeze()
    _frozen_equal(frozen, ref_graphs[metric])


def test_graphs_bit_identical_across_add_batch_split(corpus, ref_graphs):
    cfg = P.HNSWConfig(M=8, ef_construction=40, ef_search=40, metric="l2", seed=7)
    idx = P.HNSWIndex(cfg, D)
    keys = np.arange(len(corpus)) * 3
    for lo, hi in ((0, 1), (1, 400), (400, len(corpus))):
        idx.add_batch(corpus[lo:hi], keys[lo:hi], chunk=64)
    _frozen_equal(idx.freeze(), ref_graphs["l2"])


def test_search_np_matches_reference(corpus, ref_graphs):
    cfg = P.HNSWConfig(M=8, ef_construction=40, ef_search=40, metric="l2", seed=7)
    idx = P.HNSWIndex(cfg, D).add_batch(corpus, np.arange(len(corpus)) * 3)
    ref = J.HNSWIndex(J.HNSWConfig(**dataclasses.asdict(cfg)), D)
    ref.add_batch(corpus, np.arange(len(corpus)) * 3)
    qs = np.random.default_rng(4).standard_normal((12, D)).astype(np.float32)
    d, i = idx.search_np(qs, TOPK)
    d_r, i_r = ref.search_np(qs, TOPK)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(d, d_r)


def test_stack_upper_adj_matches_reference():
    rng = np.random.default_rng(0)
    nodes = [np.sort(rng.choice(50, 9, replace=False)), np.array([3, 7])]
    adj = [rng.integers(-1, 50, (9, 6)).astype(np.int32), rng.integers(-1, 50, (2, 4)).astype(np.int32)]
    np.testing.assert_array_equal(P.stack_upper_adj(nodes, adj, 50, 5),
                                  J.stack_upper_adj(nodes, adj, 50, 5))


# ---------------------------------------------------------------------------
# beams on the same frozen arrays
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_partitions():
    """Two frozen l2 graphs (sift_like rows, different sizes and depths)."""
    data, queries = sift_like(2600, 24, 60, seed=11)
    cfg = J.HNSWConfig(M=8, ef_construction=40, ef_search=40, metric="l2", seed=1)
    parts = [J.HNSWIndex(cfg, 24).add_batch(data[:1500]).freeze(),
             J.HNSWIndex(dataclasses.replace(cfg, seed=2), 24).add_batch(data[1500:]).freeze()]
    return data, queries, parts


def _flat(parts, n_pad, l_pad, q8):
    """The flat (P * n_pad) arrays of ``LannsIndex._hnsw_stack``, numpy."""
    dim = parts[0].vectors.shape[1]
    m0, M = parts[0].adj0.shape[1], parts[0].upper_adj.shape[2]
    Pn = len(parts) * n_pad
    vecs = np.zeros((Pn, dim), np.int8 if q8 else np.float32)
    norms2 = np.zeros((Pn,), np.float32)
    scales = np.ones((len(parts), dim), np.float32)
    adj0 = np.full((Pn, m0), -1, np.int32)
    upper = np.full((l_pad, Pn, M), -1, np.int32)
    for pi, fr in enumerate(parts):
        off, n = pi * n_pad, fr.size
        if q8:
            qc = jquantize_q8(fr.vectors, "l2")
            vecs[off: off + n], norms2[off: off + n], scales[pi] = qc.codes, qc.norms2, qc.scales
        else:
            vecs[off: off + n] = fr.vectors
        adj0[off: off + n] = fr.adj0
        upper[: fr.num_upper_levels, off: off + n] = fr.upper_adj
    arrs = {"vectors": vecs, "adj0": adj0, "upper_adj": upper}
    if q8:
        arrs["norms2"] = norms2
    return arrs, scales


@pytest.mark.parametrize("q8", [False, True], ids=["fp32", "q8"])
def test_beam_search_flat_matches_reference(two_partitions, q8):
    import jax.numpy as jnp

    data, queries, parts = two_partitions
    n_pad = next_pow2(max(p.size for p in parts))
    l_pad = max(p.num_upper_levels for p in parts) + 1  # a padding level
    arrs, scales = _flat(parts, n_pad, l_pad, q8)
    # lanes: every query in partition 0, the first 40 in partition 1, then
    # 7 padding lanes
    B = len(queries)
    lane_p = np.concatenate([np.zeros(B, np.int64), np.ones(40, np.int64)])
    lane_q = np.concatenate([np.arange(B), np.arange(40)])
    T = len(lane_p) + 7
    Q = np.zeros((T, 24), np.float32)
    Q[: len(lane_p)] = queries[lane_q] * (scales[lane_p] if q8 else 1.0)
    OFF = np.zeros(T, np.int32)
    OFF[: len(lane_p)] = lane_p * n_pad
    EP = np.zeros(T, np.int32)
    EP[: len(lane_p)] = np.array([p.entry for p in parts])[lane_p] + OFF[: len(lane_p)]
    V = np.arange(T) < len(lane_p)
    kw = {"k": TOPK, "ef": 40, "max_iters": 56, "metric": "l2"}
    d_r, i_r = J.beam_search_flat({k: jnp.asarray(v) for k, v in arrs.items()}, jnp.asarray(Q),
                                  jnp.asarray(EP), jnp.asarray(OFF), jnp.asarray(V), **kw)
    d_r, i_r = np.asarray(d_r), np.asarray(i_r)
    P.reset_beam_counters()
    d, i = P.beam_search_flat({k: torch.from_numpy(v) for k, v in arrs.items()},
                              torch.from_numpy(Q), torch.from_numpy(EP), torch.from_numpy(OFF),
                              torch.from_numpy(V), **kw)
    assert P.BEAM_COUNTERS["lanes"] == T and P.BEAM_COUNTERS["iterations"] <= 56
    assert i.dtype == torch.int64 and d.dtype == torch.float32
    d, i = d.numpy(), i.numpy()
    n = len(lane_p)
    truth = np.stack([lane_p[t] * n_pad + _truth(parts[lane_p[t]].vectors,
                                                   queries[lane_q[t]][None], TOPK, "l2")[0]
                      for t in range(n)])
    _assert_beams_agree(d[:n], i[:n], d_r[:n], i_r[:n], truth)
    assert (i[n:, 1:] == -1).all()  # padding lanes stop at once: empty beams
    assert np.all(i[:n] < (lane_p[:, None] + 1) * n_pad) and np.all(i[:n] >= lane_p[:, None] * n_pad)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_beam_search_matches_reference(two_partitions, metric):
    import jax.numpy as jnp

    data, queries, parts = two_partitions
    fr = parts[0] if metric == "l2" else J.HNSWIndex(
        J.HNSWConfig(M=8, ef_construction=40, metric="ip", seed=5), 24).add_batch(data[:1200]).freeze()
    n_pad, l_pad = next_pow2(fr.size), fr.num_upper_levels + 2
    B = len(queries)
    B_pad = next_pow2_quarter(B + 3)
    q = np.zeros((B_pad, 24), np.float32)
    q[:B] = queries
    valid = np.arange(B_pad) < B
    kw = {"k": TOPK, "ef": 32, "max_iters": 48, "metric": metric}
    d_r, i_r = J.beam_search(fr.device_arrays(n_pad, l_pad), jnp.asarray(q), jnp.asarray(valid), **kw)
    pf = P.FrozenHNSW(P.HNSWConfig(M=8, metric=metric), fr.vectors, fr.levels, fr.adj0,
                      fr.upper_adj, fr.entry)
    arrs = pf.device_arrays(n_pad, l_pad, device="cpu")
    assert pf.device_arrays(n_pad, l_pad, device="cpu") is arrs  # one upload per bucket
    d, i = P.beam_search(arrs, torch.from_numpy(q), torch.from_numpy(valid), **kw)
    _assert_beams_agree(d.numpy()[:B], i.numpy()[:B], np.asarray(d_r)[:B], np.asarray(i_r)[:B],
                        _truth(fr.vectors, queries, TOPK, metric))


def test_frozen_search_matches_reference(two_partitions):
    data, queries, parts = two_partitions
    fr = parts[1]
    keys = np.arange(fr.size, dtype=np.int64) * 5 + 1
    fr_k = dataclasses.replace(fr, keys=keys)
    pf = P.FrozenHNSW(P.HNSWConfig(M=8, ef_search=40), fr.vectors, fr.levels, fr.adj0,
                      fr.upper_adj, fr.entry, keys)
    d_r, i_r = fr_k.search(queries, TOPK, ef=50)
    d, i = pf.search(queries, TOPK, ef=50, device="cpu")
    _assert_beams_agree(d.numpy(), i.numpy(), d_r, i_r)
    d0, i0 = pf.search(queries[:0], TOPK, device="cpu")
    assert d0.shape == (0, TOPK) and i0.shape == (0, TOPK)


def test_stable_merge_on_forced_ties():
    """Integer vectors with many repeated rows: every distance is exact on
    both sides and ties are everywhere, so the beams depend only on the tie
    order — lowest position first in the ef + m0 merge (``lax.top_k``'s,
    here a stable sort) and the first minimum in each argmin."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    base = rng.integers(0, 3, (60, 8)).astype(np.float32)
    data = base[rng.integers(0, 60, 700)]
    queries = rng.integers(0, 3, (40, 8)).astype(np.float32)
    for metric in ("l2", "ip"):
        cfg = J.HNSWConfig(M=6, ef_construction=30, metric=metric, seed=3)
        fr = J.HNSWIndex(cfg, 8).add_batch(data).freeze()
        kw = {"k": 12, "ef": 24, "max_iters": 36, "metric": metric}
        d_r, i_r = J.beam_search(fr.device_arrays(), jnp.asarray(queries), None, **kw)
        pf = P.FrozenHNSW(P.HNSWConfig(M=6, metric=metric), fr.vectors, fr.levels, fr.adj0,
                          fr.upper_adj, fr.entry)
        d, i = P.beam_search(pf.device_arrays(device="cpu"), torch.from_numpy(queries), None, **kw)
        ties = np.mean([len(np.unique(r)) < len(r) for r in np.asarray(d_r)])
        assert ties > 0.9  # the case really is full of ties
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))


# ---------------------------------------------------------------------------
# indexes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sift():
    return sift_like(1200, D, 32, seed=5)


def _cfg(metric, spill, **kw):
    return {"num_shards": 2, "num_segments": 4, "segmenter": "rh", "engine": "hnsw",
            "hnsw_m": 8, "ef_construction": 40, "ef_search": 40, "metric": metric,
            "spill": spill, "seed": 1, **kw}


def _payload(p):
    out = {"kind": p.kind, "vectors": p.vectors, "keys": p.keys}
    if p.kind == "hnsw":
        fr = p.frozen
        out.update(levels=fr.levels, adj0=fr.adj0, upper_adj=fr.upper_adj, entry=fr.entry)
    return out


def _ref_q8(ref: JIndex, cfg_q8: dict) -> JIndex:
    """The reference index over ``ref``'s partitions and graphs, quantized
    (its ``_Partition`` encodes the frozen vectors, as a load would)."""
    out = JIndex(JConfig(**cfg_q8))
    out.partitioner = ref.partitioner
    if hasattr(ref, "_mips_M2"):
        out._mips_M2 = ref._mips_M2
    out.partitions = {sg: JPartition(_payload(p), out.config) for sg, p in ref.partitions.items()}
    return out


def _carry(ref: JIndex, cfg: dict):
    return index_from_numpy_state(
        cfg, ref.partitioner.segmenter.tree_arrays(),
        {sg: _payload(p) for sg, p in ref.partitions.items()},
        getattr(ref, "_mips_M2", None), device="cpu",
    )


def _assert_index_agrees(res, res_r, truth):
    d, i, st = res
    d_r, i_r, st_r = res_r
    assert d.dtype == np.float32 and i.dtype == np.int64
    _assert_beams_agree(d, i, d_r, i_r, truth)
    for key in ("merge_path", "per_shard_topk", "knob_groups", "mean_segments_visited",
                "max_segments_visited"):
        assert st[key] == st_r[key], key


@pytest.fixture(scope="module")
def ref_indexes(sift):
    data, _ = sift
    out = {}
    for metric in ("l2", "ip", "cos", "mips"):
        for spill in ("virtual", "physical"):
            out[(metric, spill)] = JIndex(JConfig(**_cfg(metric, spill))).build(data)
    return out


@pytest.mark.parametrize("metric", ["l2", "ip", "cos", "mips"])
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_hnsw_index_matches_reference(sift, ref_indexes, metric, spill):
    """fp32 and q8, the port carrying the reference's graphs across."""
    data, queries = sift
    ref = ref_indexes[(metric, spill)]
    truth = _truth(data, queries, TOPK, "ip" if metric == "mips" else metric)
    for quantized in ("none", "q8"):
        cfg = _cfg(metric, spill, quantized=quantized)
        ref_x = ref if quantized == "none" else _ref_q8(ref, cfg)
        port = _carry(ref_x, cfg)
        _assert_index_agrees(port.query(queries, TOPK, return_stats=True),
                             ref_x.query(queries, TOPK, return_stats=True), truth)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_hnsw_index_built_in_port(sift, ref_indexes, metric):
    """The port's own build: the same partitions and bit-identical graphs."""
    data, queries = sift
    ref = ref_indexes[(metric, "virtual")]
    port = LannsIndex(LannsConfig(**_cfg(metric, "virtual")), device="cpu").build(data)
    assert set(port.partitions) == set(ref.partitions)
    for sg, p in ref.partitions.items():
        assert port.partitions[sg].kind == p.kind
        if p.kind == "hnsw":
            _frozen_equal(port.partitions[sg].frozen, p.frozen)
    for key in ("partition_sizes", "total_stored", "duplication_factor", "build_chunk"):
        assert port.build_stats[key] == ref.build_stats[key], key
    truth = _truth(data, queries, TOPK, "ip" if metric == "mips" else metric)
    _assert_index_agrees(port.query(queries, TOPK, return_stats=True),
                         ref.query(queries, TOPK, return_stats=True), truth)


@pytest.mark.parametrize("quantized", ["none", "q8"])
def test_mixed_per_request_topk_and_ef(sift, ref_indexes, quantized):
    data, queries = sift
    cfg = _cfg("l2", "virtual", quantized=quantized)
    ref = ref_indexes[("l2", "virtual")]
    ref_x = ref if quantized == "none" else _ref_q8(ref, cfg)
    port = _carry(ref_x, cfg)
    topk = np.resize(np.array([3, 10, 10, 3, 7]), len(queries))
    ef = np.resize(np.array([0, 24, 0]), len(queries))
    d, i, st = port.query(queries, topk, ef=ef, return_stats=True)
    d_r, i_r, st_r = ref_x.query(queries, topk, ef=ef, return_stats=True)
    _assert_beams_agree(d, i, d_r, i_r)
    assert st["knob_groups"] == st_r["knob_groups"] > 1
    assert st["merge_path"] == st_r["merge_path"]
    # a group answers as the same rows queried on their own
    rows = np.nonzero((topk == 7) & (ef == 24))[0]
    d_g, i_g = port.query(queries[rows], 7, ef=24)
    np.testing.assert_array_equal(i_g, i[rows, :7])
    np.testing.assert_array_equal(d_g, d[rows, :7])


def test_empty_batch(sift, ref_indexes):
    data, _ = sift
    ref = ref_indexes[("l2", "virtual")]
    port = _carry(ref, _cfg("l2", "virtual"))
    empty = np.zeros((0, D), np.float32)
    for topk in (5, np.zeros((0,), np.int64)):
        d, i, st = port.query(empty, topk, ef=32, return_stats=True)
        d_r, i_r, st_r = ref.query(empty, topk, ef=32, return_stats=True)
        assert d.shape == d_r.shape and i.shape == i_r.shape
        for key in ("merge_path", "knob_groups", "per_shard_topk", "max_segments_visited"):
            assert st[key] == st_r[key], key


def test_hnsw_modes_agree(sift, ref_indexes):
    data, queries = sift
    ref = ref_indexes[("cos", "physical")]
    port = _carry(ref, _cfg("cos", "physical"))
    d, i = port.query(queries, TOPK)
    for mode in ("partition", "legacy"):
        d_m, i_m = port.query(queries, TOPK, hnsw_mode=mode)
        np.testing.assert_array_equal(i_m, i)
        np.testing.assert_allclose(d_m, d, rtol=1e-6, atol=1e-6)
    d_r, i_r = ref.query(queries, TOPK, hnsw_mode="partition")
    _assert_beams_agree(d, i, d_r, i_r)
    q8 = _carry(ref, _cfg("cos", "physical", quantized="q8"))
    with pytest.raises(ValueError, match="stacked"):
        q8.query(queries, TOPK, hnsw_mode="partition")
    with pytest.raises(ValueError, match="hnsw_mode"):
        port.query(queries, TOPK, hnsw_mode="flat")


def test_stack_is_built_once_and_q8_uploads_no_fp32(sift, ref_indexes):
    data, queries = sift
    ref = ref_indexes[("l2", "virtual")]
    port = _carry(ref, _cfg("l2", "virtual", quantized="q8"))
    port.query(queries[:4], TOPK)
    stack = port._hnsw_stack(quantized=True)
    assert port._hnsw_stack(quantized=True) is stack
    assert stack["arrs"]["vectors"].dtype == torch.int8
    assert set(port._stack) == {True}  # the fp32 stack was never built
    P_, n_pad = len(stack["index"]), stack["n_pad"]
    assert port.hnsw_resident_bytes() == (
        P_ * n_pad * (D + 4 + 16 * 4 + 8) + stack["l_pad"] * P_ * n_pad * 8 * 4 + P_ * D * 4)


def test_pool_build_matches_in_process(sift):
    data, queries = sift
    cfg = LannsConfig(**_cfg("l2", "virtual"))
    a = LannsIndex(cfg, device="cpu").build(data, workers=0)
    b = LannsIndex(cfg, device="cpu").build(data, workers=2, chunk=32)
    assert (a.build_stats["build_workers"], b.build_stats["build_workers"]) == (0, 2)
    assert set(a.partitions) == set(b.partitions)
    for sg, p in a.partitions.items():
        if p.kind == "hnsw":
            _frozen_equal(p.frozen, b.partitions[sg].frozen)
    np.testing.assert_array_equal(a.query(queries, TOPK)[1], b.query(queries, TOPK)[1])


def test_numpy_state_round_trip(sift, ref_indexes):
    """``index_numpy_state`` carries the graphs to a new index (another
    device, or quantized) without a rebuild."""
    data, queries = sift
    port = _carry(ref_indexes[("mips", "virtual")], _cfg("mips", "virtual"))
    config, tree, parts, mips = index_numpy_state(port)
    again = index_from_numpy_state(config, tree, parts, mips, device="cpu")
    for sg, p in port.partitions.items():
        if p.kind == "hnsw":
            _frozen_equal(again.partitions[sg].frozen, p.frozen)
    d, i = port.query(queries, TOPK)
    d2, i2 = again.query(queries, TOPK)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(d2, d)


def test_exact_rerank_l_pad_changes_nothing(two_partitions):
    """The reference pads the device re-rank's lanes to ``l_pad``
    (``plan.py:503``); the port does not.  Padding changes no row of the
    reference's result, and the port's device and host modes equal it."""
    data, queries, parts = two_partitions
    fr = parts[0]
    rng = np.random.default_rng(1)
    cand = rng.integers(0, fr.size, (37, 20)).astype(np.int32)
    q = queries[:37]
    for metric in ("l2", "ip"):
        js = jrerank.ExactStore(fr.vectors)
        ex_pad = jrerank.exact_candidate_distances(q, cand, js, metric, mode="device",
                                                   l_pad=next_pow2_quarter(37))
        ex = jrerank.exact_candidate_distances(q, cand, js, metric, mode="device")
        np.testing.assert_array_equal(ex_pad, ex)
        ps = prerank.ExactStore(fr.vectors)
        for mode in ("device", "host"):
            got = prerank.exact_candidate_distances(q, cand, ps, metric, mode=mode).numpy()
            np.testing.assert_allclose(got, ex, rtol=1e-5, atol=1e-5)

"""Port merge / routing / helpers vs the JAX reference, on the CPU.

Hashing, synthetic data and the fitted segmenter trees must be bit-identical
for a fixed seed; partition assignments and routing masks equal; merges
equal to the reference's numpy merges."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common import utils as jutils
from repro.core import merge as jmerge
from repro.core import plan as jplan
from repro.core import recall as jrecall
from repro.core.lanns import LannsConfig as JConfig
from repro.core.segmenter import SegmenterConfig as JSegConfig
from repro.core.segmenter import make_segmenter as jmake_segmenter
from repro.core.sharding import TwoLevelPartitioner as JPartitioner
from repro.core.sharding import hash_shard as jhash_shard
from repro.data import synthetic as jsynth
from repro_torch.common import utils
from repro_torch.core import merge, plan, recall
from repro_torch.core.lanns import LannsConfig
from repro_torch.core.segmenter import SegmenterConfig, make_segmenter
from repro_torch.core.sharding import TwoLevelPartitioner, hash_shard
from repro_torch.data import synthetic

CPU = torch.device("cpu")


def _candidates(R, C, seed, dup=True):
    """(R, C) candidate lists with invalid entries and (optionally)
    duplicate ids carrying different distances."""
    rng = np.random.default_rng(seed)
    d = rng.random((R, C)).astype(np.float32)
    ids = rng.integers(0, C * 2 if dup else 10**9, (R, C)).astype(np.int64)
    if not dup:
        ids = np.stack([rng.permutation(10 * C)[:C] for _ in range(R)]).astype(np.int64)
    invalid = rng.random((R, C)) < 0.15
    d[invalid] = np.inf
    ids[rng.random((R, C)) < 0.05] = -1
    return d, ids


@pytest.mark.parametrize("R,C,k,seed", [(7, 40, 10, 0), (5, 30, 50, 1), (16, 200, 100, 2)])
def test_merge_topk_vec_matches_reference(R, C, k, seed):
    d, ids = _candidates(R, C, seed)
    d_r, i_r = jmerge.merge_topk_vec(d, ids, k)
    d_p, i_p = merge.merge_topk_vec(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(d_p.numpy(), d_r)
    np.testing.assert_array_equal(i_p.numpy(), i_r)
    d_l, i_l = merge.merge_topk_np(d, ids, k)
    np.testing.assert_array_equal(i_l, i_r)
    np.testing.assert_array_equal(d_l, d_r)


def test_merge_topk_vec_leading_axes_and_neg_inf():
    d, ids = _candidates(6, 24, 3)
    d[0, 0] = -np.inf  # non-finite distances drop, like the reference
    d3, i3 = d.reshape(2, 3, 24), ids.reshape(2, 3, 24)
    d_r, i_r = jmerge.merge_topk_vec(d3, i3, 8)
    d_p, i_p = merge.merge_topk_vec(torch.from_numpy(d3), torch.from_numpy(i3), 8)
    assert d_p.shape == (2, 3, 8)
    np.testing.assert_array_equal(d_p.numpy(), d_r)
    np.testing.assert_array_equal(i_p.numpy(), i_r)


@pytest.mark.parametrize("R,C,k,seed", [(9, 64, 10, 4), (4, 20, 30, 5)])
def test_merge_topk_disjoint_matches_reference(R, C, k, seed):
    d, ids = _candidates(R, C, seed, dup=False)
    d_r, i_r = jmerge.merge_topk_disjoint_np(d, ids, k)
    d_p, i_p = merge.merge_topk_disjoint(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(d_p.numpy(), d_r)
    np.testing.assert_array_equal(i_p.numpy(), i_r)


def test_per_shard_topk_matches_reference():
    for topk in (1, 5, 10, 20, 60, 100, 200):
        for S in (1, 2, 3, 4, 8, 16, 64):
            for conf in (0.5, 0.9, 0.95, 0.99, 0.999999):
                assert merge.per_shard_topk(topk, S, conf) == jmerge.per_shard_topk(topk, S, conf)
    for p in (1e-6, 0.01, 0.3, 0.5, 0.975, 0.999):
        assert merge._probit(p) == jmerge._probit(p)


def test_hashing_and_shape_helpers_bit_identical():
    keys = np.random.default_rng(0).integers(0, 2**63, 5000, dtype=np.int64)
    np.testing.assert_array_equal(utils.splitmix64(keys), jutils.splitmix64(keys))
    for salt in (0, 7, 0x5AAD):
        np.testing.assert_array_equal(
            utils.stable_hash_u64(keys, salt), jutils.stable_hash_u64(keys, salt)
        )
    for S in (1, 2, 8, 13):
        np.testing.assert_array_equal(hash_shard(keys, S), jhash_shard(keys, S))
    for n in range(0, 3000):
        assert utils.next_pow2(n) == jutils.next_pow2(n)
        assert utils.next_pow2_quarter(n) == jutils.next_pow2_quarter(n)
        assert utils.round_up(n, 128) == jutils.round_up(n, 128)


def test_synthetic_bit_identical():
    c, q = synthetic.sift_like(3000, 24, 50, seed=7)
    c_r, q_r = jsynth.sift_like(3000, 24, 50, seed=7)
    np.testing.assert_array_equal(c, c_r)
    np.testing.assert_array_equal(q, q_r)
    kw = {"n_clusters": 16, "cluster_std": 0.3, "seed": 3, "spectrum_decay": 0.5}
    np.testing.assert_array_equal(
        synthetic.clustered_vectors(500, 12, **kw), jsynth.clustered_vectors(500, 12, **kw)
    )


@pytest.fixture(scope="module")
def world():
    data, queries = jsynth.sift_like(3000, 24, 80, seed=11)
    return data, queries


@pytest.mark.parametrize("kind", ["rh", "apd"])
@pytest.mark.parametrize("m", [2, 8])
def test_fitted_trees_bit_identical(world, kind, m):
    data, _ = world
    kw = {"kind": kind, "num_segments": m, "alpha": 0.15, "seed": 4, "sample_size": 2000}
    ref = jmake_segmenter(JSegConfig(**kw)).fit(data).tree_arrays()
    port = make_segmenter(SegmenterConfig(**kw), CPU).fit(data).tree_arrays()
    for key in ("hyperplanes", "split", "lo", "hi"):
        np.testing.assert_array_equal(port[key], ref[key])
    assert port["depth"] == ref["depth"]


@pytest.mark.parametrize("kind", ["rs", "rh", "apd"])
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_assign_and_route_queries_equal(world, kind, spill):
    data, queries = world
    kw = {"kind": kind, "num_segments": 4, "alpha": 0.15, "spill": spill, "seed": 2}
    keys = np.arange(len(data), dtype=np.int64) * 7 + 3
    ref = JPartitioner(3, JSegConfig(**kw)).fit(data)
    port = TwoLevelPartitioner(3, SegmenterConfig(**kw), CPU).fit(data)
    a_r, a_p = ref.assign(data, keys), port.assign(data, keys)
    for s in range(3):
        for g in range(4):
            np.testing.assert_array_equal(a_p.rows[s][g], a_r.rows[s][g])
    np.testing.assert_array_equal(a_p.partition_sizes(), a_r.partition_sizes())
    np.testing.assert_array_equal(
        port.route_queries(torch.from_numpy(queries)).numpy(), ref.route_queries(queries)
    )


def test_recall_matches_reference():
    rng = np.random.default_rng(0)
    true = rng.integers(0, 50, (30, 20))
    pred = np.where(rng.random((30, 20)) < 0.7, true, rng.integers(0, 50, (30, 20)))
    pred[0, :5] = -1
    for k in (1, 5, 10, 20):
        assert recall.recall_at_k(pred, true, k) == jrecall.recall_at_k(pred, true, k)
    assert recall.recall_table(pred, true) == jrecall.recall_table(pred, true)


def test_knob_groups_and_merge_path_match_reference():
    topk = np.array([5, 10, 5, 20, 10])
    for args in ((10, None, 5), (topk, None, 5), (np.array([7] * 4), None, 4),
                 (topk, np.array([0, 50, 0, 0, 50]), 5), (np.zeros((0,), int), None, 0)):
        s_r, g_r = jplan.knob_groups(*args)
        s_p, g_p = plan.knob_groups(*args)
        assert s_p == s_r and len(g_p) == len(g_r)
        for (tk_p, ef_p, rows_p), (tk_r, ef_r, rows_r) in zip(g_p, g_r):
            assert (tk_p, ef_p) == (tk_r, ef_r)
            assert (rows_p is None and rows_r is None) or np.array_equal(rows_p, rows_r)
    for engine in ("scan", "hnsw"):
        for spill in ("virtual", "physical"):
            cfg = JConfig(engine=engine, spill=spill)
            port_cfg = LannsConfig(**dataclasses.asdict(cfg))
            assert plan.choose_merge_path(port_cfg) == jplan.choose_merge_path(cfg)
    sv = np.array([1, 2, 2, 4])
    assert plan.query_stats(9, sv, "disjoint").keys() == jplan.query_stats(9, sv, "disjoint").keys()

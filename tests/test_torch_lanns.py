"""The port's scan engine end to end vs the JAX ``LannsIndex(engine="scan")``.

Three indexes per case: the reference, the port built from the same data
and seed, and the port carried across from the reference's numpy state
(``index_from_numpy_state``).  On tie-free synthetic data the ids must be
equal, distances within rtol = atol = 3e-4, and the merge path, segments
visited and recall@k the same."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.core import brute_force_topk as jbrute_force
from repro.core import recall_at_k as jrecall
from repro.data.synthetic import clustered_vectors, sift_like
from repro_torch.analysis import RetraceSentinel
from repro_torch.convert import index_from_numpy_state
from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_at_k
from repro_torch.obs import Telemetry

TOPK = 10


@pytest.fixture(scope="module")
def sift():
    data, queries = sift_like(2500, 24, 48, seed=5)
    return data, queries


def _port_pair(ref: JIndex, cfg: dict, data):
    built = LannsIndex(LannsConfig(**cfg), device="cpu").build(data)
    seg = ref.partitioner.segmenter
    carried = index_from_numpy_state(
        dataclasses.asdict(ref.config),
        None if cfg.get("segmenter") == "rs" else seg.tree_arrays(),
        {sg: {"vectors": p.vectors, "keys": p.keys} for sg, p in ref.partitions.items()},
        getattr(ref, "_mips_M2", None),
        device="cpu",
    )
    return built, carried


def _assert_same(res, res_r):
    d, i, st = res
    d_r, i_r, st_r = res_r
    assert d.dtype == np.float32 and i.dtype == np.int64
    np.testing.assert_array_equal(i, i_r)
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d))
    np.testing.assert_allclose(d[fin], d_r[fin], rtol=3e-4, atol=3e-4)
    for key in ("merge_path", "per_shard_topk", "knob_groups",
                "mean_segments_visited", "max_segments_visited"):
        assert st[key] == st_r[key], key
    assert st["scan_traces"] == -1


@pytest.mark.parametrize("metric", ["l2", "ip", "cos", "mips"])
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_scan_index_matches_reference(sift, metric, spill):
    data, queries = sift
    cfg = {"num_shards": 2, "num_segments": 4, "segmenter": "rh", "engine": "scan",
           "metric": metric, "spill": spill, "seed": 1}
    ref = JIndex(JConfig(**cfg)).build(data)
    res_r = ref.query(queries, TOPK, return_stats=True)
    for port in _port_pair(ref, cfg, data):
        _assert_same(port.query(queries, TOPK, return_stats=True), res_r)
    if metric == "l2":
        _, truth = jbrute_force(queries, data, TOPK)
        _, truth_p = brute_force_topk(queries, data, TOPK, device="cpu")
        np.testing.assert_array_equal(truth_p, truth)
        assert recall_at_k(port.query(queries, TOPK)[1], truth_p, TOPK) == jrecall(
            res_r[1], truth, TOPK
        )


@pytest.mark.parametrize("segmenter", ["rs", "apd"])
def test_scan_index_clustered_other_segmenters(segmenter):
    data = clustered_vectors(2000, 16, n_clusters=32, seed=0)
    queries = clustered_vectors(40, 16, n_clusters=32, seed=1)
    cfg = {"num_shards": 3, "num_segments": 2, "segmenter": segmenter, "engine": "scan"}
    ref = JIndex(JConfig(**cfg)).build(data)
    res_r = ref.query(queries, 25, return_stats=True)
    for port in _port_pair(ref, cfg, data):
        _assert_same(port.query(queries, 25, return_stats=True), res_r)


def test_mixed_per_request_topk(sift):
    data, queries = sift
    cfg = {"num_shards": 2, "num_segments": 4, "engine": "scan"}
    ref = JIndex(JConfig(**cfg)).build(data)
    port = LannsIndex(LannsConfig(**cfg), device="cpu").build(data)
    topk = np.resize(np.array([3, 10, 7, 10]), len(queries))
    _assert_same(port.query(queries, topk, return_stats=True),
                 ref.query(queries, topk, return_stats=True))


def test_empty_batch(sift):
    data, _ = sift
    cfg = {"num_shards": 2, "num_segments": 4, "engine": "scan"}
    ref = JIndex(JConfig(**cfg)).build(data)
    port = LannsIndex(LannsConfig(**cfg), device="cpu").build(data)
    empty = np.zeros((0, data.shape[1]), np.float32)
    for topk in (5, np.zeros((0,), np.int64)):
        d, i, st = port.query(empty, topk, return_stats=True)
        d_r, i_r, st_r = ref.query(empty, topk, return_stats=True)
        assert d.shape == d_r.shape and i.shape == i_r.shape
        assert {k: st[k] for k in ("merge_path", "knob_groups", "max_segments_visited")} == \
            {k: st_r[k] for k in ("merge_path", "knob_groups", "max_segments_visited")}


def test_build_stats_match_reference(sift):
    data, _ = sift
    cfg = {"num_shards": 2, "num_segments": 4, "engine": "scan", "spill": "physical"}
    ref = JIndex(JConfig(**cfg)).build(data)
    port = LannsIndex(LannsConfig(**cfg), device="cpu").build(data)
    for key in ("partition_sizes", "total_stored", "n_input", "duplication_factor"):
        assert port.build_stats[key] == ref.build_stats[key], key
    assert all(p.keys.dtype == torch.int64 for p in port.partitions.values())


def test_q8_queries_telemetry_is_bit_identical_and_bad_modes_raise():
    q8 = LannsIndex(LannsConfig(engine="scan", quantized="q8", num_segments=2), device="cpu")
    q8.build(np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32))
    assert q8.query(np.zeros((3, 8), np.float32), 5)[1].shape == (3, 5)
    idx = LannsIndex(LannsConfig(engine="scan", num_segments=2), device="cpu")
    idx.build(np.random.default_rng(1).standard_normal((300, 8)).astype(np.float32))
    q = np.random.default_rng(2).standard_normal((7, 8)).astype(np.float32)
    d0, i0 = idx.query(q, 5)
    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    assert idx.attach_telemetry(tel) is idx
    d1, i1 = idx.query(q, 5)
    idx.attach_telemetry(None)
    d2, i2 = idx.query(q, 5)
    for d, i in ((d1, i1), (d2, i2)):
        assert np.array_equal(d, d0) and np.array_equal(i, i0)
    assert len(tel.spans.events(kind="plan")) == 1
    with pytest.raises(ValueError):
        LannsIndex(LannsConfig(engine="scan", quantized="q4"), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert LannsIndex(LannsConfig(engine="scan")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LannsIndex(LannsConfig(engine="scan"))

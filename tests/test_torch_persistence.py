"""The port's persistence vs the JAX package's (``tests/test_persistence.py``).

* round trips in the port: save -> load -> query == build -> query for both
  engines and all four metrics, fp32 and q8, the mips manifest, legacy
  ragged v1 HNSW artifacts, an fp32 artifact upgraded to q8 on load, a
  newer ``format_version`` refused, and resume (whole and partial);
* cross-load both ways: an artifact the reference saves loads in the port
  (``device="cpu"``) and gives the reference's loaded index's ids, and an
  artifact the port saves loads in ``repro.core.LannsIndex.load`` and does
  the same; distances within rtol = atol = 3e-4 (the parity contract);
  graphs and q8 codes are ``np.array_equal`` across the two packages, and
  the files hold the same arrays under the same names.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.data.synthetic import clustered_vectors
from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.core import lanns as lanns_module

TOPK = 10
TOL = 3e-4  # the parity contract (tests/test_kernels.py:30)
GRAPH = ("vectors", "levels", "adj0", "upper_adj", "keys")


@pytest.fixture(scope="module")
def small_world():
    data = clustered_vectors(1200, 16, n_clusters=16, seed=7)
    queries = clustered_vectors(32, 16, n_clusters=16, seed=8)
    return data, queries


def _cfg(engine, metric="l2", quantized="none", shards=2, segments=2, **kw):
    return dict(num_shards=shards, num_segments=segments, segmenter="rh", engine=engine,
                metric=metric, quantized=quantized, hnsw_m=8, ef_construction=40,
                ef_search=40, **kw)


def _port(cfg: dict) -> LannsIndex:
    return LannsIndex(LannsConfig(**cfg), device="cpu")


def _assert_same(d, i, d_r, i_r, tol=None):
    d, i, d_r, i_r = (np.asarray(a) for a in (d, i, d_r, i_r))
    np.testing.assert_array_equal(i, i_r)
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d))
    if tol is None:
        np.testing.assert_array_equal(d, d_r)
    else:
        np.testing.assert_allclose(d[fin], d_r[fin], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# round trips in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["scan", "hnsw"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos", "mips"])
def test_save_load_query_roundtrip(tmp_path, small_world, metric, engine):
    data, queries = small_world
    idx = _port(_cfg(engine, metric)).build(data)
    d1, i1 = idx.query(queries, TOPK)
    root = str(tmp_path / f"{metric}_{engine}")
    idx.save(root)
    idx2 = LannsIndex.load(root, device="cpu")
    assert idx2.device.type == "cpu" and idx2.config == idx.config
    d2, i2 = idx2.query(queries, TOPK)
    _assert_same(d2, i2, d1, i1)


def test_mips_load_restores_m2(tmp_path, small_world):
    data, queries = small_world
    idx = _port(_cfg("scan", "mips", shards=1)).build(data)
    root = str(tmp_path / "mips")
    idx.save(root)
    idx2 = LannsIndex.load(root, device="cpu")
    assert idx2._mips_M2 == pytest.approx(idx._mips_M2)
    _, i = idx2.query(queries, 5)
    assert (i >= 0).all()


def test_legacy_ragged_artifact_loads(tmp_path, small_world):
    """A v1 HNSW artifact stores ragged per-level lists (level_nodes /
    level_adj / level_loc, as ``key__i`` + ``key__len``) and no upper_adj:
    loading it rebuilds the (L, n, M) stack and answers identically."""
    data, queries = small_world
    cfg = _cfg("hnsw", shards=1)
    idx = _port(cfg).build(data)
    d1, i1 = idx.query(queries, TOPK)
    root = str(tmp_path / "legacy")
    for (s, g), part in idx.partitions.items():
        fr = part.frozen
        payload = {"kind": "hnsw", "vectors": fr.vectors, "levels": fr.levels,
                   "adj0": fr.adj0, "entry": fr.entry, "keys": fr.keys}
        level_nodes, level_adj, level_loc = [], [], []
        for lv in range(fr.num_upper_levels):
            nodes = np.nonzero(fr.levels >= lv + 1)[0].astype(np.int32)
            loc = np.full(fr.size, -1, np.int32)
            loc[nodes] = np.arange(len(nodes), dtype=np.int32)
            level_nodes.append(nodes)
            level_adj.append(fr.upper_adj[lv][nodes])
            level_loc.append(loc)
        payload.update(level_nodes=level_nodes, level_adj=level_adj, level_loc=level_loc)
        idx._save_partition(root, s, g, payload)
    with np.load(idx._partition_path(root, 0, 0)) as z:
        assert "upper_adj" not in z.files and int(z["level_nodes__len"]) == len(level_nodes)
    idx2 = _port(cfg)
    idx2.partitioner = idx.partitioner
    for (s, g) in idx.partitions:
        idx2.partitions[(s, g)] = idx2._load_partition(root, s, g)
        np.testing.assert_array_equal(idx2.partitions[(s, g)].frozen.upper_adj,
                                      idx.partitions[(s, g)].frozen.upper_adj)
    d2, i2 = idx2.query(queries, TOPK)
    _assert_same(d2, i2, d1, i1)


@pytest.mark.parametrize("engine", ["scan", "hnsw"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos", "mips"])
def test_quantized_save_load_query_roundtrip(tmp_path, small_world, metric, engine):
    """v2 artifacts carry the int8 payload next to the fp32 re-rank store;
    load -> query equals build -> query and the codes are loaded, not
    re-encoded."""
    data, queries = small_world
    idx = _port(_cfg(engine, metric, "q8")).build(data)
    d1, i1 = idx.query(queries, TOPK)
    root = str(tmp_path / f"q8_{metric}_{engine}")
    idx.save(root)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 2
    assert manifest["config"]["quantized"] == "q8"
    calls = []
    real = lanns_module.quantize_q8
    lanns_module.quantize_q8 = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        idx2 = LannsIndex.load(root, device="cpu")
    finally:
        lanns_module.quantize_q8 = real
    assert calls == []
    for sg, part in idx2.partitions.items():
        if part.size:
            assert part.q8.codes.dtype == np.int8
            np.testing.assert_array_equal(part.q8.codes, idx.partitions[sg].q8.codes)
    d2, i2 = idx2.query(queries, TOPK)
    _assert_same(d2, i2, d1, i1)


def test_legacy_fp32_artifact_upgrades_to_q8(tmp_path, small_world):
    """A v1 (pre-quantization) fp32 artifact loaded under a q8 config is
    quantized on load — deterministically, so results match a fresh q8
    build bit for bit."""
    data, queries = small_world
    idx_fp = _port(_cfg("scan", shards=1)).build(data)
    root = str(tmp_path / "legacy_fp32")
    idx_fp.save(root)
    mpath = os.path.join(root, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["format_version"]
    for key in ("quantized", "rerank_factor", "rerank_store"):
        manifest["config"].pop(key, None)
    manifest["config"]["quantized"] = "q8"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    idx_q8 = LannsIndex.load(root, device="cpu")
    assert idx_q8.config.quantized == "q8"
    idx_fresh = _port(_cfg("scan", quantized="q8", shards=1)).build(data)
    for sg, part in idx_q8.partitions.items():
        np.testing.assert_array_equal(part.q8.codes, idx_fresh.partitions[sg].q8.codes)
    d1, i1 = idx_q8.query(queries, TOPK)
    d2, i2 = idx_fresh.query(queries, TOPK)
    _assert_same(d1, i1, d2, i2)


def test_newer_format_version_rejected(tmp_path, small_world):
    data, _ = small_world
    idx = _port(_cfg("scan", shards=1)).build(data[:200])
    root = str(tmp_path / "future")
    idx.save(root)
    mpath = os.path.join(root, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format_version"] = 3
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="format_version"):
        LannsIndex.load(root, device="cpu")


@pytest.mark.parametrize("engine", ["scan", "hnsw"])
@pytest.mark.parametrize("quantized", ["none", "q8"])
def test_resume_dir_roundtrip(tmp_path, small_world, engine, quantized):
    """A build checkpointed into resume_dir resumes to identical results,
    building no partition the second time."""
    data, queries = small_world
    cfg = _cfg(engine, quantized=quantized, shards=1, segments=4)
    rdir = str(tmp_path / "resume")
    idx = _port(cfg).build(data, resume_dir=rdir)
    assert sorted(os.listdir(rdir)) == [f"shard0000_seg{g:04d}.npz" for g in range(4)]
    d1, i1 = idx.query(queries, TOPK)
    idx2 = _port(cfg)
    idx2.fit(data)
    idx2.build(data, resume_dir=rdir)
    assert idx2.build_stats["per_partition_seconds"] == {}
    d2, i2 = idx2.query(queries, TOPK)
    _assert_same(d2, i2, d1, i1)


def test_partial_resume_builds_only_missing(tmp_path, small_world):
    """A build that died after some partitions resumes with exactly the
    missing ones; the manifest's timing summary folds into the new one."""
    data, queries = small_world
    cfg = _cfg("hnsw", shards=2, segments=2)
    rdir = str(tmp_path / "partial")
    full = _port(cfg).build(data, resume_dir=rdir)
    full.save(rdir)
    prior = full.build_stats["per_partition_seconds_summary"]
    os.remove(full._partition_path(rdir, 1, 0))
    again = _port(cfg).build(data, resume_dir=rdir)
    assert list(again.build_stats["per_partition_seconds"]) == ["1/0"]
    summary = again.build_stats["per_partition_seconds_summary"]
    assert summary["count"] == prior["count"] + 1
    assert summary["total"] == pytest.approx(
        prior["total"] + again.build_stats["per_partition_seconds"]["1/0"])
    assert os.path.exists(full._partition_path(rdir, 1, 0))
    _assert_same(*again.query(queries, TOPK), *full.query(queries, TOPK))


def test_merge_seconds_summary():
    merge = lanns_module._merge_seconds_summary
    a = {"min": 1.0, "median": 2.0, "max": 3.0, "total": 6.0, "count": 3}
    b = {"min": 0.5, "median": 4.0, "max": 4.0, "total": 4.0, "count": 1}
    assert merge({}, b) == b and merge(a, {}) == a
    m = merge(a, b)
    assert m == {"min": 0.5, "median": 2.5, "max": 4.0, "total": 10.0, "count": 4}


# ---------------------------------------------------------------------------
# cross-load against the reference, both ways
# ---------------------------------------------------------------------------

CROSS = [(e, m, q) for e in ("scan", "hnsw") for m in ("l2", "ip", "cos", "mips")
         for q in ("none", "q8")]


@pytest.fixture(scope="module")
def artifacts(small_world, tmp_path_factory):
    """Per (engine, metric, quantized): the reference and the port each
    build from the same data and save; built lazily, once per module."""
    data, _ = small_world
    cache = {}

    def get(engine, metric, quantized):
        key = (engine, metric, quantized)
        if key not in cache:
            cfg = _cfg(engine, metric, quantized)
            root = tmp_path_factory.mktemp(f"x_{engine}_{metric}_{quantized}")
            ref = JIndex(JConfig(**cfg)).build(data)
            ref.save(str(root / "ref"))
            port = _port(cfg).build(data)
            port.save(str(root / "port"))
            cache[key] = (ref, port, str(root / "ref"), str(root / "port"))
        return cache[key]

    return get


def _files_match(root_a, root_b):
    """Two artifacts hold the same files, and each file the same array
    names, dtypes and shapes."""
    assert sorted(os.listdir(root_a)) == sorted(os.listdir(root_b))
    for name in os.listdir(root_a):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(root_a, name)) as za, np.load(os.path.join(root_b, name)) as zb:
            assert sorted(za.files) == sorted(zb.files), name
            for key in za.files:
                assert za[key].dtype == zb[key].dtype and za[key].shape == zb[key].shape, \
                    (name, key)
    with open(os.path.join(root_a, "manifest.json")) as fa, \
            open(os.path.join(root_b, "manifest.json")) as fb:
        ma, mb = json.load(fa), json.load(fb)
    for key in ("format_version", "config", "partitions", "mips_M2"):
        assert ma[key] == mb[key], key


def _same_partitions(jidx, pidx):
    """Graphs, corpora, keys and q8 codes array-equal across the packages."""
    assert set(jidx.partitions) == set(pidx.partitions)
    for sg, jp in jidx.partitions.items():
        pp = pidx.partitions[sg]
        assert jp.kind == pp.kind
        if jp.kind == "hnsw":
            assert jp.frozen.entry == pp.frozen.entry
            for name in GRAPH:
                np.testing.assert_array_equal(getattr(jp.frozen, name),
                                              getattr(pp.frozen, name), err_msg=name)
        else:
            vecs = pp.host_vectors if pp.vectors is None else pp.vectors.numpy()
            np.testing.assert_array_equal(jp.vectors, vecs)
            np.testing.assert_array_equal(jp.keys, pp.keys.numpy())
        assert (jp.q8 is None) == (pp.q8 is None)
        if jp.q8 is not None:
            for name in ("codes", "scales", "norms2"):
                np.testing.assert_array_equal(getattr(jp.q8, name), getattr(pp.q8, name))


@pytest.mark.parametrize("engine,metric,quantized", CROSS)
def test_reference_artifact_loads_in_port(artifacts, small_world, engine, metric, quantized):
    _, queries = small_world
    ref, _, ref_root, port_root = artifacts(engine, metric, quantized)
    _files_match(ref_root, port_root)
    jloaded = JIndex.load(ref_root)
    ploaded = LannsIndex.load(ref_root, device="cpu")
    _same_partitions(jloaded, ploaded)
    _same_partitions(ref, ploaded)
    d_r, i_r = jloaded.query(queries, TOPK)
    d, i = ploaded.query(queries, TOPK)
    _assert_same(d, i, d_r, i_r, tol=TOL)


@pytest.mark.parametrize("engine,metric,quantized", CROSS)
def test_port_artifact_loads_in_reference(artifacts, small_world, engine, metric, quantized):
    _, queries = small_world
    _, port, _, port_root = artifacts(engine, metric, quantized)
    jloaded = JIndex.load(port_root)
    ploaded = LannsIndex.load(port_root, device="cpu")
    _same_partitions(jloaded, port)
    _same_partitions(jloaded, ploaded)
    seg_j, seg_p = jloaded.partitioner.segmenter, port.partitioner.segmenter
    for name in ("hyperplanes", "split", "lo", "hi"):
        np.testing.assert_array_equal(getattr(seg_j, name), getattr(seg_p, name))
    d_r, i_r = jloaded.query(queries, TOPK)
    d, i = ploaded.query(queries, TOPK)
    _assert_same(d, i, d_r, i_r, tol=TOL)


def test_reference_resume_dir_resumes_in_port(tmp_path, small_world):
    """Partitions the reference's build checkpointed resume in the port:
    nothing is rebuilt, and the answers are the reference's."""
    data, queries = small_world
    cfg = _cfg("hnsw", shards=1, segments=4)
    rdir = str(tmp_path / "jresume")
    ref = JIndex(JConfig(**cfg)).build(data, resume_dir=rdir)
    port = _port(cfg).build(data, resume_dir=rdir)
    assert port.build_stats["per_partition_seconds"] == {}
    _same_partitions(ref, port)
    _assert_same(*port.query(queries, TOPK), *ref.query(queries, TOPK), tol=TOL)

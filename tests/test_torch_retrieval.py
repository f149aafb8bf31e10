"""The port's distributed serve step (``repro_torch.serve.retrieval`` over
``launch.mesh`` and ``distributed.collectives``) vs the JAX package's.

The reference runs as ``tests/test_distributed.py`` runs it: one child
python with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` that
serves every case and saves its outputs to an ``.npz``.  The port runs
the same cases in gloo worlds of 1, 4 and 8 spawned ranks on the CPU
(``run_world``), each rank with its own shard and its own rows of the
batch.  Inputs are made here from a seed and handed to both.

float32: ids equal, distances within rtol = atol = 3e-4, overflow equal.
bfloat16 / int8: id-set agreement >= 0.99 and the reference's recall
floors (> 0.98 full, > 0.9 int8).

Spawned ranks import this module to find their function, so JAX and the
reference are imported inside the tests that run in this process only.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LannsConfig, brute_force_topk, recall_at_k
from repro_torch.data.synthetic import clustered_vectors, sift_like
from repro_torch.distributed import all_gather_stacked, ring_topk_merge
from repro_torch.launch.mesh import compat_make_mesh, init_world, run_world
from repro_torch.serve.retrieval import (
    build_device_index,
    make_serve_fn,
    route_queries_tree,
    shard_arrays,
)

ROOT = Path(__file__).resolve().parents[1]
EXACT = 1 - 1e-9  # topk_confidence at which perShardTopK == topk

# name -> (data, config, mesh shape, mesh axes, serve kwargs, corpus dtype);
# the float32 configurations are tests/test_distributed.py's (:31 full,
# :62 routed, :246 int8, :276 the two-stage gather) and smaller worlds.
CASES = {
    "full_8": (("clustered", 0, 1), dict(num_shards=4, num_segments=4, segmenter="apd",
                                         topk_confidence=EXACT),
               (2, 4), ("data", "model"), dict(mode="full", batch_per_device=32), "float32"),
    "routed_8": (("clustered", 3, 4), dict(num_shards=4, num_segments=4, segmenter="apd",
                                           alpha=0.15),
                 (2, 4), ("data", "model"),
                 dict(mode="routed", batch_per_device=32, capacity_factor=2.0), "float32"),
    "int8_full_8": (("sift", 4000, 24, 64), dict(num_shards=4, num_segments=4, segmenter="apd",
                                                topk_confidence=EXACT),
                    (2, 4), ("data", "model"), dict(mode="full", batch_per_device=32), "int8"),
    "bf16_full_8": (("clustered", 0, 1), dict(num_shards=4, num_segments=4, segmenter="apd",
                                              topk_confidence=EXACT),
                    (2, 4), ("data", "model"), dict(mode="full", batch_per_device=32),
                    "bfloat16"),
    "pod_full_8": (("sift", 3000, 16, 32), dict(num_shards=4, num_segments=2, segmenter="apd",
                                               topk_confidence=EXACT),
                   (2, 2, 2), ("pod", "data", "model"),
                   dict(mode="full", batch_per_device=16, corpus_axes=("pod", "model"),
                        query_axes=("data",)), "float32"),
    # inner product, and a capacity that overflows: the dropped slots and
    # the count hold
    "routed_ip_overflow_4": (("clustered", 5, 6), dict(num_shards=4, num_segments=4,
                                                       segmenter="rh", alpha=0.15,
                                                       metric="ip"),
                             (1, 4), ("data", "model"),
                             dict(mode="routed", batch_per_device=64, capacity_factor=0.5),
                             "float32"),
    # physical spill: the full scan keeps the duplicates the reference keeps
    "full_physical_4": (("clustered", 9, 10), dict(num_shards=4, num_segments=4,
                                                   segmenter="rh", spill="physical"),
                        (1, 4), ("data", "model"), dict(mode="full", batch_per_device=64),
                        "float32"),
    "int8_routed_4": (("sift", 4000, 24, 64), dict(num_shards=4, num_segments=4,
                                                  segmenter="rh", alpha=0.15),
                      (1, 4), ("data", "model"), dict(mode="routed", batch_per_device=64),
                      "int8"),
    "routed_1": (("clustered", 11, 12), dict(num_shards=1, num_segments=8, segmenter="rh",
                                             alpha=0.15),
                 (1, 1), ("data", "model"), dict(mode="routed", batch_per_device=64),
                 "float32"),
    "full_1": (("clustered", 11, 12), dict(num_shards=1, num_segments=4, segmenter="rh"),
               (1, 1), ("data", "model"), dict(mode="full", batch_per_device=64), "float32"),
}
TOPK = 10


def _data(spec):
    if spec[0] == "clustered":
        _, seed, q_seed = spec
        return (clustered_vectors(4000, 24, n_clusters=64, seed=seed),
                clustered_vectors(64, 24, n_clusters=64, seed=q_seed))
    _, n, d, nq = spec
    return sift_like(n, d, nq, seed=0)


def _config(cfg):
    return LannsConfig(engine="scan", **cfg)


# ---------------------------------------------------------------------------
# the reference, in a child with 8 forced host devices
# ---------------------------------------------------------------------------

REF_CHILD = """
    import json, sys
    import numpy as np, jax.numpy as jnp
    from repro.core.lanns import LannsConfig
    from repro.launch.mesh import compat_make_mesh
    from repro.serve.retrieval import build_device_index, make_serve_fn

    src, dst = sys.argv[1], sys.argv[2]
    cases = json.load(open(src + ".json"))
    arrays = np.load(src)
    out = {}
    for name, (cfg, shape, axes, kw, dtype) in cases.items():
        mesh = compat_make_mesh(tuple(shape), tuple(axes))
        cfg = LannsConfig(engine="scan", **cfg)
        idx = build_device_index(arrays[name + "/data"], cfg, corpus_dtype=dtype)
        for key in ("corpus_axes", "query_axes"):
            if key in kw:
                kw[key] = tuple(kw[key])
        serve_fn, sh = make_serve_fn(mesh, cfg, topk=%d, **kw)
        scale = None if idx.scale is None else jnp.asarray(idx.scale)
        d, i, ovf = serve_fn(jnp.asarray(arrays[name + "/queries"]), jnp.asarray(idx.corpus),
                             jnp.asarray(idx.ids), jnp.asarray(idx.norms), idx.tree, scale)
        out[name + "/d"] = np.asarray(d)
        out[name + "/i"] = np.asarray(i)
        out[name + "/meta"] = np.array([int(ovf), sh["per_shard_topk"], sh["capacity"]])
    np.savez(dst, **out)
    print("REF_OK")
""" % TOPK


def _start_reference(tmp: str):
    import json

    arrays, specs = {}, {}
    for name, (data, cfg, shape, axes, kw, dtype) in CASES.items():
        arrays[name + "/data"], arrays[name + "/queries"] = _data(data)
        specs[name] = (cfg, shape, axes, kw, dtype)
    src = os.path.join(tmp, "inputs.npz")
    np.savez(src, **arrays)
    with open(src + ".json", "w") as f:
        json.dump(specs, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(ROOT / "src")
    dst = os.path.join(tmp, "ref.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CHILD), src, dst],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    )
    return proc, dst


# ---------------------------------------------------------------------------
# the port, in gloo worlds of spawned ranks
# ---------------------------------------------------------------------------


def _serve_cases(world_mesh, cases):
    """Rank body: every case of this world on its own mesh; returns, per
    case, this rank's (query block, dists, ids, overflow, info)."""
    out = {}
    for name, (index, queries, shape, axes, kw) in cases.items():
        mesh = compat_make_mesh(shape, axes, device="cpu")
        serve_fn, info = make_serve_fn(mesh, index.config, topk=TOPK, **kw)
        rows = len(queries) // info["query_blocks"]
        b = info["query_block"]
        q = torch.from_numpy(queries[b * rows: (b + 1) * rows])
        d, i, ovf = serve_fn(q, **shard_arrays(index, info["shard"], "cpu"))
        out[name] = (b, d.numpy(), i.numpy(), int(ovf), info)
    return out


def _run_port_world(world: int):
    cases = {}
    for name, (data, cfg, shape, axes, kw, dtype) in CASES.items():
        if int(np.prod(shape)) != world:
            continue
        corpus, queries = _data(data)
        index = build_device_index(corpus, _config(cfg), corpus_dtype=dtype)
        cases[name] = (index, queries, shape, axes, kw)
    per_rank = run_world(_serve_cases, (world,), ("world",), (cases,), device="cpu",
                         timeout=300)
    out = {}
    for name, (_, queries, *_rest) in cases.items():
        blocks = {}
        for rank_out in per_rank:
            b, d, i, ovf, info = rank_out[name]
            if b in blocks:  # every rank of a query block gives the broker's answer
                np.testing.assert_array_equal(blocks[b][1], i)
                np.testing.assert_array_equal(blocks[b][0], d)
            blocks[b] = (d, i)
        order = sorted(blocks)
        out[name] = (np.concatenate([blocks[b][0] for b in order]),
                     np.concatenate([blocks[b][1] for b in order]),
                     {r[name][3] for r in per_rank}, per_rank[0][name][4])
    return out


@pytest.fixture(scope="module")
def served():
    """(reference outputs, port outputs) of every case: the reference child
    runs while the port's worlds do."""
    with tempfile.TemporaryDirectory() as tmp:
        proc, dst = _start_reference(tmp)
        try:
            port = {}
            for world in (8, 4, 1):
                port.update(_run_port_world(world))
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
        with np.load(dst) as f:
            ref = {k: f[k] for k in f.files}
    return ref, port


def _agreement(a, b):
    return float(np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / max((y >= 0).sum(), 1)
                          for x, y in zip(a, b)]))


@pytest.mark.parametrize("name", list(CASES))
def test_serve_step_matches_reference(served, name):
    ref, port = served
    data, cfg, shape, axes, kw, dtype = CASES[name]
    corpus, queries = _data(data)
    d, i, ovfs, info = port[name]
    d_r, i_r, meta = ref[name + "/d"], ref[name + "/i"], ref[name + "/meta"]
    assert d.shape == d_r.shape == (len(queries), TOPK)
    assert ovfs == {int(meta[0])}, "every rank holds the global overflow, the reference's"
    assert (info["per_shard_topk"], info["capacity"]) == (meta[1], meta[2])
    if dtype == "float32":
        np.testing.assert_array_equal(i, i_r)
        fin = np.isfinite(d_r)
        assert np.array_equal(fin, np.isfinite(d))
        np.testing.assert_allclose(d[fin], d_r[fin], rtol=3e-4, atol=3e-4)
    else:
        assert _agreement(i, i_r) >= 0.99
    if kw["mode"] == "full" and cfg.get("topk_confidence") == EXACT:
        _, truth = brute_force_topk(queries, corpus, TOPK, device="cpu")
        floor = 0.9 if dtype == "int8" else 0.98
        assert recall_at_k(i, truth, TOPK) > floor
        assert recall_at_k(i_r, truth, TOPK) > floor
    if name == "routed_ip_overflow_4":
        assert meta[0] > 0, "the case must overflow its capacity"
    if name == "full_physical_4":
        assert any(len(set(r)) < len(r) for r in i_r), "the case must hold duplicate ids"


# ---------------------------------------------------------------------------
# the pieces, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("spill", [True, False])
def test_route_queries_tree_matches_reference(depth, spill):
    import jax.numpy as jnp

    from repro.core.segmenter import SegmenterConfig as JSegConfig
    from repro.core.segmenter import TreeSegmenter as JTree
    from repro.serve.retrieval import route_queries_tree as j_route

    data, queries = sift_like(3000, 24, 200, seed=depth)
    seg = JTree(JSegConfig(kind="rh", num_segments=2**depth, alpha=0.15, seed=depth)).fit(data)
    tree = seg.tree_arrays()
    want = np.asarray(j_route({k: jnp.asarray(v) if k != "depth" else v
                               for k, v in tree.items()}, jnp.asarray(queries), spill=spill))
    got = route_queries_tree(tree, torch.from_numpy(queries), spill=spill).numpy()
    assert got.shape == (200, 2**depth)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) >= 1).all()


@pytest.mark.parametrize("spill", ["virtual", "physical"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_device_index_matches_reference(dtype, spill):
    from repro.core.lanns import LannsConfig as JConfig
    from repro.serve.retrieval import build_device_index as j_build

    data, _ = sift_like(2500, 16, 8, seed=3)
    keys = np.arange(len(data), dtype=np.int64) * 7 + 11
    cfg = dict(num_shards=2, num_segments=4, segmenter="rh", spill=spill, engine="scan",
               seed=2)
    want = j_build(data, JConfig(**cfg), keys, corpus_dtype=dtype)
    got = build_device_index(data, LannsConfig(**cfg), keys, corpus_dtype=dtype)
    ref_corpus = want.corpus.view(np.uint16) if dtype == "bfloat16" else want.corpus
    assert got.corpus.dtype == ref_corpus.dtype
    np.testing.assert_array_equal(got.corpus, ref_corpus)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.norms, want.norms)
    if dtype == "int8":
        np.testing.assert_array_equal(got.scale, want.scale)
    else:
        assert got.scale is None and want.scale is None
    assert set(got.tree) == set(want.tree)
    for k, v in want.tree.items():
        np.testing.assert_array_equal(np.asarray(got.tree[k]), np.asarray(v))
    sa = shard_arrays(got, 1, "cpu")
    assert sa["corpus"].shape == (1, *got.corpus.shape[1:])
    assert sa["corpus"].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                  "int8": torch.int8}[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(sa["corpus"].float().numpy(),
                                      want.corpus[1:2].astype(np.float32))


def _ring_rank(mesh, d, ids, k):
    """Rank body: the ring merge and the all-gather merge of this rank's
    (B, k0) lists over the mesh's one axis."""
    group = mesh.get_group("s")
    r = mesh.get_local_rank("s")
    dl, il = torch.from_numpy(d[r]), torch.from_numpy(ids[r])
    rd, ri = ring_topk_merge(dl, il, k, group)
    gd = all_gather_stacked(dl, group).permute(1, 0, 2).reshape(dl.shape[0], -1)
    gi = all_gather_stacked(il, group).permute(1, 0, 2).reshape(dl.shape[0], -1)
    top = torch.sort(gd, dim=1, stable=True).indices[:, :k]
    return (rd.numpy(), ri.numpy(), torch.gather(gd, 1, top).numpy(),
            torch.gather(gi, 1, top).numpy())


def test_ring_topk_merge_matches_allgather():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((4, 3, 8)).astype(np.float32)
    ids = rng.permutation(4 * 3 * 8).reshape(4, 3, 8).astype(np.int32)
    outs = run_world(_ring_rank, (4,), ("s",), (d, ids, 5), device="cpu", timeout=300)
    flat_d = np.moveaxis(d, 0, -1).reshape(3, 32)  # as tests/test_distributed.py:183
    flat_i = np.moveaxis(ids, 0, -1).reshape(3, 32)
    for rd, ri, gd, gi in outs:
        np.testing.assert_array_equal(rd, gd)
        np.testing.assert_array_equal(ri, gi)
        for r in range(3):
            order = np.argsort(flat_d[r])[:5]
            assert set(ri[r].tolist()) == set(flat_i[r][order].tolist())
            np.testing.assert_array_equal(rd[r], np.sort(flat_d[r])[:5])


def _failing_rank(mesh, how):
    if how == "exits":
        os._exit(3)
    raise RuntimeError(f"rank {mesh.get_rank()} fails on purpose")


@pytest.mark.parametrize("how,match", [("raises", "fails on purpose"),
                                       ("exits", "died without reporting")])
def test_run_world_raises_a_rank_failure(how, match):
    with pytest.raises(RuntimeError, match=match):
        run_world(_failing_rank, (1,), ("s",), (how,), device="cpu", timeout=120)


def test_world_rules():
    with pytest.raises(ValueError, match="gloo"):
        init_world(0, 1, "file:///nonexistent", device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="init_world"):
        compat_make_mesh((1,), ("s",), device="cpu")
    if not torch.cuda.is_available():  # the default device is CUDA, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            init_world(0, 1, "file:///nonexistent")

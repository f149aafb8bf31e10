"""The port's int8 two-stage scan vs the JAX package's (``quantized="q8"``).

Inputs come from numpy with a seed and go to both packages.  Tolerances,
and why:

* codec (numpy copies), query codes and scales (torch twin), stage-1 scores
  and the plain K2 (``ref.distance_topk_q8_blocked``) against the
  reference's codec, its plain version and its Pallas kernel: BIT-EQUAL.
  The dot is an exact integer in both packages and every float step is one
  IEEE float32 operation in the same order.  Ids are equal up to swaps
  between EQUAL scores at the k-th place (the two top-k sorts break ties
  apart).  The reference's jitted ``_stage1_scores`` is the exception: XLA
  rewrites its arithmetic (see the stage-1 test), rtol = 1e-6, atol = 1e-5.
* the ``distance_topk_q8`` wrappers: ip bit-equal; l2 and cos within
  rtol = atol = 1e-6 — each package adds ``||q||^2`` back (l2) or
  normalizes the query (cos) with its own float32 reduction order.
* exact re-rank distances: host mode runs the reference's numpy code
  (bit-equal); device mode sums in torch's order, rtol = atol = 1e-5.
* ``LannsIndex`` end to end: ids equal, distances rtol = atol = 3e-4 (the
  port's parity contract, ROADMAP), merge path and segments visited equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import LannsConfig as JConfig
from repro.core import LannsIndex as JIndex
from repro.data.synthetic import clustered_vectors
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.distance_topk_q8 import distance_topk_q8_pallas
from repro.quant import codec as jcodec
from repro.quant import rerank as jrerank
from repro.quant.twostage import _stage1_scores
from repro_torch.convert import index_from_numpy_state
from repro_torch.core import LannsConfig, LannsIndex
from repro_torch.kernels import ops, ref
from repro_torch.quant import codec, rerank
from repro_torch.quant.twostage import _Q8Partition


def _rand(B, N, D, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32) * scale
    x = rng.standard_normal((N, D)).astype(np.float32) * scale
    return q, x


def _assert_topk_bit_equal(d, i, d_r, i_r):
    """Scores bit-equal; ids equal up to swaps between equal scores."""
    d, i, d_r, i_r = (np.asarray(a) for a in (d, i, d_r, i_r))
    assert d.shape == d_r.shape and i.shape == i_r.shape
    assert np.array_equal(d, d_r), np.abs(d - d_r)[np.isfinite(d_r)].max()
    _assert_ids_up_to_ties(d_r, i, i_r)


def _assert_ids_up_to_ties(d_r, i, i_r):
    for dr, ri, rr in zip(d_r, i, i_r):
        for v in np.unique(dr):
            assert set(ri[dr == v].tolist()) == set(rr[dr == v].tolist()) or v == dr[-1]
        assert np.all(ri[np.isinf(dr)] == -1)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_codec_bit_identical(metric):
    q, x = _rand(9, 700, 48, seed=1, scale=3.0)
    qc, qc_r = codec.quantize_q8(x, metric), jcodec.quantize_q8(x, metric)
    for f in ("codes", "scales", "norms2"):
        assert np.array_equal(getattr(qc, f), getattr(qc_r, f)), f
    assert np.array_equal(codec.dequantize_q8(qc), jcodec.dequantize_q8(qc_r))
    assert codec.q8_bytes_per_vector(qc) == jcodec.q8_bytes_per_vector(qc_r)
    for a, b in zip(codec.quantize_queries_q8(q, qc.scales),
                    jcodec.quantize_queries_q8(q, qc_r.scales)):
        assert np.array_equal(a, b)
    assert np.array_equal(codec.q8_scores_np(q, qc, metric), jcodec.q8_scores_np(q, qc_r, metric))
    for a, b in zip(codec.distance_topk_q8_np(q, qc, 20, metric),
                    jcodec.distance_topk_q8_np(q, qc_r, 20, metric)):
        assert np.array_equal(a, b)


def test_codec_empty_corpus_and_accum_guard():
    qc = codec.quantize_q8(np.zeros((0, 8), np.float32))
    assert qc.size == 0 and qc.dim == 8
    assert np.array_equal(qc.scales, jcodec.quantize_q8(np.zeros((0, 8), np.float32)).scales)
    assert codec.Q8_ACCUM_MAX_D == jcodec.Q8_ACCUM_MAX_D
    wide = np.zeros((2, codec.Q8_ACCUM_MAX_D + 1), np.float32)
    with pytest.raises(ValueError, match="accumulator"):
        codec.quantize_q8(wide)
    with pytest.raises(ValueError, match="accumulator"):
        codec.quantize_queries_q8_t(torch.from_numpy(wide), torch.ones(wide.shape[1]))


@pytest.mark.parametrize("B,D,scale,seed", [
    (64, 24, 1.0, 0), (33, 128, 40.0, 1), (7, 960, 0.01, 2), (5, 2048, 1.0, 3), (4, 50, 1e-3, 4),
])
def test_query_quantization_torch_bit_equal(B, D, scale, seed):
    q, x = _rand(B, 300, D, seed=seed, scale=scale)
    q[0] = 0.0  # an all-zero query: its scale clamps to EPS_SCALE
    scales = jcodec.quantize_q8(x).scales
    qcodes, qscale = codec.quantize_queries_q8_t(torch.from_numpy(q), torch.from_numpy(scales))
    qcodes_r, qscale_r = jcodec.quantize_queries_q8(q, scales)
    assert qcodes.dtype == torch.int8 and qscale.dtype == torch.float32
    assert np.array_equal(qcodes.numpy(), qcodes_r)
    assert np.array_equal(qscale.numpy(), qscale_r)


# ---------------------------------------------------------------------------
# the plain K2 vs the Pallas kernel (interpret mode) and the wrapper
# ---------------------------------------------------------------------------

# the reference's own sweep (tests/test_quant.py)
SWEEP = [
    (4, 300, 24, 10, "l2"),
    (3, 513, 128, 7, "ip"),      # SIFT dims, odd N
    (5, 200, 20, 5, "cos"),
    (2, 64, 8, 100, "l2"),       # k > N
    (2, 150, 960, 16, "l2"),     # GIST dims
    (9, 255, 2048, 128, "ip"),   # k == lane width, D > exact-cast bound
]


def _pallas_q8(q_codes, x_codes, q_scale, norms2, k, metric_k):
    """The reference's raw K2 in interpret mode, padded as its wrapper pads."""
    B, D = q_codes.shape
    N = x_codes.shape[0]
    k_pad = max(1 << (k - 1).bit_length(), 128)
    block_n = (1 << (k_pad + max(256, k_pad) - 1).bit_length()) - k_pad
    B_pad, D_pad, N_pad = -(-B // 8) * 8, -(-D // 128) * 128, -(-N // block_n) * block_n
    qp = np.zeros((B_pad, D_pad), np.int8)
    qp[:B, :D] = q_codes
    xp = np.zeros((N_pad, D_pad), np.int8)
    xp[:N, :D] = x_codes
    qsp = np.zeros((B_pad, 1), np.float32)
    qsp[:B, 0] = q_scale
    n2p = np.full((1, N_pad), np.inf, np.float32)
    n2p[0, :N] = norms2
    d, i = distance_topk_q8_pallas(
        jnp.asarray(qp), jnp.asarray(xp), jnp.asarray(qsp), jnp.asarray(n2p), k_pad=k_pad,
        block_q=8, block_n=block_n, n_valid=N, metric=metric_k, interpret=True,
    )
    return np.asarray(d)[:B, :k], np.asarray(i)[:B, :k]


@pytest.mark.parametrize("B,N,D,k,metric", SWEEP)
def test_plain_k2_bit_equal_to_pallas_interpret(B, N, D, k, metric):
    q, x = _rand(B, N, D, seed=B + N)
    qc = jcodec.quantize_q8(x, metric)
    if metric == "cos":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    metric_k = "l2" if metric == "l2" else "ip"
    q_codes, q_scale = jcodec.quantize_queries_q8(q, qc.scales)
    k_eff = min(k, N)
    d_r, i_r = _pallas_q8(q_codes, qc.codes, q_scale, qc.norms2, k_eff, metric_k)
    args = [torch.from_numpy(a) for a in (q_codes, qc.codes, q_scale, qc.norms2)]
    d, i = ref.distance_topk_q8_blocked(*args, k_eff, metric_k, block_n=128)
    _assert_topk_bit_equal(d.numpy(), i.numpy(), d_r, i_r)
    d_o, i_o = ops.distance_topk_q8_codes(*args, k_eff, metric_k)
    _assert_topk_bit_equal(d_o.numpy(), i_o.numpy(), d_r, i_r)


@pytest.mark.parametrize("B,N,D,k,metric", SWEEP)
def test_distance_topk_q8_matches_reference_wrapper(B, N, D, k, metric):
    q, x = _rand(B, N, D, seed=B + N)
    qc = codec.quantize_q8(x, metric)
    d, i = ops.distance_topk_q8(torch.from_numpy(q), qc, k, metric)
    d_r, i_r = map(np.asarray, jops.distance_topk_q8(q, qc, k, metric, backend="pallas_interpret"))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    d, i = d.numpy(), i.numpy()
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d)) and np.all(i[~fin] == -1)
    if metric == "ip":
        assert np.array_equal(d, d_r)
    else:
        np.testing.assert_allclose(d[fin], d_r[fin], rtol=1e-6, atol=1e-6)
    for ri, rr, f in zip(i, i_r, fin):
        assert len(set(ri[f].tolist()) & set(rr[f].tolist())) >= f.sum() - 1  # one tie swap


def test_distance_topk_q8_wrapper_edges():
    q, x = _rand(4, 100, 16, seed=8)
    qc = codec.quantize_q8(x)
    qt = torch.from_numpy(q)
    # n_valid masks the padding rows of a bucketed corpus
    pad = codec.Q8Corpus(
        codes=np.vstack([qc.codes, np.full((28, 16), 7, np.int8)]), scales=qc.scales,
        norms2=np.concatenate([qc.norms2, np.zeros(28, np.float32)]), metric="l2",
    )
    d0, i0 = ops.distance_topk_q8(qt, qc, 9)
    d1, i1 = ops.distance_topk_q8(qt, pad, 9, n_valid=100)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    # empty corpus, n_valid 0 and k > N pad with (inf, -1)
    empty = codec.quantize_q8(np.zeros((0, 16), np.float32))
    for d, i in (ops.distance_topk_q8(qt, empty, 5), ops.distance_topk_q8(qt, qc, 5, n_valid=0)):
        assert d.shape == (4, 5) and torch.isinf(d).all() and (i == -1).all()
    d, i = ops.distance_topk_q8(qt, codec.quantize_q8(x[:7]), 10)
    assert torch.isinf(d[:, 7:]).all() and (i[:, 7:] == -1).all()
    assert sorted(i[0, :7].tolist()) == list(range(7))
    with pytest.raises(ValueError, match="quantized for metric"):
        ops.distance_topk_q8(qt, qc, 5, "ip")
    ops.reset_launches()
    ops.distance_topk_q8(qt, qc, 5)
    assert ops.KERNEL_LAUNCHES["distance_topk_q8"] == 0  # CPU tensors: plain version


def test_plain_k2_large_k_and_blocks():
    q, x = _rand(3, 2000, 40, seed=9)
    qc = codec.quantize_q8(x)
    q_codes, q_scale = codec.quantize_queries_q8(q, qc.scales)
    args = [torch.from_numpy(a) for a in (q_codes, qc.codes, q_scale, qc.norms2)]
    d0, i0 = ref.distance_topk_q8_blocked(*args, 400, "l2", block_n=256)
    d1, i1 = ref.distance_topk_q8_blocked(*args, 400, "l2", block_n=4096)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    s = codec.q8_scores_np(q, qc, "l2") - np.einsum("bd,bd->b", q, q)[:, None]
    full = ref.q8_score_matrix(*args, "l2").numpy()
    assert np.allclose(full, s, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# stage 1 and the exact re-rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("D", [24, 128, 2048])
def test_stage1_scores_bit_equal_to_reference(metric, D):
    q, x = _rand(37, 900, D, seed=D)
    qc = jcodec.quantize_q8(x, metric)
    keys = torch.arange(900, dtype=torch.int64)
    part = _Q8Partition(qc, x, keys, metric, torch.device("cpu"))
    mult = -2.0 if metric == "l2" else -1.0
    bias = qc.norms2 if metric == "l2" else np.zeros(900, np.float32)
    s_r = np.asarray(_stage1_scores(
        jnp.asarray(q), jnp.asarray(qc.codes), jnp.asarray(np.concatenate([qc.scales, bias])),
        mult, D <= 1024,
    ))
    q_codes, q_scale = codec.quantize_queries_q8_t(torch.from_numpy(q), part.scales)
    s = ref.q8_score_matrix(q_codes, part.codes, q_scale, part.bias, metric).numpy()
    # bit-equal to the reference's codec + its plain kernel version
    q_codes_r, q_scale_r = jcodec.quantize_queries_q8(q, qc.scales)
    assert np.array_equal(q_codes.numpy(), q_codes_r)
    s_np = np.asarray(jref.q8_score_matrix(
        jnp.asarray(q_codes_r), jnp.asarray(qc.codes), jnp.asarray(q_scale_r),
        jnp.asarray(qc.norms2), "l2" if metric == "l2" else "ip",
    ))
    assert np.array_equal(s, s_np)
    # The jitted _stage1_scores is not bit-equal to its own package's codec:
    # XLA divides by 127 as a product with the reciprocal (q_scale 1 ulp off
    # in some rows) and contracts bias + scale * dot into one FMA.  Both
    # stay within one rounding of each term: rtol = 1e-6, atol = 1e-5.
    np.testing.assert_allclose(s, s_r, rtol=1e-6, atol=1e-5)
    # stage 1's top-C set is the reference's argpartition set, up to scores
    # within that tolerance of the C-th
    C = 60
    cand = part.stage1(torch.from_numpy(q), C).numpy()
    cand_r = np.argpartition(s_r, C, axis=1)[:, :C]
    for row, cr, sr in zip(cand, cand_r, s_r):
        kth = np.sort(sr)[C - 1]
        tol = 1e-5 + 1e-6 * abs(kth)
        sure = set(np.nonzero(sr < kth - tol)[0].tolist())
        assert sure <= set(row.tolist()) and sure <= set(cr.tolist())
        assert len(set(row.tolist())) == C and np.all(sr[row] <= kth + tol)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("b,C", [(40, 30), (3, 5)])  # dense regime, gather regime
def test_exact_candidate_distances_match_reference(metric, b, C):
    q, x = _rand(b, 500, 32, seed=b)
    if metric == "cos":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    cand = np.random.default_rng(b).integers(0, 500, (b, C)).astype(np.int32)
    store_r = jrerank.ExactStore(x)
    ex_r = jrerank.exact_candidate_distances(q, cand, store_r, metric, mode="host")
    store = rerank.ExactStore(x)
    assert np.array_equal(store.norms2, store_r.norms2)
    ex_h = rerank.exact_candidate_distances(q, cand, store, metric, mode="host")
    assert np.array_equal(ex_h.numpy(), ex_r)
    ex_d = rerank.exact_candidate_distances(torch.from_numpy(q), torch.from_numpy(cand), store,
                                            metric, mode="device")
    np.testing.assert_allclose(ex_d.numpy(), ex_r, rtol=1e-5, atol=1e-5)
    assert store.device_nbytes() == store.nbytes()


def test_resolve_store_mode():
    assert rerank.resolve_store_mode("auto", torch.device("cpu")) == "host"
    assert rerank.resolve_store_mode("auto", torch.device("cuda")) == "device"
    assert rerank.resolve_store_mode("device", torch.device("cpu")) == "device"
    with pytest.raises(ValueError, match="rerank_store"):
        rerank.resolve_store_mode("gpu", torch.device("cpu"))


# ---------------------------------------------------------------------------
# LannsIndex(quantized="q8") end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    data = clustered_vectors(4000, 24, n_clusters=32, seed=0)
    queries = clustered_vectors(64, 24, n_clusters=32, seed=1)
    return data, queries


def _cfg(**kw):
    base = {"num_shards": 1, "num_segments": 4, "segmenter": "apd", "engine": "scan",
            "alpha": 0.15, "quantized": "q8", "seed": 1}
    base.update(kw)
    return base


def _ports(ref_idx: JIndex, cfg: dict, data):
    """The port index built from the data, and carried across from the
    reference with the reference's own codes."""
    built = LannsIndex(LannsConfig(**cfg), device="cpu").build(data)
    parts = {
        sg: {"vectors": p.vectors, "keys": p.keys,
             **({} if p.q8 is None else
                {"q8_codes": p.q8.codes, "q8_scales": p.q8.scales, "q8_norms2": p.q8.norms2})}
        for sg, p in ref_idx.partitions.items()
    }
    carried = index_from_numpy_state(
        dataclasses.asdict(ref_idx.config), ref_idx.partitioner.segmenter.tree_arrays(), parts,
        getattr(ref_idx, "_mips_M2", None), device="cpu",
    )
    for sg, p in ref_idx.partitions.items():
        if p.q8 is not None:
            assert np.array_equal(built.partitions[sg].q8.codes, p.q8.codes)
            assert carried.partitions[sg].q8.codes is p.q8.codes
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
    assert st["scan_traces_q8"] == -1


@pytest.mark.parametrize("metric", ["l2", "ip", "cos", "mips"])
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_q8_index_matches_reference(world, metric, spill):
    data, queries = world
    cfg = _cfg(metric=metric, spill=spill)
    ref_idx = JIndex(JConfig(**cfg)).build(data)
    res_r = ref_idx.query(queries, 20, return_stats=True)
    for port in _ports(ref_idx, cfg, data):
        assert all(p.vectors is None for p in port.partitions.values())  # no fp32 scan copy
        _assert_same(port.query(queries, 20, return_stats=True), res_r)


@pytest.mark.parametrize("case", ["multi_shard", "mixed_topk", "rerank_clamp", "device_store"])
def test_q8_index_variants_match_reference(world, case):
    data, queries = world
    cfg, topk = _cfg(), 20
    if case == "multi_shard":
        cfg = _cfg(num_shards=2, num_segments=2, segmenter="rh")
    elif case == "mixed_topk":
        topk = np.resize(np.array([3, 20, 7, 20]), len(queries))
    elif case == "rerank_clamp":  # 4 segments of ~75 rows; C = 4 * 100 >> 75
        cfg, topk, data = _cfg(rerank_factor=4), 100, data[:300]
    else:  # exact re-rank from the device copy of the fp32 rows
        cfg = _cfg(rerank_store="device")
    ref_idx = JIndex(JConfig(**cfg)).build(data)
    res_r = ref_idx.query(queries, topk, return_stats=True)
    for port in _ports(ref_idx, cfg, data):
        res = port.query(queries, topk, return_stats=True)
        _assert_same(res, res_r)
        if case == "rerank_clamp":
            assert (res[1] == -1).any()  # partitions smaller than topk pad with -1
        if case == "device_store":
            ex = port._q8_executor()
            assert ex.rerank_store == "device"
            assert ex.exact_store_device_bytes() == ex.exact_store_bytes()


def test_q8_empty_batch_and_stats(world):
    data, queries = world
    cfg = _cfg()
    ref_idx = JIndex(JConfig(**cfg)).build(data[:500])
    port = LannsIndex(LannsConfig(**cfg), device="cpu").build(data[:500])
    empty = np.zeros((0, data.shape[1]), np.float32)
    for topk in (7, np.zeros((0,), np.int64)):
        d, i, st = port.query(empty, topk, return_stats=True)
        d_r, i_r, st_r = ref_idx.query(empty, topk, return_stats=True)
        assert d.shape == d_r.shape and i.shape == i_r.shape
        assert set(st) == set(st_r)
        assert st["merge_path"] == st_r["merge_path"]
    assert port.build_stats["q8_encode_seconds"] >= 0.0
    ex = port._q8_executor()
    assert ex.rerank_store == "host" and ex.exact_store_device_bytes() == 0
    codes = sum(p.codes.numel() for p in ex.parts.values())
    assert ex.resident_bytes() == codes + sum(
        4 * p.scales.numel() + 4 * p.n + 8 * p.n for p in ex.parts.values()
    )


def test_q8_carried_without_codes_encodes_like_reference(world):
    """A carried-across q8 index given only fp32 rows encodes them itself,
    to the reference's codes, and answers as the reference does."""
    data, queries = world
    cfg = _cfg(metric="mips", spill="physical")
    ref_idx = JIndex(JConfig(**cfg)).build(data)
    parts = {sg: {"vectors": p.vectors, "keys": p.keys} for sg, p in ref_idx.partitions.items()}
    port = index_from_numpy_state(
        dataclasses.asdict(ref_idx.config), ref_idx.partitioner.segmenter.tree_arrays(), parts,
        ref_idx._mips_M2, device="cpu",
    )
    for sg, p in ref_idx.partitions.items():
        if p.q8 is not None:
            q8 = port.partitions[sg].q8
            assert np.array_equal(q8.codes, p.q8.codes) and np.array_equal(q8.norms2, p.q8.norms2)
    _assert_same(port.query(queries, 20, return_stats=True),
                 ref_idx.query(queries, 20, return_stats=True))

"""K1, K2 and K3 on the card: the CUDA kernels against their plain PyTorch
versions, card indexes against CPU indexes (scan and HNSW), the HNSW beam on
the card against the beam on the CPU, and the LM path on the card against
the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
module imports torch and the port only (no JAX), so it runs on a machine
that has the card but not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import index_from_numpy_state, index_numpy_state
from repro_torch.core import LannsConfig, LannsIndex, beam_search_flat
from repro_torch.data.synthetic import sift_like
from repro_torch.kernels import ops, ref
from repro_torch.kernels.distance_topk import B_SMALL, TILE_N, TILE_Q, split_plan
from repro_torch.kernels.flash_attention import flash_attention_cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc to build the kernels")
    return torch.device("cuda")


def _chunk_edge(dev, B, k_pad, lo=4000, hi=40_000):
    """An n_valid whose last corpus chunk holds exactly one row on this card."""
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for nv in range(lo, hi):
        ns, ch = split_plan(B, nv, sm, k_pad)
        if ns > 1 and nv % ch == 1:
            return nv
    raise AssertionError("no chunk edge in range")


# the scan's tile edges: B = TILE_Q +- 1, N = TILE_N +- 1, a chunk edge
# (n_valid = None: a multiple of the chunk plus one row, set on the card)
TILE_EDGES = [
    (TILE_Q - 1, 5003, 64, 100, None),
    (TILE_Q + 1, 5003, 64, 100, None),
    (37, TILE_N - 1, 32, 10, None),
    (37, TILE_N + 1, 32, 60, None),
    (TILE_Q + 1, 20_000, 48, 200, "chunk edge"),  # k_pad 256
    (37, 5003, 33, 200, None),  # ragged D, k_pad 256
]


def _assert_topk_close(d, i, d_r, i_r):
    d, i, d_r, i_r = (t.cpu().numpy() for t in (d, i, d_r, i_r))
    fin = np.isfinite(d_r)
    assert np.array_equal(fin, np.isfinite(d))
    assert np.all(i[~fin] == -1)
    assert np.allclose(d[fin], d_r[fin], rtol=3e-4, atol=3e-4), np.abs(d - d_r)[fin].max()
    for rk, rr, f in zip(i, i_r, fin):
        assert len(set(rk[f].tolist()) & set(rr[f].tolist())) >= f.sum() - 1  # one tie swap


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("B,N,D,k,n_valid", [
    (37, 5003, 128, 100, None),
    (9, 4097, 50, 200, 257),
    (3, 64, 960, 100, 40),
    (1000, 200_000, 128, 10, None),
    (37, 5003, 128, 400, None),  # k_pad 512
] + TILE_EDGES)
def test_k1_matches_plain(cuda, metric, B, N, D, k, n_valid):
    if n_valid == "chunk edge":
        n_valid = _chunk_edge(cuda, B, 256)
    g = torch.Generator(device=cuda).manual_seed(B + N)
    q = torch.randn(B, D, generator=g, device=cuda)
    x = torch.randn(N, D, generator=g, device=cuda)
    ops.reset_launches()
    d, i = ops.distance_topk(q, x, k, metric, n_valid=n_valid)
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 1
    d_p, i_p = ref.distance_topk_blocked(q, x, k, metric, n_valid=n_valid)
    torch.cuda.synchronize()
    _assert_topk_close(d, i, d_p, i_p)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_k1_near_equal_rows(cuda, metric):
    # rows that differ by 1e-3 relative: the 3xTF32 scores must rank them
    # as the plain float32 version does, up to one tie swap a row
    rng = np.random.default_rng(3)
    base = rng.standard_normal((500, 96)).astype(np.float32)
    x = np.repeat(base, 8, 0) * (1 + 1e-3 * rng.standard_normal((4000, 96))).astype(np.float32)
    q = base[:40] + 0.05 * rng.standard_normal((40, 96)).astype(np.float32)
    q, x = torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda)
    d, i = ops.distance_topk(q, x, 100, metric)
    d_p, i_p = ref.distance_topk_blocked(q, x, 100, metric)
    torch.cuda.synchronize()
    _assert_topk_close(d, i, d_p, i_p)


# the scans' batch edges: the small-batch threshold and the warpgroup's 64
# queries, at ragged and whole D, with n_valid < N, at each k_pad
BATCH_EDGES = [(B, D, k) for B in (1, 2, B_SMALL, B_SMALL + 1, 63, 65)
               for D in (7, 18, 50, 128, 512) for k in (100, 200, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,k", BATCH_EDGES)
def test_k1_batch_edges_match_plain_and_repeat_their_bits(cuda, B, D, k):
    metric = ("l2", "ip")[(B + D) % 2]
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + D)
    q = torch.randn(B, D, generator=g, device=cuda)
    x = torch.randn(5003, D, generator=g, device=cuda)
    ops.reset_launches()
    d, i = ops.distance_topk(q, x, k, metric, n_valid=4001)
    d2, i2 = ops.distance_topk(q, x, k, metric, n_valid=4001)
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 2
    k_pad = max(128, 1 << (k - 1).bit_length())
    assert ops.LAUNCHES_BY_SHAPE["distance_topk"] == {(B, 4001, D, k_pad): 2}
    d_p, i_p = ref.distance_topk_blocked(q, x, k, metric, n_valid=4001)
    torch.cuda.synchronize()
    assert torch.equal(d, d2) and torch.equal(i, i2)
    _assert_topk_close(d, i, d_p, i_p)


@pytest.mark.cuda
def test_k1_rejects_large_k(cuda):
    q = torch.randn(2, 8, device=cuda)
    x = torch.randn(1000, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.distance_topk(q, x, 600, "l2")


def _assert_q8_topk(d, i, d_p, i_p, scores_of):
    """K2 vs its plain version: scores bit-equal, ids equal up to swaps
    between equal scores at the k-th place, and every id the kernel returns
    carries its own plain score (``scores_of(row, ids)``)."""
    d, i, d_p, i_p = (t.cpu().numpy() for t in (d, i, d_p, i_p))
    assert np.array_equal(d, d_p)
    for r, (dr, ir, pr) in enumerate(zip(d, i, i_p)):
        fin = np.isfinite(dr)
        assert np.all(ir[~fin] == -1) and len(set(ir[fin].tolist())) == fin.sum()
        if fin.any():
            kth = dr[fin][-1]
            assert set(ir[dr < kth].tolist()) == set(pr[dr < kth].tolist())
            assert np.array_equal(scores_of(r, ir[fin]), dr[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("B,N,D,k,n_valid", [
    (37, 5003, 128, 38, None),
    (9, 4097, 50, 228, 257),   # D not a multiple of 4, n_valid < N
    (3, 64, 960, 100, 40),     # k > n_valid
    (345, 150_000, 512, 38, None),
    (19, 3001, 2048, 400, None),  # k_pad 512, D > 1024
] + TILE_EDGES + [(37, 5003, 31, 100, None)])
def test_k2_matches_plain(cuda, metric, B, N, D, k, n_valid):
    from repro_torch.quant.codec import quantize_q8

    if n_valid == "chunk edge":
        n_valid = _chunk_edge(cuda, B, 256)
    rng = np.random.default_rng(B + N)
    x = rng.standard_normal((N, D)).astype(np.float32)
    qc = quantize_q8(x, metric)
    codes = torch.from_numpy(qc.codes).to(cuda)
    scales = torch.from_numpy(qc.scales).to(cuda)
    norms2 = torch.from_numpy(qc.norms2).to(cuda)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(cuda)
    corpus = type("Q8", (), {"codes": codes, "scales": scales, "norms2": norms2,
                             "metric": metric})()
    ops.reset_launches()
    d, i = ops.distance_topk_q8(q, corpus, k, metric, n_valid=n_valid)
    assert ops.KERNEL_LAUNCHES["distance_topk_q8"] == 1
    # the plain version on the same tensors
    from repro_torch.quant.codec import quantize_queries_q8_t

    q_eff = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12) if metric == "cos" else q
    metric_k = "l2" if metric == "l2" else "ip"
    q_codes, q_scale = quantize_queries_q8_t(q_eff, scales)
    d_k, i_k = ops.distance_topk_q8_codes(q_codes, codes, q_scale, norms2, k, metric_k,
                                          n_valid=n_valid)
    d_p, i_p = ref.distance_topk_q8_blocked(q_codes, codes, q_scale, norms2, k, metric_k,
                                            n_valid=n_valid)
    torch.cuda.synchronize()

    def scores_of(r, ids):
        idx = torch.from_numpy(ids.astype(np.int64)).to(cuda)
        s = ref.q8_score_matrix(q_codes[r: r + 1], codes[idx], q_scale[r: r + 1], norms2[idx],
                                metric_k)
        return s[0].cpu().numpy()

    _assert_q8_topk(d_k, i_k, d_p, i_p, scores_of)
    if metric == "l2":
        d_k = d_k + (q * q).sum(-1, keepdim=True)
    assert torch.equal(torch.where(torch.isinf(d_k), -1, i_k), i)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,k", BATCH_EDGES)
def test_k2_batch_edges_bit_equal_plain_and_repeat_their_bits(cuda, B, D, k):
    from repro_torch.quant.codec import quantize_q8, quantize_queries_q8_t

    metric = ("l2", "ip")[(B + D) % 2]
    rng = np.random.default_rng(B * 1000 + D)
    qc = quantize_q8(rng.standard_normal((5003, D)).astype(np.float32), metric)
    codes, norms2 = torch.from_numpy(qc.codes).to(cuda), torch.from_numpy(qc.norms2).to(cuda)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(cuda)
    q_codes, q_scale = quantize_queries_q8_t(q, torch.from_numpy(qc.scales).to(cuda))
    runs = [ops.distance_topk_q8_codes(q_codes, codes, q_scale, norms2, k, metric, n_valid=4001)
            for _ in range(2)]
    d_p, i_p = ref.distance_topk_q8_blocked(q_codes, codes, q_scale, norms2, k, metric,
                                            n_valid=4001)
    torch.cuda.synchronize()
    (d, i), (d2, i2) = runs
    assert torch.equal(d, d2) and torch.equal(i, i2)

    def scores_of(r, ids):
        idx = torch.from_numpy(ids.astype(np.int64)).to(cuda)
        return ref.q8_score_matrix(q_codes[r: r + 1], codes[idx], q_scale[r: r + 1],
                                   norms2[idx], metric)[0].cpu().numpy()

    _assert_q8_topk(d, i, d_p, i_p, scores_of)


@pytest.mark.cuda
def test_k2_rejects_large_k(cuda):
    codes = torch.zeros((1000, 8), dtype=torch.int8, device=cuda)
    q_codes = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    ones = torch.ones(2, device=cuda)
    with pytest.raises(NotImplementedError, match="k_pad"):
        ops.distance_topk_q8_codes(q_codes, codes, ones, torch.zeros(1000, device=cuda), 600)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_card_index_matches_cpu_index(cuda, spill):
    data, queries = sift_like(2500, 24, 48, seed=5)
    cfg = LannsConfig(num_shards=2, num_segments=4, engine="scan", spill=spill)
    gpu = LannsIndex(cfg).build(data)
    cpu = LannsIndex(cfg, device="cpu").build(data)
    ops.reset_launches()
    d, i = gpu.query(queries, 10)
    assert ops.KERNEL_LAUNCHES["distance_topk"] > 0
    d_c, i_c = cpu.query(queries, 10)
    np.testing.assert_array_equal(i, i_c)
    np.testing.assert_allclose(d, d_c, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", ["virtual", "physical"])
@pytest.mark.parametrize("rerank_store", ["auto", "host"])
def test_card_q8_index_matches_cpu_index(cuda, spill, rerank_store):
    data, queries = sift_like(2500, 24, 48, seed=5)
    cfg = LannsConfig(num_shards=2, num_segments=4, engine="scan", spill=spill,
                      quantized="q8", rerank_store=rerank_store)
    gpu = LannsIndex(cfg).build(data)
    cpu = LannsIndex(cfg, device="cpu").build(data)
    ops.reset_launches()
    d, i = gpu.query(queries, 10)
    assert ops.KERNEL_LAUNCHES["distance_topk_q8"] > 0
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 0
    d_c, i_c = cpu.query(queries, 10)
    np.testing.assert_array_equal(i, i_c)
    np.testing.assert_allclose(d, d_c, rtol=3e-4, atol=3e-4)


def _hnsw_cfg(**kw):
    return LannsConfig(num_shards=2, num_segments=4, engine="hnsw", hnsw_m=8,
                       ef_construction=40, ef_search=48, **kw)


def _beams_agree(d, i, d_c, i_c):
    """The HNSW acceptance (tests/test_torch_hnsw.py): ids equal in >= 99%
    of entries, distances within 1e-4 where they are."""
    d, i, d_c, i_c = (np.asarray(a) for a in (d, i, d_c, i_c))
    assert d.shape == d_c.shape
    same = i == i_c
    assert same.mean() >= 0.99, same.mean()
    fin = same & np.isfinite(d_c)
    np.testing.assert_allclose(d[fin], d_c[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", ["none", "q8"])
def test_card_beam_matches_cpu_beam(cuda, quantized):
    """One set of frozen graphs: ``beam_search_flat`` on the card against
    the same call on the CPU, over every partition's lanes plus padding
    lanes."""
    data, queries = sift_like(3000, 32, 64, seed=7)
    gpu = LannsIndex(_hnsw_cfg(quantized=quantized)).build(data)
    stack = gpu._hnsw_stack(quantized=quantized == "q8")
    n_pad, P = stack["n_pad"], len(stack["index"])
    lane_p = np.repeat(np.arange(P), len(queries))
    T = len(lane_p) + 5
    q = np.zeros((T, 32), np.float32)
    q[: len(lane_p)] = np.tile(queries, (P, 1))
    q = torch.from_numpy(q)
    if quantized == "q8":
        q[: len(lane_p)] *= stack["scales"].cpu()[torch.from_numpy(lane_p)]
    off = torch.zeros(T, dtype=torch.int64)
    off[: len(lane_p)] = torch.from_numpy(lane_p * n_pad)
    ep = off + torch.from_numpy(np.pad(stack["entry"][lane_p], (0, 5)))
    valid = torch.arange(T) < len(lane_p)
    kw = {"k": 20, "ef": 48, "max_iters": 64, "metric": "l2"}
    d, i = beam_search_flat(stack["arrs"], q.to(cuda), ep.to(cuda), off.to(cuda),
                            valid.to(cuda), **kw)
    cpu_arrs = {k: t.cpu() for k, t in stack["arrs"].items()}
    d_c, i_c = beam_search_flat(cpu_arrs, q, ep, off, valid, **kw)
    n = len(lane_p)
    _beams_agree(d.cpu()[:n], i.cpu()[:n], d_c[:n], i_c[:n])
    assert (i.cpu()[n:, 1:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", ["none", "q8"])
@pytest.mark.parametrize("spill", ["virtual", "physical"])
def test_card_hnsw_index_matches_cpu_index(cuda, quantized, spill):
    """The card index and a CPU index carrying its graphs answer alike."""
    data, queries = sift_like(3000, 24, 64, seed=5)
    gpu = LannsIndex(_hnsw_cfg(quantized=quantized, spill=spill)).build(data)
    cpu = index_from_numpy_state(*index_numpy_state(gpu), device="cpu")
    ops.reset_launches()
    d, i = gpu.query(queries, 10)
    assert not any(ops.KERNEL_LAUNCHES.values())  # the beam is torch ops
    d_c, i_c = cpu.query(queries, 10)
    _beams_agree(d, i, d_c, i_c)


@pytest.mark.cuda
def test_pool_build_after_cuda_init(cuda):
    """``build(workers=2)`` in a process that holds a CUDA context gives
    the graphs of ``workers=0``."""
    torch.zeros(1, device=cuda)
    data, queries = sift_like(2000, 16, 16, seed=3)
    a = LannsIndex(_hnsw_cfg()).build(data, workers=2)
    b = LannsIndex(_hnsw_cfg()).build(data, workers=0)
    for sg, p in a.partitions.items():
        if p.kind == "hnsw":
            fa, fb = p.frozen, b.partitions[sg].frozen
            assert fa.entry == fb.entry
            for name in ("vectors", "levels", "adj0", "upper_adj", "keys"):
                np.testing.assert_array_equal(getattr(fa, name), getattr(fb, name))
    np.testing.assert_array_equal(a.query(queries, 10)[1], b.query(queries, 10)[1])


# K3's shapes: a few of the model's, then the kernel's tile edges (64-row q
# and kv tiles) at every head dim, causal and not
K3_CASES = [
    (1, 1, 16, True),
    (15, 200, 64, True),
    (3, 1025, 128, False),
    (30, 129, 32, True),
    (2, 4096, 64, True),
] + [(BH, S, D, causal) for S in (15, 17, 63, 65, 1000, 4097) for BH in (1, 7)
     for D in (16, 32, 64, 128) for causal in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("BH,S,D,causal,v_scale,q_scale", [c + (1.0, 1.0) for c in K3_CASES] + [
    (7, 1000, 64, True, 8.0, 1.0),  # outputs past 4, where one bf16 ulp is 3.1e-2
] + [(7, S, D, causal, 8.0, 1.0) for S, D, causal in ((1000, 16, False), (65, 128, True))] + [
    (7, S, D, causal, 1.0, 4.0)  # a peaky softmax: scores 4x larger
    for S in (1000, 4097) for D in (16, 32, 64, 128) for causal in (True, False)
])
def test_k3_matches_plain(cuda, dtype, tol, BH, S, D, causal, v_scale, q_scale):
    """K3 against its plain version on the same tensors within the
    reference's limit (scaled with v: attention is linear in v); bfloat16
    also within half a bf16 ulp + 1e-4 of the plain version in float32
    (``ref.bf16_agreement``), which a bf16 p would miss."""
    g = torch.Generator(device=cuda).manual_seed(BH * S + D)
    q, k, v = (torch.randn(BH, S, D, generator=g, device=cuda) for _ in range(3))
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), (v * v_scale).to(dtype)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.float() - want.float()).abs().max()) <= tol * v_scale
    if dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        assert ref.bf16_agreement(out, want32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("BH,S,causal,q_scale", [
    (BH, S, causal, 1.0) for S in (1, 65, 1000, 4097) for BH in (1, 16)
    for causal in (True, False)] + [(7, 1000, True, 4.0), (7, 4097, False, 4.0)])
def test_k3_mla_head_dims_match_plain(cuda, dtype, tol, BH, S, causal, q_scale):
    """K3's (192, 128) instance (MLA: q . k over 128 nope + 64 rope dims, v
    of 128) against its plain version, one launch, with K3's limits."""
    g = torch.Generator(device=cuda).manual_seed(BH * S + 192)
    q, k = (torch.randn(BH, S, 192, generator=g, device=cuda) for _ in range(2))
    v = torch.randn(BH, S, 128, generator=g, device=cuda)
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (BH, S, 128)
    assert float((out.float() - want.float()).abs().max()) <= tol
    if dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        assert ref.bf16_agreement(out, want32) <= 1.0


@pytest.mark.cuda
def test_k3_rejects_unsupported_inputs(cuda):
    x = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(NotImplementedError, match="head dim"):
        ops.flash_attention(x, x, x)
    with pytest.raises(NotImplementedError, match="head dim"):  # (192, 64): no instance
        ops.flash_attention(*(torch.zeros(2, 8, 192, device=cuda),) * 2, x[..., :64])
    h = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ops.flash_attention(h, h, h)
    # a contiguous bf16 view off the 16-byte grid: the launcher refuses it,
    # the wrapper copies it and gives the plain version's answer
    b = torch.randn(2 * 8 * 64 + 1, device=cuda).to(torch.bfloat16)[1:].view(2, 8, 64)
    assert b.is_contiguous() and b.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(b, b, b, causal=True, scale=0.125)
    out = ops.flash_attention(b, b, b)
    want = ref.flash_attention_ref(b.float(), b.float(), b.float(), causal=True)
    assert ref.bf16_agreement(out, want) <= 1.0
    # the same for float32: 4 bytes off the grid
    f = torch.randn(2 * 8 * 64 + 1, device=cuda)[1:].view(2, 8, 64)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_cuda(f, f, f, causal=True, scale=0.125)
    out = ops.flash_attention(f, f, f)
    want = ref.flash_attention_ref(f, f, f, causal=True)
    assert float((out - want).abs().max()) <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,D,causal", [(15, 2048, 64, True), (7, 1000, 128, False),
                                           (3, 65, 16, True), (7, 1000, 192, True)])
def test_k3_float32_launches_are_bit_equal(cuda, BH, S, D, causal):
    """Two launches on the same inputs give the same bits: no atomics, no
    order that depends on timing.  D = 192 is MLA's instance, v of 128."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k = (torch.randn(BH, S, D, generator=g, device=cuda) for _ in range(2))
    v = torch.randn(BH, S, 128 if D == 192 else D, generator=g, device=cuda)
    a = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    b = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K3's float32 instances, and the edges of their tiles: kv tiles of 64 rows
# up to D = 64, 32 at 128 and 16 at (192, 128); q blocks of 128 rows up to
# D = 64 (two consumer warpgroups), 64 past it
K3_F32_INSTANCES = [(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)]
K3_F32_EDGES = [15, 17, 31, 33, 63, 65, 127, 129]


def _k3_f32_inputs(cuda, BH, S, D, Dv, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(BH, S, D, generator=g, device=cuda) for _ in range(2))
    return q, k, torch.randn(BH, S, Dv, generator=g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", K3_F32_INSTANCES)
@pytest.mark.parametrize("causal", [True, False])
def test_k3_f32_output_with_lse_is_bit_equal_to_output_without(cuda, D, Dv, causal):
    """float32: the lse instance only adds the store: its output is the
    other instance's bit for bit, and its lse is the plain version's."""
    q, k, v = _k3_f32_inputs(cuda, 5, 1000, D, Dv, seed=D + Dv)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5, with_lse=True)
    bare = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    _, lse_plain = ref.flash_attention_ref(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    assert float((lse - lse_plain).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", K3_F32_INSTANCES)
@pytest.mark.parametrize("S", K3_F32_EDGES)
@pytest.mark.parametrize("causal", [True, False])
def test_k3_f32_tile_edges_match_plain(cuda, D, Dv, S, causal):
    """float32 at every instance, S one row either side of each kv tile and
    q block size: within 3e-5 of the plain version, in one launch."""
    q, k, v = _k3_f32_inputs(cuda, 3, S, D, Dv, seed=S * D + Dv)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (3, S, Dv)
    assert float((out - want).abs().max()) <= 3e-5


# K3's bfloat16 instances ((D, Dv): D = Dv in 16-128 and MLA's (192, 128))
K3_BF16_INSTANCES = [(16, 16), (32, 32), (64, 64), (128, 128), (192, 128)]


def _k3_bf16_inputs(cuda, BH, S, D, Dv, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(BH, S, D, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    return q, k, torch.randn(BH, S, Dv, generator=g, device=cuda).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", K3_BF16_INSTANCES)
@pytest.mark.parametrize("BH,S,causal", [(15, 2048, True), (7, 1000, False), (3, 65, True)])
def test_k3_bf16_launches_are_bit_equal(cuda, D, Dv, BH, S, causal):
    """bfloat16 at every instance: two launches on the same inputs give the
    same bits (no atomics, no split over kv: each output row is one
    warpgroup's work in a fixed order)."""
    q, k, v = _k3_bf16_inputs(cuda, BH, S, D, Dv, seed=S + D)
    a = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    b = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", K3_BF16_INSTANCES)
@pytest.mark.parametrize("causal", [True, False])
def test_k3_bf16_output_with_lse_is_bit_equal_to_output_without(cuda, D, Dv, causal):
    """The lse instance only adds the store: its output is the other
    instance's bit for bit, and its lse is the plain version's."""
    q, k, v = _k3_bf16_inputs(cuda, 5, 1000, D, Dv, seed=D + Dv)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5, with_lse=True)
    bare = flash_attention_cuda(q, k, v, causal=causal, scale=D ** -0.5)
    _, lse_plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                           with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    assert float((lse - lse_plain).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", K3_BF16_INSTANCES)
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 4097])
@pytest.mark.parametrize("causal", [True, False])
def test_k3_bf16_tile_edges_match_plain(cuda, D, Dv, S, causal):
    """bfloat16 at the edges of the kv tiles (128 rows up to Dv = 64, 64 past
    it) and of the 128-row blocks (a block's two warpgroups of 64 q rows)
    and past 4096, at every instance:
    within 3e-2 of the plain version and ``ref.bf16_agreement`` <= 1
    against it in float32, in one launch."""
    q, k, v = _k3_bf16_inputs(cuda, 3, S, D, Dv, seed=S * D + Dv)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (3, S, Dv)
    assert float((out.float() - want).abs().max()) <= 3e-2
    assert ref.bf16_agreement(out, want) <= 1.0


@pytest.mark.cuda
def test_card_lm_engine_matches_cpu(cuda):
    """A small LM served on the card (prefill through K3) and on the CPU:
    equal greedy tokens, prefill logits within 1e-4."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine, make_bucketed_prefill_fn

    cfg = tf.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128, vocab=256, q_chunk=32, kv_chunk=64)
    cpu_params = tf.init(cfg, seed=0, device="cpu")
    gpu_params = tf.init(cfg, seed=0, device="cpu").to(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, L).astype(np.int32) for L in (7, 40, 100)]
    outs = []
    for params in (gpu_params, cpu_params):
        eng = ServeEngine(cfg, params, slots=2, max_seq=128)
        reqs = [Request(u, p, max_new_tokens=6) for u, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launches()
        eng.run()
        outs.append([r.tokens_out for r in reqs])
        if params is gpu_params:
            assert ops.KERNEL_LAUNCHES["flash_attention"] > 0
    assert outs[0] == outs[1]
    prefill = make_bucketed_prefill_fn(cfg)
    toks = torch.from_numpy(np.pad(prompts[2], (0, 28))[None].astype(np.int64))
    lg = [prefill(p, toks.to(p.embed.device), tf.make_cache(cfg, 1, 128, torch.float32,
                                                            p.embed.device), 99)[0]
          for p in (gpu_params, cpu_params)]
    assert float((lg[0].cpu() - lg[1]).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("engine,quantized", [("scan", "none"), ("scan", "q8"),
                                              ("hnsw", "none"), ("hnsw", "q8")])
def test_saved_index_loads_on_card_and_serves_warm(cuda, tmp_path, engine, quantized):
    """An index built on the card, saved and loaded on the card gives equal
    ids (and the CPU's, loaded from the same artifact, up to ties); after
    ``warm_traces`` the front end's serving window loads no kernel
    library."""
    from repro_torch.analysis import RetraceSentinel
    from repro_torch.obs import Telemetry
    from repro_torch.serve import AsyncAnnFrontend

    data, queries = sift_like(6000, 32, 64, seed=11)
    cfg = LannsConfig(num_shards=2, num_segments=2, segmenter="rh", engine=engine,
                      quantized=quantized, hnsw_m=8, ef_construction=40, ef_search=40)
    built = LannsIndex(cfg).build(data)
    d_built, i_built = built.query(queries, 10)
    built.save(str(tmp_path))
    card = LannsIndex.load(str(tmp_path))
    assert card.device.type == "cuda"
    d_card, i_card = card.query(queries, 10)
    np.testing.assert_array_equal(i_card, i_built)
    np.testing.assert_array_equal(d_card, d_built)
    _, i_cpu = LannsIndex.load(str(tmp_path), device="cpu").query(queries, 10)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_card, i_cpu)])
    assert overlap >= 0.99, overlap
    card.warm_traces(16, 10)
    sentinel = RetraceSentinel(card.device)
    assert sentinel.available
    tel = Telemetry(sentinel=RetraceSentinel(card.device))
    card.attach_telemetry(tel)
    try:
        with AsyncAnnFrontend(card, topk=10, max_batch=16, max_wait_ms=1.0,
                              telemetry=tel) as fe:
            reqs = [fe.submit(q) for q in queries]
            assert all(r.wait(60.0) for r in reqs)
    finally:
        card.attach_telemetry(None)
    assert all(r.done for r in reqs)
    assert sentinel.deltas()["kernel_library_loads"] == 0
    plans = tel.spans.events(kind="plan")
    assert plans and all(ev["stage_s"]["candidates"] >= 0.0 for ev in plans)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_k1_segment_scan_matches_plain(cuda, metric):
    """The distributed serve step's segment scan: one K1 launch per segment
    over that segment's valid rows, against the plain version on the same
    blocks (C = 300 queries, ragged segments padded to a multiple of 8)."""
    from repro_torch.serve.retrieval import _segment_scan_topk, build_device_index, shard_arrays

    data, queries = sift_like(20_000, 64, 300, seed=13)
    cfg = LannsConfig(num_shards=1, num_segments=8, segmenter="rh", engine="scan")
    index = build_device_index(data, cfg)
    card, cpu = shard_arrays(index, 0, cuda), shard_arrays(index, 0, "cpu")
    q_seg = torch.from_numpy(queries).expand(8, *queries.shape)
    ops.reset_launches()
    d, i = _segment_scan_topk(q_seg.to(cuda), card["corpus"][0], card["ids"][0],
                              card["norms"][0], 60, metric)
    assert ops.KERNEL_LAUNCHES["distance_topk"] == 8
    d_p, i_p = _segment_scan_topk(q_seg, cpu["corpus"][0], cpu["ids"][0], cpu["norms"][0], 60,
                                  metric)
    torch.cuda.synchronize()
    for g in range(8):
        _assert_topk_close(d[g], i[g], d_p[g], i_p[g])


def _serve_rank(mesh, index, queries, kw):
    """Rank body: this rank's rows through the serve step; (query block,
    dists, ids, overflow, K1 launches)."""
    from repro_torch.common.utils import resolve_device
    from repro_torch.serve.retrieval import make_serve_fn, shard_arrays

    dev = resolve_device(mesh.device_type)
    serve_fn, info = make_serve_fn(mesh, index.config, **kw)
    rows = len(queries) // info["query_blocks"]
    b = info["query_block"]
    q = torch.from_numpy(queries[b * rows: (b + 1) * rows]).to(dev)
    ops.reset_launches()
    d, i, ovf = serve_fn(q, **shard_arrays(index, info["shard"], dev))
    return b, d.cpu().numpy(), i.cpu().numpy(), int(ovf), ops.KERNEL_LAUNCHES["distance_topk"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,backend", [((1, 1), None), ((1, 2), "gloo")])
def test_serve_step_on_card_matches_cpu(cuda, shape, backend):
    """``make_serve_fn`` in a world on the card (NCCL for one rank; two
    ranks on the one card on gloo) gives the CPU world's answers."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_world
    from repro_torch.serve.retrieval import build_device_index

    _build.build_all(("distance_topk.cu",))  # here, not in two ranks at once
    data, queries = sift_like(20_000, 64, 256, seed=17)
    cfg = LannsConfig(num_shards=shape[1], num_segments=4, segmenter="rh", engine="scan")
    index = build_device_index(data, cfg)
    kw = dict(topk=20, mode="routed", batch_per_device=256)
    args = (index, queries, kw)
    card = run_world(_serve_rank, shape, ("data", "model"), args, backend=backend, timeout=300)
    cpu = run_world(_serve_rank, shape, ("data", "model"), args, device="cpu", timeout=300)
    for (_, d, i, ovf, launches), (_, d_c, i_c, ovf_c, _) in zip(card, cpu):
        assert launches == 4 and ovf == ovf_c
        fin = np.isfinite(d_c)
        assert np.array_equal(fin, np.isfinite(d))
        np.testing.assert_allclose(d[fin], d_c[fin], rtol=3e-4, atol=3e-4)
        overlap = np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(i, i_c)])
        assert overlap >= 0.999, overlap


# K3-bwd's shapes: the slice's layer shape, then the tile edges at every head
# dim, causal and not: a consumer warpgroup's 64 rows (63, 65), a block's 128
# (127, 128, 129; 257: three blocks) and the 32-row walked tiles of D = 128
# (31, 32, 33)
K3_BWD_CASES = [(60, 4096, 64, True), (1, 1, 16, True), (15, 1100, 64, True),
                (3, 1025, 128, False)] + [
    (BH, S, D, causal) for S in (63, 65, 1000) for BH in (1, 3) for D in (16, 32, 64, 128)
    for causal in (True, False)] + [
    (1, S, D, causal) for S in (31, 32, 33, 127, 128, 129) for D in (16, 32, 64, 128)
    for causal in (True, False)] + [(2, 257, D, True) for D in (64, 128)]


def _k3_bwd_case(dev, dtype, BH, S, D, causal, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(BH, S, D, generator=g, device=dev).to(dtype) for _ in range(4))
    return q, k, v, do


def _check_k3_bwd(got, want32, dtype):
    """float32: max |kernel - plain| / max |plain| <= 1e-4 per tensor;
    bfloat16: ``ref.bf16_agreement`` <= 1 against the plain version in
    float32 on the same bf16-valued inputs.  With one key (S = 1) the
    softmax is constant, so dq and dk are exactly zero and both sides hold
    rounding noise, whose ratio means nothing: there float32 dq and dk
    must be zero at 1e-4 of dv's scale."""
    if dtype == torch.float32 and got[0].shape[1] == 1:
        zero_tol = 1e-4 * float(want32[2].abs().max())
        for name, a in (("dq", got[0]), ("dk", got[1])):
            assert float(a.abs().max()) <= zero_tol, name
        got, want32 = got[2:], want32[2:]
    for name, a, w in zip(("dq", "dk", "dv")[-len(got):], got, want32):
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.float32:
            err = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            assert err <= 1e-4, (name, err)
        else:
            assert ref.bf16_agreement(a, w) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D,causal", K3_BWD_CASES)
def test_k3_bwd_matches_plain(cuda, dtype, BH, S, D, causal):
    """K3's row log-sum-exp against the plain version's, K3's output with
    lse requested bit-equal to the output without, and K3-bwd's dq, dk, dv
    against the plain backward on the same tensors."""
    q, k, v, do = _k3_bwd_case(cuda, dtype, BH, S, D, causal, seed=BH * S + D)
    scale = D ** -0.5
    ops.reset_launches()
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, with_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal, scale=scale))
    f = lambda t: t.float()
    _, lse_plain = ref.flash_attention_ref(f(q), f(k), f(v), causal=causal, with_lse=True)
    assert float((lse - lse_plain).abs().max()) <= 1e-4
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(out), f(do), lse, causal=causal)
    torch.cuda.synchronize()
    _check_k3_bwd(got, want, dtype)


# float32 inputs that stress the 3xTF32 products, as phase 2c gives K3's
# float32 forward: q x 4 (a peaky softmax: a score's error is amplified
# through the exponent) and v x 8 (large values), at every head dim, causal
# and not, on a ragged S and across several blocks
K3_BWD_F32_SCALED = [(BH, S, D, causal, qs, vs) for BH, S in ((1, 65), (2, 1000))
                     for D in (16, 32, 64, 128) for causal in (True, False)
                     for qs, vs in ((4.0, 1.0), (1.0, 8.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,D,causal,q_scale,v_scale", K3_BWD_F32_SCALED)
def test_k3_bwd_f32_scaled_inputs_match_plain(cuda, BH, S, D, causal, q_scale, v_scale):
    """K3-bwd's float32 path on q x 4 or v x 8 against the plain backward at
    the same 1e-4 relative limit, and two launches bit-equal."""
    q, k, v, do = _k3_bwd_case(cuda, torch.float32, BH, S, D, causal, seed=BH * S + D + 7)
    q, v = q * q_scale, v * v_scale
    scale = D ** -0.5
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    _check_k3_bwd(got, want, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_bwd_takes_strided_and_misaligned_inputs_and_is_deterministic(cuda, dtype):
    """A dO that is a permuted view (as autograd hands it back through the
    (B, S, H, D) fold) and a q 4 bytes off the 16-byte grid: the launcher
    refuses the latter, ``ops.flash_attention_bwd`` copies both.  Two
    launches on the same inputs give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    BH, S, D = 6, 300, 64
    q, k, v, _ = _k3_bwd_case(cuda, dtype, BH, S, D, True, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    do = torch.randn(S, BH, D, generator=g, device=cuda).to(dtype).transpose(0, 1)
    assert not do.is_contiguous()
    shift = 4 // q.element_size()  # 4 bytes
    q_off = torch.empty(q.numel() + shift, device=cuda, dtype=dtype)[shift:].view(BH, S, D)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 != 0
    out, lse = flash_attention_cuda(q, k, v, causal=True, scale=0.125, with_lse=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd_cuda(q_off, k, v, out, do.contiguous(), lse, causal=True, scale=0.125)
    got = ops.flash_attention_bwd(q_off, k, v, out, do, lse, causal=True, scale=0.125)
    again = ops.flash_attention_bwd(q, k, v, out, do.contiguous(), lse, causal=True, scale=0.125)
    f = lambda t: t.float()
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(out), f(do), lse, causal=True,
                                       scale=0.125)
    torch.cuda.synchronize()
    _check_k3_bwd(got, want, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# MLA's (192, 128) instance: one key, a consumer warpgroup's 64 rows, a
# block's 128, the 16-row (bf16) and 8-row (float32) walked tiles, ragged S,
# and the float32 card-vs-CPU check's (16, 1100)
K3_BWD_MLA_CASES = [(BH, S, causal) for BH, S in ((1, 1), (1, 15), (1, 17), (3, 63), (3, 65),
                                                  (2, 129), (2, 1000), (16, 1100))
                    for causal in (True, False)]


def _k3_bwd_mla_case(dev, dtype, BH, S, seed, q_scale=1.0, v_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(BH, S, 192, generator=g, device=dev) for _ in range(2))
    v, do = (torch.randn(BH, S, 128, generator=g, device=dev) for _ in range(2))
    return (q * q_scale).to(dtype), k.to(dtype), (v * v_scale).to(dtype), do.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,causal", K3_BWD_MLA_CASES)
def test_k3_bwd_mla_head_dims_match_plain(cuda, dtype, BH, S, causal):
    """K3-bwd at q . k 192 and v 128 (DeepSeek-V2's MLA) against the plain
    backward on the same tensors, dq and dk of q's shape and dv of v's, one
    launch, and two launches bit-equal."""
    q, k, v, do = _k3_bwd_mla_case(cuda, dtype, BH, S, seed=BH * S + 11)
    scale = 192 ** -0.5
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, with_lse=True)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    assert ops.KERNEL_LAUNCHES["flash_attention_bwd"] == 1
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    f = lambda t: t.float()
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(out), f(do), lse, causal=causal)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [(BH, S, 192), (BH, S, 192), (BH, S, 128)]
    _check_k3_bwd(got, want, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,causal,q_scale,v_scale", [
    (BH, S, causal, qs, vs) for BH, S in ((1, 65), (2, 1000)) for causal in (True, False)
    for qs, vs in ((4.0, 1.0), (1.0, 8.0))])
def test_k3_bwd_mla_f32_scaled_inputs_match_plain(cuda, BH, S, causal, q_scale, v_scale):
    """The (192, 128) float32 instance on q x 4 (a peaky softmax) and v x 8
    (large values) at the float32 limit."""
    q, k, v, do = _k3_bwd_mla_case(cuda, torch.float32, BH, S, seed=S + 13, q_scale=q_scale,
                                   v_scale=v_scale)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=192 ** -0.5, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    _check_k3_bwd(got, want, torch.float32)


@pytest.mark.cuda
def test_k3_bwd_rejects_head_dims_without_an_instance(cuda):
    """A (D, Dv) with no CUDA instance raises on the card, in the gradient's
    entry and in K3's forward that precedes it: never the plain version."""
    q = torch.zeros(2, 64, 96, device=cuda)
    v = torch.zeros(2, 64, 64, device=cuda)
    lse = torch.zeros(2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="not in"):
        ops.flash_attention_bwd(q, q, v, v, v, lse, causal=True)
    with pytest.raises(NotImplementedError, match="not in"):
        ops.flash_attention(q.requires_grad_(), q, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["gqa", "mla"])
def test_card_moe_mla_train_step_matches_cpu(cuda, attention):
    """One train step's grads of a small MoE LM with the DeepSeek head dims
    (GQA at 128; MLA at q . k 128 + 64 and v 128, so K3 and K3-bwd run the
    (192, 128) instance), float32, chunked attention, 2 microbatches: the
    card (kernels) against the CPU (plain versions) from the same params:
    loss and aux within 1e-5 relative, every grad within 1e-3 of the CPU's
    largest entry, the grad norm within 1e-4 relative."""
    import copy

    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe import MoEConfig
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

    cfg = tf.TransformerConfig(
        n_layers=3, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512, vocab=512,
        attention=attention, mla_kv_lora_rank=64, q_chunk=64, remat=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=128, n_shared=1, first_k_dense=1,
                      capacity_factor=1.25))
    cpu_params = tf.init(cfg, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    toks, labels = token_batch(4, 300, cfg.vocab, seed=2)
    batch = {"tokens": toks, "labels": labels}
    ops.reset_launches()
    loss_g, grads_g, aux_g = _accumulate_grads(lm_loss_fn(cfg), gpu_params, batch, 2)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 2 * cfg.n_layers * 2
    assert ops.KERNEL_LAUNCHES["flash_attention_bwd"] == cfg.n_layers * 2
    loss_c, grads_c, aux_c = _accumulate_grads(lm_loss_fn(cfg), cpu_params, batch, 2)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    assert abs(float(aux_g) - float(aux_c)) <= 1e-5 * abs(float(aux_c))
    for g, c in zip(grads_g, grads_c):
        assert float((g.cpu() - c).abs().max()) <= 1e-3 * float(c.abs().max())
    n_g, n_c = float(global_norm(grads_g)), float(global_norm(grads_c))
    assert abs(n_g - n_c) <= 1e-4 * n_c


@pytest.mark.cuda
def test_card_train_step_matches_cpu(cuda):
    """One train step of a small LM (f32, chunked attention: K3 and K3-bwd
    on the card, the plain versions on the CPU) from the same params: loss
    within 1e-5 relative, every grad within 1e-3 of the CPU's largest, the
    grad norm within 1e-4 relative."""
    import copy
    import dataclasses

    from repro_torch.common.tree import leaves
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

    cfg = dataclasses.replace(tf.TransformerConfig(n_layers=2, d_model=128, n_heads=4,
                                                   n_kv_heads=2, head_dim=32, d_ff=256,
                                                   vocab=512), q_chunk=64, remat=True)
    cpu_params = tf.init(cfg, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to(cuda)
    toks, labels = token_batch(4, 300, cfg.vocab, seed=1)
    batch = {"tokens": toks, "labels": labels}
    ops.reset_launches()
    loss_g, grads_g, _ = _accumulate_grads(lm_loss_fn(cfg), gpu_params, batch, 2)
    torch.cuda.synchronize()
    # remat: each layer's forward twice per microbatch, one backward
    assert ops.KERNEL_LAUNCHES["flash_attention"] == 2 * cfg.n_layers * 2
    assert ops.KERNEL_LAUNCHES["flash_attention_bwd"] == cfg.n_layers * 2
    loss_c, grads_c, _ = _accumulate_grads(lm_loss_fn(cfg), cpu_params, batch, 2)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for g, c in zip(grads_g, grads_c):
        assert float((g.cpu() - c).abs().max()) <= 1e-3 * float(c.abs().max())
    n_g, n_c = float(global_norm(grads_g)), float(global_norm(grads_c))
    assert abs(n_g - n_c) <= 1e-4 * n_c
    assert len(leaves(tf.param_tree(gpu_params))) == len(grads_g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_order_ops_are_bit_equal_on_card(cuda, dtype):
    """``segment.gather``'s backward and ``segment_sum`` on the card, on
    indices that repeat thousands of times (a power-law head) with an empty
    row: two runs bit-equal, and float32 within rounding of the CPU."""
    from repro_torch.models import segment

    rng = np.random.default_rng(0)
    n, M, h = 1000, 200_000, 128
    idx = np.minimum(rng.zipf(1.5, M) - 1, n - 1)
    idx[idx == 5] = 4
    x = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((M, h)).astype(np.float32)).to(dtype)
    outs = {}
    for dev in ("cuda", "cuda", "cpu"):
        t = x.to(dev).requires_grad_()
        fi = segment.FixedIndex(torch.from_numpy(idx).to(dev), n)
        y = segment.gather(t, fi)
        s = segment.segment_sum(y * g.to(dev), fi)
        (gt,) = torch.autograd.grad(s.float().square().sum(), t)
        outs.setdefault(dev, []).append((s.detach().cpu(), gt.cpu()))
    (s1, g1), (s2, g2) = outs["cuda"]
    assert torch.equal(s1, s2) and torch.equal(g1, g2)
    assert not s1[5].any()
    if dtype == torch.float32:
        s_c, g_c = outs["cpu"][0]
        assert float((s1 - s_c).abs().max()) <= 1e-5 * float(s_c.abs().max())
        assert float((g1 - g_c).abs().max()) <= 1e-5 * float(g_c.abs().max())


@pytest.mark.cuda
def test_card_dimenet_train_step_matches_cpu_and_repeats_its_bits(cuda):
    """One DimeNet train step (reduced config, float32, molecules with -1
    padding) on the card against the CPU from the same params: loss within
    1e-5 relative, every grad within 1e-3 of the CPU's largest, the grad
    norm within 1e-4 relative; and two card steps from one state give the
    same params, bit for bit."""
    import copy

    from repro_torch.common.tree import leaves, unflatten
    from repro_torch.configs import get_config, reduced_gnn_config
    from repro_torch.data.synthetic import random_molecule_batch
    from repro_torch.models import dimenet
    from repro_torch.train.optimizer import AdamWConfig, global_norm, init_state
    from repro_torch.train.train_step import _accumulate_grads, dimenet_loss_fn, make_train_step

    cfg = reduced_gnn_config(get_config("dimenet"))
    mols = random_molecule_batch(16, 30, 64, seed=1)
    t_in, t_out = np.full((16, 256), -1, np.int32), np.full((16, 256), -1, np.int32)
    for b in range(16):
        ti, to = dimenet.build_triplets(mols["edge_index"][b], 30)
        m = min(256, len(ti))
        t_in[b, :m], t_out[b, :m] = ti[:m], to[:m]
    batch = {"positions": mols["positions"], "edge_index": mols["edge_index"], "t_in": t_in,
             "t_out": t_out, "z": mols["z"], "y": mols["y"]}
    cpu_params = dimenet.init(cfg, seed=0, device="cpu")
    gpu_params = unflatten(cpu_params, [t.to(cuda) for t in leaves(cpu_params)])
    loss_g, grads_g, _ = _accumulate_grads(dimenet_loss_fn(cfg), gpu_params, batch, 1)
    loss_c, grads_c, _ = _accumulate_grads(dimenet_loss_fn(cfg), cpu_params, batch, 1)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for g, c in zip(grads_g, grads_c):
        assert float((g.cpu() - c).abs().max()) <= 1e-3 * float(c.abs().max())
    n_g, n_c = float(global_norm(grads_g)), float(global_norm(grads_c))
    assert abs(n_g - n_c) <= 1e-4 * n_c
    step = make_train_step(dimenet_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                             total_steps=20))
    runs = []
    for _ in range(2):
        p = copy.deepcopy(gpu_params)
        s = init_state(p)
        for _ in range(2):
            p, s, _ = step(p, s, batch)
        runs.append([t.detach().clone() for t in leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_recsys_train_step_repeats_its_bits_on_card(cuda):
    """AutoInt (reduced vocabs of 64 rows a field, so every row repeats in
    a batch of 4,096): two train steps from one state on the card give the
    same params, bit for bit (the lookups' backward sums in a fixed order)."""
    import copy
    import dataclasses

    from repro_torch.common.tree import leaves
    from repro_torch.configs import get_config, reduced_recsys_config
    from repro_torch.data.synthetic import criteo_like_batch
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step, recsys_loss_fn

    cfg = dataclasses.replace(reduced_recsys_config(get_config("autoint")),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    data = criteo_like_batch(4096, n_sparse=cfg.n_sparse, vocab_sizes=list(cfg.vocab_sizes),
                             seed=0)
    batch = {"sparse_ids": data["sparse_ids"], "label": data["label"]}
    params = recsys.init(cfg, seed=0, device=cuda)
    step = make_train_step(recsys_loss_fn("autoint", cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                                      total_steps=20))
    runs = []
    for _ in range(2):
        p = copy.deepcopy(params)
        s = init_state(p)
        for _ in range(2):
            p, s, _ = step(p, s, batch)
        runs.append([t.detach().clone() for t in leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))

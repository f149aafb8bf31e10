"""The port's gradient collectives on the CPU: ``hierarchical_grad_sync`` in a
2 x 2 (pod, data) world of spawned gloo ranks equals the global mean of
every rank's grads (leaf sizes that do and do not divide the local group),
``compressed_psum`` in a world of 4 equals its definition (int32 sum of
each rank's codes times the largest scale), and the compression functions
against the reference's on the reference's own cases
(``tests/test_substrates.py``).

Spawned ranks import this module to find their function, so JAX and the
reference are imported inside the tests that run in this process only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import (
    compressed_psum,
    dequantize_int8,
    error_feedback_compress,
    hierarchical_grad_sync,
    quantize_int8,
    topk_sparsify,
)
from repro_torch.launch.mesh import run_world

SHAPES = {"w": (5, 3), "b": (7,), "s": ()}


def _rank_grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal(SHAPES["w"]).astype(np.float32),
            "blocks": [rng.standard_normal(SHAPES["b"]).astype(np.float32),
                       np.float32(rng.standard_normal())]}


def _sync_rank(mesh):
    import torch.distributed as dist

    g = _rank_grads(dist.get_rank())
    grads = {"w": torch.from_numpy(g["w"]),
             "blocks": [torch.from_numpy(g["blocks"][0]), torch.tensor(g["blocks"][1])]}
    out = hierarchical_grad_sync(grads, pod_group=mesh.get_group("pod"),
                                 local_group=mesh.get_group("data"))
    return {"w": out["w"].numpy(), "b": out["blocks"][0].numpy(), "s": out["blocks"][1].numpy(),
            "rank": dist.get_rank()}


def _psum_rank(mesh, x_all):
    import torch.distributed as dist

    r = dist.get_rank()
    return compressed_psum(torch.from_numpy(x_all[r]), mesh.get_group("data")).numpy()


def test_hierarchical_grad_sync_is_the_global_mean():
    out = run_world(_sync_rank, (2, 2), ("pod", "data"), device="cpu", timeout=300)
    g = [_rank_grads(r) for r in range(4)]
    want = {"w": np.mean([x["w"] for x in g], 0), "b": np.mean([x["blocks"][0] for x in g], 0),
            "s": np.mean([x["blocks"][1] for x in g], 0)}
    assert [o["rank"] for o in out] == [0, 1, 2, 3]
    for o in out:
        for key, shape in SHAPES.items():
            assert o[key].shape == shape
            np.testing.assert_allclose(o[key], want[key], rtol=1e-6, atol=1e-6)


def test_compressed_psum_in_a_world_of_four():
    rng = np.random.default_rng(3)
    x_all = (rng.standard_normal((4, 33)) * np.array([1, 2, 3, 4])[:, None]).astype(np.float32)
    out = run_world(_psum_rank, (4, 1), ("data", "model"), args=(x_all,), device="cpu",
                    timeout=300)
    qs = [quantize_int8(torch.from_numpy(x)) for x in x_all]
    want = (sum(q.to(torch.int32) for q, _ in qs).float() * max(float(s) for _, s in qs)).numpy()
    for o in out:
        np.testing.assert_allclose(o, want, rtol=1e-6)


def test_quantize_matches_reference():
    import jax.numpy as jnp

    from repro.distributed import compression as jc

    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32) * 3
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)
    err = np.abs(dequantize_int8(q, scale).numpy() - x).max()
    assert err <= float(scale) * 0.5 + 1e-6


def test_error_feedback_matches_reference_and_reduces_bias():
    import jax.numpy as jnp

    from repro.distributed import compression as jc

    rng = np.random.default_rng(1)
    g = rng.standard_normal(512).astype(np.float32)
    res, jres = {"g": torch.zeros(512)}, {"g": jnp.zeros(512)}
    total_naive, total_ef = np.zeros(512), np.zeros(512)
    for _ in range(50):
        q, s = quantize_int8(torch.from_numpy(g))
        total_naive += dequantize_int8(q, s).numpy()
        qs, res = error_feedback_compress({"g": torch.from_numpy(g)}, res)
        jqs, jres = jc.error_feedback_compress({"g": jnp.asarray(g)}, jres)
        qe, se = qs["g"]
        assert np.array_equal(qe.numpy(), np.asarray(jqs["g"][0]))
        np.testing.assert_allclose(res["g"].numpy(), np.asarray(jres["g"]), atol=1e-6)
        total_ef += dequantize_int8(qe, se).numpy()
    want = g * 50
    assert np.abs(total_ef - want).max() <= np.abs(total_naive - want).max() + 1e-5


def test_topk_sparsify_matches_reference():
    import jax.numpy as jnp

    from repro.distributed import compression as jc

    x = [1.0, -5.0, 0.1, 3.0]
    y, mask = topk_sparsify(torch.tensor(x), 0.5)
    assert int(mask.sum()) == 2 and float(y[1]) == -5.0 and float(y[3]) == 3.0
    z = np.random.default_rng(2).standard_normal((6, 7)).astype(np.float32)
    for frac in (0.1, 0.5, 1.0):
        y, mask = topk_sparsify(torch.from_numpy(z), frac)
        jy, jmask = jc.topk_sparsify(jnp.asarray(z), frac)
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert np.array_equal(y.numpy(), np.asarray(jy))

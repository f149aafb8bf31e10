"""The port's GNN family on the CPU vs the JAX reference: the graph data
(``power_law_graph``, ``random_molecule_batch``, the sampler's
``CSRGraph`` / ``sample_subgraph``, ``build_triplets``), DimeNet's bases,
the fixed-order gather and segment sum against ``jax.ops.segment_sum`` and
the scatter-add of a gather's backward, ``apply`` in the three batch
layouts of ``dimenet_loss_fn`` (one graph; lanes with graph targets; lanes
with node targets), the loss and grads against ``jax.value_and_grad``, two
train steps against the reference's jitted step, ``convert`` and the
registry.

Reduced config (2 blocks, d_hidden 32), params drawn by the reference and
carried across, inputs from numpy with a seed.  Data arrays are equal.
Forward rtol = atol = 1e-5 in float32 and under the cells' bf16-param
config (the reference promotes every product after the embedding to
float32, and so does the port); bases 1e-6; loss 1e-5 relative; grads
rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry; params
after two steps within 1e-5 (lr 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import families as jfam
from repro.configs.registry import get_arch
from repro.data import sampler as jsampler
from repro.data import synthetic as jsyn
from repro.models import dimenet as jdn
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.common.tree import flatten, leaves
from repro_torch.configs import (
    GNN_ARCH_IDS,
    GNN_CELLS,
    get_config,
    gnn_cell_config,
    reduced_gnn_config,
)
from repro_torch.convert import (
    dimenet_params_from_jax,
    dimenet_params_to_numpy,
    recsys_adamw_state_from_jax,
)
from repro_torch.data import sampler as psampler
from repro_torch.data import synthetic as psyn
from repro_torch.models import dimenet as pdn
from repro_torch.models import segment
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    jcfg = dataclasses.replace(get_arch("dimenet").model_config(reduced=True), **kw)
    pcfg = dataclasses.replace(reduced_gnn_config(get_config("dimenet")), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _pad(a, n):
    out = np.full(n, -1, np.int32)
    out[:min(n, len(a))] = a[:n]
    return out


def _graph(seed, *, d_feat=8, n=40, E=150):
    """One graph (the full_graph_sm layout): a power-law graph with some
    parallel edges added and -1 edges inside and after the real ones,
    capped triplets padded with -1, a node mask and node targets; species
    z instead of features when ``d_feat`` is 0."""
    g = psyn.power_law_graph(n, E, d_feat=d_feat, seed=seed)
    ei = g["edge_index"]
    ei = np.concatenate([ei, ei[:, :7], np.full((2, 5), -1, np.int32)], axis=1)
    ei[:, 9] = -1
    ti, to = pdn.build_triplets(ei, n, max_in_per_edge=3)
    T = len(ti) + 9
    rng = np.random.default_rng(seed + 100)
    b = {"positions": g["positions"], "edge_index": ei, "t_in": _pad(ti, T),
         "t_out": _pad(to, T), "node_mask": rng.random(n) > 0.2,
         "y": rng.standard_normal(n).astype(np.float32)}
    if d_feat:
        b["features"] = g["features"]
    else:
        b["z"] = rng.integers(1, 10, n).astype(np.int32)
    return b


def _molecules(seed, B=3, n=12, E=24, t_max=56):
    """Lanes with graph targets (the molecule layout): the first t_max
    triplets of each molecule, -1 padded, as ``GNNArch.smoke`` cuts them."""
    mols = psyn.random_molecule_batch(B, n, E, seed=seed)
    t_in, t_out = np.full((B, t_max), -1, np.int32), np.full((B, t_max), -1, np.int32)
    for b in range(B):
        ti, to = pdn.build_triplets(mols["edge_index"][b], n)
        t_in[b], t_out[b] = _pad(ti, t_max), _pad(to, t_max)
    return {"positions": mols["positions"], "edge_index": mols["edge_index"], "t_in": t_in,
            "t_out": t_out, "z": mols["z"], "y": mols["y"]}


def _lanes(seed, B=2, n_max=40, e_max=80, t_max=150, d_feat=8):
    """Lanes with node targets: sampled subgraphs of one power-law graph
    (minibatch_lg's sampler), subsampled triplets, node features and mask."""
    n = 300
    g = psyn.power_law_graph(n, 2400, d_feat=d_feat, seed=seed)
    csr = psampler.CSRGraph.from_edge_index(g["edge_index"], n)
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("positions", "edge_index", "t_in", "t_out", "features", "node_mask")}
    for _ in range(B):
        sub = psampler.sample_subgraph(csr, rng.choice(n, 5, replace=False), (4, 3), rng=rng,
                                       n_max=n_max, e_max=e_max)
        nodes = sub["nodes"]
        ti, to = pdn.build_triplets(sub["edge_index"], n_max, max_triplets=t_max - 10, seed=1)
        out["positions"].append(np.where(nodes[:, None] >= 0, g["positions"][nodes.clip(0)], 0))
        out["features"].append(np.where(nodes[:, None] >= 0, g["features"][nodes.clip(0)], 0))
        out["edge_index"].append(sub["edge_index"])
        out["t_in"].append(_pad(ti, t_max))
        out["t_out"].append(_pad(to, t_max))
        out["node_mask"].append(sub["node_mask"])
    b = {k: np.stack(v) for k, v in out.items()}
    b["y"] = rng.standard_normal((B, n_max)).astype(np.float32)
    return b


#: the three batch layouts of ``dimenet_loss_fn`` (and one graph with species)
LAYOUTS = {"graph": lambda s: _graph(s), "graph-z": lambda s: _graph(s, d_feat=0),
           "molecules": _molecules, "lanes": _lanes}


def _case(layout, seed, **kw):
    b = LAYOUTS[layout](seed)
    jcfg, pcfg = _cfgs(d_node_feat=b["features"].shape[-1] if "features" in b else 0, **kw)
    return jcfg, pcfg, b


def _japply(jcfg, jparams, b):
    """The reference's apply on one graph, or vmapped over lanes as its
    loss does; jitted."""
    keys = [k for k in ("z", "features", "node_mask") if k in b]

    def one(p, pos, ei, ti, to, *opts):
        kw = dict(zip(keys, opts))
        return jdn.apply(p, jcfg, positions=pos, edge_index=ei, t_in=ti, t_out=to,
                         z=kw.get("z"), node_feat=kw.get("features"),
                         node_mask=kw.get("node_mask"))

    if b["positions"].ndim == 3:
        one = jax.vmap(one, in_axes=(None,) + (0,) * (4 + len(keys)))
    args = [jnp.asarray(b[k]) for k in ("positions", "edge_index", "t_in", "t_out", *keys)]
    return jax.jit(one)(jparams, *args)


def _papply(pcfg, pparams, b):
    kw = dict(positions=b["positions"], edge_index=b["edge_index"], t_in=b["t_in"],
              t_out=b["t_out"], z=b.get("z"), node_feat=b.get("features"),
              node_mask=b.get("node_mask"))
    kw = {k: None if v is None else torch.as_tensor(v) for k, v in kw.items()}
    fn = pdn.apply if b["positions"].ndim == 2 else pdn.apply_batched
    with torch.no_grad():
        return fn(pparams, pcfg, **kw)


# --------------------------------------------------------------------------
# data


@pytest.mark.parametrize("kw", [{}, {"d_feat": 5}, {"with_positions": False, "seed": 3}])
def test_power_law_graph_matches_reference(kw):
    got = psyn.power_law_graph(200, 1500, **kw)
    want = jsyn.power_law_graph(200, 1500, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_molecule_batch_matches_reference():
    got = psyn.random_molecule_batch(5, 12, 30, seed=4)
    want = jsyn.random_molecule_batch(5, 12, 30, seed=4)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_csr_graph_and_sampler_match_reference():
    """CSRGraph of a graph with parallel edges and -1 edges; subgraphs from
    the same generator state, with and without the n_max / e_max trims; the
    generators' states after sampling equal."""
    g = psyn.power_law_graph(500, 4000, seed=2)["edge_index"]
    g = np.concatenate([g, g[:, :50], np.full((2, 3), -1, np.int32)], axis=1)
    got, want = psampler.CSRGraph.from_edge_index(g, 500), jsampler.CSRGraph.from_edge_index(g, 500)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.n_nodes == want.n_nodes == 500
    seeds = np.arange(0, 500, 25)
    for n_max, e_max in ((512, 2048), (60, 100)):
        rg, rw = np.random.default_rng(9), np.random.default_rng(9)
        sg = psampler.sample_subgraph(got, seeds, (6, 4), rng=rg, n_max=n_max, e_max=e_max)
        sw = jsampler.sample_subgraph(want, seeds, (6, 4), rng=rw, n_max=n_max, e_max=e_max)
        for k in sw:
            assert sg[k].dtype == sw[k].dtype
            np.testing.assert_array_equal(sg[k], sw[k], err_msg=f"{k} n_max={n_max}")
        assert rg.integers(1 << 30) == rw.integers(1 << 30)
    nb = psampler.sample_neighbors(got, np.array([0, 499, 7]), 5, np.random.default_rng(1))
    np.testing.assert_array_equal(
        nb, jsampler.sample_neighbors(want, np.array([0, 499, 7]), 5, np.random.default_rng(1)))


@pytest.mark.parametrize("kw", [{}, {"max_in_per_edge": 2}, {"max_triplets": 300, "seed": 5},
                                {"max_in_per_edge": 4, "max_triplets": 200}])
def test_build_triplets_matches_reference(kw):
    """A power-law graph with parallel edges and -1 edges; uncapped, capped,
    subsampled."""
    ei = psyn.power_law_graph(60, 400, seed=1)["edge_index"]
    ei = np.concatenate([ei, ei[:, :30], np.full((2, 4), -1, np.int32)], axis=1)
    ei[:, 17] = -1
    got = pdn.build_triplets(ei, 60, **kw)
    want = jdn.build_triplets(ei, 60, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


# --------------------------------------------------------------------------
# bases and the fixed-order operations


def test_bases_match_reference():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0.0, 6.0, 200), [0.0, 1e-10, 4.999, 5.0, 5.5]])
    d = d.astype(np.float32)
    cos_t = rng.uniform(-1, 1, 200).astype(np.float32)
    angle = np.arccos(cos_t).astype(np.float32)
    td = torch.from_numpy(d)
    close = lambda got, want: np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                                         rtol=1e-6, atol=1e-6)
    close(pdn.envelope(td, 5.0, 6), jdn.envelope(jnp.asarray(d), 5.0, 6))
    close(pdn.radial_basis(td, 6, 5.0, 6), jdn.radial_basis(jnp.asarray(d), 6, 5.0, 6))
    for l_max in (1, 2, 7):
        close(pdn._legendre(torch.from_numpy(cos_t), l_max),
              jdn._legendre(jnp.asarray(cos_t), l_max))
    close(pdn.spherical_basis(td[:200], torch.from_numpy(angle), 7, 6, 5.0, 6),
          jdn.spherical_basis(jnp.asarray(d[:200]), jnp.asarray(angle), 7, 6, 5.0, 6))


def _repeated_indices(rng, M=300, n=20):
    """Indices with many repeats, an empty destination and a padded tail
    clipped to 0 (as the model clips -1)."""
    idx = rng.integers(0, n, M)
    idx[idx == 7] = 3  # row 7 empty
    idx[-30:] = 0
    return idx


def test_fixed_order_ops_match_jax_scatter_adds():
    """``segment_sum`` forward (and its gather backward) against
    ``jax.ops.segment_sum`` (and its vjp); ``gather``'s backward against the
    scatter-add of a jnp gather's vjp; within float32 rounding."""
    rng = np.random.default_rng(3)
    n, M, h = 20, 300, 16
    idx = _repeated_indices(rng, M, n)
    x = rng.standard_normal((M, h)).astype(np.float32) * 10
    table = rng.standard_normal((n, h)).astype(np.float32)
    g_rows = rng.standard_normal((M, h)).astype(np.float32) * 10
    g_seg = rng.standard_normal((n, h)).astype(np.float32)
    close = lambda got, want: np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                                         rtol=1e-6, atol=1e-5)

    want, vjp = jax.vjp(lambda a: jax.ops.segment_sum(a, jnp.asarray(idx), num_segments=n),
                        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = segment.segment_sum(tx, segment.FixedIndex(torch.from_numpy(idx), n))
    close(got, want)
    assert not got[7].any()
    close(torch.autograd.grad(got, tx, torch.from_numpy(g_seg))[0], vjp(jnp.asarray(g_seg))[0])

    want, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    got = segment.gather(tt, segment.FixedIndex(torch.from_numpy(idx), n))
    close(got, want)
    close(torch.autograd.grad(got, tt, torch.from_numpy(g_rows))[0], vjp(jnp.asarray(g_rows))[0])


def test_fixed_order_ops_are_bit_equal_across_runs():
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(_repeated_indices(rng))
    x = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    outs = []
    for _ in range(2):
        t = x[:20].clone().requires_grad_()
        y = segment.gather(t, segment.FixedIndex(idx, 20))
        s = segment.segment_sum(y * 3.0, segment.FixedIndex(idx, 20))
        (gt,) = torch.autograd.grad((s * s).sum() + (y * g).sum(), t)
        outs.append((s.detach(), gt))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# --------------------------------------------------------------------------
# apply


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_apply_matches_reference(layout, param_dtype):
    """node_pred and graph_pred (each lane's) within rtol = atol = 1e-5 of
    the reference's, float32 params and the cells' bf16 params (both
    packages promote the bf16 weights to float32 where they meet float32
    operands, so the same limit holds); padded entries contribute zeros."""
    jcfg, pcfg, b = _case(layout, seed=1, param_dtype=param_dtype)
    jparams = jdn.init(jax.random.PRNGKey(2), jcfg)
    pparams = dimenet_params_from_jax(pcfg, _np(jparams), device="cpu")
    assert all(t.dtype == getattr(torch, param_dtype) for t in leaves(pparams))
    want_node, want_graph = _japply(jcfg, jparams, b)
    got_node, got_graph = _papply(pcfg, pparams, b)
    assert got_node.dtype == torch.float32
    assert got_node.shape == want_node.shape and got_graph.shape == want_graph.shape
    np.testing.assert_allclose(got_node.numpy(), np.asarray(want_node), **TOL)
    np.testing.assert_allclose(got_graph.numpy(), np.asarray(want_graph), **TOL)
    if "node_mask" in b:
        assert not got_node.numpy()[~b["node_mask"]].any()


# --------------------------------------------------------------------------
# training


def _grad_close(got, want, label):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=label)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_grads_match_reference(layout):
    jcfg, pcfg, b = _case(layout, seed=5)
    jparams = jdn.init(jax.random.PRNGKey(6), jcfg)
    pparams = dimenet_params_from_jax(pcfg, _np(jparams), device="cpu")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jts.dimenet_loss_fn(jcfg), has_aux=True))(
        jparams, jb)
    loss, grads, aux = pts._accumulate_grads(pts.dimenet_loss_fn(pcfg), pparams, b, 1)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    names = [n for n, _ in flatten(pparams)]
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        assert g.shape == jg[name].shape
        _grad_close(g, jg[name], f"{layout} {name}")
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_train_steps_match_reference():
    """Two steps of ``make_train_step(dimenet_loss_fn(cfg), AdamW)`` from the
    same params and state, one batch of each of the lanes layouts: loss,
    grad norm and lr within 1e-5 relative, params within 1e-5."""
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    for layout in ("molecules", "lanes"):
        jcfg, pcfg, b = _case(layout, seed=8)
        jparams = jdn.init(jax.random.PRNGKey(9), jcfg)
        jstate = jopt.init_state(jparams)
        pparams = dimenet_params_from_jax(pcfg, _np(jparams), device="cpu")
        pstate = recsys_adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        jstep = jax.jit(jts.make_train_step(jts.dimenet_loss_fn(jcfg), opt_cfg))
        pstep = pts.make_train_step(pts.dimenet_loss_fn(pcfg),
                                    popt.AdamWConfig(**dataclasses.asdict(opt_cfg)))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        for step in range(2):
            jparams, jstate, jm = jstep(jparams, jstate, jb)
            pparams, pstate, pm = pstep(pparams, pstate, b)
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5,
                                           err_msg=f"{layout} step {step} {key}")
        want = dict(flatten(_np(jparams)))
        for name, t in flatten(pparams):
            np.testing.assert_allclose(t.detach().numpy(), want[name], rtol=0, atol=1e-5,
                                       err_msg=f"{layout} {name}")


# --------------------------------------------------------------------------
# convert and registry


def test_convert_round_trip_and_num_params():
    jcfg, pcfg = _cfgs(param_dtype="bfloat16")
    jparams = jdn.init(jax.random.PRNGKey(0), jcfg)
    pparams = dimenet_params_from_jax(pcfg, _np(jparams), device="cpu")
    back = dimenet_params_to_numpy(pparams)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jparams))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(got, want)
    own = pdn.init(pcfg, seed=0, device="cpu")
    assert [(n, tuple(t.shape), t.dtype) for n, t in flatten(own)] == \
        [(n, tuple(t.shape), t.dtype) for n, t in flatten(pparams)]
    for cfg_kw in ({}, {"d_node_feat": 1433}):
        for full in (False, True):
            jc = dataclasses.replace(get_arch("dimenet").model_config(reduced=not full), **cfg_kw)
            pc = dataclasses.replace(get_config("dimenet") if full else pcfg, **cfg_kw)
            assert pc.num_params() == jc.num_params()


def test_registry_matches_reference():
    arch = get_arch("dimenet")
    assert GNN_ARCH_IDS == ("dimenet",)
    assert dataclasses.asdict(get_config("dimenet")) == dataclasses.asdict(arch.model_config())
    assert dataclasses.asdict(reduced_gnn_config(get_config("dimenet"))) == \
        dataclasses.asdict(arch.model_config(reduced=True))
    assert set(GNN_CELLS) == set(jfam.GNN_CELLS)
    for name, cell in jfam.GNN_CELLS.items():
        assert GNN_CELLS[name] == {"kind": cell.kind, **dict(cell.extra),
                                   **({"global_batch": cell.global_batch}
                                      if name == "molecule" else {})}
        assert dataclasses.asdict(gnn_cell_config(get_config("dimenet"), name)) == \
            dataclasses.asdict(arch._cfg_for_cell(cell))


def test_full_width_molecule_step_matches_reference():
    """One train step at the published width under the molecule cell's
    config (bf16 params), 16 molecules of the cell's shape: the loss within
    1e-5 relative of the reference's, past 1e25 in both (the
    radial basis divides by d twice, and six residual blocks compound it);
    the float32 grad norm overflows to inf in both, so the clipped update
    is zero and the params move by weight decay alone, equal in both."""
    jcfg = get_arch("dimenet")._cfg_for_cell(jfam.GNN_CELLS["molecule"])
    pcfg = gnn_cell_config(get_config("dimenet"), "molecule")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    b = _molecules(0, B=16, n=30, E=64, t_max=256)
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jparams = jdn.init(jax.random.PRNGKey(0), jcfg)
    jstate = jopt.init_state(jparams)
    pparams = dimenet_params_from_jax(pcfg, _np(jparams), device="cpu")
    pstate = recsys_adamw_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    jparams, jstate, jm = jax.jit(jts.make_train_step(jts.dimenet_loss_fn(jcfg), opt_cfg))(
        jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
    pparams, pstate, pm = pts.make_train_step(
        pts.dimenet_loss_fn(pcfg), popt.AdamWConfig(**dataclasses.asdict(opt_cfg)))(
        pparams, pstate, b)
    assert float(jm["loss"]) > 1e25
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert np.isinf(float(jm["grad_norm"])) and np.isinf(float(pm["grad_norm"]))
    want = dict(flatten(_np(jparams)))
    for name, t in flatten(pparams):
        np.testing.assert_array_equal(t.detach().float().numpy(), want[name], err_msg=name)

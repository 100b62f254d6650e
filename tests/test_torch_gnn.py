"""The port's GNN (GraphSAGE) against the reference, on the CPU.

The graph data (``repro_torch.data.graph``) is held bitwise against
``repro.data.graph`` for one seed.  The three forwards run in ``repro``
(JAX on the CPU) and in ``repro_torch`` (``device="cpu"``, where K4 and
K4ᵀ take their plain versions) on the same weights
(``gnn_params_from_jax``) and the same inputs; they add the neighbour
messages in the same order (stable destination order) but the products
in different BLAS orders, so outputs agree within rtol 1e-5 / atol
1e-6, and non-finite entries at the same places.  The ``GNNArch`` cells
run three reduced steps of each shape against the reference's jitted
cell (loss and grad norm within rtol 1e-5; the parameters after step 1
within 1e-6 where the first gradient is clear of zero, as
``tests/test_torch_lm_train.py`` holds them), and the port's own runs
are bitwise run to run.  Node search over the port's
embeddings agrees with the reference's driver where neighbouring scores
are more than 1e-5 apart, and every port score x heap pair gives the
same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro.data import graph as jgraph
from repro.models import encoder as jencoder
from repro.models import gnn as jgnn
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro_torch.configs import get_arch
from repro_torch.configs import gnn_arch
from repro_torch.configs.base import init_train_state
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.data import graph
from repro_torch.kernels import ops
from repro_torch.models import gnn
from repro_torch.models.convert import gnn_params_from_jax
from repro_torch.models.encoder import ENCODER_REGISTRY, GNNEncoder

torch.set_num_threads(1)

RTOL, ATOL, SEP = 1e-5, 1e-6, 1e-5
PARAM_ATOL, STEPS = 1e-6, 3
# AdamW as the cells run it (make_train_cell's rate, the default decay),
# and the share of a leaf's largest gradient below which an element's
# first update is set by rounding (tests/test_torch_lm_train.py's rule)
LR, WD, SMALL_GRAD = 1e-3, 0.01, 1e-4
AGGREGATORS = ("mean", "max")
SHAPES = tuple(gnn_arch.GNN_SHAPES)


def _cfgs(aggregator="mean", d_feat=6, d_hidden=8):
    jcfg = jgnn.SAGEConfig(d_feat=d_feat, d_hidden=d_hidden,
                           aggregator=aggregator)
    cfg = gnn.SAGEConfig(d_feat=d_feat, d_hidden=d_hidden,
                         aggregator=aggregator)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = jgnn.init_params(jcfg, jax.random.key(seed))
    return jp, gnn_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _graph(rng, n=12, e=40):
    """Edges with a duplicate, a self-loop and isolated nodes (the last
    three have no in-edges)."""
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 3, e).astype(np.int32)
    src[1], dst[1] = src[0], dst[0]                 # a duplicate edge
    src[2] = dst[2]                                 # a self-loop
    return src, dst


# -- the graph data, bitwise --------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_csr_from_edges_matches_reference(seed):
    rng = np.random.default_rng(seed)
    src, dst = _graph(rng)
    want = jgraph.CSRGraph.from_edges(src, dst, 12)
    got = graph.CSRGraph.from_edges(src, dst, 12)
    for name in ("indptr", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    nodes = np.arange(12)
    np.testing.assert_array_equal(got.degree(nodes), want.degree(nodes))
    for v in nodes:
        np.testing.assert_array_equal(got.neighbors(v), want.neighbors(v))


@pytest.mark.parametrize("n,deg,seed", ((200, 8, 1), (50, 4, 2),
                                        (1000, 3, 7)))
def test_make_random_graph_matches_reference(n, deg, seed):
    for a, b in zip(graph.make_random_graph(n, deg, seed),
                    jgraph.make_random_graph(n, deg, seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanouts", ((5, 3), (4,), (1, 1, 2)))
def test_sampler_matches_reference(fanouts):
    """``sample`` and ``positive_pairs`` draw the reference's ids, isolated
    nodes looping to themselves, over several calls of one sampler."""
    src, dst, _ = jgraph.make_random_graph(200, 3, seed=1)
    keep = dst < 180                              # nodes 180.. isolated
    g = graph.CSRGraph.from_edges(src[keep], dst[keep], 200)
    jg = jgraph.CSRGraph.from_edges(src[keep], dst[keep], 200)
    got, want = (graph.NeighborSampler(g, fanouts, seed=3),
                 jgraph.NeighborSampler(jg, fanouts, seed=3))
    for batch in (np.arange(10), np.arange(175, 200), np.asarray([199])):
        for a, b in zip(got.sample(batch), want.sample(batch)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.positive_pairs(batch),
                                      want.positive_pairs(batch))
    lone = got.sample(np.asarray([190, 195]))
    assert all((lv == np.asarray([190, 195]).reshape(
        (2,) + (1,) * (lv.ndim - 1))).all() for lv in lone)


def test_sample_block_matches_reference_on_host_and_tensor():
    src, dst, _ = jgraph.make_random_graph(50, 4, seed=2)
    x = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    want = jgraph.NeighborSampler(jgraph.CSRGraph.from_edges(src, dst, 50),
                                  (3, 2), seed=1).sample_block(
        x, np.arange(4))
    g = graph.CSRGraph.from_edges(src, dst, 50)
    host = graph.NeighborSampler(g, (3, 2), seed=1).sample_block(
        x, np.arange(4))
    dev = graph.NeighborSampler(g, (3, 2), seed=1).sample_block(
        torch.from_numpy(x), np.arange(4))
    for a, t, b in zip(host, dev, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.numpy(), b)


# -- the neighbour table ------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1))
def test_neighbor_table_slots_in_stable_destination_order(seed):
    rng = np.random.default_rng(seed)
    src, dst = _graph(rng)
    t = gnn.neighbor_table(*_t(src, dst), 12)
    csr = jgraph.CSRGraph.from_edges(src, dst, 12)
    deg = csr.degree(np.arange(12))
    assert t.idx.shape == (12, deg.max()) and t.idx.dtype == torch.int32
    assert t.n_edges == 40 and t.slots == 12 * deg.max() and t.weights is None
    for v in range(12):
        row = t.idx[v].numpy()
        np.testing.assert_array_equal(row[:deg[v]], csr.neighbors(v))
        assert (row[deg[v]:] == 12).all()          # padding: the zero row
    np.testing.assert_array_equal(t.counts.numpy(), deg.astype(np.float32))
    assert t.keys.ids_for(t.idx) is t.idx


def test_neighbor_table_weights_and_refusals():
    src, dst = _t(np.asarray([0, 1, 2, 0], np.int32),
                  np.asarray([1, 2, 0, 2], np.int32))
    w = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    t = gnn.neighbor_table(src, dst, 4, w)
    np.testing.assert_array_equal(t.idx.numpy(),
                                  [[2, 4], [0, 4], [1, 0], [4, 4]])
    np.testing.assert_array_equal(t.weights.numpy(),
                                  [[1, 0], [1, 0], [0, 1], [0, 0]])
    np.testing.assert_array_equal(t.counts.numpy(), [1, 1, 1, 0])
    empty = gnn.neighbor_table(src[:0], dst[:0], 3)
    assert empty.idx.shape == (3, 1) and (empty.idx == 3).all()
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        gnn.neighbor_table(src, dst, 2)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        gnn.neighbor_table(src - 1, dst, 4)
    with pytest.raises(ValueError, match="rows for a table"):
        gnn.neighbor_sum(torch.zeros(5, 2), t)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_neighbor_sum_and_its_gradient_match_segment_sum(seed):
    """K4's plain version over the table is the reference's
    ``segment_sum(take(h, src), dst)``, bitwise (the same additions in the
    same order); its K4ᵀ gradient matches ``jax.vjp`` within RTOL."""
    rng = np.random.default_rng(seed)
    src, dst = _graph(rng)
    h = rng.normal(size=(12, 5)).astype(np.float32)
    g = rng.normal(size=(12, 5)).astype(np.float32)

    def ref(hh):
        return jax.ops.segment_sum(jnp.take(hh, src, axis=0), dst,
                                   num_segments=12)

    want, vjp = jax.vjp(ref, jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    got = gnn.neighbor_sum(ht, gnn.neighbor_table(*_t(src, dst), 12))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=RTOL, atol=ATOL)


def test_gather_rows_backward_adds_repeated_rows():
    z = torch.randn(6, 4, requires_grad=True)
    ids = torch.tensor([5, 0, 5, 5, 2])
    out = gnn.gather_rows(z, ids)
    torch.testing.assert_close(out, z.detach()[ids], rtol=0, atol=0)
    out.sum().backward()
    np.testing.assert_array_equal(z.grad[:, 0].numpy(), [1, 0, 1, 0, 0, 3])


# -- the forwards -------------------------------------------------------------


@pytest.mark.parametrize("aggregator", AGGREGATORS)
@pytest.mark.parametrize("seed", (0, 1))
def test_forward_full_matches_reference(aggregator, seed):
    """Isolated nodes, a self-loop and a duplicate edge; the max's empty
    segments are -inf in both packages (so NaN rows where they meet the
    weights)."""
    jcfg, cfg = _cfgs(aggregator)
    jp, p = _params(jcfg, cfg, seed)
    rng = np.random.default_rng(seed + 10)
    src, dst = _graph(rng)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    want = jgnn.forward_full(jcfg, jp, x, src, dst)
    got = gnn.forward_full(cfg, p, *_t(x, src, dst))
    _close(got, want)


@pytest.mark.parametrize("row", (0, 4, 11))
def test_non_finite_feature_row_stays_where_the_reference_puts_it(row):
    """An inf feature row reaches only the nodes the reference's mean
    reaches: padding reads the appended zero row, never row 0."""
    jcfg, cfg = _cfgs("mean")
    jp, p = _params(jcfg, cfg)
    rng = np.random.default_rng(5)
    src, dst = _graph(rng)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    x[row, 2] = np.inf
    want = np.asarray(jgnn.forward_full(jcfg, jp, x, src, dst))
    got = gnn.forward_full(cfg, p, *_t(x, src, dst))
    _close(got, want)
    assert np.isfinite(want).all(1).any()           # some rows stay finite


def test_forward_full_is_permutation_equivariant():
    """The port of ``tests/test_models.py``'s equivariance test."""
    rng = np.random.default_rng(0)
    jcfg, cfg = _cfgs("mean")
    _, p = _params(jcfg, cfg)
    n, e = 10, 30
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    z = gnn.forward_full(cfg, p, x, src, dst)
    perm = torch.from_numpy(rng.permutation(n))
    inv = torch.argsort(perm)
    z_p = gnn.forward_full(cfg, p, x[perm], inv[src.long()], inv[dst.long()])
    torch.testing.assert_close(z_p, z[perm], rtol=0, atol=1e-5)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_forward_minibatch_matches_reference(aggregator):
    jcfg, cfg = _cfgs(aggregator)
    jp, p = _params(jcfg, cfg)
    rng = np.random.default_rng(3)
    f0, f1, f2 = (rng.normal(size=s).astype(np.float32)
                  for s in ((5, 6), (5, 3, 6), (5, 3, 2, 6)))
    want = jgnn.forward_minibatch(jcfg, jp, f0, f1, f2)
    got = gnn.forward_minibatch(cfg, p, *_t(f0, f1, f2))
    assert got.shape == (5, 8)
    _close(got, want)
    with pytest.raises(ValueError, match="2 layers"):
        gnn.forward_minibatch(dataclasses.replace(cfg, n_layers=3), p,
                              *_t(f0, f1, f2))


@pytest.mark.parametrize("aggregator", AGGREGATORS)
@pytest.mark.parametrize("seed", (0, 1))
def test_forward_batched_graphs_matches_reference(aggregator, seed):
    """Masked edges weigh 0 (their rows still read, as the reference's
    ``msgs * emask``) and masked nodes leave the pool."""
    jcfg, cfg = _cfgs(aggregator, d_feat=4)
    jp, p = _params(jcfg, cfg, seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    edges = rng.integers(0, 5, (3, 7, 2)).astype(np.int32)
    emask = np.ones((3, 7), np.int32)
    emask[1, 3:] = 0
    emask[2] = 0                                  # a graph with no edge
    nmask = np.ones((3, 5), np.int32)
    nmask[1, 4:] = 0
    want = jgnn.forward_batched_graphs(jcfg, jp, x, edges, emask, nmask)
    got = gnn.forward_batched_graphs(cfg, p, *_t(x, edges, emask, nmask))
    assert got.shape == (3, 8)
    _close(got, want)
    if aggregator == "mean":
        assert np.isfinite(got.numpy()).all()
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        gnn.batched_edges(torch.from_numpy(edges) + 1, 5)


def test_gradient_through_every_layer_matches_jax_grad():
    """The features' gradient (layer 0's K4ᵀ) and every weight's, of a
    full-graph forward, against ``jax.grad``."""
    jcfg, cfg = _cfgs("mean")
    jp, p = _params(jcfg, cfg)
    rng = np.random.default_rng(8)
    src, dst = _graph(rng)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    ct = rng.normal(size=(12, 8)).astype(np.float32)

    def f(params, xx):
        return (jgnn.forward_full(jcfg, params, xx, src, dst) * ct).sum()

    jgp, jgx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = (gnn.forward_full(cfg, leaves, xt, *_t(src, dst))
           * torch.from_numpy(ct)).sum()
    out.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_unknown_aggregator_raises():
    _, cfg = _cfgs("sum")
    p = gnn.init_params(dataclasses.replace(cfg, aggregator="mean"),
                        torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="aggregator"):
        gnn.forward_full(cfg, p, torch.zeros(3, 6), *_t(
            np.zeros(2, np.int32), np.ones(2, np.int32)))


# -- GNNArch ------------------------------------------------------------------


def test_shapes_and_reduced_match_reference():
    jarch = jax_get_arch("graphsage-reddit")
    arch = get_arch("graphsage-reddit")
    assert isinstance(arch, gnn_arch.GNNArch) and arch.family == "gnn"
    assert gnn_arch.GNN_SHAPES == jbase.GNN_SHAPES
    assert arch.shapes == jarch.shapes and arch.pad == jarch.pad == 512
    small, jsmall = arch.reduced(), jarch.reduced()
    assert small.shapes == jsmall.shapes and small.pad == jsmall.pad
    for a, j in ((arch, jarch), (small, jsmall)):
        for name in a.shape_names():
            c, jc = a.shape_cfg(name), j.shape_cfg(name)
            for f in dataclasses.fields(jc):
                want = getattr(jc, f.name)
                if f.name == "dtype":
                    want = {jnp.float32: torch.float32}[want]
                assert getattr(c, f.name) == want, (name, f.name)
            assert a.param_shapes(name) == {
                k: v.shape for k, v in jgnn.abstract_params(jc).items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_smoke_inputs_bitwise_with_reference(shape):
    jarch = jax_get_arch("graphsage-reddit").reduced()
    arch = get_arch("graphsage-reddit").reduced()
    want = jarch.smoke_inputs(shape, np.random.default_rng(4))
    got = arch.smoke_inputs(shape, np.random.default_rng(4), "cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == {np.dtype(np.int32): torch.int32,
                                np.dtype(np.float32): torch.float32}[
            np.asarray(want[k]).dtype]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    drawn = arch.smoke_inputs(shape, torch.Generator().manual_seed(0), "cpu")
    for k, v in drawn.items():
        assert v.shape == got[k].shape and v.dtype == got[k].dtype, k
        if k.endswith("mask"):
            assert (v == 1).all()
        elif v.dtype == torch.int32:
            n = arch.shapes[shape]["n_nodes"]
            assert 0 <= int(v.min()) and int(v.max()) < n


@pytest.fixture(scope="module", params=SHAPES)
def runs(request):
    """STEPS steps of each package's reduced cell on one batch (a full
    graph's carrying its neighbour table, as a caller keeps it): per step
    (loss, grad_norm), parameters after step 1, the port's final state
    and how many tables its steps built."""
    shape = request.param
    jarch = jax_get_arch("graphsage-reddit").reduced()
    arch = get_arch("graphsage-reddit").reduced()
    jcfg = jarch.shape_cfg(shape)
    jparams = jgnn.init_params(jcfg, jax.random.key(0))
    host = jax.tree.map(np.asarray, jparams)
    jbatch = jarch.smoke_inputs(shape, np.random.default_rng(1))
    batch = arch.smoke_inputs(shape, np.random.default_rng(1), "cpu")
    if arch.shapes[shape]["mode"] == "full":
        batch["table"] = gnn.neighbor_table(
            batch["edge_src"], batch["edge_dst"], batch["x"].shape[0])
    opt_init, _ = jmake_optimizer(JOptimizerConfig(name="adamw",
                                                   learning_rate=1e-3))
    jstate = {"step": jnp.int32(0), "params": jparams,
              "opt": opt_init(jparams)}
    jstep = jax.jit(jarch.build_cell(shape).fn)
    out = {"ref": [], "port": [], "shape": shape, "host": host,
           "arch": arch, "batch": batch}
    builds = []
    real_table = gnn.neighbor_table

    def counted_table(*a, **kw):
        builds.append(1)
        return real_table(*a, **kw)

    gnn.neighbor_table = counted_table
    try:
        cell = arch.build_cell(shape, device="cpu")
        state = init_train_state(cell, gnn_params_from_jax(
            host, arch.shape_cfg(shape), "cpu"))
        ops.reset_launch_counts()
        for i in range(STEPS):
            jstate, jm = jstep(jstate, jbatch)
            state, m = cell.fn(state, batch)
            out["ref"].append((float(jm["loss"]), float(jm["grad_norm"])))
            out["port"].append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                out["ref_params1"] = jax.tree.map(np.asarray,
                                                  jstate["params"])
                out["port_params1"] = {k: v.clone() for k, v in
                                       state["params"].items()}
                out["port_mu1"] = {k: v.numpy().copy() for k, v in
                                   state["opt"]["mu"].items()}
    finally:
        gnn.neighbor_table = real_table
    out["launches"] = ops.launch_counts()
    out["state"], out["builds"] = state, len(builds)
    return out


def test_cell_losses_and_grad_norms_match_reference(runs):
    got, want = np.array(runs["port"]), np.array(runs["ref"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1, 0] < got[0, 0]


def test_cell_params_after_first_step_match_reference(runs):
    """Within 1e-6 where the first gradient (AdamW's first moment) is at
    least SMALL_GRAD of its leaf's largest: AdamW's first update, lr * (g
    / (|g| + eps) + wd * p), amplifies the rounding of a gradient near 0;
    there the bound is the most one update moves an element."""
    got, want, mu = runs["port_params1"], runs["ref_params1"], runs["port_mu1"]
    assert got.keys() == want.keys()
    for name in got:
        g = np.abs(mu[name])
        clear = g >= SMALL_GRAD * g.max()
        np.testing.assert_allclose(got[name].numpy()[clear],
                                   want[name][clear], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        p0 = runs["host"][name]
        assert (np.abs(got[name].numpy() - p0)
                <= 2 * LR * (1 + WD * np.abs(p0)) + 1e-7).all(), name


def test_cell_builds_tables_only_where_the_batch_lacks_one(runs):
    """A full graph's steps use the table its batch carries and build
    none; the batched graphs, new every step, build each view's table
    every step; the minibatch has none.  No launch on the CPU."""
    mode = runs["arch"].shapes[runs["shape"]]["mode"]
    assert runs["builds"] == {"full": 0, "minibatch": 0,
                              "batched": 2 * STEPS}[mode]
    assert set(runs["launches"].values()) == {0}
    state = runs["state"]
    assert int(state["step"]) == STEPS and set(state["opt"]) == {"mu", "nu"}


def test_cell_is_bitwise_run_to_run(runs):
    """Two more runs from the same weights and batch give the same bits:
    losses, grad norms and parameters."""
    arch, shape = runs["arch"], runs["shape"]
    finals = []
    for _ in range(2):
        cell = arch.build_cell(shape, device="cpu")
        state = init_train_state(cell, gnn_params_from_jax(
            runs["host"], arch.shape_cfg(shape), "cpu"))
        metrics = [cell.fn(state, runs["batch"])[1] for _ in range(2)]
        finals.append((metrics, state["params"]))
    (m1, p1), (m2, p2) = finals
    for a, b in zip(m1, m2):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


@pytest.mark.parametrize("shape", ("full_graph_sm", "ogb_products"))
def test_full_cell_steps_alike_with_or_without_the_batch_table(shape):
    """A full graph's batch that carries its neighbour table steps to the
    same bits as one that does not, whose steps build the table."""
    arch = get_arch("graphsage-reddit").reduced()
    batch = arch.smoke_inputs(shape, np.random.default_rng(3), "cpu")
    params = gnn.init_params(arch.shape_cfg(shape),
                             torch.Generator().manual_seed(0), "cpu")
    table = gnn.neighbor_table(batch["edge_src"], batch["edge_dst"],
                               batch["x"].shape[0])
    finals = []
    for b in (batch, {**batch, "table": table}):
        cell = arch.build_cell(shape, device="cpu")
        state = init_train_state(cell, {k: v.clone()
                                        for k, v in params.items()})
        metrics = [cell.fn(state, b)[1] for _ in range(2)]
        finals.append((metrics, state["params"]))
    (m1, p1), (m2, p2) = finals
    for a, b in zip(m1, m2):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


def test_cell_refuses_a_mesh_and_needs_a_card_unless_cpu():
    arch = get_arch("graphsage-reddit").reduced()
    with pytest.raises(NotImplementedError, match="item 10"):
        arch.build_cell("molecule", device="cpu", mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = arch.shape_cfg("molecule")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.build_cell("molecule")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.smoke_inputs("molecule", np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_params_from_jax({}, cfg)


# -- the encoder and the converter --------------------------------------------


def test_gnn_encoder_registered_and_dispatching_as_reference():
    assert ENCODER_REGISTRY["gnn"] is GNNEncoder
    jcfg, cfg = _cfgs("mean")
    jp, p = _params(jcfg, cfg)
    jenc, enc = jencoder.get_encoder("gnn", jcfg), GNNEncoder(cfg)
    assert enc.param_shapes() == {
        k: v.shape for k, v in jenc.abstract_params().items()}
    drawn = enc.init_params(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in drawn.items()} == enc.param_shapes()
    assert all(not v.any() for k, v in drawn.items() if k.startswith("b_"))
    rng = np.random.default_rng(2)
    src, dst = _graph(rng)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    xb = rng.normal(size=(2, 5, 6)).astype(np.float32)
    edges = rng.integers(0, 5, (2, 6, 2)).astype(np.int32)
    masks = np.ones((2, 6), np.int32), np.ones((2, 5), np.int32)
    fs = [rng.normal(size=s).astype(np.float32)
          for s in ((4, 6), (4, 3, 6), (4, 3, 2, 6))]
    batches = [
        {"x": x, "edge_src": src, "edge_dst": dst},
        {"x": xb, "edges": edges, "edge_mask": masks[0],
         "node_mask": masks[1]},
        {"feats0": fs[0], "feats1": fs[1], "feats2": fs[2]}]
    for b in batches:
        want = jenc.encode(jp, {k: jnp.asarray(v) for k, v in b.items()})
        got = enc.encode(p, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(got, want)
    table = gnn.neighbor_table(*_t(src, dst), 12)
    got = enc.encode(p, {**{k: torch.from_numpy(v)
                            for k, v in batches[0].items()}, "table": table})
    _close(got, jenc.encode(jp, batches[0]))


def test_gnn_params_from_jax_checks_names_and_shapes():
    jcfg, cfg = _cfgs("mean")
    host = jax.tree.map(np.asarray, jgnn.init_params(jcfg,
                                                     jax.random.key(1)))
    p = gnn_params_from_jax(host, cfg, "cpu")
    assert all(np.array_equal(p[k].numpy(), host[k]) for k in host)
    with pytest.raises(ValueError, match="keys"):
        gnn_params_from_jax({k: v for k, v in host.items() if k != "b_0"},
                            cfg, "cpu")
    with pytest.raises(ValueError, match="w_self_1: shape"):
        gnn_params_from_jax({**host, "w_self_1": host["w_self_1"][:, :3]},
                            cfg, "cpu")


# -- node search --------------------------------------------------------------


def test_node_search_matches_reference_and_every_pair_bitwise():
    """Node embeddings of a reduced full graph searched by the port's
    driver on all nine score x heap pairs (bitwise equal to each other)
    and by the reference's: ids equal where separated, scores within
    1e-5."""
    arch = get_arch("graphsage-reddit").reduced()
    shape = "ogb_products"
    cfg = arch.shape_cfg(shape)
    p = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = arch.smoke_inputs(shape, np.random.default_rng(0), "cpu")
    with torch.no_grad():
        z = gnn.forward_full(cfg, p, b["x"], b["edge_src"], b["edge_dst"])
    z = z.numpy()
    q = z[b["pairs"][:16, 0].numpy()]
    k = 10

    def load(lo, hi):
        return z[lo:hi]

    want_v, want_i = RefDriver(score_impl="numpy", chunk_size=16).search(
        q, len(z), load, k)
    outs = [ShardedSearchDriver(score_impl=s, heap_impl=h, chunk_size=16,
                                superchunk_size=4, device="cpu").search(
        q, len(z), load, k)
        for s in ("numpy", "torch", "fused")
        for h in ("python", "torch", "kernel")]
    for v, i in outs[1:]:
        np.testing.assert_array_equal(v, outs[0][0])
        np.testing.assert_array_equal(i, outs[0][1])
    v, i = outs[0]
    np.testing.assert_allclose(v, want_v, rtol=0, atol=SEP)
    sep = np.ones_like(want_v, bool)
    gaps = np.abs(np.diff(want_v, axis=1)) > SEP
    sep[:, 1:] &= gaps
    sep[:, :-1] &= gaps
    np.testing.assert_array_equal(i[sep], want_i[sep])
    np.testing.assert_array_equal(i[:, 0], b["pairs"][:16, 0].numpy())

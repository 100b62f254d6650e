"""The port's recsys scoring path against the reference, on the CPU.

Every reduced ``serve`` and ``retrieval`` cell of the four rankers
(``RecSysArch.reduced()``: DeepFM, Wide&Deep, AutoInt, BST) runs in
``repro`` (JAX on the CPU) and in ``repro_torch`` (``device="cpu"``) on
the same weights (the reference's ``init_params``, carried across by
``recsys_params_from_jax``) and the same inputs (``smoke_inputs`` from
one numpy seed, identical in both packages).  The two sum in different
orders in float32: outputs agree within rtol 1e-5 / atol 1e-6, and the
retrieval ids wherever neighbouring scores are more than 1e-5 apart.
"""

import dataclasses
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jrecsys
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import recsys
from repro_torch.models.convert import recsys_params_from_jax
from repro_torch.sharding import make_mesh

torch.set_num_threads(1)

RTOL, ATOL, SEP = 1e-5, 1e-6, 1e-5
ARCHS = ["deepfm", "wide-deep", "autoint", "bst"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference arch, its params, port arch, its params), reduced."""
    jarch = jax_get_arch(request.param).reduced()
    arch = get_arch(request.param).reduced()
    jparams = jrecsys.init_params(jarch.cfg, jax.random.key(0))
    params = recsys_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    arch.cfg, device="cpu")
    return jarch, jparams, arch, params


def _inputs(jarch, arch, shape, seed=1):
    jb = jarch.smoke_inputs(shape, np.random.default_rng(seed))
    tb = arch.smoke_inputs(shape, np.random.default_rng(seed), device="cpu")
    return jb, tb


def test_forward_matches_reference(pair):
    jarch, jparams, arch, params = pair
    jb, tb = _inputs(jarch, arch, "serve_bulk")
    want = np.asarray(jrecsys.forward(jarch.cfg, jparams, jb))
    got = recsys.forward(arch.cfg, params, tb)
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_cell_matches_reference(pair, shape):
    jarch, jparams, arch, params = pair
    jb, tb = _inputs(jarch, arch, shape, seed=2)
    want = np.asarray(jarch.build_cell(shape).fn(jparams, jb))
    got = arch.build_cell(shape, device="cpu").fn(params, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert ((got > 0) & (got < 1)).all()


def test_retrieval_cell_matches_reference(pair):
    jarch, jparams, arch, params = pair
    jb, tb = _inputs(jarch, arch, "retrieval_cand", seed=3)
    wv, wi = (np.asarray(x) for x in jarch.build_cell(
        "retrieval_cand").fn(jparams, jb))
    gv, gi = arch.build_cell("retrieval_cand", device="cpu").fn(params, tb)
    assert gv.shape == gi.shape == (8,) and gi.dtype == torch.int32
    np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL, atol=ATOL)
    gap = np.abs(np.diff(wv))
    sep = np.ones(8, bool)
    sep[1:] &= gap > SEP
    sep[:-1] &= gap > SEP
    np.testing.assert_array_equal(gi.numpy()[sep], wi[sep])
    assert np.isin(gi.numpy(), tb["cand_idx"].numpy()).all()


def test_retrieval_scores_match_per_candidate_forward(pair):
    """Scoring one user against N candidates in one batch equals a
    forward of each candidate alone (the reference's
    test_recsys_retrieval_scores_match_forward)."""
    _, _, arch, params = pair
    tb = arch.smoke_inputs("retrieval_cand", np.random.default_rng(4),
                           device="cpu")
    tb["cand_idx"] = tb["cand_idx"][:5]
    scores = recsys.retrieval_scores(arch.cfg, params, tb)
    for i in range(5):
        cand = tb["cand_idx"][i:i + 1]
        if arch.cfg.kind == "bst":
            lone = {"hist": tb["hist"], "target": cand,
                    "profile": tb["profile"]}
        else:
            lone = {"sparse_idx": torch.cat([cand[:, None], tb["user_idx"]],
                                            1)}
        np.testing.assert_allclose(
            float(scores[i]), float(recsys.forward(arch.cfg, params,
                                                   lone)[0]), rtol=1e-5)


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_inputs_identical_across_packages(name, shape):
    jarch = jax_get_arch(name).reduced()
    arch = get_arch(name).reduced()
    jb, tb = _inputs(jarch, arch, shape, seed=5)
    assert list(tb) == list(jb)
    for k in jb:
        assert tb[k].dtype == (torch.float32 if k == "labels" else
                               torch.int32)
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_configs_match_reference(name):
    """The published vocabularies and widths, parameter by parameter."""
    jarch, arch = jax_get_arch(name), get_arch(name)
    want = {k: tuple(v.shape) for k, v in jarch.abstract_params().items()}
    assert arch.param_shapes() == want
    assert arch.shape_names() == jarch.shape_names()
    assert arch.shapes == jarch.shapes
    fields = ("kind", "vocab_sizes", "embed_dim", "mlp_dims",
              "n_attn_layers", "n_heads", "d_attn", "seq_len",
              "n_profile_fields", "bst_d_ff")
    assert {f: getattr(arch.cfg, f) for f in fields} == {
        f: getattr(jarch.cfg, f) for f in fields}


def test_published_table_sizes():
    assert get_arch("deepfm").cfg.total_vocab == 34_312_192
    assert get_arch("wide-deep").cfg.total_vocab == 34_377_728
    assert get_arch("bst").cfg.total_vocab == 4_202_496


def test_kernel_launches_on_cpu_stay_zero(pair):
    """On CPU tensors the bag sums take K4's plain version: no launch."""
    jarch, _, arch, params = pair
    ops.reset_launch_counts()
    _, tb = _inputs(jarch, arch, "retrieval_cand")
    arch.build_cell("retrieval_cand", device="cpu").fn(params, tb)
    assert ops.launch_counts() == {"fused_score_topk": 0, "topk_update": 0,
                                   "embedding_bag": 0,
                                   "embedding_bag_backward": 0}


def test_entry_points_default_to_the_card():
    """No CUDA device here: every entry point that defaults to
    ``device="cuda"`` raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arch = get_arch("deepfm").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.init_params(arch.cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.build_cell("serve_p99")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.smoke_inputs("serve_p99", np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_params_from_jax({}, arch.cfg)


def test_unported_parts_raise():
    arch = get_arch("deepfm").reduced()
    params = recsys.init_params(arch.cfg, torch.Generator().manual_seed(0),
                           "cpu")
    tb = arch.smoke_inputs("serve_p99", np.random.default_rng(0), "cpu")
    # on a mesh the xla_gather lookup is the one-card path on the
    # gathered table; the psum lookup needs the mesh bound to a process
    # group (tests/test_torch_mesh.py)
    mesh = make_mesh((1, 2), ("data", "model"))
    torch.testing.assert_close(recsys.forward(arch.cfg, params, tb, mesh),
                               recsys.forward(arch.cfg, params, tb),
                               rtol=0, atol=0)
    psum = dataclasses.replace(arch.cfg, embedding_impl="psum")
    with pytest.raises(RuntimeError, match="shape-only"):
        recsys.forward(psum, params, tb, mesh)
    # gemma-7b and the MoE archs are LM encoders of the port now
    # (tests/test_torch_lm_encoders.py, tests/test_torch_moe.py), and the
    # GNN is ported too (tests/test_torch_gnn.py)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    assert get_arch("graphsage-reddit").family == "gnn"


def test_init_params_follow_reference_rule():
    """Same names and shapes as the reference; biases 0, tables at scale
    0.01, weights at 1/sqrt(fan_in); seeded, so reproducible."""
    arch = get_arch("bst").reduced()
    p = recsys.init_params(arch.cfg, torch.Generator().manual_seed(0),
                           "cpu")
    q = recsys.init_params(arch.cfg, torch.Generator().manual_seed(0),
                           "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == arch.param_shapes()
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert (p["attn_ln1"] == 1).all() and not p["mlp_b0"].eq(0).all()
    assert 0.005 < float(p["table"].std()) < 0.02
    fan_in = p["mlp_w0"].shape[0]
    assert 0.5 < float(p["mlp_w0"].std()) * fan_in ** 0.5 < 1.5


def test_params_from_jax_checks_layout():
    arch = get_arch("deepfm").reduced()
    tree = {k: np.zeros(s, np.float32) for k, s in arch.param_shapes().items()}
    assert recsys_params_from_jax(tree, arch.cfg, device="cpu").keys() == \
        tree.keys()
    bad = dict(tree, table=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="table: shape"):
        recsys_params_from_jax(bad, arch.cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        recsys_params_from_jax({**tree, "extra": np.zeros(1)}, arch.cfg,
                               device="cpu")

"""The port's recsys training step (the ``train_batch`` cell: BCE +
AdamW) against the reference's, on the CPU.

For each of the four reduced rankers the reference's cell runs jitted
(``jax.jit(cell.fn)``, JAX on the CPU) on a state built from its
``init_params`` and ``make_optimizer``; the port's cell runs on
``device="cpu"`` from the same weights (``recsys_params_from_jax``),
zero optimizer state (``init_train_state``) and the same batch
(``smoke_inputs`` from one numpy seed).  DeepFM's and Wide&Deep's bag
sums take K4 and its backward K4T (their plain versions here); AutoInt
and BST gather only.  The two sum in different orders in float32:

* loss and grad_norm of 3 steps within rtol 1e-4, as the retrieval
  trainer's test holds them;
* every parameter after step 1 within atol 1e-6.  AdamW's first update
  is lr * (g / |g| + wd * p), about 1e-3 per element; the two packages'
  float32 gradients differ at the rounding level, which moves it by
  ~1e-7 (a gradient whose sign the rounding flipped would move it by
  2e-3).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jrecsys
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro_torch.configs import get_arch
from repro_torch.configs.base import (init_train_state, make_layout,
                                      make_train_cell)
from repro_torch.kernels import ops
from repro_torch.models.convert import recsys_params_from_jax
from repro_torch.sharding import make_mesh

torch.set_num_threads(1)

RTOL, PARAM_ATOL, STEPS = 1e-4, 1e-6, 3
ARCHS = ["deepfm", "wide-deep", "autoint", "bst"]


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """3 steps of each package's cell on one batch: per step (loss,
    grad_norm), the parameters after step 1, and the port's state."""
    jarch = jax_get_arch(request.param).reduced()
    arch = get_arch(request.param).reduced()
    jparams = jrecsys.init_params(jarch.cfg, jax.random.key(0))
    params = recsys_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    arch.cfg, device="cpu")
    jbatch = jarch.smoke_inputs("train_batch", np.random.default_rng(1))
    batch = arch.smoke_inputs("train_batch", np.random.default_rng(1),
                              device="cpu")
    opt_init, _ = jmake_optimizer(JOptimizerConfig(name="adamw",
                                                   learning_rate=1e-3))
    jstate = {"step": jnp.int32(0), "params": jparams,
              "opt": opt_init(jparams)}
    jstep = jax.jit(jarch.build_cell("train_batch").fn)
    cell = arch.build_cell("train_batch", device="cpu")
    state = init_train_state(cell, params)
    out = {"ref": [], "port": [], "state": state, "cell": cell,
           "batch": batch, "arch": arch}
    ops.reset_launch_counts()
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        state, m = cell.fn(state, batch)
        out["ref"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            out["ref_params1"] = jax.tree.map(np.asarray, jstate["params"])
            out["port_params1"] = {k: v.clone() for k, v in
                                   state["params"].items()}
    out["launches"] = ops.launch_counts()
    return out


def test_losses_and_grad_norms_match_reference(runs):
    got, want = np.array(runs["port"]), np.array(runs["ref"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1, 0] < got[0, 0]              # the loss falls on one batch


def test_params_after_first_step_match_reference(runs):
    got, want = runs["port_params1"], runs["ref_params1"]
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_step_updates_state_in_place_without_a_launch(runs):
    """The cell writes the parameters and AdamW's state in place and
    counts the step; on CPU tensors K4 / K4T take their plain versions."""
    state, cell = runs["state"], runs["cell"]
    assert cell.kind == "train" and cell.optimizer == "adamw"
    assert int(state["step"]) == STEPS and state["step"].dtype == torch.int32
    assert set(state["opt"]) == {"mu", "nu"}
    for name, p in state["params"].items():
        assert state["opt"]["mu"][name].shape == p.shape
        assert not p.requires_grad and p.grad is None
    assert set(runs["launches"].values()) == {0}


def test_tables_get_gradients_only_on_touched_rows(runs):
    """Every embedding table (DeepFM's linear_table and Wide&Deep's
    wide_table through K4T alone) has AdamW momentum on each row the
    batch's ids touch and on no other row."""
    arch, state = runs["arch"], runs["state"]
    touched = torch.zeros(arch.cfg.total_vocab, dtype=torch.bool)
    for key, ids in runs["batch"].items():
        if key != "labels":
            touched[ids.reshape(-1).long()] = True
    tables = [n for n in state["params"] if n.endswith("table")]
    assert len(tables) == (1 if arch.cfg.kind in ("autoint", "bst") else 2)
    for name in tables:
        mu = state["opt"]["mu"][name].abs().sum(1)
        assert bool((mu[touched] > 0).all()), name
        assert not mu[~touched].any(), name


def test_step_leaves_no_reference_cycle():
    """A step frees its gradients when it returns: nothing it builds is
    left in a reference cycle for the cyclic collector (at full width
    each uncollected gradient copy of Wide&Deep's table is 4.4 GB)."""
    arch = get_arch("wide-deep").reduced()
    params = recsys_params_from_jax(
        {k: np.zeros(s, np.float32) for k, s in arch.param_shapes().items()},
        arch.cfg, device="cpu")
    cell = arch.build_cell("train_batch", device="cpu")
    state = init_train_state(cell, params)
    batch = arch.smoke_inputs("train_batch", np.random.default_rng(2),
                              device="cpu")
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        cell.fn(state, batch)
        assert gc.collect() == 0
    finally:
        if enabled:
            gc.enable()


def test_train_cell_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arch = get_arch("deepfm").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.build_cell("train_batch")
    assert arch.build_cell("train_batch", device="cpu").kind == "train"


def test_make_train_cell_refuses_a_mesh_and_init_takes_a_name():
    """A cell laid out on a shape-only mesh builds, and refuses to step
    until its mesh is bound to a process group."""
    arch = get_arch("deepfm").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    layout = make_layout(mesh, arch.axis_rules(), arch.param_shapes(),
                         arch.param_logical_axes(),
                         arch.batch_axes("train_batch"), "adamw")
    cell = make_train_cell("x", "train_batch", loss_fn=lambda p, b: 0.0,
                           optimizer="adamw", layout=layout)
    assert tuple(layout.param_specs["table"]) == ("model", None)
    assert tuple(layout.opt_specs["mu"]["table"]) == ("model", None)
    with pytest.raises(RuntimeError, match="shape-only"):
        cell.fn({}, arch.smoke_inputs("train_batch", np.random.default_rng(0),
                                      "cpu"))
    params = {"w": torch.zeros((130, 140)), "b": torch.zeros(3)}
    state = init_train_state("adafactor", params)
    assert state["params"] is params and int(state["step"]) == 0
    assert set(state["opt"]["v"]["w"]) == {"vr", "vc"}
    assert set(init_train_state("adamw", params)["opt"]) == {"mu", "nu"}

"""The MoE FFN (granite-moe-3b-a800m, llama4-maverick-400b-a17b) against
the reference, on the CPU.

* At full width ``param_shapes``, ``param_count()`` and
  ``active_param_count()`` equal the reference's ``abstract_params`` and
  counts (``jax.eval_shape`` of nothing: no allocation).
* ``_moe_ffn`` of one layer, float32, against the reference's
  ``_moe_ffn(cfg, lp, x, None)`` on the same numpy-seeded parameters
  (``params_from_jax``) and rows: output within 1e-6, aux within 1e-6
  of its value (a routed-to-one-expert aux is ~6.6, where float32's
  spacing is 4.8e-7 and the two packages sum the means in other orders);
  top-2 of 8 (granite reduced), top-1 of 8 with a shared expert (llama4
  reduced), a router biased to one expert (most slots drop), two equal
  router columns (exact ties), a row of one repeated vector (a padding
  row), and lengths where the capacity's ``ceil`` rounds up.
* ``_route`` equals a numpy oracle that walks the tokens s-major: the
  choice, keep and slot equal, the gates within 1e-7.  A zero router
  gives experts 0..k-1 to every token.
* ``forward_hidden`` / ``encode`` of both reduced archs: hidden within
  1e-5, aux within 1e-6.
* The reduced ``train_4k`` cells: loss and grad_norm of 3 steps within
  rtol 1e-4 (of the first step's value), every parameter after step 1
  within atol 1e-6 where the first gradient is clear of zero (the
  tolerances of ``tests/test_torch_lm_train.py``), now with a nonzero
  aux; remat on and off bitwise.
* ``launch.train --arch granite-moe-3b-a800m --smoke`` against the
  reference's launcher, ``moe_aux_loss`` logged by both.
* A token's output depends on its row's padded length (the capacity is
  per row of S padded tokens), in both packages alike.
* llama4-maverick at full width is refused before any allocation.
"""

import contextlib
import dataclasses
import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_launch
import repro.training.trainer as ref_trainer
from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as jtf
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro_torch.configs import (get_arch, granite_moe_3b_a800m,
                                 llama4_maverick_400b_a17b)
from repro_torch.configs.base import init_train_state
from repro_torch.configs.lm_arch import REDUCED_SHAPES, LMArch
from repro_torch.launch import serve, train
from repro_torch.launch.serve import lm_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import flatten, tree_map, unflatten

torch.set_num_threads(1)

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
ARCHS = [GRANITE, LLAMA4]
MODULES = {GRANITE: granite_moe_3b_a800m, LLAMA4: llama4_maverick_400b_a17b}
# the reference's param_count() / active_param_count() at published width
COUNTS = {GRANITE: (3_298_793_472, 882_874_368),
          LLAMA4: (396_657_464_320, 13_130_306_560)}
FFN_ATOL, AUX_ATOL, HIDDEN_ATOL = 1e-6, 1e-6, 1e-5
RTOL, PARAM_ATOL, STEPS, LR, WD = 1e-4, 1e-6, 3, 1e-3, 0.01
SMALL_GRAD = 1e-4
PASSAGE_LENGTHS = (32, 20, 9, 1)


def _port_cfg(jcfg) -> tf.LMConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tf.LMConfig) if f.name != "dtype"}
    return tf.LMConfig(**fields, dtype=torch.float32)


def _pair(jcfg, seed=0):
    """Reference params (numpy leaves) and the port's copy."""
    cfg = _port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.key(seed)))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _by_path(jtree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _bits(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.view(np.int32)
    return t.detach().view(torch.int32).numpy()


# -- layout at full width -----------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_layout_and_counts_match_reference(name):
    jcfg = ref_get_arch(name).cfg
    cfg = MODULES[name].get_config()
    assert cfg == dataclasses.replace(_port_cfg(jcfg), dtype=torch.bfloat16)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert tf.param_shapes(cfg) == shapes(jtf.abstract_params(jcfg))
    assert (cfg.n_dense_layers, cfg.n_moe_layers) == (
        jcfg.n_dense_layers, jcfg.n_moe_layers)
    assert (cfg.param_count(), cfg.active_param_count()) == (
        jcfg.param_count(), jcfg.active_param_count()) == COUNTS[name]


@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_reduced_forms_match_reference(name):
    jarch, arch = ref_get_arch(name), get_arch(name)
    assert isinstance(arch, LMArch) and arch.name == name
    assert arch.cfg == MODULES[name].get_config()
    assert arch.reduced().cfg == MODULES[name].reduced() == _port_cfg(
        jarch.reduced().cfg)
    assert arch.reduced().shapes == jarch.reduced().shapes
    small = arch.reduced().cfg
    assert (small.n_layers, small.n_experts, small.top_k, small.moe_d_ff) \
        == (2, 8, min(arch.cfg.top_k, 2), 32)
    assert set(tf.param_shapes(small)) - {"embed", "final_ln"} == (
        {"moe_blocks"} if name == GRANITE else {"blocks", "moe_blocks"})


# -- one MoE FFN against the reference ----------------------------------------


def _layer(name, seed=0):
    """The reduced arch's first MoE layer: (jcfg, cfg, reference layer
    params, the port's)."""
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, _ = _pair(jcfg, seed)
    lp = {k: v[0] for k, v in tree["moe_blocks"].items()}
    return jcfg, cfg, lp


def _ffn_both(jcfg, cfg, lp, x):
    want, jaux = jtf._moe_ffn(jcfg, jax.tree.map(jnp.asarray, lp),
                              jnp.asarray(x), None)
    got, aux = tf._moe_ffn(cfg, {k: torch.from_numpy(np.array(v))
                                 for k, v in lp.items()},
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FFN_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_ATOL,
                               atol=0)
    return got


def _route_np(lp, cfg, x):
    """The port's route of ``x`` through ``lp``'s router."""
    p = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    xt = torch.from_numpy(x)
    h = tf._norm(xt, p["ln2"], None, cfg.norm)
    return [t.numpy() if t.ndim else float(t)
            for t in tf._route(cfg, h, p["router"])]


def _case(name, seed, s, b=3):
    rng = np.random.default_rng(seed)
    jcfg, cfg, lp = _layer(name, seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, lp, x, rng


def _raised(cfg, lp, x, rng, scale):
    """``x`` with a component shared by every token, and the unit
    direction of its normed rows' mean times ``scale``: a router column
    plus that vector gives every token a larger logit there."""
    x = x + 2.0 * rng.normal(size=x.shape[-1]).astype(np.float32)
    h = tf._norm(torch.from_numpy(x), torch.from_numpy(np.array(lp["ln2"])),
                 None, cfg.norm).numpy()
    m = h.mean((0, 1))
    return x, (scale * m / np.linalg.norm(m)).astype(np.float32)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("s", [1, 3, 5, 12, 33])
def test_moe_ffn_matches_reference(name, s):
    """S = 1, 3, 5, 12, 33: capacities (top-2 of 8 / top-1 of 8) 1 / 1,
    1 / 1, 2 / 1, 4 / 2, 11 / 6, each ``ceil`` rounding up."""
    jcfg, cfg, lp, x, _ = _case(name, s, s)
    cap = tf.capacity(cfg, s)
    assert cap == max(int(np.ceil(s * jcfg.top_k / jcfg.n_experts
                                  * jcfg.capacity_factor)), 1)
    assert cap > s * cfg.top_k / cfg.n_experts * cfg.capacity_factor
    _ffn_both(jcfg, cfg, lp, x)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_with_a_biased_router_drops_and_matches(name):
    """Router column 3 raised: most tokens choose expert 3 first, and most
    of their slots overflow its capacity."""
    jcfg, cfg, lp, x, rng = _case(name, 11, 24)
    x, up = _raised(cfg, lp, x, rng, 0.5)
    lp["router"] = lp["router"].copy()
    lp["router"][:, 3] += up
    _, choice, _, keep, _ = _route_np(lp, cfg, x)
    assert (choice[..., 0] == 3).mean() > 0.8
    assert (~keep).mean() > 0.3
    _ffn_both(jcfg, cfg, lp, x)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_with_exact_ties_matches_reference(name):
    """Router columns 1, 4 and 6 equal and raised: every token's three
    largest probabilities are exactly equal, so the chosen experts are
    the lowest indices among them (1, then 4), as ``lax.top_k``."""
    jcfg, cfg, lp, x, rng = _case(name, 12, 16)
    x, up = _raised(cfg, lp, x, rng, 0.5)
    r = lp["router"].copy()
    r[:, 1] = r[:, 4] = r[:, 6] = r[:, 1] + up
    lp["router"] = r
    gates, choice, _, _, _ = _route_np(lp, cfg, x)
    logits = np.einsum("bsd,de->bse", tf._norm(
        torch.from_numpy(x), torch.from_numpy(np.array(lp["ln2"])), None,
        cfg.norm).numpy(), r)
    tied = (logits[..., 1] == logits[..., 4]) & (
        logits[..., 1] == logits[..., 6]) & (logits.argmax(-1) == 1)
    assert tied.mean() > 0.8
    want = np.array([1, 4][: cfg.top_k])
    assert (choice[tied] == want).all()
    _ffn_both(jcfg, cfg, lp, x)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_on_a_padding_row_matches_reference(name):
    """One row is a single vector repeated (as a row of padding tokens
    enters the FFN): every position routes alike, and all but the
    capacity's first tokens drop."""
    jcfg, cfg, lp, x, rng = _case(name, 13, 20)
    x[1] = rng.normal(size=cfg.d_model).astype(np.float32)
    _, choice, _, keep, _ = _route_np(lp, cfg, x)
    cap = tf.capacity(cfg, 20)
    assert (choice[1] == choice[1, 0]).all()
    k = cfg.top_k
    assert keep[1].reshape(20, k)[:cap].all()
    assert not keep[1].reshape(20, k)[cap:].any()
    _ffn_both(jcfg, cfg, lp, x)


# -- the route against a numpy oracle -----------------------------------------


def _oracle(probs, k, cap):
    """Plain loops: each token's top k (the larger probability first, the
    lower expert among equal ones), its gates, then each (s, k) pair's
    rank within its expert, counted s-major."""
    b, s, e = probs.shape
    choice = np.zeros((b, s, k), np.int64)
    gates = np.zeros((b, s, k), np.float32)
    slot = np.zeros((b, s * k), np.int64)
    keep = np.zeros((b, s * k), bool)
    for i in range(b):
        taken = [0] * e
        for t in range(s):
            order = sorted(range(e), key=lambda x: (-probs[i, t, x], x))
            choice[i, t] = order[:k]
            g = probs[i, t, order[:k]]
            gates[i, t] = g / max(g.sum(), 1e-9)
            for j, ex in enumerate(order[:k]):
                n = t * k + j
                keep[i, n] = taken[ex] < cap
                slot[i, n] = ex * cap + taken[ex] if keep[i, n] else e * cap
                taken[ex] += 1
    return gates, choice, slot, keep


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("case", ["seeded", "biased", "zero"])
def test_route_equals_numpy_oracle(name, case):
    jcfg, cfg, lp, x, _ = _case(name, 21, 17)
    p = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    if case == "biased":
        p["router"][:, 2] += 0.4
    if case == "zero":
        p["router"].zero_()
    h = tf._norm(torch.from_numpy(x), p["ln2"], None, cfg.norm)
    gates, choice, slot, keep, aux = tf._route(cfg, h, p["router"])
    probs = torch.softmax(torch.einsum("bsd,de->bse", h, p["router"]),
                          -1).numpy()
    cap = tf.capacity(cfg, x.shape[1])
    wg, wc, ws, wk = _oracle(probs, cfg.top_k, cap)
    np.testing.assert_array_equal(choice.numpy(), wc)
    np.testing.assert_array_equal(keep.numpy(), wk)
    np.testing.assert_array_equal(slot.numpy(), ws)
    np.testing.assert_allclose(gates.numpy(), wg, atol=1e-7, rtol=0)
    density = np.bincount(wc[..., 0].ravel(), minlength=cfg.n_experts)
    want_aux = cfg.n_experts * np.sum(density / wc[..., 0].size
                                      * probs.mean((0, 1)))
    np.testing.assert_allclose(float(aux), want_aux, atol=AUX_ATOL)
    if case == "zero":
        assert (wc == np.arange(cfg.top_k)).all()
        np.testing.assert_allclose(float(aux), 1.0, atol=AUX_ATOL)


# -- the stacks ---------------------------------------------------------------


def _tokens(rng, vocab, b=4, s=12):
    toks = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 7, 1, 0][:b])             # last row all padding
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, toks, 0), mask


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("s", [12, 40])
def test_forward_hidden_and_encode_match_reference(name, s):
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, params = _pair(jcfg)
    toks, mask = _tokens(np.random.default_rng(s), cfg.vocab_size, s=s)
    jp = jax.tree.map(jnp.asarray, tree)
    jh, jaux = jtf.forward_hidden(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(mask))
    h, aux = tf.forward_hidden(cfg, params, torch.from_numpy(toks),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HIDDEN_ATOL,
                               rtol=0)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert float(aux) > 0.5
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_ATOL,
                               rtol=0)
    got = tf.encode(cfg, params, torch.from_numpy(toks),
                    torch.from_numpy(mask)).numpy()
    want = np.asarray(jtf.encode(jcfg, jp, jnp.asarray(toks),
                                 jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=HIDDEN_ATOL, rtol=0)


def test_dense_stack_reports_a_zero_aux():
    cfg = get_arch("qwen2-0.5b").reduced().cfg
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, mask = _tokens(np.random.default_rng(0), cfg.vocab_size)
    _, aux = tf.forward_hidden(cfg, params, torch.from_numpy(toks),
                               torch.from_numpy(mask))
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_interleaved_stack_runs_dense_then_moe():
    """moe_every = 2: layer 0 is blocks[0], layer 1 moe_blocks[0]."""
    cfg = dataclasses.replace(get_arch(LLAMA4).reduced().cfg, n_layers=4)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    order = tf._stack_order(cfg, params)
    assert [m for m, _ in order] == [False, True, False, True]
    assert order[2][1]["wq"].data_ptr() == params["blocks"]["wq"][
        1].data_ptr()
    assert order[3][1]["router"].data_ptr() == params["moe_blocks"][
        "router"][1].data_ptr()


# -- the train_4k cells -------------------------------------------------------


def _batch(jarch):
    """The reference's train_4k token rows (numpy seed 1), the passages
    padded to PASSAGE_LENGTHS; (jax batch, port batch)."""
    jbatch = jarch.smoke_inputs("train_4k", np.random.default_rng(1))
    s = jbatch["passage"]["mask"].shape[1]
    mask = (np.arange(s)[None] < np.array(PASSAGE_LENGTHS)[:, None]
            ).astype(np.int32)
    toks = np.where(mask > 0, np.asarray(jbatch["passage"]["tokens"]), 0)
    jbatch["passage"] = {"tokens": jnp.asarray(toks),
                         "mask": jnp.asarray(mask)}
    batch = {side: {k: torch.from_numpy(np.array(v)) for k, v in
                    rows.items()} for side, rows in jbatch.items()}
    return jbatch, batch


def _loss_grads(arch, params, batch) -> dict:
    named = flatten(params)
    leaves_ = [p.detach().requires_grad_(True) for _, p in named]
    loss = arch._contrastive_loss()(unflatten(params, leaves_), batch)
    return {k: g.numpy() for (k, _), g in
            zip(named, torch.autograd.grad(loss, leaves_))}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    name = request.param
    jarch = ref_get_arch(name).reduced()
    arch = LMArch(_port_cfg(jarch.cfg), optimizer=jarch.optimizer,
                  shapes=REDUCED_SHAPES)
    jparams = jtf.init_params(jarch.cfg, jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), arch.cfg,
                             device="cpu")
    jbatch, batch = _batch(jarch)
    opt_init, _ = jmake_optimizer(JOptimizerConfig(name="adamw",
                                                   learning_rate=LR))
    jstate = {"step": jnp.int32(0), "params": jparams,
              "opt": opt_init(jparams)}
    jstep = jax.jit(jarch.build_cell("train_4k").fn)
    out = {"ref": [], "port": [], "params0": _by_path(jparams),
           "ref_grads": _by_path(jax.grad(
               lambda p: jarch._contrastive_loss()(p, jbatch, None))(
                   jparams)),
           "aux": [float(tf.forward_hidden(
               arch.cfg, params, batch["passage"]["tokens"],
               batch["passage"]["mask"])[1]), float(jtf.forward_hidden(
                   jarch.cfg, jparams, jbatch["passage"]["tokens"],
                   jbatch["passage"]["mask"])[1])]}
    cell = arch.build_cell("train_4k", device="cpu")
    state = init_train_state(cell, params)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        state, m = cell.fn(state, batch)
        out["ref"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            out["ref_params1"] = _by_path(jstate["params"])
            out["port_params1"] = {k: v.clone().numpy() for k, v in
                                   flatten(state["params"])}
    return out


def test_train_4k_aux_is_in_the_loss(runs):
    got, want = runs["aux"]
    assert got > 0.5
    np.testing.assert_allclose(got, want, atol=AUX_ATOL, rtol=0)
    # the router's gradient comes from the aux term as well as the
    # contrastive one
    assert any(np.abs(g).max() > 0 for k, g in runs["ref_grads"].items()
               if k.endswith("router"))


def test_train_4k_losses_and_grad_norms_match_reference(runs):
    np.testing.assert_allclose(runs["port"][0], runs["ref"][0], rtol=RTOL)
    for step, (got, want) in enumerate(zip(runs["port"], runs["ref"])):
        for what, a, b, first in zip(("loss", "grad_norm"), got, want,
                                     runs["ref"][0]):
            assert math.isfinite(a)
            assert abs(a - b) <= RTOL * abs(first), (step, what, a, b)


def test_train_4k_params_after_one_step_match_reference(runs):
    want, grads = runs["ref_params1"], runs["ref_grads"]
    got = runs["port_params1"]
    assert set(got) == set(want)
    for key, leaf in got.items():
        g = np.abs(grads[key])
        clear = g >= SMALL_GRAD * g.max()
        np.testing.assert_allclose(leaf[clear], want[key][clear], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
        bound = 2 * LR * (1 + WD * np.abs(runs["params0"][key]))
        assert (np.abs(leaf - want[key]) <= bound).all(), key


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_bits(name):
    """The cell's gradients with remat on and off, the MoE layers' aux an
    output of each checkpoint: the same bits."""
    base = get_arch(name).reduced().cfg
    params = tf.init_params(base, torch.Generator().manual_seed(0), "cpu")
    _, batch = _batch(ref_get_arch(name).reduced())
    grads = {}
    for remat in (False, True):
        arch = LMArch(dataclasses.replace(base, remat=remat),
                      optimizer="adamw", shapes=REDUCED_SHAPES)
        grads[remat] = _loss_grads(arch, tree_map(torch.clone, params),
                                   batch)
    assert set(grads[False]) == set(grads[True])
    for key, a in grads[False].items():
        np.testing.assert_array_equal(_bits(a), _bits(grads[True][key]),
                                      err_msg=key)
    assert np.abs(grads[True]["moe_blocks/router"]).max() > 0


# -- the launcher --------------------------------------------------------------


def test_launcher_matches_reference(tmp_path, monkeypatch):
    """Both launchers on one data dir, the port's trainer from the
    reference's initial parameters: per-step losses within RTOL, and
    ``moe_aux_loss`` logged by both, within AUX_ATOL."""
    argv = ["--arch", GRANITE, "--smoke", "--data-dir",
            str(tmp_path / "data"), "--max_steps", "3", "--log_every", "1",
            "--per_device_batch_size", "4", "--checkpoint_every", "100",
            "--learning_rate", "3e-3"]
    seen = {}
    ref_init = ref_trainer.RetrievalTrainer.init_state
    ref_train = ref_trainer.RetrievalTrainer.train

    def recorded_init(trainer, rng=None):
        state = ref_init(trainer, rng)
        seen["params"] = jax.tree.map(np.asarray, state["params"])
        return state

    def recorded_train(trainer, *args, **kw):
        seen["trainer"] = trainer
        return ref_train(trainer, *args, **kw)

    monkeypatch.setattr(ref_trainer.RetrievalTrainer, "init_state",
                        recorded_init)
    monkeypatch.setattr(ref_trainer.RetrievalTrainer, "train",
                        recorded_train)
    with contextlib.redirect_stdout(io.StringIO()):
        ref_launch.main(argv + ["--output_dir", str(tmp_path / "ref")])
    params = params_from_jax(seen["params"], lm_config(GRANITE, True),
                             device="cpu")
    port_init = port_trainer.RetrievalTrainer.init_state
    monkeypatch.setattr(port_trainer.RetrievalTrainer, "init_state",
                        lambda trainer, p=None: port_init(
                            trainer, params if p is None else p))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, state = train.main(argv + [
            "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert trainer.retriever.encoder.cfg == lm_config(GRANITE, True)
    assert int(state["step"]) == 3
    want = seen["trainer"].logs
    assert [r["step"] for r in trainer.logs] == [r["step"] for r in want] \
        == [0, 1, 2]
    for got, ref in zip(trainer.logs, want):
        assert set(got) == set(ref)
        for key in ("loss", "grad_norm", "contrastive_loss"):
            assert math.isfinite(got[key])
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {got['step']} {key}")
        assert got["moe_aux_loss"] > 1.0
        np.testing.assert_allclose(got["moe_aux_loss"], ref["moe_aux_loss"],
                                   atol=AUX_ATOL, rtol=0)


# -- padded length -------------------------------------------------------------


def test_output_depends_on_the_padded_length_in_both_packages(monkeypatch):
    """One row of 8 equal tokens, encoded padded to 8 and to 32 (the rungs
    of two batches).  The tokens route alike, and the capacity is 3 at
    S = 8 (5 of the 8 overflow each chosen expert) and 10 at S = 32 (none
    overflow; the padding comes after them).  The embedding differs
    between the two rungs, in both packages, and agrees across packages
    at each."""
    name = GRANITE
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, params = _pair(jcfg, seed=5)
    assert (tf.capacity(cfg, 8), tf.capacity(cfg, 32)) == (3, 10)
    kept = []
    route = tf._route

    def recorded(c, h, router):
        out = route(c, h, router)
        kept.append(out[3].reshape(h.shape[0], h.shape[1], -1)[0, :8])
        return out

    monkeypatch.setattr(tf, "_route", recorded)
    embs = {}
    for s in (8, 32):
        toks = np.zeros((1, s), np.int32)
        toks[0, :8] = 7
        mask = (toks > 0).astype(np.int32)
        got, = tf.encode(cfg, params, torch.from_numpy(toks),
                         torch.from_numpy(mask)).numpy()
        want, = np.asarray(jtf.encode(jcfg, jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(toks), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, atol=HIDDEN_ATOL, rtol=0)
        embs[s] = got, want
    # two layers at each rung: at S = 8 the last 5 tokens overflow both
    # chosen experts in the first layer; at 32 every real token is kept
    dropped = [int((~k).sum()) for k in kept]
    assert dropped[0] == 10 and dropped[2:] == [0, 0], dropped
    for i in range(2):
        assert np.abs(embs[8][i] - embs[32][i]).max() > 1e-3


# -- refusals ------------------------------------------------------------------


def test_llama4_at_full_width_is_refused_before_allocating(tmp_path,
                                                           monkeypatch):
    def no_init(*args, **kw):
        raise AssertionError("parameters allocated")

    monkeypatch.setattr(tf, "init_params", no_init)
    with pytest.raises(NotImplementedError, match="item 10") as err:
        lm_config(LLAMA4, smoke=False)
    assert "739 GiB" in str(err.value)
    assert lm_config(LLAMA4, smoke=True) == llama4_maverick_400b_a17b.reduced()
    assert lm_config(GRANITE, smoke=False) == granite_moe_3b_a800m.get_config()
    for main in (serve.main, train.main):
        with pytest.raises(NotImplementedError, match="item 10"):
            main(["--arch", LLAMA4, "--device", "cpu", "--data-dir",
                  str(tmp_path / "data"), "--output_dir",
                  str(tmp_path / "out")] if main is train.main else
                 ["--arch", LLAMA4, "--device", "cpu", "--data-dir",
                  str(tmp_path / "data")])
    assert not os.listdir(tmp_path)

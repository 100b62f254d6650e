"""The dense LM encoders under training, against the reference, on the CPU.

* The ``train_4k`` cell (the contrastive bi-encoder step: InfoNCE over
  in-batch scores at temperature 0.02, clip, the arch's optimizer) of
  each reduced arch (2 x 64, float32, AdamW at 1e-3) against the
  reference's jitted cell from the same parameters (``params_from_jax``,
  biases set non-zero) and the same token rows (some passages padded).
  Once as ``reduced()`` gives it (no remat, one attention pass) and once
  with ``remat`` on and attention in 4 chunks, against the reference's
  ``variant(remat=True, attn_chunk=8)``.  The two packages' float32
  gradients differ at the rounding level, and the tolerances follow
  what that does to each number:

  - the first gradient, each leaf within 1e-5 of its largest element;
  - loss and grad_norm of 3 steps within rtol 1e-4 of the first step's
    value.  One step at 1e-3 separates the 4 in-batch pairs, and the
    loss falls to ~1e-2 .. 1e-7 (stablelm-3b: 0.0 against -3.6e-7), where
    a tolerance relative to the value itself compares rounding noise;
  - every parameter after step 1 within atol 1e-6 where the first
    gradient is at least 1e-4 of its leaf's largest element (AdamW's
    first update is lr * (g / (|g| + eps) + wd * p), about 1e-3 an
    element).  Below that, g / (|g| + eps) amplifies the gradient's
    rounding (an embedding element summed to ~1e-8 from terms of ~50 may
    change sign), and the bound is the most one update can move an
    element, 2 * lr * (1 + wd * |p|).
* ``remat`` on and off give bitwise-equal gradients and updated
  parameters in the port, with and without chunked attention, and with
  it on the backward recomputes the layers.
* The in-place clip, AdamW and Adafactor are bitwise equal to the
  out-of-place forms they replaced, kept here as the oracle.
* ``launch.train.main --arch X --smoke --device cpu`` against the
  reference's ``repro.launch.train.main`` on one data dir, from the
  reference's initial parameters: per-step loss and grad_norm within
  rtol 1e-4.
"""

import contextlib
import dataclasses
import io
import math

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
from repro_torch.configs import get_arch
from repro_torch.configs.base import init_train_state
from repro_torch.configs.lm_arch import REDUCED_SHAPES, LMArch
from repro_torch.launch import train
from repro_torch.launch.serve import lm_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding import make_mesh
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import flatten, leaves, tree_map, unflatten

torch.set_num_threads(1)

RTOL, PARAM_ATOL, STEPS, LR, WD = 1e-4, 1e-6, 3, 1e-3, 0.01
# gradient elements below this share of their leaf's largest are within
# the rounding of zero for AdamW's first step; the gradients' tolerance,
# as a share of the leaf's largest element
SMALL_GRAD, GRAD_TOL = 1e-4, 1e-5
ARCHS = ["gemma-7b", "qwen2-0.5b", "stablelm-3b"]
# the reduced cell as given, and with remat on and attention in chunks of
# 8 over the 32-token rows
VARIANTS = {"plain": {}, "remat": dict(remat=True, attn_chunk=8)}
# passage lengths of the reduced train_4k batch (4 rows of 32)
PASSAGE_LENGTHS = (32, 20, 9, 1)


def _biased(jparams, seed=0):
    """The reference initializes biases to zero: give them values so the
    bias paths count."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.1, x.dtype)
                      if str(p[-1].key).startswith("b")
                      or str(p[-1].key).endswith("_b") else x), jparams)


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


def _port_arch(jarch) -> LMArch:
    """The port's counterpart of a reduced (possibly varied) reference
    arch: the same fields, float32, AdamW, the reduced shapes."""
    fields = {f.name: getattr(jarch.cfg, f.name)
              for f in dataclasses.fields(tf.LMConfig) if f.name != "dtype"}
    return LMArch(tf.LMConfig(**fields, dtype=torch.float32),
                  optimizer=jarch.optimizer, shapes=REDUCED_SHAPES)


def _by_path(jtree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _loss_grads(arch, params, batch) -> dict:
    """The port's contrastive-loss gradients at ``params``, by path."""
    named = flatten(params)
    leaves_ = [p.detach().requires_grad_(True) for _, p in named]
    loss = arch._contrastive_loss()(unflatten(params, leaves_), batch)
    return {k: g.numpy() for (k, _), g in
            zip(named, torch.autograd.grad(loss, leaves_))}


@pytest.fixture(scope="module",
                params=[(a, v) for a in ARCHS for v in VARIANTS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """STEPS steps of each package's train_4k cell on one batch: per step
    (loss, grad_norm); the first gradients and the parameters after step
    1."""
    name, variant = request.param
    jarch = ref_get_arch(name).reduced()
    if VARIANTS[variant]:
        jarch = jarch.variant(**VARIANTS[variant])
    arch = _port_arch(jarch)
    assert (arch.cfg.remat, arch.cfg.attn_chunk) == (
        jarch.cfg.remat, jarch.cfg.attn_chunk)
    jparams = _biased(jtf.init_params(jarch.cfg, jax.random.key(0)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), arch.cfg,
                             device="cpu")
    jbatch, batch = _batch(jarch)
    jloss = jarch._contrastive_loss()
    out = {"ref": [], "port": [],
           "ref_grads": _by_path(jax.grad(
               lambda p: jloss(p, jbatch, None))(jparams)),
           "port_grads": _loss_grads(arch, params, batch)}
    opt_init, _ = jmake_optimizer(JOptimizerConfig(name="adamw",
                                                   learning_rate=LR))
    jstate = {"step": jnp.int32(0), "params": jparams,
              "opt": opt_init(jparams)}
    jstep = jax.jit(jarch.build_cell("train_4k").fn)
    cell = arch.build_cell("train_4k", device="cpu")
    assert (cell.kind, cell.optimizer) == ("train", "adamw")
    state = init_train_state(cell, params)
    out["state"] = state
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        state, m = cell.fn(state, batch)
        out["ref"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            out["ref_params1"] = _by_path(jstate["params"])
            out["port_params1"] = {k: v.clone().numpy() for k, v in
                                   flatten(state["params"])}
    out["params0"] = _by_path(jparams)
    return out


def test_train_4k_gradients_match_reference(runs):
    want = runs["ref_grads"]
    assert set(runs["port_grads"]) == set(want)
    for key, got in runs["port_grads"].items():
        np.testing.assert_allclose(
            got, want[key], rtol=0,
            atol=GRAD_TOL * float(np.abs(want[key]).max()), err_msg=key)


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


def test_train_4k_state_after_the_steps(runs):
    state = runs["state"]
    assert int(state["step"]) == STEPS
    assert set(state["opt"]) == {"mu", "nu"}
    assert all(p.dtype == torch.float32 for p in leaves(state["params"]))


@pytest.mark.parametrize("name", ARCHS)
def test_arch_optimizers_and_refusals(name):
    """Adafactor at full width, AdamW reduced (the reference's defaults);
    ``train_4k`` builds on a mesh with its layout (stepping it needs the
    mesh bound to a process group, ``tests/test_torch_mesh.py``) and the
    decode cell builds there with its cache's specs; the reduced decode
    cell builds and steps."""
    arch, jarch = get_arch(name), ref_get_arch(name)
    assert arch.optimizer == jarch.optimizer == "adafactor"
    assert arch.reduced().optimizer == jarch.reduced().optimizer == "adamw"
    assert arch.cfg.remat and not arch.reduced().cfg.remat
    mesh = make_mesh((2, 2), ("data", "model"))
    cell = arch.reduced().build_cell("train_4k", device="cpu", mesh=mesh)
    assert cell.layout.mesh is mesh and cell.layout.keep == ()
    assert tuple(cell.layout.param_specs["blocks"]["wq"]) == (
        None, "data", "model", None)
    with pytest.raises(RuntimeError, match="shape-only"):
        cell.fn({}, arch.reduced().smoke_inputs(
            "train_4k", torch.Generator(), device="cpu"))
    serve = arch.reduced().build_cell("decode_32k", device="cpu", mesh=mesh)
    assert serve.layout.mesh is mesh
    assert tuple(serve.layout.cache_specs["k"])[1] == "data"
    small = arch.reduced()
    cache, tokens = small.smoke_inputs("decode_32k", torch.Generator(),
                                       device="cpu")
    params = tf.init_params(small.cfg, torch.Generator().manual_seed(0),
                            "cpu")
    logits, cache = small.build_cell("decode_32k", device="cpu").fn(
        params, cache, tokens)
    assert logits.shape == (4, small.cfg.vocab_size)
    assert torch.isfinite(logits).all() and int(cache["len"]) == 64


# -- remat -------------------------------------------------------------------


def _grads_and_step(arch, params, batch):
    """The cell's loss gradients at ``params`` (:func:`_loss_grads`),
    counting the score function's calls, then one cell step from a copy
    of ``params``; (grads, updated params, calls)."""
    calls = {"n": 0}
    score = tf._attn_scores_softmax

    def counted(*args):
        calls["n"] += 1
        return score(*args)

    tf._attn_scores_softmax = counted
    try:
        grads = _loss_grads(arch, params, batch)
    finally:
        tf._attn_scores_softmax = score
    cell = arch.build_cell("train_4k", device="cpu")
    state, _ = cell.fn(init_train_state(cell, tree_map(torch.clone, params)),
                       batch)
    return grads, state["params"], calls["n"]


def _bits(t) -> np.ndarray:
    """The bit patterns of a float32 / bf16 tensor or float32 array."""
    if isinstance(t, np.ndarray):
        return t.view(np.int32)
    return t.detach().view({4: torch.int32, 2: torch.int16}[
        t.element_size()]).numpy()


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_bits(name, chunk):
    """Gradients and the updated parameters with remat on and off: the
    same bits.  The score function runs once per chunk and layer in each
    encode's forward, again in the backward where remat recomputes the
    layer, and again where a checkpointed chunk is recomputed."""
    base = get_arch(name).reduced()
    cfg = dataclasses.replace(base.cfg, attn_chunk=chunk)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, batch = _batch(ref_get_arch(name).reduced())
    out = {}
    for remat in (False, True):
        arch = LMArch(dataclasses.replace(cfg, remat=remat),
                      optimizer="adamw", shapes=REDUCED_SHAPES)
        out[remat] = _grads_and_step(arch, params, batch)
    (g0, p0, n0), (g1, p1, n1) = out[False], out[True]
    assert set(g0) == set(g1)
    for key, a in g0.items():
        np.testing.assert_array_equal(_bits(a), _bits(g1[key]), err_msg=key)
    for (key, a), (_, b) in zip(flatten(p0), flatten(p1)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)
    # two encodes (queries, passages) of n_layers layers
    forward = 2 * cfg.n_layers * (32 // chunk if chunk else 1)
    assert n0 == (2 * forward if chunk else forward)
    assert n1 == (3 * forward if chunk else 2 * forward)


# -- the in-place clip and updates against their old forms -------------------


def _old_clip(grads, max_norm):
    gs = leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.minimum(torch.tensor(1.0, device=gn.device),
                          max_norm / torch.clamp_min(gn, 1e-9))
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def _old_adamw(cfg, grads, state, params, step):
    step = opt._step_tensor(step)
    lr = opt.schedule(cfg, step)
    t = (step + 1).float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for g, mu, nu, p in zip(leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"]), leaves(params)):
        g = g.float()
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))


@torch.no_grad()
def _old_adafactor(cfg, grads, state, params, step):
    step = opt._step_tensor(step)
    lr = opt.schedule(cfg, step)
    b2 = 1.0 - (step + 1.0) ** -0.8
    eps = 1e-30
    for (path, p), g in zip(flatten(params), leaves(grads)):
        v = opt._state_at(state["v"], path)
        g = g.float()
        g2 = g * g + eps
        if "vr" in v:
            v["vr"].copy_(b2 * v["vr"] + (1 - b2) * g2.mean(-1))
            v["vc"].copy_(b2 * v["vc"] + (1 - b2) * g2.mean(-2))
            vr, vc = v["vr"], v["vc"]
            denom = torch.sqrt(vr[..., None] / vr.mean(-1, keepdim=True
                                                       )[..., None]
                               * vc[..., None, :])
        else:
            v["v"].copy_(b2 * v["v"] + (1 - b2) * g2)
            denom = torch.sqrt(v["v"])
        u = g / torch.clamp_min(denom, 1e-30)
        rms_u = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))


def _tree(seed: int, dtype) -> dict:
    """Leaves of every kind the optimizers meet: a stacked factored
    matrix, a factored and an unfactored matrix, a 3-D leaf whose last
    two dims are too small to factor, a vector; some elements exactly
    zero (an embedding row no token reached)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    emb = r(160, 130, scale=0.05)
    emb[7] = 0.0
    return {"blocks": {"w": r(3, 130, 200, scale=0.3),
                       "wq": r(3, 130, 4, 16), "ln": r(3, 130)},
            "embed": emb, "final_ln": r(130, scale=1e-3)}


def _same_tree_bits(got, want, what):
    for (key, a), (_, b) in zip(flatten(got), flatten(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} {key}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_clip_is_bitwise_the_old_form(dtype):
    for seed, max_norm in ((1, 3.0), (2, 1e9)):       # clipped, not clipped
        grads = _tree(seed, dtype)
        want, want_norm = _old_clip(grads, max_norm)
        copy = tree_map(torch.clone, grads)
        got, norm = opt.clip_by_global_norm(copy, max_norm)
        assert got is copy                            # written in place
        assert norm.numpy().tobytes() == want_norm.numpy().tobytes()
        _same_tree_bits(got, want, f"clip at {max_norm}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_in_place_updates_are_bitwise_the_old_forms(name, dtype):
    """5 clipped steps through warmup and the cosine: the parameters and
    the state the same bits after every step."""
    cfg = opt.OptimizerConfig(name=name, learning_rate=0.05,
                              weight_decay=0.01, warmup_steps=2,
                              total_steps=5, grad_clip=3.0)
    old = _old_adamw if name == "adamw" else _old_adafactor
    init, update = opt.make_optimizer(cfg)
    got_p = _tree(0, dtype)
    want_p = tree_map(torch.clone, got_p)
    got_s, want_s = init(got_p), init(want_p)
    for step in range(5):
        grads = _tree(100 + step, dtype)
        want_g, _ = _old_clip(grads, cfg.grad_clip)
        got_g, _ = opt.clip_by_global_norm(tree_map(torch.clone, grads),
                                           cfg.grad_clip)
        step_t = torch.tensor(step, dtype=torch.int32)
        old(cfg, want_g, want_s, want_p, step_t)
        update(got_g, got_s, got_p, step_t)
        _same_tree_bits(got_p, want_p, f"step {step} params")
        _same_tree_bits(got_s, want_s, f"step {step} state")


# -- the launcher ------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_matches_reference(name, tmp_path, monkeypatch):
    """Both launchers on one data dir (written by the reference's), the
    port's trainer starting from the reference's initial parameters: the
    same steps logged, each loss and grad_norm within RTOL."""
    argv = ["--arch", name, "--smoke", "--data-dir", str(tmp_path / "data"),
            "--max_steps", "3", "--log_every", "1",
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
    params = params_from_jax(seen["params"], lm_config(name, True),
                             device="cpu")
    port_init = port_trainer.RetrievalTrainer.init_state
    monkeypatch.setattr(port_trainer.RetrievalTrainer, "init_state",
                        lambda trainer, p=None: port_init(
                            trainer, params if p is None else p))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, state = train.main(argv + [
            "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert trainer.retriever.encoder.cfg == lm_config(name, True)
    assert int(state["step"]) == 3
    want = seen["trainer"].logs
    assert [r["step"] for r in trainer.logs] == [r["step"] for r in want] \
        == [0, 1, 2]
    for got, ref in zip(trainer.logs, want):
        for key in ("loss", "grad_norm"):
            assert math.isfinite(got[key])
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {got['step']} {key}")

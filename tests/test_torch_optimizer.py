"""The port's optimizers, schedule, clipping and int8 compression against
the reference's.

Both packages get the same seeded numpy gradients for 5 steps of AdamW
and of Adafactor, with warmup + cosine decay and clipping active, from
the same parameters (float32, and bf16 for AdamW): clip, then update,
step after step, both updates taking the reference's clipped gradients.
Not bitwise, and why: each elementwise op is the reference's, in the
same order and in float32, but XLA's CPU ``sqrt`` is not correctly
rounded (one ulp off torch's on 10^4 random floats), ``cos`` differs by
one ulp, and the global norm and Adafactor's row / column means are
reductions summed in other orders.  So every parameter, clipped gradient
and optimizer-state leaf is held to ``MAX_ULP`` = 4 units of the last
place of the leaf's largest entry, in the leaf's dtype (an entry near 0
can lose all its digits to cancellation, so per-entry ulps say
nothing); the global norm, a sum of 10^5 squares, to ``NORM_ULP`` = 64
of its own; the schedule to two ulps (warmup bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import grad_compression as ref_gc
from repro.training import optimizer as ref_opt
from repro_torch.training import grad_compression as gc
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import flatten

MAX_ULP = 4
NORM_ULP = 64
EPS_F32, EPS_BF16 = float(np.finfo(np.float32).eps), 2.0 ** -7
SHAPES = {"blocks": {"w": (2, 130, 129), "ln": (2, 8)},
          "embed": (140, 128), "bias": (7,)}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return _tree(lambda s: rng.normal(size=s).astype(np.float32))


def _leaf_ulps(a: np.ndarray, b: np.ndarray, eps: float) -> float:
    """Largest difference in units of ``eps x max|b|``: the last place of
    the leaf's largest entry, the scale a float32 op's rounding works at
    (an entry near 0 may lose every digit to cancellation)."""
    scale = eps * float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale else float(
        np.abs(a - b).max())


def _port_tree(tree, dtype=torch.float32):
    return _tree_map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_trees_close(got, want, max_ulp=MAX_ULP):
    g, w = flatten(got), flatten(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        bf16 = np.asarray(b).dtype == jnp.bfloat16
        assert (a.dtype == torch.bfloat16) == bf16, path
        a, b = _as_np(a), _as_np(b)
        assert a.shape == b.shape, path
        u = _leaf_ulps(a, b, EPS_BF16 if bf16 else EPS_F32)
        assert u <= max_ulp, (path, u)


@pytest.mark.parametrize("name,dtype", (("adamw", "float32"),
                                        ("adamw", "bfloat16"),
                                        ("adafactor", "float32")))
def test_five_steps_match_reference(name, dtype):
    cfg = dict(name=name, learning_rate=0.05, weight_decay=0.01,
               warmup_steps=2, total_steps=5, grad_clip=3.0)
    ref_cfg, port_cfg = ref_opt.OptimizerConfig(**cfg), \
        opt.OptimizerConfig(**cfg)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    start = _params(0)
    jp = _tree_map(lambda a: jnp.asarray(a, jdt), start)
    tp = _port_tree(start, tdt)
    r_init, r_update = ref_opt.make_optimizer(ref_cfg)
    p_init, p_update = opt.make_optimizer(port_cfg)
    jstate, tstate = r_init(jp), p_init(tp)
    _assert_trees_close(tstate, jstate, 0)
    clipped = 0
    for step in range(5):
        grads = _params(100 + step)
        jg, jn = ref_opt.clip_by_global_norm(
            _tree_map(lambda a: jnp.asarray(a, jdt), grads), 3.0)
        tg, tn = opt.clip_by_global_norm(_port_tree(grads, tdt), 3.0)
        clipped += float(jn) > 3.0
        assert _leaf_ulps(tn.numpy(), np.asarray(jn), EPS_F32) <= NORM_ULP
        _assert_trees_close(tg, jg)
        # both updates take the reference's clipped gradients: a bf16
        # gradient one rounding apart would move mu by (1 - b1) of a bf16
        # ulp, which is not the update's error
        tg = _tree_map(lambda a: torch.tensor(
            np.asarray(a, np.float32)).to(tdt), jg)
        jp, jstate = r_update(jg, jstate, jp, jnp.asarray(step, jnp.int32))
        out = p_update(tg, tstate, tp, torch.tensor(step, dtype=torch.int32))
        assert out[0] is tp and out[1] is tstate        # in place
        _assert_trees_close(tp, jp)
        _assert_trees_close(tstate, jstate)
    assert clipped == 5


def test_schedule_within_two_ulps():
    """Warmup is bitwise; with the cosine the rate is within two ulps
    (one ulp of ``cos``, carried through ``0.55 + 0.45 cos`` and the
    product)."""
    for cfg in (dict(learning_rate=0.003, warmup_steps=7, total_steps=40),
                dict(learning_rate=1.0, warmup_steps=0, total_steps=10),
                dict(learning_rate=0.1, warmup_steps=3)):
        for step in range(45):
            want = np.float32(ref_opt.schedule(ref_opt.OptimizerConfig(**cfg),
                                               jnp.asarray(step, jnp.int32)))
            got = opt.schedule(opt.OptimizerConfig(**cfg),
                               torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= 2 * np.spacing(want), (
                cfg, step)
            if step < cfg["warmup_steps"] or "total_steps" not in cfg:
                assert got.numpy().tobytes() == want.tobytes(), (cfg, step)


def test_schedule_warmup_cosine():
    cfg = opt.OptimizerConfig(learning_rate=1.0, warmup_steps=10,
                              total_steps=100)
    assert float(opt.schedule(cfg, 0)) < 0.2
    assert float(opt.schedule(cfg, 9)) > 0.9
    assert float(opt.schedule(cfg, 99)) < 0.2


def test_grad_clip_keeps_dtype():
    g = {"a": torch.tensor([3.0, 4.0]),
         "b": torch.tensor([0.0], dtype=torch.bfloat16)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0, rel=1e-6)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)
    assert clipped["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_optimizer_descends(name):
    cfg = opt.OptimizerConfig(name=name, learning_rate=0.1,
                              weight_decay=0.0)
    init, update = opt.make_optimizer(cfg)
    params = {"w": torch.tensor([3.0, -2.0, 1.5]),
              "m": torch.ones(4, 130) * 2.0}     # a factored leaf
    state = init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + (p["m"] ** 2).sum()

    l0 = float(loss(params))
    for t in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        update(grads, state, params, t)
    assert float(loss(params)) < l0 * 0.05
    with pytest.raises(ValueError):
        opt.make_optimizer(opt.OptimizerConfig(name="sgd"))


def test_adafactor_state_layout_matches_reference():
    cfg = dict(name="adafactor")
    start = _params(0)
    want = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**cfg))[0](
        _tree_map(jnp.asarray, start))
    got = opt.make_optimizer(opt.OptimizerConfig(**cfg))[0](
        _port_tree(start))
    assert [(p, tuple(v.shape)) for p, v in flatten(got)] == [
        ("/".join(str(k.key) for k in path), tuple(v.shape))
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]]


def test_int8_quantization_matches_reference():
    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]                  # ties round to even
    q, scale = gc.quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_gc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
    deq = gc.dequantize_int8(q, scale)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(ref_gc.dequantize_int8(rq, rscale)))
    assert np.abs(deq.numpy() - x).max() <= float(scale) / 2 + 1e-7


def test_error_feedback_converges():
    """EF-int8 SGD reaches the optimum a plain-int8 SGD would circle."""
    w = torch.tensor([1.0, -1.0, 0.5])
    target = torch.tensor([0.3, 0.7, -0.2])
    ef = gc.init_error_feedback({"w": w})["w"]
    for _ in range(150):
        g_ef = (w - target) + ef
        q, s = gc.quantize_int8(g_ef)
        deq = gc.dequantize_int8(q, s)
        ef = g_ef - deq
        w = w - 0.2 * deq
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=5e-3)

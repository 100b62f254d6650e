"""The port's EmbeddingBag backward (K4T's plain path, the wrapper and the
autograd ``ops.embedding_bag``) against the reference.

The reference has no Pallas backward: it differentiates its bag sums
through XLA.  The oracle is ``jax.vjp`` of the reference's plain
``repro.kernels.ref.embedding_bag_ref`` with respect to the table, fed
the same numpy inputs made from a seed.  On integer-valued gradients,
tables and weights every sum is exact: **bitwise equal** (up to the
sign of a zero, which ``assert_array_equal`` does not tell apart).  On
random normals the two add a row's contributions in different orders:
rtol 1e-5 / atol 1e-5 (a row of these shapes sums up to ~40 products of
normals, each sum carrying ~1e-6 of float32 rounding).  bfloat16 is
compared in float32 after one rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5

# (V, D, B, L): the forward tests' shapes (test_torch_embedding_bag.py),
# the recsys path's D = 1 / 10 over 39 fields among them
SHAPES = [(20, 8, 5, 3), (100, 32, 16, 10), (64, 1, 7, 39), (64, 10, 9, 39),
          (64, 10, 13, 1), (300, 1, 33, 1)]


def _inputs(rng, v, d, b, n_slots, ints):
    if ints:
        g = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
        w = rng.integers(-2, 3, size=(b, n_slots)).astype(np.float32)
    else:
        g = rng.normal(size=(b, d)).astype(np.float32)
        w = rng.normal(size=(b, n_slots)).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, n_slots)).astype(np.int32)
    return g, idx, w


def _want(g, idx, w, v):
    """The reference's table gradient: jax.vjp of its plain bag sum."""
    table = jnp.zeros((v, g.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(
        t, jnp.asarray(idx), None if w is None else jnp.asarray(w)), table)
    return np.asarray(vjp(jnp.asarray(g))[0])


def _got(g, idx, w, v):
    return ref.embedding_bag_backward_ref(
        torch.from_numpy(g), torch.from_numpy(idx), v,
        None if w is None else torch.from_numpy(w))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,d,b,n_slots", SHAPES)
def test_matches_reference_vjp_on_integers_bitwise(v, d, b, n_slots,
                                                   weighted):
    rng = np.random.default_rng(10 + v * d + b * n_slots)
    g, idx, w = _inputs(rng, v, d, b, n_slots, ints=True)
    w = w if weighted else None
    got = _got(g, idx, w, v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    np.testing.assert_array_equal(got.numpy(), _want(g, idx, w, v))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,d,b,n_slots", SHAPES)
def test_matches_reference_vjp_on_floats(v, d, b, n_slots, weighted):
    rng = np.random.default_rng(11 + v * d + b * n_slots)
    g, idx, w = _inputs(rng, v, d, b, n_slots, ints=False)
    w = w if weighted else None
    np.testing.assert_allclose(_got(g, idx, w, v).numpy(),
                               _want(g, idx, w, v), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["id_past_table", "inf_grad_padded",
                                  "inf_weight_padded", "nan_grad_used"])
def test_non_finite_edges_follow_reference(case):
    """A padded slot read row 0 with mask 0, so it adds (g * 0) * w there:
    NaN where g or the weight is not finite.  An id >= V read no row and
    adds nothing.  NaN lands where the reference's lands, and nowhere
    else."""
    rng = np.random.default_rng(12)
    g, idx, w = _inputs(rng, 12, 4, 6, 5, ints=True)
    idx = np.maximum(idx, 1)                     # row 0 only as padding
    if case == "id_past_table":
        idx[2, 3] = 12
        idx[4, 1] = 10_000
        g[4] = np.nan                     # its bag's rows NaN, not row 0
    elif case == "inf_grad_padded":
        idx[1, 2] = -1
        g[1, 0] = np.inf
    elif case == "inf_weight_padded":
        idx[3, 4] = -1
        w[3, 4] = np.inf
    else:
        g[5, 1] = np.nan
    got, want = _got(g, idx, w, 12).numpy(), _want(g, idx, w, 12)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    assert np.isnan(got[0]).any() == case.endswith("_padded")
    np.testing.assert_array_equal(got, want)          # NaN == NaN here


@pytest.mark.parametrize("b,n_slots", [(4, 6), (4, 0), (0, 6)])
def test_all_padded_and_empty_give_zeros(b, n_slots):
    """All slots padded adds (g * 0) to row 0, a zero; L = 0 and B = 0
    touch no row."""
    rng = np.random.default_rng(13)
    g, idx, _ = _inputs(rng, 10, 3, b, n_slots, ints=False)
    idx = np.full_like(idx, -1)
    got, want = _got(g, idx, None, 10).numpy(), _want(g, idx, None, 10)
    assert got.shape == (10, 3) and not got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ints", [True, False])
def test_bfloat16_grad_compared_in_float32(ints):
    """A bf16 gradient is summed in float32 and rounded once; the
    reference, given the same values in float32, must agree after that
    rounding (bitwise on integers, within one bf16 step on floats)."""
    rng = np.random.default_rng(14)
    g, idx, w = _inputs(rng, 50, 10, 20, 39, ints=ints)
    g16 = torch.from_numpy(g).bfloat16()
    got = ref.embedding_bag_backward_ref(g16, torch.from_numpy(idx), 50,
                                         torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = _want(g16.float().numpy(), idx, w, 50)
    want16 = torch.tensor(want).bfloat16().float().numpy()
    if ints:
        np.testing.assert_array_equal(got.float().numpy(), want16)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-4)


def test_plain_version_sums_in_flat_position_order():
    """Each row adds its contributions in ascending b * L + l: (1e8 + 1)
    - 1e8 is 0 in that order, which the kernel reproduces bitwise."""
    g = torch.tensor([[1e8], [1.0], [-1e8]])
    idx = torch.tensor([[2], [2], [2]], dtype=torch.int32)
    assert ref.embedding_bag_backward_ref(g, idx, 3)[2].item() == 0.0
    g = torch.tensor([[1e8, 1.0, -1e8]]).T[[0, 2, 1]]
    assert ref.embedding_bag_backward_ref(g, idx, 3)[2].item() == 1.0
    # within one bag, slot order: bag 0's slots 0 and 2, then bag 1's
    g = torch.tensor([[1e8], [1.0]])
    idx = torch.tensor([[0, -1, 0], [0, 1, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, 5.0, -1.0], [1.0, 2.0, 3.0]])
    out = ref.embedding_bag_backward_ref(g, idx, 2, w)
    assert out[0].item() == 1.0 and out[1].item() == 5.0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ints", [True, False])
def test_autograd_embedding_bag_matches_autograd_of_plain_forward(ints,
                                                                  weighted):
    """``ops.embedding_bag`` is differentiable in its table: its backward
    (K4T's plain version here) against autograd of the plain forward,
    bitwise on integers.  A strided upstream gradient (DeepFM's ``[:,
    0]`` of a (B, 1) sum) goes through too."""
    rng = np.random.default_rng(15 + ints + 2 * weighted)
    g, idx, w = _inputs(rng, 64, 1, 40, 39, ints=ints)
    if ints:
        table = rng.integers(-3, 4, size=(64, 1)).astype(np.float32)
    else:
        table = rng.normal(size=(64, 1)).astype(np.float32)
    wt = torch.from_numpy(w) if weighted else None
    grads = []
    for fwd in (ops.embedding_bag, ref.embedding_bag_ref):
        t = torch.from_numpy(table).requires_grad_(True)
        out = fwd(t, torch.from_numpy(idx), wt)[:, 0]
        (out * torch.from_numpy(g[:, 0])).sum().backward()
        grads.append(t.grad.numpy())
    if ints:
        np.testing.assert_array_equal(grads[0], grads[1])
    else:
        np.testing.assert_allclose(grads[0], grads[1], rtol=RTOL, atol=ATOL)


def test_autograd_through_a_bf16_table_and_no_bags():
    t = torch.zeros((5, 3), dtype=torch.bfloat16, requires_grad=True)
    out = ops.embedding_bag(t, torch.tensor([[1, -1]], dtype=torch.int32))
    out.float().sum().backward()
    assert t.grad.dtype == torch.bfloat16
    assert t.grad[1].tolist() == [1.0] * 3 and not t.grad[2:].any()
    t = torch.zeros((5, 3), requires_grad=True)
    out = ops.embedding_bag(t, torch.zeros((0, 4), dtype=torch.int32))
    assert out.shape == (0, 3)
    out.sum().backward()
    assert t.grad.shape == (5, 3) and not t.grad.any()


def test_weights_gradient_raises():
    t = torch.zeros((5, 3), requires_grad=True)
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="weights"):
        ops.embedding_bag(t, idx, torch.ones((2, 4), requires_grad=True))


def test_backward_keys_sort_stably_with_padding_as_row_0():
    """Padding sorts past every row (PAD_KEY), where the kernel's row
    ranges never reach it; it adds to row 0 only as the first pass's NaN
    columns."""
    idx = torch.tensor([[3, -1, 0], [3, 2, -1]], dtype=torch.int32)
    keys, order = bag.backward_keys(idx)
    pad = bag.PAD_KEY
    assert pad == 2 ** 31 - 1
    assert keys.tolist() == [0, 2, 3, 3, pad, pad]
    assert order.tolist() == [2, 4, 0, 3, 1, 5]
    assert keys.dtype == order.dtype == torch.int32


def test_wrapper_validates_and_counts_nothing_on_cpu():
    bag.reset_launch_counts()
    g = torch.ones((3, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    out = torch.full((8, 4), 7.0)
    bag.embedding_bag_backward_(out, g, idx, torch.ones((3, 2)))
    assert out[0].tolist() == [6.0] * 4 and not out[1:].any()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bag.embedding_bag_backward_(out.double(), g.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        bag.embedding_bag_backward_(out, g, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        bag.embedding_bag_backward_(out, torch.ones((4, 3)).T, idx)
    with pytest.raises(ValueError, match="out"):
        bag.embedding_bag_backward_(out.bfloat16(), g, idx)
    with pytest.raises(ValueError, match="do not agree"):
        bag.embedding_bag_backward_(torch.empty((8, 5)), g, idx)
    with pytest.raises(ValueError, match="do not agree"):
        bag.embedding_bag_backward_(out, g, idx[:2])
    with pytest.raises(ValueError, match="weights"):
        bag.embedding_bag_backward_(out, g, idx, torch.ones((3, 3)))
    with pytest.raises(ValueError, match="no rows"):
        bag.embedding_bag_backward_(torch.empty((0, 4)), g, idx)
    assert bag.LAUNCHES == {"embedding_bag": 0, "embedding_bag_backward": 0}
    assert ops.launch_counts()["embedding_bag_backward"] == 0


# -- one sort per DeepFM backward (ops.BagKeys) -------------------------------

def _recsys_grads(name, monkeypatch, shared=True, no_grad=False,
                  serve=False):
    """One forward (and, unless ``no_grad`` or ``serve``, one backward) of
    a reduced recsys arch on the CPU, with the K4T wrapper standing in for
    the card's path (it sorts the ids before the plain version runs, by
    the BagKeys where one is given) and every sort counted.  Returns the
    gradients by name and the number of sorts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.models.losses import BCELoss

    arch = get_arch(name).reduced()
    params = recsys.init_params(arch.cfg, torch.Generator().manual_seed(0),
                                "cpu")
    rng = np.random.default_rng(3)
    batch = arch.smoke_inputs("train_batch", rng, "cpu")
    sorts = []
    plain_keys, plain_backward = bag.backward_keys, bag.embedding_bag_backward_

    def counted_keys(idx):
        sorts.append(idx.shape)
        return plain_keys(idx)

    def card_like(out, grad_out, idx, weights=None, *, keys=None):
        if keys is not None:
            keys.sorted()
        else:
            bag.backward_keys(idx)
        plain_backward(out, grad_out, idx, weights, keys=keys)

    monkeypatch.setattr(bag, "backward_keys", counted_keys)
    monkeypatch.setattr(bag, "embedding_bag_backward_", card_like)
    if not shared:
        monkeypatch.setattr(ops, "BagKeys", lambda idx: None)
    if serve:
        arch.build_cell("serve_p99", device="cpu").fn(params, batch)
        return {}, len(sorts)
    leaves = {k: p.detach().requires_grad_(not no_grad)
              for k, p in params.items()}
    if no_grad:
        with torch.no_grad():
            recsys.forward(arch.cfg, leaves, batch)
        return {}, len(sorts)
    loss = BCELoss()(recsys.forward(arch.cfg, leaves, batch),
                     batch["labels"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), len(sorts)


def test_deepfm_step_gradients_bitwise_with_and_without_shared_keys(
        monkeypatch):
    """DeepFM's two bag sums share one BagKeys: every gradient of its loss
    is bitwise what it is with a sort per bag sum."""
    with_keys, _ = _recsys_grads("deepfm", monkeypatch)
    monkeypatch.undo()
    without, _ = _recsys_grads("deepfm", monkeypatch, shared=False)
    assert with_keys.keys() == without.keys()
    for name, g in with_keys.items():
        assert torch.equal(g.view(torch.int32),
                           without[name].view(torch.int32)), name
    assert with_keys["linear_table"].any() and with_keys["table"].any()


@pytest.mark.parametrize("case,want", [
    ("deepfm backward", 1), ("deepfm backward, no BagKeys", 2),
    ("wide-deep backward", 1), ("deepfm no_grad forward", 0),
    ("deepfm serve_p99", 0), ("wide-deep serve_p99", 0)])
def test_backward_sorts_once_per_deepfm_backward_and_never_without_one(
        case, want, monkeypatch):
    """The card's path sorts the ids once per DeepFM backward (both bag
    sums share the BagKeys), once per Wide&Deep backward (one bag sum), and
    never in a forward under no_grad or in serving."""
    name = case.split()[0]
    _, sorts = _recsys_grads(name, monkeypatch,
                             shared="no BagKeys" not in case,
                             no_grad="no_grad" in case,
                             serve="serve" in case)
    assert sorts == want


def test_bag_keys_built_on_other_ids_raise():
    rng = np.random.default_rng(16)
    idx = torch.from_numpy(rng.integers(-1, 9, (6, 4)).astype(np.int32))
    other = idx.clone()
    keys = ops.BagKeys(idx)
    table = torch.zeros((9, 3), requires_grad=True)
    g = torch.ones((6, 3))
    out = torch.empty((9, 3))
    # the ids it was built on, and their int64 source, are taken
    ops.embedding_bag(table, idx, keys=keys).sum().backward()
    wide = idx.long()
    assert ops.BagKeys(wide).ids_for(wide).dtype == torch.int32
    bag.embedding_bag_backward_(out, g, idx, keys=keys)
    # equal values in another tensor are other ids
    with pytest.raises(ValueError, match="other ids"):
        ops.embedding_bag(table, other, keys=keys)
    with pytest.raises(ValueError, match="other ids"):
        bag.embedding_bag_backward_(out, g, other, keys=keys)
    with pytest.raises(ValueError, match="other ids"):
        bag.embedding_bag_backward_(out, g[:3], idx[:3], keys=ops.BagKeys(
            idx[:3].clone()))
    # sorted once, then changed in place: the sort is stale
    first = keys.sorted()
    assert keys.sorted() is first
    assert torch.equal(first[0], bag.backward_keys(idx)[0])
    idx[0, 0] = 5
    with pytest.raises(RuntimeError, match="changed in place"):
        keys.sorted()

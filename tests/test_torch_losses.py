"""The port's retrieval losses against the reference's.

Every registered alias on the same seeded numpy scores and labels: the
value and the gradient with respect to the scores from
``jax.value_and_grad`` of ``repro.models.losses`` against torch autograd
of ``repro_torch.models.losses``, within rtol 1e-5 / atol 1e-6 (float32,
the two frameworks' softmax / logsumexp / cumsum round differently in
the last bits).  Integer labels (the positive's index) and graded labels
(Q, P) with -1 padding, ties among the grades included (``ws`` sorts by
grade stably, as ``jnp.argsort``), and scores with exact zeros (``|x|``
takes JAX's derivative there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import losses as ref_losses
from repro_torch.models import losses

RTOL, ATOL = 1e-5, 1e-6
Q, P = 6, 9


def _scores(seed=0):
    s = np.random.default_rng(seed).normal(size=(Q, P)).astype(np.float32)
    s[0, :3] = 0.0                      # exact zeros: |x| and max(x, 0)
    return s * 3.0


def _graded(seed=1, ties=True):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 4, size=(Q, P)).astype(np.float32)
    lab[:, -2:] = -1.0                  # padding
    lab[1, -4:] = -1.0
    if ties:
        lab[2, :5] = 2.0                # a run of equal grades
    else:
        lab[:, :P - 2] = np.argsort(rng.random((Q, P - 2)), 1) * 0.5
    return lab


def _both(alias, scores, labels):
    ref = ref_losses.get_loss(alias)
    val, grad = jax.value_and_grad(
        lambda s: ref(s, jnp.asarray(labels)))(jnp.asarray(scores))
    st = torch.tensor(scores, requires_grad=True)
    got = losses.get_loss(alias)(st, torch.from_numpy(labels))
    got.backward()
    return (float(val), np.asarray(grad)), (float(got.detach()), st.grad.numpy())


def _check(alias, scores, labels):
    (want, want_g), (got, got_g) = _both(alias, scores, labels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)


def test_registry_matches_reference():
    assert set(losses.LOSS_REGISTRY) == set(ref_losses.LOSS_REGISTRY) == {
        "infonce", "kl", "ws", "listnet", "bce"}


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_infonce_integer_labels(seed):
    labels = np.random.default_rng(seed).integers(0, P, size=Q).astype(
        np.int32)
    _check("infonce", _scores(seed), labels)


@pytest.mark.parametrize("alias", ("infonce", "kl", "ws", "listnet"))
@pytest.mark.parametrize("ties", (True, False), ids=("ties", "distinct"))
def test_graded_losses(alias, ties):
    _check(alias, _scores(3), _graded(4, ties))


@pytest.mark.parametrize("dtype", (np.int32, np.float32))
def test_bce(dtype):
    labels = np.random.default_rng(5).integers(0, 2, size=(Q, P)).astype(
        dtype)
    _check("bce", _scores(5), labels)


def test_ws_sorts_equal_grades_stably():
    """A row of equal grades: a stable sort keeps the candidate order, an
    unstable one would permute the cumulative sums and change W1."""
    labels = np.full((Q, P), 1.0, np.float32)
    labels[:, 0] = 3.0
    _check("ws", _scores(6), labels)


def test_fully_padded_row_stays_finite():
    labels = _graded(7)
    labels[3] = -1.0
    for alias in ("infonce", "kl", "ws", "listnet"):
        (want, want_g), (got, got_g) = _both(alias, _scores(7), labels)
        assert np.isfinite(got) and np.isfinite(got_g).all(), alias
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)


def test_biencoder_scores_and_user_losses():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(3, 5)).astype(np.float32)
    p = rng.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        losses.biencoder_scores(torch.from_numpy(q), torch.from_numpy(p),
                                0.05).numpy(),
        np.asarray(ref_losses.biencoder_scores(jnp.asarray(q),
                                               jnp.asarray(p), 0.05)),
        rtol=RTOL, atol=ATOL)
    inst = losses.InfoNCELoss()
    assert losses.get_loss(inst) is inst
    fn = lambda s, lab: s.sum()                       # noqa: E731
    assert losses.get_loss(fn) is fn
    with pytest.raises(TypeError):
        losses.get_loss(3)


@pytest.mark.parametrize("alias", ("kl", "ws", "listnet"))
def test_graded_losses_refuse_integer_labels(alias):
    with pytest.raises(ValueError, match="graded"):
        losses.get_loss(alias)(torch.zeros(Q, P), torch.zeros(Q))

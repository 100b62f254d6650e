"""The port's retrievers against the reference's: forward and gradients.

trove-base cut to 2 x 64 in float32 (``trove_base.reduced()``, the
reference's ``get_arch("trove-base").reduced()``), the reference's
seeded parameters carried across by ``params_from_jax``, one collated
batch of synthetic data (the collator and tokenizer of both packages
make the same arrays).  The loss, the metrics and every parameter's
gradient from ``jax.value_and_grad(forward)`` against torch autograd:
loss and metrics within rtol 1e-5; a gradient within atol 2e-5 x its
leaf's largest entry (float32 through two layers and a 1/temperature
of 20; the frameworks sum the products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.collator import RetrievalCollator as RefCollator
from repro.core.config import DataArguments as RefDataArguments
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models import encoder as ref_encoder
from repro.models import retriever as ref_retriever
from repro_torch.configs import trove_base
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, ModelArguments
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import retriever
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.training.tree import flatten, unflatten

torch.set_num_threads(1)

GRAD_REL = 2e-5
WORDS = "alpha bravo charlie delta echo foxtrot golf hotel india".split()


@pytest.fixture(scope="module")
def models():
    jcfg = ref_get_arch("trove-base").reduced().cfg
    cfg = trove_base.reduced()
    jparams = ref_encoder.DefaultEncoder(jcfg).init_params(
        jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def _features(n_q=4, group=3, graded=False, seed=0):
    rng = np.random.default_rng(seed)

    def text(n):
        return " ".join(rng.choice(WORDS, size=n))

    feats = []
    for i in range(n_q):
        f = {"query": text(4 + i), "passages": [text(10 + 3 * j)
                                                for j in range(group)]}
        if graded:
            lab = rng.integers(0, 4, size=group).astype(np.float32)
            lab[-1] = -1.0
            f["labels"] = lab
        feats.append(f)
    return feats


def _batch(feats, vocab=512):
    ref = RefCollator(RefDataArguments(vocab_size=vocab,
                                       query_max_len=16,
                                       passage_max_len=40),
                      RefTokenizer(vocab))(feats)
    port = RetrievalCollator(DataArguments(vocab_size=vocab,
                                           query_max_len=16,
                                           passage_max_len=40),
                             HashTokenizer(vocab))(feats)
    for (path, a), (_, b) in zip(flatten(ref), flatten(port)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    return ref


def _port_forward(retr, params, batch):
    leaves = [p.detach().requires_grad_(True) for _, p in flatten(params)]
    tp = unflatten(params, leaves)
    tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in batch.items()}
    loss, metrics = retr.forward(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            dict(zip([p for p, _ in flatten(params)], grads)))


def _ref_forward(retr, jparams, batch):
    jb = jax.tree.map(jnp.asarray, batch)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: retr.forward(p, jb), has_aux=True)(jparams)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {"/".join(str(k.key) for k in path): np.asarray(g)
             for path, g in flat})


def _compare(got, want):
    loss, metrics, grads = got
    wloss, wmetrics, wgrads = want
    np.testing.assert_allclose(loss, wloss, rtol=1e-5)
    assert set(metrics) == set(wmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k], wmetrics[k], rtol=1e-5,
                                   err_msg=k)
    assert set(grads) == set(wgrads)
    for path, w in wgrads.items():
        g = grads[path].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-12,
                                   err_msg=path)


@pytest.mark.parametrize("labels", (False, True), ids=("default", "given"))
def test_biencoder_forward_and_grads(models, labels):
    loss = "infonce"
    jcfg, cfg, jparams, params = models
    batch = _batch(_features())
    if labels:
        batch["labels"] = np.array([0, 4, 8, 10], np.int32)
    want = _ref_forward(ref_retriever.BiEncoderRetriever(
        ref_encoder.DefaultEncoder(jcfg), loss, 0.05), jparams, batch)
    got = _port_forward(retriever.BiEncoderRetriever(
        DefaultEncoder(cfg), loss, 0.05), params, batch)
    _compare(got, want)
    assert set(got[1]) == {"contrastive_loss", "in_batch_accuracy"}


@pytest.mark.parametrize("loss", ("kl", "ws", "listnet", "infonce"))
def test_graded_biencoder_forward_and_grads(models, loss):
    jcfg, cfg, jparams, params = models
    batch = _batch(_features(graded=True, seed=1))
    want = _ref_forward(ref_retriever.GradedBiEncoderRetriever(
        ref_encoder.DefaultEncoder(jcfg), loss, 0.05), jparams, batch)
    got = _port_forward(retriever.GradedBiEncoderRetriever(
        DefaultEncoder(cfg), loss, 0.05), params, batch)
    _compare(got, want)
    assert set(got[1]) == {"graded_loss"}


def test_in_batch_accuracy_takes_the_first_of_tied_maxima():
    """Every score equal: argmax is index 0, so only query 0 (positive at
    0) counts as right."""

    class Constant:
        def encode(self, params, batch):
            return torch.ones(batch["tokens"].shape[0], 4)

    retr = retriever.BiEncoderRetriever(Constant())
    toks = torch.zeros(3, 2, dtype=torch.int32)
    _, metrics = retr.forward({}, {"query": {"tokens": toks},
                                   "passage": {"tokens": toks.repeat(2, 1)}})
    assert float(metrics["in_batch_accuracy"]) == pytest.approx(1 / 3)


def test_user_loss_and_user_encoder(models):
    """Paper §3.3: any callable as the loss and any object with the
    encoder duck-type as the encoder."""
    _, cfg, _, _ = models

    class BagEncoder:
        """Mean of token embeddings, L2-normalised: a user model."""

        def init_params(self, generator, device="cpu"):
            return {"table": torch.randn(512, 16, generator=generator)}

        def encode(self, params, batch):
            emb = params["table"][batch["tokens"].long()]
            m = batch["mask"].float()[..., None]
            e = (emb * m).sum(1) / m.sum(1).clamp_min(1.0)
            return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-9)

        def format_query(self, text):
            return "q: " + text

        def format_passage(self, text, title=""):
            return text

    calls = []

    def margin(scores, labels):
        calls.append(scores.shape)
        pos = scores.gather(1, labels.long()[:, None])
        return torch.relu(1.0 - pos + scores).mean()

    retr = retriever.BiEncoderRetriever.from_model_args(
        ModelArguments(temperature=0.1), None, encoder=BagEncoder())
    retr.loss = retriever.get_loss(margin)
    params = retr.init_params(torch.Generator().manual_seed(0), "cpu")
    params["table"].requires_grad_(True)
    batch = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
             for k, v in _batch(_features()).items()}
    loss, metrics = retr.forward(params, batch)
    loss.backward()
    assert calls == [(4, 12)] and torch.isfinite(loss)
    assert params["table"].grad.abs().sum() > 0
    assert retr.format_query("x") == "q: x"
    assert "in_batch_accuracy" in metrics


def test_registry_and_from_model_args(models):
    _, cfg, _, _ = models
    assert set(retriever.RETRIEVER_REGISTRY) == {"biencoder",
                                                 "graded_biencoder"}
    retr = retriever.BiEncoderRetriever.from_model_args(
        ModelArguments(loss="ws", temperature=0.3), cfg)
    assert isinstance(retr.encoder, DefaultEncoder)
    assert type(retr.loss).__name__ == "WassersteinLoss"
    assert retr.temperature == 0.3
    fn = retriever.make_train_loss_fn(retr)
    assert callable(fn)

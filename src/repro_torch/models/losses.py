"""Retrieval loss registry (paper §3.3).

Losses subclass :class:`RetrievalLoss` and self-register under ``_alias``
(the paper's customization mechanism: ``--loss=ws`` etc.).  All losses
consume ``scores (Q, P)`` and ``labels``:

  * integer labels ``(Q,)``   — index of the positive (InfoNCE/binary data)
  * graded labels ``(Q, P)``  — multi-level relevance (MultiLevelDataset)

The port of ``repro.models.losses``.  Where the frameworks differ, the
reference's numerics are kept: masks are -1e30 (not -inf), the graded
target's sum is clipped at 1e-9, ``ws`` sorts the labels stably (as
``jnp.argsort`` does), and ``|x|`` has JAX's derivative at 0 (+1, where
``torch.abs`` gives 0).
"""

from __future__ import annotations

import torch

LOSS_REGISTRY: dict[str, type["RetrievalLoss"]] = {}


class RetrievalLoss:
    _alias: str = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls._alias:
            LOSS_REGISTRY[cls._alias] = cls

    def __call__(self, scores: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def get_loss(alias_or_obj) -> RetrievalLoss:
    if isinstance(alias_or_obj, RetrievalLoss):
        return alias_or_obj
    if isinstance(alias_or_obj, str):
        return LOSS_REGISTRY[alias_or_obj]()
    if callable(alias_or_obj):          # arbitrary user callable
        return alias_or_obj
    raise TypeError(alias_or_obj)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s derivative: +1 at x = 0."""
    return torch.where(x >= 0, x, -x)


def _graded_only(labels: torch.Tensor, name: str) -> None:
    if labels.ndim != 2:
        raise ValueError(f"{name} needs graded (Q, P) labels, got shape "
                         f"{tuple(labels.shape)}")


def _masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, scores, -1e30)


def _graded_target(labels: torch.Tensor):
    """Normalize graded labels (Q,P) to a target distribution."""
    lab = labels.float()
    mask = lab >= 0                      # -1 == padding
    w = torch.where(mask, lab, 0.0)
    z = w.sum(-1, keepdim=True).clamp_min(1e-9)
    return w / z, mask


class InfoNCELoss(RetrievalLoss):
    """Softmax cross-entropy against the positive index (DPR/Karpukhin)."""

    _alias = "infonce"

    def __call__(self, scores, labels):
        if labels.ndim == 1:
            logz = torch.logsumexp(scores, dim=-1)
            pos = torch.gather(scores, -1, labels.long()[:, None])[:, 0]
            return (logz - pos).mean()
        # graded: treat every doc with max grade as positive (multi-positive CE)
        tgt, mask = _graded_target(labels)
        logp = torch.log_softmax(_masked(scores, mask), dim=-1)
        return -(tgt * logp).sum(-1).mean()


class KLDivergenceLoss(RetrievalLoss):
    """KL(target || softmax(scores)) for graded labels (distillation)."""

    _alias = "kl"

    def __call__(self, scores, labels):
        _graded_only(labels, "the kl loss")
        tgt, mask = _graded_target(labels)
        logp = torch.log_softmax(_masked(scores, mask), dim=-1)
        logt = torch.log(tgt.clamp_min(1e-9))
        kl = torch.where(tgt > 0, tgt * (logt - logp), 0.0).sum(-1)
        return kl.mean()


class WassersteinLoss(RetrievalLoss):
    """1-D W1 between score distribution and label distribution (SyCL §4.1).

    Candidates are a discrete support; W1 = sum |CDF_p - CDF_q| over the
    label-sorted candidate axis (equal labels keep their order).
    """

    _alias = "ws"

    def __call__(self, scores, labels):
        _graded_only(labels, "the ws loss")
        tgt, mask = _graded_target(labels)
        order = torch.argsort(-labels, dim=-1, stable=True)
        p = torch.softmax(_masked(scores, mask), dim=-1)
        p_s = torch.gather(p, -1, order)
        q_s = torch.gather(tgt, -1, order)
        w1 = _abs(torch.cumsum(p_s - q_s, dim=-1)).sum(-1)
        return w1.mean()


class ListNetLoss(RetrievalLoss):
    """Cross entropy between label softmax and score softmax."""

    _alias = "listnet"

    def __call__(self, scores, labels):
        _graded_only(labels, "the listnet loss")
        mask = labels >= 0
        tgt = torch.softmax(_masked(labels.float(), mask), dim=-1)
        logp = torch.log_softmax(_masked(scores, mask), dim=-1)
        return -(tgt * logp).sum(-1).mean()


class BCELoss(RetrievalLoss):
    """Pointwise sigmoid BCE (recsys CTR training)."""

    _alias = "bce"

    def __call__(self, scores, labels):
        lab = labels.float()
        return (torch.maximum(scores, torch.zeros_like(scores))
                - scores * lab
                + torch.log1p(torch.exp(-_abs(scores)))).mean()


def biencoder_scores(q_emb: torch.Tensor, p_emb: torch.Tensor,
                     temperature: float = 0.02) -> torch.Tensor:
    """In-batch similarity (Q, P_total) over the whole batch: every other
    query's passages are this query's negatives."""
    return torch.einsum("qd,pd->qp", q_emb, p_emb) / temperature

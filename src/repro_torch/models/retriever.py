"""Retriever = encoder + loss + retrieval logic (paper §3.3).

``BiEncoderRetriever`` encodes queries and passages with one encoder and
trains with in-batch negatives: the loss is written over the whole
batch's (Q, P) score matrix, so every other query's passages are a
query's negatives.  ``GradedBiEncoderRetriever`` trains on graded groups
(``MultiLevelDataset``).  Subclasses self-register under ``_alias``.

``forward(params, batch)`` takes a batch of tensors on the encoder's
device (the trainer moves the collator's numpy arrays there) and returns
``(loss, metrics)``; autograd through it gives every parameter's
gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.config import ModelArguments
from repro_torch.models.encoder import PretrainedEncoder, get_encoder
from repro_torch.models.losses import biencoder_scores, get_loss
from repro_torch.sharding import collectives
from repro_torch.sharding.layout import gather_rows
from repro_torch.sharding.partitioning import data_axes

RETRIEVER_REGISTRY: dict[str, type["PretrainedRetriever"]] = {}


class PretrainedRetriever:
    _alias = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls._alias:
            RETRIEVER_REGISTRY[cls._alias] = cls

    def __init__(self, encoder: PretrainedEncoder, loss="infonce",
                 temperature=0.02, aux_loss_weight: float = 0.0):
        self.encoder = encoder
        self.loss = get_loss(loss)
        self.temperature = temperature
        self.aux_loss_weight = aux_loss_weight

    @classmethod
    def from_model_args(cls, model_args: ModelArguments, encoder_cfg,
                        encoder: PretrainedEncoder | None = None):
        """Build a retriever from argument objects (paper workflow);
        ``encoder`` may be any object with the encoder duck-type."""
        enc = encoder or get_encoder(model_args.encoder_class, encoder_cfg)
        return cls(enc, model_args.loss, model_args.temperature)

    def init_params(self, generator, device="cuda"):
        return self.encoder.init_params(generator, device)

    def param_logical_axes(self):
        return self.encoder.param_logical_axes()

    def format_query(self, text):
        return self.encoder.format_query(text)

    def format_passage(self, text, title=""):
        return self.encoder.format_passage(text, title)

    def forward(self, params, batch, ctx=None):
        raise NotImplementedError


class BiEncoderRetriever(PretrainedRetriever):
    _alias = "biencoder"

    def encode_query(self, params, batch):
        return self.encoder.encode(params, batch)

    def encode_passage(self, params, batch):
        return self.encoder.encode(params, batch)

    def forward(self, params, batch, ctx=None):
        """batch: {"query": {...}, "passage": {...}, optional "labels"}.

        Passages are ordered [q0_docs..., q1_docs...] with ``group_size``
        docs per query; labels default to "first doc in group is
        positive".  Returns (loss, metrics dict).  Under ``ctx = (mesh,
        rules)`` the batch is this rank's rows along the data axes, and
        the embeddings (and labels) of every rank's rows are gathered
        before the scores, so the loss is the whole batch's, in-batch
        negatives included (``sharding.layout.gather_rows``), and an MoE
        encoder's aux is the whole batch's too.
        """
        aux = None
        mesh = None if ctx is None else ctx[0]
        if self.aux_loss_weight and hasattr(self.encoder, "encode_with_aux"):
            # on a mesh each aux is the whole batch's
            q_emb, aux_q = self.encoder.encode_with_aux(
                params, batch["query"], mesh)
            p_emb, aux_p = self.encoder.encode_with_aux(
                params, batch["passage"], mesh)
            aux = aux_q + aux_p
        else:
            q_emb = self.encode_query(params, batch["query"])
            p_emb = self.encode_passage(params, batch["passage"])
        labels = batch.get("labels")
        if mesh is not None:
            q_emb, p_emb = gather_rows(q_emb, mesh), gather_rows(p_emb, mesh)
            if labels is not None:
                labels = collectives.all_gather(labels, mesh,
                                                data_axes(mesh))
        nq = q_emb.shape[0]
        group = p_emb.shape[0] // nq
        scores = biencoder_scores(q_emb, p_emb, self.temperature)
        if labels is None:
            labels = torch.arange(nq, dtype=torch.int32,
                                  device=scores.device) * group
        loss = self.loss(scores, labels)
        metrics = {"contrastive_loss": loss}
        if aux is not None:
            loss = loss + self.aux_loss_weight * aux
            metrics["moe_aux_loss"] = aux
        if labels.ndim == 1:
            # argmax gives the first of equal maxima, as jnp.argmax
            acc = (scores.argmax(-1) == labels).float().mean()
            metrics["in_batch_accuracy"] = acc
        return loss, metrics


class GradedBiEncoderRetriever(BiEncoderRetriever):
    """Multi-level relevance training (MultiLevelDataset): each query sees
    only its own group of graded docs — the score matrix is the group
    diagonal blocks, and the graded loss (kl/ws/listnet) is applied."""

    _alias = "graded_biencoder"

    def forward(self, params, batch, ctx=None):
        # the graded loss is a mean of per-query terms, so a rank's rows
        # need no other rank's embeddings
        q_emb = self.encode_query(params, batch["query"])
        p_emb = self.encode_passage(params, batch["passage"])
        nq = q_emb.shape[0]
        group = p_emb.shape[0] // nq
        p_grp = p_emb.reshape(nq, group, -1)
        scores = torch.einsum("qd,qgd->qg", q_emb, p_grp) / self.temperature
        loss = self.loss(scores, batch["labels"])
        return loss, {"graded_loss": loss}


def make_train_loss_fn(retriever: PretrainedRetriever,
                       ctx=None) -> Callable[..., Any]:
    """(params, batch) -> (loss, metrics) — consumed by RetrievalTrainer."""

    def loss_fn(params, batch):
        return retriever.forward(params, batch, ctx)

    return loss_fn

"""Encoder wrappers + registry (paper §3.3 / Appendix B).

An encoder bundles ``encode(params, batch) -> (B, d)`` embeddings, input
formatting callbacks and parameter construction: the LM encoders over a
transformer backbone, and :class:`GNNEncoder` (alias ``"gnn"``) over
GraphSAGE.  Subclasses register
under ``_alias`` so experiments swap encoders by name; any object with
the same duck-type also works.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import gnn, transformer
from repro_torch.sharding.partitioning import AxisRules

ENCODER_REGISTRY: dict[str, type["PretrainedEncoder"]] = {}


class PretrainedEncoder:
    _alias = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls._alias:
            ENCODER_REGISTRY[cls._alias] = cls

    def init_params(self, generator: torch.Generator,
                    device: str | torch.device = "cuda"):
        raise NotImplementedError

    def encode(self, params, batch: dict[str, torch.Tensor]):
        """batch {"tokens", "mask"} -> (B, d) L2-normalized embeddings."""
        raise NotImplementedError

    def param_logical_axes(self):
        raise NotImplementedError

    def axis_rules(self) -> AxisRules:
        return AxisRules()

    def format_query(self, text: str) -> str:
        return text

    def format_passage(self, text: str, title: str = "") -> str:
        return f"{title} {text}".strip() if title else text


def get_encoder(alias: str, *args, **kw) -> PretrainedEncoder:
    return ENCODER_REGISTRY[alias](*args, **kw)


class DefaultEncoder(PretrainedEncoder):
    """LM-transformer encoder (dense or MoE backbone)."""

    _alias = "lm"

    def __init__(self, cfg: transformer.LMConfig):
        self.cfg = cfg

    def init_params(self, generator, device="cuda"):
        return transformer.init_params(self.cfg, generator, device)

    def param_shapes(self):
        return transformer.param_shapes(self.cfg)

    def param_logical_axes(self):
        return transformer.param_logical_axes(self.cfg)

    def axis_rules(self) -> AxisRules:
        return transformer.LM_RULES

    def encode(self, params, batch):
        return transformer.encode(self.cfg, params, batch["tokens"],
                                  batch["mask"])

    def encode_with_aux(self, params, batch, mesh=None):
        """(embeddings, aux loss): an MoE backbone's load-balance loss, so
        the retriever can weight it in (0.0 for a dense one); on a
        ``mesh``, ``batch`` is this rank's rows and the aux the whole
        batch's (``transformer.forward_hidden``)."""
        hidden, aux = transformer.forward_hidden(
            self.cfg, params, batch["tokens"], batch["mask"], mesh)
        return transformer.pool(self.cfg, hidden, batch["mask"]), aux


class EncoderWithInstruction(DefaultEncoder):
    """Paper Appendix B example: E5-Mistral-style instruction formatting."""

    _alias = "encoder_with_inst"

    instruction = "Given a web search query, retrieve relevant passages"

    def format_query(self, text: str) -> str:
        return f"Instruct: {self.instruction}\nQuery: {text}"


class MeanPoolEncoder(DefaultEncoder):
    """Paper Appendix B example: overriding the pooling method."""

    _alias = "encoder_mean_pool"

    def __init__(self, cfg: transformer.LMConfig):
        super().__init__(dataclasses.replace(cfg, pooling="mean"))


class GNNEncoder(PretrainedEncoder):
    """GraphSAGE node / graph encoder for graph retrieval.  ``encode``
    takes the reference's batches: ``feats0`` / ``feats1`` / ``feats2``
    (sampled blocks), ``x`` / ``edges`` / ``edge_mask`` / ``node_mask``
    (batched small graphs) or ``x`` / ``edge_src`` / ``edge_dst`` (one
    full graph, with an optional prebuilt ``table``, its
    ``gnn.neighbor_table``)."""

    _alias = "gnn"

    def __init__(self, cfg: gnn.SAGEConfig):
        self.cfg = cfg

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return gnn.param_shapes(self.cfg)

    def init_params(self, generator, device="cuda"):
        return gnn.init_params(self.cfg, generator, device)

    def param_logical_axes(self):
        return gnn.param_logical_axes(self.cfg)

    def encode(self, params, batch):
        if "feats2" in batch:
            return gnn.forward_minibatch(
                self.cfg, params, batch["feats0"], batch["feats1"],
                batch["feats2"])
        if "node_mask" in batch:
            return gnn.forward_batched_graphs(
                self.cfg, params, batch["x"], batch["edges"],
                batch["edge_mask"], batch["node_mask"])
        return gnn.forward_full(
            self.cfg, params, batch["x"], batch["edge_src"],
            batch["edge_dst"], batch.get("table"))

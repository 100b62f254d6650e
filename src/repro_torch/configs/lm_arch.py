"""LM cells: (architecture x input shape) -> a step the card runs.

The counterpart of ``repro.configs.base.LMArch`` for the dense LM
encoders (trove-base, qwen2-0.5b, stablelm-3b, gemma-7b).  Of the
reference's four shapes the port runs the ``encode`` kind
(``prefill_32k``: ``transformer.encode`` over a batch of token rows, the
corpus-encoding prefill).  ``train_4k`` (the contrastive step at 4k
tokens) needs activation checkpointing and a mesh (ROADMAP queue 1
items 7c, 10); ``decode_32k`` and ``long_500k`` are the KV-cache decode
(item 8c).  Both raise.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.models import transformer

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="encode", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="serve", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="serve", seq_len=524288, global_batch=1),
}

# the reference's reduced() shapes
REDUCED_SHAPES = {
    "train_4k": dict(kind="train", seq_len=32, global_batch=4),
    "prefill_32k": dict(kind="encode", seq_len=64, global_batch=2),
    "decode_32k": dict(kind="serve", seq_len=64, global_batch=4),
    "long_500k": dict(kind="serve", seq_len=128, global_batch=1),
}


def reduced_config(cfg: transformer.LMConfig) -> transformer.LMConfig:
    """The reference's ``LMArch.reduced()`` config: 2 layers of width 64
    (4 heads x 16; 2 KV heads where the arch groups its heads, else 4),
    d_ff 128, vocab 512, float32, unchunked attention."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16,
        d_ff=128, vocab_size=512, dtype=torch.float32, attn_chunk=0)


def _not_ported(shape: str, items: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{shape} needs {what}, which the port does not have yet "
        f"(ROADMAP queue 1 item {items})")


class LMArch:
    family = "lm"

    def __init__(self, cfg: transformer.LMConfig,
                 shapes: dict | None = None):
        self.cfg = cfg
        self.name = cfg.name
        self.shapes = shapes or LM_SHAPES

    def shape_names(self) -> list[str]:
        return list(self.shapes)

    def build_cell(self, shape_name: str,
                   device: str | torch.device = "cuda") -> Cell:
        """The step of one shape: ``encode`` gives a cell whose ``fn(params,
        batch)`` is ``transformer.encode`` of ``batch["tokens"]`` /
        ``batch["mask"]`` without gradients, on the device of its inputs
        (``device`` is checked here, and must hold a card unless it is
        ``"cpu"``)."""
        resolve_device(device)
        kind = self.shapes[shape_name]["kind"]
        if kind == "train":
            raise _not_ported(shape_name, "7c / 10",
                              "activation checkpointing and a mesh")
        if kind == "serve":
            raise _not_ported(shape_name, "8c",
                              "the KV-cache decode step")
        cfg = self.cfg

        def encode_fn(params, batch):
            with torch.no_grad():
                return transformer.encode(cfg, params, batch["tokens"],
                                          batch["mask"])

        return Cell(self.name, shape_name, "encode", encode_fn)

    def reduced(self) -> "LMArch":
        """A small config of the same family, for CPU tests (the
        reference's ``reduced``)."""
        return LMArch(reduced_config(self.cfg), shapes=REDUCED_SHAPES)

    def smoke_inputs(self, shape_name: str, generator: torch.Generator,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
        """Token rows of one shape, ids in [3, vocab) drawn from
        ``generator`` on its device, every position unmasked (the
        reference's draw; a train shape gives ``{"query", "passage"}``)."""
        dev = resolve_device(device)
        spec = self.shapes[shape_name]
        b, s = spec["global_batch"], spec["seq_len"]
        if spec["kind"] == "serve":
            raise _not_ported(shape_name, "8c", "the KV-cache decode step")

        def toks():
            t = torch.randint(3, self.cfg.vocab_size, (b, s),
                              generator=generator, device=generator.device)
            return {"tokens": t.to(device=dev, dtype=torch.int32),
                    "mask": torch.ones((b, s), dtype=torch.int32,
                                       device=dev)}

        if spec["kind"] == "train":
            return {"query": toks(), "passage": toks()}
        return toks()

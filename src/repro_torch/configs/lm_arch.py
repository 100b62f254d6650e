"""LM cells: (architecture x input shape) -> a step the card runs.

The counterpart of ``repro.configs.base.LMArch`` for the LM encoders
(trove-base, qwen2-0.5b, stablelm-3b, gemma-7b, and the MoE stacks
granite-moe-3b-a800m and llama4-maverick-400b-a17b).  The reference's
four shapes are three kinds: ``train_4k``, the contrastive bi-encoder
step at 4k tokens (forward, backward and the arch's optimizer through
``configs.base.make_train_cell``: Adafactor at full width, AdamW in
``reduced()``, the reference's defaults); ``prefill_32k``, the
``encode`` kind (``transformer.encode`` over a batch of token rows, the
corpus-encoding prefill); and ``decode_32k`` / ``long_500k``, the
``serve`` kind (``transformer.decode_step``: one token a row against a
KV cache of the shape's length).  A mesh raises (ROADMAP queue 1 item
10).  At full width the reference runs ``train_4k`` at 256 x 4096 on a
mesh, and its serve shapes' caches (up to 1,792 GiB) on one too; one
card takes a cut batch or depth (the reckonings are in ``PERF.md``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Cell, make_train_cell
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.losses import InfoNCELoss

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
    d_ff 128, vocab 512, float32, unchunked attention, no remat; an MoE
    stack keeps at most 8 experts, top-2 at most, of width 32 (so an
    interleaved stack is one dense and one MoE layer)."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16,
        d_ff=128, vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        moe_d_ff=32 if cfg.moe else 0, dtype=torch.float32, attn_chunk=0,
        remat=False)


def _not_ported(shape: str, items: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{shape} needs {what}, which the port does not have yet "
        f"(ROADMAP queue 1 item {items})")


class LMArch:
    family = "lm"

    def __init__(self, cfg: transformer.LMConfig,
                 optimizer: str = "adafactor", shapes: dict | None = None):
        self.cfg = cfg
        self.name = cfg.name
        self.optimizer = optimizer
        self.shapes = shapes or LM_SHAPES

    def shape_names(self) -> list[str]:
        return list(self.shapes)

    def variant(self, **overrides) -> "LMArch":
        """A copy with config fields overridden (the hill-climb's
        candidates, ``launch/hillclimb.py``), same optimizer and shapes."""
        return LMArch(dataclasses.replace(self.cfg, **overrides),
                      optimizer=self.optimizer, shapes=self.shapes)

    def _contrastive_loss(self):
        """The reference's contrastive step loss: queries through
        ``encode``, passages through ``forward_hidden`` and ``pool``,
        in-batch scores at temperature 0.02, InfoNCE on the diagonal plus
        0.01 x the passages' MoE aux loss (0.0 for a dense stack; the
        queries' aux is dropped, as in the reference)."""
        loss = InfoNCELoss()
        cfg = self.cfg

        def fn(params, batch):
            q = transformer.encode(cfg, params, batch["query"]["tokens"],
                                   batch["query"]["mask"])
            hidden, aux = transformer.forward_hidden(
                cfg, params, batch["passage"]["tokens"],
                batch["passage"]["mask"])
            p = transformer.pool(cfg, hidden, batch["passage"]["mask"])
            scores = torch.einsum("qd,pd->qp", q, p) / 0.02
            labels = torch.arange(q.shape[0], dtype=torch.int32,
                                  device=q.device)
            return loss(scores, labels) + 0.01 * aux

        return fn

    def build_cell(self, shape_name: str,
                   device: str | torch.device = "cuda", mesh=None) -> Cell:
        """The step of one shape, on the device of its inputs (``device``
        is checked here, and must hold a card unless it is ``"cpu"``).
        ``train`` gives ``make_train_cell``'s cell: ``fn(state, batch)``
        with ``batch = {"query", "passage"}`` token rows and ``state``
        from ``configs.base.init_train_state``, updated in place.
        ``encode`` gives a cell whose ``fn(params, batch)`` is
        ``transformer.encode`` of ``batch["tokens"]`` / ``batch["mask"]``
        without gradients.  ``serve`` gives a cell whose ``fn(params,
        cache, tokens)`` is ``transformer.decode_step`` without
        gradients: ``(logits (B, V) float32, cache)``, the cache written
        in place (the reference donates it)."""
        resolve_device(device)
        if mesh is not None:
            raise _not_ported(shape_name, "10", "a device mesh across cards")
        kind = self.shapes[shape_name]["kind"]
        if kind == "train":
            return make_train_cell(self.name, shape_name,
                                   loss_fn=self._contrastive_loss(),
                                   optimizer=self.optimizer)
        cfg = self.cfg
        if kind == "serve":
            def serve_fn(params, cache, tokens):
                with torch.no_grad():
                    return transformer.decode_step(cfg, params, cache,
                                                   tokens)

            return Cell(self.name, shape_name, "serve", serve_fn)

        def encode_fn(params, batch):
            with torch.no_grad():
                return transformer.encode(cfg, params, batch["tokens"],
                                          batch["mask"])

        return Cell(self.name, shape_name, "encode", encode_fn)

    def reduced(self) -> "LMArch":
        """A small config of the same family, for CPU tests (the
        reference's ``reduced``: AdamW, the reduced shapes)."""
        return LMArch(reduced_config(self.cfg), optimizer="adamw",
                      shapes=REDUCED_SHAPES)

    def smoke_inputs(self, shape_name: str, generator: torch.Generator,
                     device: str | torch.device = "cuda"
                     ):
        """Token rows of one shape, ids in [3, vocab) drawn from
        ``generator`` on its device, every position unmasked (the
        reference's draw; a train shape gives ``{"query", "passage"}``).
        A serve shape gives the reference's ``(cache, tokens)``: a zeroed
        cache of the shape's batch and length with ``len = seq_len - 1``,
        and one token a row."""
        dev = resolve_device(device)
        spec = self.shapes[shape_name]
        b, s = spec["global_batch"], spec["seq_len"]
        if spec["kind"] == "serve":
            cache = transformer.init_cache(self.cfg, b, s, dev)
            cache["len"].fill_(s - 1)
            tokens = torch.randint(3, self.cfg.vocab_size, (b,),
                                   generator=generator,
                                   device=generator.device)
            return cache, tokens.to(device=dev, dtype=torch.int32)

        def toks():
            t = torch.randint(3, self.cfg.vocab_size, (b, s),
                              generator=generator, device=generator.device)
            return {"tokens": t.to(device=dev, dtype=torch.int32),
                    "mask": torch.ones((b, s), dtype=torch.int32,
                                       device=dev)}

        if spec["kind"] == "train":
            return {"query": toks(), "passage": toks()}
        return toks()

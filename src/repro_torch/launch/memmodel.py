"""Analytic memory model of a cell on one card.

The counterpart of ``repro.launch.memmodel`` for one H100 (80 GB).  A
cell's budget is

  state+args  — exact: the bytes of the cell's arguments as the dry run
                makes them on meta (parameters, optimizer state, batch,
                KV cache; ``launch/dryrun.py``), plus what the port's
                step keeps that the reference's inputs do not hold (a
                full graph's neighbour table, :func:`neighbor_table_bytes`)
  activations — the reference's family closed forms under the declared
                remat policy, at one card (its mesh divisors are 1)
  transient   — the float32 gradient of the parameters, for train cells

and ``fits_80GB`` says whether the total is below one card's memory.  It
is a reckoning, not a measurement: ``chip_smoke.py`` phase (s) holds it
against ``torch.cuda.max_memory_allocated`` for three cells.
"""

from __future__ import annotations

import math

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.launch.roofline import HBM_BYTES
from repro_torch.training.tree import leaves


def args_bytes(args) -> int:
    """The bytes of every tensor among a cell's arguments (nested dicts
    and tuples; the reference's ``args_bytes_per_device`` at one
    device)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(args)
               if isinstance(t, torch.Tensor))


def neighbor_table_bytes(arch, shape_name: str) -> int:
    """A full graph's :class:`~repro_torch.models.gnn.NeighborTable`,
    which the port's step keeps in its batch (the caller builds it once a
    graph; the reference has no table): its (N, L) int32 ids, K4T's
    sorted int32 keys and order over them, and the (N,) float32
    in-degrees.  L, the widest in-degree, depends on the edges: it is
    counted at its least, ceil(E / N).  0 for other modes."""
    spec = arch.shapes[shape_name]
    if spec["mode"] != "full":
        return 0
    n = -(-spec["n_nodes"] // arch.pad) * arch.pad
    e = -(-spec["n_edges"] // arch.pad) * arch.pad
    width = max(1, -(-e // n))
    return 3 * 4 * n * width + 4 * n


def _lm_activation_bytes(arch, shape_name) -> int:
    cfg = arch.cfg
    spec = arch.shapes[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    bpe = 2 if cfg.dtype == torch.bfloat16 else 4

    if spec["kind"] == "serve":
        # single token: qkv + logits; cache already counted in args
        return b * cfg.vocab_size * 4 + b * cfg.d_model * bpe * 8

    saved = cfg.n_layers * b * s * cfg.d_model * bpe

    # within-layer peak: attention scores (query-chunked)
    chunk = cfg.attn_chunk if (cfg.attn_chunk and s > cfg.attn_chunk) else s
    scores = b * cfg.n_kv_heads * \
        (cfg.n_heads // cfg.n_kv_heads) * chunk * s * 4
    ffn = b * s * cfg.d_ff * bpe * 2
    moe = 0
    if cfg.moe:
        cap = int(math.ceil(s * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))
        moe = b * cfg.n_experts * cap * (cfg.d_model + cfg.moe_d_ff) * bpe
    peak_layer = max(scores + ffn, scores + moe)
    mult = 3 if spec["kind"] == "train" else 2   # bwd/live-slack factor
    return saved + mult * peak_layer


def _gnn_activation_bytes(arch, shape_name) -> int:
    spec = arch.shapes[shape_name]
    cfg = arch.shape_cfg(shape_name)
    if spec["mode"] == "full":
        n, e = spec["n_nodes"], spec["n_edges"]
        per = (n * (cfg.d_feat + 2 * cfg.d_hidden)
               + e * (cfg.d_feat + cfg.d_hidden)) * 4
        return 3 * per
    if spec["mode"] == "minibatch":
        b = spec["batch_nodes"]
        f1, f2 = spec["fanouts"]
        nodes = 2 * b * (1 + f1 + f1 * f2)
        return 3 * nodes * max(cfg.d_feat, cfg.d_hidden) * 4
    g, n = spec["n_graphs"], spec["n_nodes"]
    return 3 * 2 * g * n * max(cfg.d_feat, cfg.d_hidden) * 4


def _recsys_activation_bytes(arch, shape_name) -> int:
    spec = arch.shapes[shape_name]
    cfg = arch.cfg
    b = (spec["n_candidates"] if spec["kind"] == "retrieval"
         else spec["batch"])
    width = max(cfg.n_fields * cfg.embed_dim,
                max(cfg.mlp_dims) if cfg.mlp_dims else 0,
                cfg.n_fields * cfg.n_heads * cfg.d_attn)
    mult = 3 if spec["kind"] == "train" else 1
    return mult * b * width * 4 * 2


def activation_bytes(arch, shape_name) -> int:
    fam = {"lm": _lm_activation_bytes, "gnn": _gnn_activation_bytes,
           "recsys": _recsys_activation_bytes}[arch.family]
    return int(fam(arch, shape_name))


def grad_transient_bytes(cell, params) -> int:
    """fp32 gradient buffer for train cells (exists between bwd and opt)."""
    if cell.kind != "train":
        return 0
    return sum(math.prod(leaf.shape) * 4 for leaf in leaves(params))


def memory_model(arch, shape_name, cell, args) -> dict:
    """The budget of one cell whose arguments are ``args`` (the dry run's
    meta arguments: ``(state, batch)`` for a train cell)."""
    table_b = neighbor_table_bytes(arch, shape_name) if (
        arch.family == "gnn") else 0
    args_b = args_bytes(args) + table_b
    grad_b = (grad_transient_bytes(cell, args[0]["params"])
              if cell.kind == "train" else 0)
    act_b = activation_bytes(arch, shape_name)
    total = args_b + grad_b + act_b
    return {
        "state_and_args_bytes": int(args_b),
        "neighbor_table_bytes": int(table_b),
        "grad_transient_bytes": int(grad_b),
        "activation_bytes": int(act_b),
        "total_bytes": int(total),
        "fits_80GB": bool(total < HBM_BYTES),
    }

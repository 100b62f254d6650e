"""RecSys rankers: BST, AutoInt, DeepFM, Wide&Deep (scoring).

The counterpart of ``repro.models.recsys``, for one card:
  * one hashed embedding table shared by all sparse fields, addressed by
    per-field offsets (:func:`field_offsets`);
  * :func:`embedding_lookup` is a plain gather, or under a mesh with
    ``embedding_impl="psum"`` the reference's psum lookup
    (:func:`_lookup_psum`): the table is split in row shards over
    "model", each rank runs K4 over its own shard in bags of one (ids of
    other shards set to -1, K4's padding), casts to bf16 and all-reduces
    over "model".  Exactly one shard contributes each row, so a row is
    rounded to bf16 once and is otherwise exact; the backward rounds the
    cotangent to bf16 (the transpose of the reference's casts) and runs
    K4T over the same local ids, writing only the shard's gradient.
    Under a mesh DeepFM's linear term and FM sum are sums of those
    looked-up rows, as the reference computes them there, not K4 bag sums
    (a bag sum all-reduced in bf16 would round a sum over shards).  With
    ``"xla_gather"`` under a mesh the table comes gathered and the
    one-card path runs;
  * the bag sums of the forward pass go through the EmbeddingBag kernel
    (K4, ``kernels.ops.embedding_bag``): DeepFM's linear term and FM sum,
    Wide&Deep's wide term.  AutoInt and BST launch no kernel.  In
    training (``configs.base.make_train_cell``) the bag sums carry their
    tables' gradients through K4's backward kernel (K4T, one launch per
    bag sum), while the ``table[idx]`` gathers keep torch's own backward,
    as the reference keeps ``jnp.take``'s.

:func:`retrieval_scores` scores one user against N candidates as one
batched forward (the paper's FastResultHeapq scenario, Table 3).
Parameters are a plain dict of tensors; ``init_params`` draws them from
a ``torch.Generator`` with the reference's scales (the numbers differ
from ``jax.random``'s: carry reference weights across with
``models.convert.recsys_params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sharding import collectives

Params = dict[str, torch.Tensor]

# BST's attention heads (fixed, as in the reference)
BST_HEADS = 8


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

def field_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int64)


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor,
                     impl: str = "xla_gather", mesh=None,
                     table_axis: str = "model") -> torch.Tensor:
    """(V, D) x (...,) int -> (..., D).  Ids must lie in [0, V).  With
    ``impl="psum"`` on a mesh that has ``table_axis``, ``table`` is this
    rank's row shard and the lookup is :func:`_lookup_psum`."""
    if not psum_active(impl, mesh, table_axis):
        return table[idx]
    local = local_ids(idx, table.shape[0], mesh, table_axis)
    return _lookup_psum(table, local, mesh, table_axis).reshape(
        *idx.shape, table.shape[1])


def psum_active(impl: str, mesh, table_axis: str = "model") -> bool:
    """Whether the psum lookup runs: ``impl == "psum"`` on a mesh with
    ``table_axis`` (the reference's condition)."""
    return impl == "psum" and mesh is not None and table_axis in mesh.shape


def local_ids(idx: torch.Tensor, rows: int, mesh,
              table_axis: str = "model") -> torch.Tensor:
    """Global ids -> this shard's row ids as (N, 1) bags of one, ids of
    other shards -1 (K4's padding); the shard holds rows [s * rows,
    (s + 1) * rows) with s its index along ``table_axis``."""
    lo = mesh.shard_index((table_axis,)) * rows
    local = idx.reshape(-1, 1).to(torch.int64) - lo
    ok = (local >= 0) & (local < rows)
    return torch.where(ok, local, -1).to(torch.int32)


class _PsumBF16(torch.autograd.Function):
    """bf16 round trip through an all-reduce over ``axis``; the backward
    rounds the cotangent to bf16 and back (the reference's psum under
    ``shard_map(check_rep=False)`` transposes to the identity on a
    replicated cotangent)."""

    @staticmethod
    def forward(ctx, part, mesh, axis):
        wire = collectives.all_reduce(part.to(torch.bfloat16), mesh, (axis,))
        return wire.to(part.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype), None, None


def _lookup_psum(table: torch.Tensor, local: torch.Tensor, mesh,
                 axis: str = "model", keys=None) -> torch.Tensor:
    """K4 over this rank's row shard at the (N, 1) ``local`` ids, in bf16
    through the all-reduce over ``axis`` -> (N, D) in the table's dtype,
    differentiable in the shard (K4T).  ``keys`` (``ops.BagKeys`` on
    ``local``) shares K4T's sort between tables of one shard layout."""
    part = ops.embedding_bag(table, local, keys=keys)
    return _PsumBF16.apply(part, mesh, axis)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag over flat multi-hot ids (CSR): gather the rows of
    ``idx`` (N,), reduce them into bag ``bag_ids`` (N,) -> (n_bags, D)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown mode {mode!r}; expected sum or mean")
    rows = table[idx]
    bags = bag_ids.long()
    s = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                    device=table.device).index_add_(0, bags, rows)
    if mode == "sum":
        return s
    counts = torch.zeros(n_bags, dtype=rows.dtype,
                         device=table.device).index_add_(
        0, bags, torch.ones_like(bags, dtype=rows.dtype))
    return s / counts.clamp(min=1.0)[:, None]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str = "deepfm"
    kind: str = "deepfm"              # deepfm | autoint | wide_deep | bst
    vocab_sizes: tuple[int, ...] = (1024,) * 8
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # bst
    seq_len: int = 20
    n_profile_fields: int = 8
    bst_d_ff: int = 64
    dtype: torch.dtype = torch.float32
    embedding_impl: str = "xla_gather"  # xla_gather | psum (under a mesh)

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))


def _mlp_shapes(dims: Sequence[int]) -> dict[str, tuple[int, ...]]:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"mlp_w{i}"] = (a, b)
        out[f"mlp_b{i}"] = (b,)
    return out


def param_shapes(cfg: RecSysConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter (the reference's
    ``abstract_params`` without the dtype)."""
    v, d = cfg.total_vocab, cfg.embed_dim
    shapes: dict[str, tuple[int, ...]] = {"table": (v, d)}
    if cfg.kind in ("deepfm", "wide_deep"):
        shapes["linear_table" if cfg.kind == "deepfm" else "wide_table"] = (
            v, 1)
        shapes["bias"] = (1,)
        shapes.update(_mlp_shapes(
            (cfg.n_fields * d,) + cfg.mlp_dims + (1,)))
    elif cfg.kind == "autoint":
        d_in = d
        for i in range(cfg.n_attn_layers):
            dh = cfg.n_heads * cfg.d_attn
            for nm in ("wq", "wk", "wv", "wres"):
                shapes[f"attn{i}_{nm}"] = (d_in, dh)
            d_in = dh
        shapes["out_w"] = (cfg.n_fields * d_in, 1)
        shapes["out_b"] = (1,)
    elif cfg.kind == "bst":
        s = cfg.seq_len + 1
        shapes["pos_emb"] = (s, d)
        for nm in ("wq", "wk", "wv", "wo"):
            shapes[f"attn_{nm}"] = (d, d)
        shapes["attn_ln1"] = (d,)
        shapes["attn_ln2"] = (d,)
        shapes["ffn_w1"] = (d, cfg.bst_d_ff)
        shapes["ffn_w2"] = (cfg.bst_d_ff, d)
        flat = s * d + cfg.n_profile_fields * d
        shapes.update(_mlp_shapes((flat,) + cfg.mlp_dims + (1,)))
    else:
        raise ValueError(cfg.kind)
    return shapes


TABLES = ("table", "linear_table", "wide_table")


def param_logical_axes(cfg: RecSysConfig) -> dict[str, tuple]:
    """The tables' rows on "embed_rows" (-> "model"), every other leaf
    replicated (the reference's rule)."""
    return {k: (("embed_rows",) + (None,) * (len(shape) - 1)
                if k in TABLES else (None,) * len(shape))
            for k, shape in param_shapes(cfg).items()}


def mesh_kept_leaves(cfg: RecSysConfig, mesh) -> tuple[str, ...]:
    """The tables a forward on ``mesh`` consumes as row shards (the psum
    lookup's), which a meshed step leaves sharded."""
    if not psum_active(cfg.embedding_impl, mesh):
        return ()
    return tuple(k for k in TABLES if k in param_shapes(cfg))


def init_params(cfg: RecSysConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's rule: biases 0, BST's
    LayerNorm scales 1, tables N(0, 0.01^2), weights N(0, 1/fan_in).
    ``generator`` lives on ``device``; names are drawn in sorted order."""
    dev = resolve_device(device)
    out: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith(("_b", "bias")) or name.startswith("attn_ln"):
            fill = 1.0 if name.startswith("attn_ln") else 0.0
            out[name] = torch.full(shape, fill, dtype=cfg.dtype, device=dev)
            continue
        fan_in = shape[0] if len(shape) > 1 else 1
        x = torch.randn(shape, generator=generator, device=dev)
        x.mul_(0.01 if "table" in name else 1 / math.sqrt(fan_in))
        out[name] = x.to(cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# Forward passes (logit per example)
# ---------------------------------------------------------------------------

def _mlp(params: Params, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = x @ params[f"mlp_w{i}"] + params[f"mlp_b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _n_mlp(cfg: RecSysConfig) -> int:
    return len(cfg.mlp_dims) + 1


def forward(cfg: RecSysConfig, params: Params,
            batch: dict[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """Returns logits (B,).  On a mesh ``batch`` is this rank's rows and,
    under the psum lookup, the tables are this rank's row shards."""
    if cfg.kind == "bst":
        return _forward_bst(cfg, params, batch, mesh)
    if psum_active(cfg.embedding_impl, mesh):
        return _forward_psum(cfg, params, batch, mesh)
    idx = batch["sparse_idx"]                              # (B, F) global ids
    emb = embedding_lookup(params["table"], idx)           # (B, F, D)
    b = idx.shape[0]
    if cfg.kind == "deepfm":
        # the two bag sums' backwards share one sort of the ids
        keys = ops.BagKeys(idx)
        lin = ops.embedding_bag(params["linear_table"], idx, keys=keys)[:, 0]
        sum_v = ops.embedding_bag(params["table"], idx, keys=keys)  # (B, D)
        fm = 0.5 * ((sum_v * sum_v) - (emb * emb).sum(1)).sum(-1)
        deep = _mlp(params, emb.reshape(b, -1), _n_mlp(cfg))[:, 0]
        return lin + fm + deep + params["bias"][0]
    if cfg.kind == "wide_deep":
        wide = ops.embedding_bag(params["wide_table"], idx)[:, 0]
        deep = _mlp(params, emb.reshape(b, -1), _n_mlp(cfg))[:, 0]
        return wide + deep + params["bias"][0]
    if cfg.kind == "autoint":
        return _autoint(cfg, params, emb)
    raise ValueError(cfg.kind)


def _forward_psum(cfg: RecSysConfig, params: Params,
                  batch: dict[str, torch.Tensor], mesh) -> torch.Tensor:
    """DeepFM / Wide&Deep / AutoInt on the psum lookup: the reference's
    meshed forward, its sums over the looked-up (bf16-rounded) rows."""
    idx = batch["sparse_idx"]
    b, f = idx.shape
    table = params["table"]
    local = local_ids(idx, table.shape[0], mesh)
    # the tables share one shard layout, so their backwards share a sort
    keys = ops.BagKeys(local)
    emb = _lookup_psum(table, local, mesh, keys=keys).reshape(
        b, f, table.shape[1])
    if cfg.kind in ("deepfm", "wide_deep"):
        name = "linear_table" if cfg.kind == "deepfm" else "wide_table"
        lin = _lookup_psum(params[name], local, mesh, keys=keys).reshape(
            b, f).sum(-1)
        deep = _mlp(params, emb.reshape(b, -1), _n_mlp(cfg))[:, 0]
        if cfg.kind == "wide_deep":
            return lin + deep + params["bias"][0]
        sum_v = emb.sum(1)
        fm = 0.5 * ((sum_v * sum_v) - (emb * emb).sum(1)).sum(-1)
        return lin + fm + deep + params["bias"][0]
    if cfg.kind == "autoint":
        return _autoint(cfg, params, emb)
    raise ValueError(cfg.kind)


def _autoint(cfg: RecSysConfig, params: Params, emb: torch.Tensor
             ) -> torch.Tensor:
    b = emb.shape[0]
    h = emb
    nh, da = cfg.n_heads, cfg.d_attn

    def split(t):
        return t.reshape(b, -1, nh, da)

    for i in range(cfg.n_attn_layers):
        q = split(h @ params[f"attn{i}_wq"])
        k = split(h @ params[f"attn{i}_wk"])
        v = split(h @ params[f"attn{i}_wv"])
        scores = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        o = torch.einsum("bhfg,bghd->bfhd", torch.softmax(scores, -1), v)
        o = o.reshape(b, h.shape[1], nh * da)
        h = torch.relu(o + h @ params[f"attn{i}_wres"])
    return (h.reshape(b, -1) @ params["out_w"])[:, 0] + params["out_b"][0]


def _forward_bst(cfg: RecSysConfig, params: Params,
                 batch: dict[str, torch.Tensor], mesh=None) -> torch.Tensor:
    hist, target = batch["hist"], batch["target"]          # (B,S), (B,)
    profile = batch["profile"]                             # (B,P) global ids
    b, s = hist.shape

    def lookup(idx):
        return embedding_lookup(params["table"], idx, cfg.embedding_impl,
                                mesh)

    seq = torch.cat([hist, target[:, None]], dim=1)        # (B,S+1)
    e = lookup(seq) + params["pos_emb"][None]
    # one transformer block (post-LN, as in the BST paper)
    d = cfg.embed_dim
    hd = d // BST_HEADS
    q = (e @ params["attn_wq"]).reshape(b, s + 1, BST_HEADS, hd)
    k = (e @ params["attn_wk"]).reshape(b, s + 1, BST_HEADS, hd)
    v = (e @ params["attn_wv"]).reshape(b, s + 1, BST_HEADS, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    o = o.reshape(b, s + 1, d) @ params["attn_wo"]
    h = _ln(e + o, params["attn_ln1"])
    f = torch.relu(h @ params["ffn_w1"]) @ params["ffn_w2"]
    h = _ln(h + f, params["attn_ln2"])
    prof = lookup(profile)                                 # (B,P,D)
    flat = torch.cat([h.reshape(b, -1), prof.reshape(b, -1)], dim=-1)
    return _mlp(params, flat, _n_mlp(cfg))[:, 0]


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale


# ---------------------------------------------------------------------------
# Retrieval scoring: 1 user x N candidates (paper Table 3 scenario)
# ---------------------------------------------------------------------------

def retrieval_scores(cfg: RecSysConfig, params: Params,
                     batch: dict[str, torch.Tensor], mesh=None
                     ) -> torch.Tensor:
    """Batched scoring of one user against (N,) candidate item ids.

    The candidate id replaces field 0 (non-BST) / the target item (BST);
    the user's context is broadcast.  Returns scores (N,) (on a mesh,
    this rank's candidates).
    """
    cands = batch["cand_idx"]                              # (N,)
    n = cands.shape[0]
    if cfg.kind == "bst":
        big = {"hist": batch["hist"].expand(n, cfg.seq_len),
               "target": cands,
               "profile": batch["profile"].expand(
                   n, batch["profile"].shape[-1])}
        return forward(cfg, params, big, mesh)
    user = batch["user_idx"]                               # (1, F-1)
    idx = torch.cat([cands[:, None], user.expand(n, user.shape[-1])], dim=1)
    return forward(cfg, params, {"sparse_idx": idx}, mesh)

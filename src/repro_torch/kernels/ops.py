"""Public operations on top of the port's kernels.

The counterparts of ``repro.kernels.ops``: :func:`fused_score_topk`,
:func:`topk_update` and :func:`superchunk_update` over the streaming
top-k kernels (K1, K2), and :func:`embedding_bag` over K4 (its table's
gradient through K4's backward kernel, K4T; :class:`BagKeys` shares
that backward's sort between bag sums over the same ids), with the
reference's rules — an empty docs slice yields an empty (-inf, -1)
state, and a superchunk carries per-step ``offsets`` / ``n_valids`` with
padded steps at ``n_valid == 0``.  The TPU's alignment padding (Q and the
bags to 8 rows, the chunk axis to 128 lanes) is not carried over: the
kernels mask ragged edges themselves.  :func:`launch_counts` and
:func:`reset_launch_counts` cover every kernel's launch count.  On meta
tensors (the dry run's) every operation here runs as on the card, the
wrappers launching nothing and reporting their cost to an active
``launch.roofline.CostMode``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import ref, topk

NEG_INF = ref.NEG_INF

SUPERCHUNK_SCORES = ("fused", "torch")
SUPERCHUNK_MERGES = ("kernel", "torch")


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last :func:`reset_launch_counts`."""
    with topk.LAUNCH_LOCK:
        return {**topk.LAUNCHES, **_bag.LAUNCHES}


def reset_launch_counts() -> None:
    topk.reset_launch_counts()
    _bag.reset_launch_counts()


def empty_state(n_queries: int, k: int, device) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """k slots of (-inf, -1) per query."""
    return (torch.full((n_queries, k), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.full((n_queries, k), -1, dtype=torch.int32, device=device))


def fused_score_topk(queries: torch.Tensor, docs: torch.Tensor, k: int, *,
                     id_offset: int = 0, n_valid: int | None = None):
    """Top-k of ``queries @ docs.T`` without a score matrix (K1).

    queries (Q, d), docs (N, d) -> (vals (Q, k) descending, ids int32
    (Q, k)); ids are row positions plus ``id_offset``, rows at or past
    ``n_valid`` (default N) are never retrieved.
    """
    dev = queries.device
    vals, ids = empty_state(queries.shape[0], k, dev)
    n = docs.shape[0]
    if n == 0:
        # an empty corpus slice (the sharder may hand out empty shards)
        # has a well-defined answer: the empty state
        return vals, ids
    n_valid = n if n_valid is None else min(int(n_valid), n)
    topk.fused_score_topk_(
        vals, ids, queries.float().contiguous(),
        docs.float().contiguous().unsqueeze(0),
        torch.tensor([id_offset], dtype=torch.int32, device=dev),
        torch.tensor([n_valid], dtype=torch.int32, device=dev))
    return vals, ids


def topk_update(vals: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor,
                chunk_ids: torch.Tensor):
    """Merge a (Q, C) score chunk into the (Q, k) state in place (K2);
    returns the state."""
    topk.topk_update_(vals, ids, scores.float().contiguous(),
                      chunk_ids.to(torch.int32).contiguous())
    return vals, ids


def _merge_plain_(vals, ids, scores, chunk_ids) -> None:
    v, i = ref.topk_update_ref(vals, ids, scores, chunk_ids)
    vals.copy_(v)
    ids.copy_(i)


def superchunk_update(vals: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor, tile: torch.Tensor,
                      offsets: torch.Tensor, n_valids: torch.Tensor, *,
                      score: str = "fused", merge: str = "kernel") -> None:
    """Fold an (S, C, d) superchunk into the (Q, k) state, in place.

    ``offsets`` / ``n_valids`` are per-step (S,) int32 on the state's
    device: each chunk's global corpus offset and its count of valid rows
    (tail chunks are padded up to C rows; padded steps have
    ``n_valid == 0``).  ``score="fused"`` is one K1 launch over the whole
    tile; ``score="torch"`` scores each step with a matrix product and
    merges it with K2 (``merge="kernel"``) or the plain sort
    (``merge="torch"``).  All paths select identically given the same
    scores.  The reference donates the state to its scan; here it is
    updated in place.
    """
    if score not in SUPERCHUNK_SCORES:
        raise ValueError(f"unknown score {score!r}; expected one of "
                         f"{list(SUPERCHUNK_SCORES)}")
    if merge not in SUPERCHUNK_MERGES:
        raise ValueError(f"unknown merge {merge!r}; expected one of "
                         f"{list(SUPERCHUNK_MERGES)}")
    if queries.shape[0] != vals.shape[0]:
        raise ValueError(f"queries {tuple(queries.shape)} vs state "
                         f"{tuple(vals.shape)}")
    if score == "fused":
        topk.fused_score_topk_(vals, ids, queries, tile, offsets, n_valids)
        return
    merge_ = topk.topk_update_ if merge == "kernel" else _merge_plain_
    c = tile.shape[1]
    row = torch.arange(c, dtype=torch.int32, device=tile.device)
    for s in range(tile.shape[0]):
        valid = row < n_valids[s]
        scores = torch.where(valid[None, :], ref.score_matrix(queries,
                                                              tile[s]),
                             NEG_INF)
        merge_(vals, ids, scores, torch.where(valid, row + offsets[s], -1))


BagKeys = _bag.BagKeys


class _EmbeddingBag(torch.autograd.Function):
    """K4 forward, K4T backward (the table's gradient).  On CPU tensors
    both wrappers run their plain versions, so autograd sees the same
    function there."""

    @staticmethod
    def forward(ctx, table, idx, weights, keys):
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        _bag.embedding_bag_(out, table, idx, weights)
        ctx.save_for_backward(idx, weights)
        ctx.n_rows = table.shape[0]
        ctx.keys = keys
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        idx, weights = ctx.saved_tensors
        # written whole by K4T (or the plain version): no fill
        d_table = torch.empty((ctx.n_rows, grad_out.shape[1]),
                              dtype=grad_out.dtype, device=grad_out.device)
        # a strided gradient (DeepFM's ``[:, 0]`` of a (B, 1) sum) is made
        # contiguous for the kernel
        _bag.embedding_bag_backward_(d_table, grad_out.contiguous(), idx,
                                     weights, keys=ctx.keys)
        return d_table, None, None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None, *,
                  keys: BagKeys | None = None) -> torch.Tensor:
    """Fused gather + bag sum (K4): table (V, D), idx (B, L) with idx < 0
    as padding, optional weights (B, L) -> (B, D) in the table's dtype.

    Differentiable in the table: the backward is K4T (one launch per
    backward on the card), the gradient of the plain version.  ``keys``,
    a :class:`BagKeys` built on ``idx``, lets bag sums over the same ids
    share the backward's sort of them (it raises for other ids); without
    it each backward sorts its own.  A gradient for ``weights`` is not
    implemented.  B = 0 returns (0, D) without a launch.
    """
    if weights is not None and weights.requires_grad:
        raise NotImplementedError(
            "embedding_bag has no gradient for weights (K4T gives the "
            "table's only)")
    if keys is not None:
        idx = keys.ids_for(idx)
    else:
        idx = idx.to(torch.int32).contiguous()
    if weights is not None:
        weights = weights.float().contiguous()
    return _EmbeddingBag.apply(table.contiguous(), idx, weights, keys)

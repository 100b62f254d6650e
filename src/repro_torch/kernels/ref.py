"""Plain PyTorch versions of the port's kernels.

These compute exactly what the CUDA kernels in ``csrc/topk.cu`` (K1, K2),
``csrc/embedding_bag.cu`` (K4) and ``csrc/embedding_bag_backward.cu``
(K4's backward, K4T) compute.  The kernel wrappers
(``kernels/topk.py``, ``kernels/embedding_bag.py``) take them for CPU
tensors; the CPU tests hold them against the reference package, and
``chip_smoke.py`` holds the kernels against them on the card.

Selection rule (shared by every path of the port): the new state is the
first k of a **stable** descending sort over the concatenation
``[state | candidates]``, with NaN read as -inf.  The state starts as k
slots of (-inf, -1) ahead of every candidate and ties go to the earlier
entry of the concatenation, so the lower stream position wins a tie and
a -inf (or NaN) candidate never surfaces an id.  ``torch.topk`` is never
used: it promises no order among ties on CUDA.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def score_matrix(queries: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) float32 dot-product scores.

    On the CPU the products are summed in float64 and rounded once, so
    the scores do not depend on how the corpus was cut into chunks (a
    BLAS may pick its summation order by shape) and every CPU backend
    of the port agrees bitwise.  On the card the float32 product is used
    as it is (TF32 off, see ``device.require_full_f32``).
    """
    if queries.device.type == "cpu":
        return (queries.double() @ docs.double().T).float()
    return queries.float() @ docs.float().T


def select_topk(vals: torch.Tensor, ids: torch.Tensor,
                cand_v: torch.Tensor, cand_i: torch.Tensor):
    """First k of the stable descending sort of ``[state | candidates]``.

    vals (Q, k) f32, ids (Q, k) i32, cand_v (Q, m) f32, cand_i (Q, m)
    i32 -> new (vals, ids), sorted descending.
    """
    k = vals.shape[1]
    cv = torch.cat([vals, cand_v.float()], dim=1)
    cv = torch.where(torch.isnan(cv), NEG_INF, cv)
    ci = torch.cat([ids, cand_i.to(ids.dtype)], dim=1)
    top_v, pos = torch.sort(cv, dim=1, descending=True, stable=True)
    return top_v[:, :k].contiguous(), torch.gather(ci, 1, pos[:, :k])


def topk_update_ref(vals: torch.Tensor, ids: torch.Tensor,
                    scores: torch.Tensor, chunk_ids: torch.Tensor):
    """K2: merge a (Q, C) score chunk with ids (C,) into the (Q, k)
    state -> new (vals, ids)."""
    cand_i = chunk_ids.to(ids.dtype)[None, :].expand(scores.shape)
    return select_topk(vals, ids, scores, cand_i)


def fused_score_topk_ref(vals: torch.Tensor, ids: torch.Tensor,
                         queries: torch.Tensor, tile: torch.Tensor,
                         offsets: torch.Tensor, n_valids: torch.Tensor):
    """K1: fold an (S, C, d) superchunk into the (Q, k) state.

    Step ``s`` scores rows ``r < n_valids[s]`` of ``tile[s]`` with id
    ``offsets[s] + r``; rows at or past ``n_valids[s]`` are (-inf, -1).
    Returns new (vals, ids).
    """
    s, c, d = tile.shape
    scores = score_matrix(queries, tile.reshape(s * c, d))
    row = torch.arange(c, device=tile.device, dtype=torch.int32)
    valid = row[None, :] < n_valids[:, None]                     # (S, C)
    cand_i = torch.where(valid, offsets[:, None] + row[None, :], -1)
    scores = torch.where(valid.reshape(1, s * c), scores, NEG_INF)
    return select_topk(vals, ids, scores,
                       cand_i.reshape(1, s * c).expand(scores.shape))


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """K4: bag sums ``out[b] = sum_l table[idx[b, l]] * weights[b, l]``.

    table (V, D) float32 or bfloat16, idx (B, L) int32, weights (B, L)
    float32 or None (all ones) -> (B, D) in the table's dtype.  Slots are
    added in order l = 0..L-1 in float32 as ``acc + (row * w) * mask``
    and the sum is rounded once to the table's dtype, as the kernel does.
    The reference's semantics (``repro.kernels.ref.embedding_bag_ref``)
    hold at the edges: a slot with idx < 0 is padding that reads row 0
    and multiplies it by 0 (so a non-finite ``table[0]`` or weight there
    gives NaN), an id >= V reads a NaN row (``jnp.take``'s fill mode), and
    L = 0 gives zeros.
    """
    b, n_slots = idx.shape
    v, d = table.shape
    acc = torch.zeros((b, d), dtype=torch.float32, device=table.device)
    nan_row = torch.full((d,), float("nan"), device=table.device)
    for l in range(n_slots):
        rid = idx[:, l].long()
        safe = rid.clamp(min=0)
        inside = safe < v
        row = torch.where(inside[:, None],
                          table[torch.where(inside, safe, 0)].float(),
                          nan_row)
        w = 1.0 if weights is None else weights[:, l, None].float()
        acc = acc + (row * w) * (rid >= 0)[:, None].float()
    return acc.to(table.dtype)


def embedding_bag_backward_ref(grad_out: torch.Tensor, idx: torch.Tensor,
                               n_rows: int,
                               weights: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """K4T: the gradient of :func:`embedding_bag_ref` with respect to its
    (``n_rows``, D) table,
    ``d_table[r] = sum over (b, l) with idx[b, l] = r of g[b] * w[b, l]``.

    grad_out (B, D) float32 or bfloat16 (the table's dtype), idx (B, L)
    int32, weights (B, L) float32 or None (all ones) -> (n_rows, D) in
    grad_out's dtype.  Slot (b, l) contributes ``(g[b] * mask) * w[b, l]``
    in float32, the product autograd of the forward's ``acc + (row * w) *
    mask`` takes, with mask 0 on padding.  **Order:** each row adds its
    contributions to +0.0 one at a time in ascending flat position
    ``b * L + l``, and the sum is rounded once to grad_out's dtype; the
    kernel adds them in the same order, so the two agree bitwise.  At the
    edges this is what autograd of the plain forward gives: a padded slot
    (idx < 0) read row 0, so it adds ``(g[b] * 0) * w`` there (NaN where
    ``g[b]`` or the weight is not finite); an id >= ``n_rows`` read no
    row and adds nothing; rows no id touches, and L = 0 or B = 0, give
    zeros.
    """
    b, n_slots = idx.shape
    dev = grad_out.device
    flat = idx.reshape(-1).long()
    rows = flat.clamp(min=0)
    pos = torch.arange(b * n_slots, device=dev)[rows < n_rows]
    rows = rows[pos]
    x = grad_out.float()[pos // n_slots] * (flat[pos] >= 0)[:, None].float()
    if weights is not None:
        x = x * weights.reshape(-1)[pos, None].float()
    # a stable sort by row keeps each row's contributions in position
    # order; a contribution's rank is its place in its row's run
    rows, order = torch.sort(rows, stable=True)
    x = x[order]
    n = rows.numel()
    at = torch.arange(n, device=dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = rows[1:] != rows[:-1]
    rank = at - torch.cummax(torch.where(head, at, 0), 0).values
    out = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                      device=dev)
    # rank by rank: within one rank every row appears at most once
    by_rank = torch.argsort(rank, stable=True)
    lo = 0
    for count in torch.bincount(rank).tolist() if n else []:
        sel = by_rank[lo:lo + count]
        lo += count
        out[rows[sel]] += x[sel]
    return out.to(grad_out.dtype)

"""K1's split of the superchunk rows (``repro_torch.kernels.topk``).

On the card K1 runs in two stages: each block scores 32 (or, in the
narrow tile, 16) queries against one range of the superchunk's rows, in
tiles of 128 (or 32) rows, and keeps, in row order, the scores strictly
above the query's threshold (the state's smallest value, then the range's
k-th value once its buffer of k + rows entries fills and is cut to its
exact top k); then one pass merges the state with every range's
survivors.  The kernels run only on the card (``chip_smoke.py``
holds them against the plain version there); here the wrapper's
pure-Python split plan is checked, a plain PyTorch model of the two
stages is held **bitwise** against the plain version
``fused_score_topk_ref`` (one stable sort over ``[state | candidates]``),
and the model and the port's CPU path are held against the reference's
Pallas kernel in interpret mode and its ``lax.top_k`` oracle on float
inputs: ids equal wherever neighbouring scores are more than TOL apart,
scores within TOL (the reference sums in float32, the port's CPU path in
float64 rounded once).  NaN rows are held against the reference's
``jax`` heap instead (reference fault 3: its Pallas kernel wipes a
query's tile on one NaN).  Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.result_heap import FastResultHeapq as JaxHeap
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import topk as jtopk
from repro_torch.kernels import ops, ref, topk

torch.set_num_threads(1)

NEG_INF = float("-inf")
TOL = 1e-5
SMS = 132                     # streaming multiprocessors of an H100 SXM


def _ranges(n, splits, span):
    return [(r * span, min((r + 1) * span, n)) for r in range(splits)]


# -- (a) the split plan -------------------------------------------------------

@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("q,n", [
    (256, 64 * 32),           # the (fused, kernel) evaluation path
    (32, 8 * 32),             # a serving request, S = 8
    (32, 256 * 32),           # a serving request at the autotune's ceiling
    (33, 64 * 32),            # Q not a multiple of the query tile
    (32, 32), (1, 40), (5000, 2048), (100, 1_000_000)])
def test_fused_split_plan_covers_the_rows(q, n, sms):
    rows, splits, span = topk.fused_split_plan(q, n, sms)
    queries, slab = topk.FUSED_TILES[rows]
    tiles = -(-q // queries)
    cover = _ranges(n, splits, span)
    assert cover[0][0] == 0 and cover[-1][1] == n
    assert all(a < b for a, b in cover)                   # none empty
    assert all(cover[r][1] == cover[r + 1][0] for r in range(splits - 1))
    assert splits == 1 or span >= slab
    # one wave of blocks that fills the SMs, where the rows allow it
    want = max(1, min(sms // tiles, n // slab))
    assert splits == 1 or tiles * splits <= sms
    # a span of ceil(n / want) rounded up to a multiple of 4 gives fewer
    # ranges than want by under 4 want^2 / n
    assert want - 4 * want * want // n - 1 <= splits <= want
    # the wide tile unless its grid would leave most SMs idle
    wide_q, wide_slab = topk.FUSED_TILES[128]
    wide_tiles = -(-q // wide_q)
    wide_blocks = wide_tiles * max(1, min(sms // wide_tiles, n // wide_slab))
    assert (rows == 128) == (2 * wide_blocks >= sms)
    for k in (1, 100, 256):
        ws_v, ws_p = topk.fused_workspace(q, splits, span, k, rows, "cpu")
        assert ws_v.shape == ws_p.shape == (q, splits,
                                            min(span, k + rows))
        assert ws_v.dtype == torch.float32 and ws_p.dtype == torch.int32


def test_fused_split_plan_at_the_path_shapes():
    # more blocks than one per 4 queries (what PR 14's kernel ran) at
    # every path shape
    assert topk.fused_split_plan(256, 2048, SMS) == (128, 16, 128)
    assert topk.fused_split_plan(32, 256, SMS) == (32, 32, 8)   # narrow
    assert topk.fused_split_plan(32, 8192, SMS) == (128, 128, 64)
    assert topk.fused_split_plan(96, 2048, SMS) == (128, 43, 48)
    assert topk.fused_split_plan(5000, 2048, SMS) == (128, 1, 2048)
    assert topk.fused_split_plan(1, 40, SMS) == (32, 5, 8)


# -- (b) the two-stage model --------------------------------------------------

def _same(got, want):
    """Bitwise: value bits (so -0.0 != +0.0) and ids."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def _top_in_order(v, p, k):
    """The first k of (v, p) under (value desc, position asc), left in
    position order (p ascending in the input), and the k-th value."""
    order = torch.sort(v, descending=True, stable=True).indices[:k]
    kth = v[order[-1]]
    keep = torch.sort(order).values
    return v[keep], p[keep], kth


def _stage_one(scores, least, row0, k, rows):
    """One range of one query as a stage-1 block keeps it: tiles of
    ``rows`` rows, survivors strictly above the threshold appended in
    row order, the buffer of k + rows cut to its exact top k (and the
    threshold raised to the k-th value) when a tile might overflow."""
    cap = k + rows
    thr = least
    buf_v = torch.empty(0)
    buf_p = torch.empty(0, dtype=torch.long)
    for t0 in range(0, scores.shape[0], rows):
        v = scores[t0: t0 + rows]
        p = torch.arange(t0, t0 + v.shape[0]) + row0 + k
        if buf_v.shape[0] + int((v > thr).sum()) > cap:
            buf_v, buf_p, thr = _top_in_order(buf_v, buf_p, k)
        keep = v > thr                                   # NaN fails too
        buf_v = torch.cat([buf_v, v[keep]])
        buf_p = torch.cat([buf_p, p[keep]])
    return buf_v, buf_p


def _two_stage(vals, ids, queries, tile, offsets, n_valids, rows, splits,
               span):
    """K1's decomposition in plain PyTorch, in tiles of ``rows`` rows: per
    range and query, the survivors of stage 1; then the first k of the
    state (positions
    0..k-1, NaN as -inf) and every survivor (position k + row) under
    (value desc, position asc), ids from the state or offsets[row // C]
    + row % C."""
    q, k = vals.shape
    s, c, d = tile.shape
    n = s * c
    scores = ref.score_matrix(queries, tile.reshape(n, d))
    row = torch.arange(n)
    valid = (row % c) < n_valids.long()[row // c]
    scores = torch.where(valid[None, :] & ~torch.isnan(scores), scores,
                         NEG_INF)
    sv = torch.where(torch.isnan(vals), NEG_INF, vals)
    least = sv.min(dim=1).values
    out_v, out_i = [], []
    for qi in range(q):
        parts = [_stage_one(scores[qi, a:b], least[qi], a, k, rows)
                 for a, b in _ranges(n, splits, span)]
        v = torch.cat([sv[qi], *(pv for pv, _ in parts)])
        p = torch.cat([torch.arange(k), *(pp for _, pp in parts)])
        order = torch.sort(v, descending=True, stable=True).indices[:k]
        top_v, top_p = v[order], p[order]
        r = (top_p - k).clamp(min=0)
        cand = offsets.long()[r // c] + r % c
        out_v.append(top_v)
        out_i.append(torch.where(top_p < k, ids[qi].long()[top_p.clamp(
            max=k - 1)], cand).to(torch.int32))
    return torch.stack(out_v), torch.stack(out_i)


def _ints(rng, *shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _case(mode, rng, q, s, c, d, k):
    queries = _ints(rng, q, d)
    tile = _ints(rng, s, c, d)
    n_valids = np.full(s, c, np.int32)
    vals = np.full((q, k), NEG_INF, np.float32)
    ids = np.full((q, k), -1, np.int32)
    if mode == "ragged steps":
        n_valids[1], n_valids[2], n_valids[-1] = 5, 0, c - 3
    elif mode == "duplicate rows":                       # ties across ranges
        tile[s // 2:] = tile[: s - s // 2]
    elif mode == "nan / -inf rows":
        queries = _ints(rng, q, d, lo=1, hi=3)
        tile[0, 2] = np.nan
        tile[1, :] = np.nan                              # a whole range
        tile[2, 5] = NEG_INF
    elif mode == "unsorted state":
        vals = _ints(rng, q, k, lo=-12, hi=13)
        vals[:, 3] = np.nan
        ids = (rng.permutation(q * k).reshape(q, k) + 10_000).astype(
            np.int32)
    elif mode == "long ranges (cuts)":
        # the top k lie in the first tile of range 0, which its buffer's
        # first cut reduces: a cut that kept fewer than k would lose one
        queries = _ints(rng, q, d, lo=1, hi=3)
        flat = tile.reshape(s * c, d)
        flat[:128] = _ints(rng, 128, d, lo=5, hi=60)
    elif mode == "signed zeros":
        queries = _ints(rng, q, d, lo=-1, hi=1)          # -1 or 0
        tile = np.where(rng.random((s, c, d)) < 0.7, 0.0,
                        _ints(rng, s, c, d)).astype(np.float32)
        vals[:, : k // 2] = -0.0
        ids[:, : k // 2] = np.arange(k // 2)
    offsets = (np.arange(s) * c + 7).astype(np.int32)
    return [torch.from_numpy(x) for x in (vals, ids, queries, tile,
                                          offsets, n_valids)]


@pytest.mark.parametrize("mode,q,s,c,d,k,rows,splits", [
    ("ragged steps", 5, 6, 12, 8, 20, 128, 3),  # span 24 crosses steps
    ("ragged steps", 4, 6, 12, 8, 20, 128, 1),  # one range
    ("ragged steps", 9, 6, 12, 8, 20, 32, 5),   # narrow tile
    ("duplicate rows", 3, 8, 16, 8, 16, 128, 4),
    ("k=256, ranges shorter than k", 3, 4, 40, 8, 256, 128, 5),
    ("unsorted state", 3, 5, 24, 8, 12, 128, 4),
    ("nan / -inf rows", 4, 3, 32, 8, 30, 128, 3),
    ("long ranges (cuts)", 2, 10, 100, 8, 8, 128, 2),  # span > k + 128
    ("long ranges (cuts)", 2, 10, 100, 8, 8, 32, 2),   # span > k + 32
    ("signed zeros", 3, 4, 32, 6, 40, 128, 4),
    ("plan at Q=33", 33, 8, 32, 4, 10, None, None),
    ("plan at Q=32, S=8", 32, 8, 32, 4, 100, None, None),
])
def test_two_stage_model_equals_plain_version(mode, q, s, c, d, k, rows,
                                              splits):
    rng = np.random.default_rng(len(mode) * 100 + q + k)
    vals, ids, queries, tile, offsets, n_valids = _case(mode, rng, q, s, c,
                                                        d, k)
    if splits is None:
        rows, splits, span = topk.fused_split_plan(q, s * c, SMS)
    else:
        splits, span = topk.ranges(s * c, splits)
    assert splits > 1 or mode == "ragged steps"
    for step in range(2):                 # given state, then full
        want = ref.fused_score_topk_ref(vals, ids, queries, tile, offsets,
                                        n_valids)
        _same(_two_stage(vals, ids, queries, tile, offsets, n_valids, rows,
                         splits, span), want)
        vals, ids = want
        tile, offsets = tile.flip(0).contiguous(), offsets + s * c


# -- (c) against the reference ------------------------------------------------

def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _separated(vals):
    """Slots whose value is more than TOL from both neighbours."""
    v = np.asarray(vals, np.float64)
    pad = np.full((v.shape[0], 1), np.inf)
    up = np.concatenate([pad, v[:, :-1]], 1) - v
    down = v - np.concatenate([v[:, 1:], -pad], 1)
    return (up > TOL) & (down > TOL)


def _close(got, want):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    assert np.abs(gv - wv).max() <= TOL
    sep = _separated(wv)
    np.testing.assert_array_equal(gi[sep], wi[sep])
    return sep.mean()


@pytest.mark.parametrize("q,n,d,k,offset,n_valid", [
    (12, 300, 32, 20, 0, None), (5, 200, 48, 50, 1000, 170),
    (33, 64, 16, 10, 5, None)])
def test_float_inputs_match_pallas(q, n, d, k, offset, n_valid):
    rng = np.random.default_rng(q * n + d)
    queries, docs = _unit(rng, q, d), _unit(rng, n, d)
    want = jtopk.fused_score_topk_pallas(
        jnp.asarray(queries), jnp.asarray(docs), k, id_offset=offset,
        n_valid=n_valid, bn=64, interpret=True)
    if n_valid is None:
        _close(jref.fused_score_topk_ref(jnp.asarray(queries),
                                         jnp.asarray(docs), k, offset), want)
    got = ops.fused_score_topk(torch.from_numpy(queries),
                               torch.from_numpy(docs), k, id_offset=offset,
                               n_valid=n_valid)
    assert _close((got[0].numpy(), got[1].numpy()), want) > 0.9
    nv = n if n_valid is None else n_valid
    model = _two_stage(*ops.empty_state(q, k, "cpu"),
                       torch.from_numpy(queries),
                       torch.from_numpy(docs)[None],
                       torch.tensor([offset], dtype=torch.int32),
                       torch.tensor([nv], dtype=torch.int32),
                       *topk.fused_split_plan(q, n, SMS))
    _same(model, got)
    assert topk.LAUNCHES["fused_score_topk"] == 0      # plain on the CPU


def test_float_superchunk_matches_reference_scan():
    """A superchunk with a ragged and a padded step, folded twice into one
    state: the port's fused path and the model at a split against the
    reference's scan over its Pallas kernel."""
    rng = np.random.default_rng(11)
    q, s, c, d, k = 9, 6, 24, 32, 15
    queries, tile = _unit(rng, q, d), _unit(rng, s, c, d)
    offsets = (np.arange(s) * c).astype(np.int32)
    n_valids = np.array([c, c, 9, c, 0, c], np.int32)
    vals = np.full((q, k), NEG_INF, np.float32)
    ids = np.full((q, k), -1, np.int32)
    v, i = torch.from_numpy(vals.copy()), torch.from_numpy(ids.copy())
    mv, mi = v.clone(), i.clone()
    splits, span = topk.ranges(s * c, 3)
    for _ in range(2):
        want = jops.superchunk_update(
            jnp.asarray(vals), jnp.asarray(ids), queries, tile, offsets,
            n_valids, k=k, score="pallas_fused", merge="jax",
            interpret=True)
        args = [torch.from_numpy(x) for x in (queries, tile, offsets,
                                              n_valids)]
        ops.superchunk_update(v, i, *args, score="fused")
        mv, mi = _two_stage(mv, mi, *args, 128, splits, span)
        _close((v.numpy(), i.numpy()), want)
        _same((mv, mi), (v, i))
        vals, ids = np.asarray(want[0]).copy(), np.asarray(want[1]).copy()
        offsets = offsets + s * c


def test_nan_rows_follow_jax_heap():
    """NaN rows, one a whole range, drop only themselves: the port and the
    model against the reference's ``jax`` heap on the same scores."""
    rng = np.random.default_rng(21)
    q, s, c, d, k = 4, 4, 32, 16, 25
    queries, tile = _unit(rng, q, d), _unit(rng, s, c, d)
    tile[1] = np.nan
    tile[2, 3] = np.nan
    heap = JaxHeap(q, k, impl="jax")
    for st in range(s):
        heap.update((queries.astype(np.float64) @ tile[st].T.astype(
            np.float64)).astype(np.float32),
            np.arange(st * c, (st + 1) * c, dtype=np.int32))
    args = [torch.from_numpy(queries), torch.from_numpy(tile),
            torch.arange(s, dtype=torch.int32) * c,
            torch.full((s,), c, dtype=torch.int32)]
    v, i = ops.empty_state(q, k, "cpu")
    ops.superchunk_update(v, i, *args, score="fused")
    want = (np.asarray(heap.vals), np.asarray(heap.ids))
    _close((v.numpy(), i.numpy()), want)
    np.testing.assert_array_equal(i.numpy(), want[1])
    _same(_two_stage(*ops.empty_state(q, k, "cpu"), *args, 32,
                     *topk.ranges(s * c, 4)), (v, i))
    assert not ((i >= c) & (i < 2 * c)).any()

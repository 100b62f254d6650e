"""K2's split of the column axis (``repro_torch.kernels.topk``).

On the card K2 runs in two stages: each of ``splits`` column ranges keeps
its own top-k of the scores strictly above the state's smallest value,
then one pass merges the state with the ranges' top-k.  The kernels run
only on the card (``chip_smoke.py`` holds them bitwise against the plain
version); here the wrapper's pure-Python split choice is checked, and a
plain PyTorch model of the two-stage decomposition is held **bitwise**
against the plain version ``topk_update_ref`` (one stable sort over
``[state | candidates]``) and, at a larger C, against the reference's
``lax.top_k`` oracle.  Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, topk

torch.set_num_threads(1)

NEG_INF = float("-inf")
INT_MAX = 2 ** 31 - 1
SMS = 132                     # streaming multiprocessors of an H100 SXM


def _ranges(c, splits, span):
    return [(r * span, min((r + 1) * span, c)) for r in range(splits)]


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("q,c,k", [
    (256, 32, 100), (256, 4096, 100), (1, 1_000_000, 100),
    (3, 1_000_000, 100), (1, 1_000_000, 256), (1, 999_999, 100),
    (1, 20_000, 100), (1, 4096, 100), (7, 50, 256), (131, 10 ** 6, 10)])
def test_split_plan_covers_the_columns(q, c, k, sms):
    splits, span = topk.split_plan(q, c, sms)
    if q >= sms or (q, c) in ((256, 32), (256, 4096)):
        assert splits == 1
    else:
        assert 1 <= q * splits <= sms + q
        assert splits == 1 or span >= max(topk.MIN_SPAN, 8 * k)
    assert span % 4 == 0
    cover = _ranges(c, splits, span)
    assert cover[0][0] == 0 and cover[-1][1] == c
    assert all(a < b for a, b in cover)                   # none empty
    assert all(cover[r][1] == cover[r + 1][0] for r in range(splits - 1))
    ws_v, ws_p = topk.workspace(q, splits, k, "cpu")
    if splits == 1:
        assert ws_v is None and ws_p is None
    else:
        assert ws_v.shape == ws_p.shape == (q, splits, k)
        assert ws_v.dtype == torch.float32 and ws_p.dtype == torch.int32


def test_split_plan_at_the_path_shapes():
    assert topk.split_plan(256, 32, SMS) == (1, 32)
    assert topk.split_plan(256, 4096, SMS) == (1, 4096)
    # one block per SM at the recsys retrieval_cand shape
    assert topk.split_plan(1, 1_000_000, SMS) == (SMS, 7576)
    assert topk.split_plan(3, 1_000_000, SMS) == (SMS // 3, 22728)
    # ranges(): as many as asked, or fewer where ranges would be empty
    assert topk.ranges(300, 5) == (5, 60)
    assert topk.ranges(10, 10) == (3, 4)
    with pytest.raises(ValueError, match="splits"):
        topk.ranges(10, 0)


def _same(got, want):
    """Bitwise: value bits (so -0.0 != +0.0) and ids."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def _ahead_order(v, p):
    """Indices sorting each row by (value desc, position asc)."""
    by_pos = torch.argsort(p, dim=1, stable=True)
    v, p = torch.gather(v, 1, by_pos), torch.gather(p, 1, by_pos)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices
    return torch.gather(by_pos, 1, order)


def _two_stage(vals, ids, scores, cids, splits, span):
    """The kernels' decomposition in plain PyTorch: per range, the top-k
    (value desc, column asc) of the scores strictly above the state's
    smallest value, padded with (-inf, INT_MAX); then the first k of the
    state (positions 0..k-1) and the partials (positions k + column)."""
    q, k = vals.shape
    c = scores.shape[1]
    sv = torch.where(torch.isnan(vals), NEG_INF, vals)
    least = sv.min(dim=1, keepdim=True).values
    part_v, part_p = [], []
    for c0, c1 in _ranges(c, splits, span):
        v = scores[:, c0:c1]
        v = torch.where(v > least, v, NEG_INF)          # NaN fails too
        p = torch.arange(c0, c1).expand(q, -1) + k
        order = _ahead_order(v, p)[:, :k]
        v, p = torch.gather(v, 1, order), torch.gather(p, 1, order)
        p = torch.where(torch.isneginf(v), INT_MAX, p)
        pad = k - v.shape[1]
        part_v.append(torch.nn.functional.pad(v, (0, pad), value=NEG_INF))
        part_p.append(torch.nn.functional.pad(p, (0, pad), value=INT_MAX))
    v = torch.cat([sv, *part_v], dim=1)
    p = torch.cat([torch.arange(k).expand(q, -1), *part_p], dim=1)
    order = _ahead_order(v, p)[:, :k]
    top_v, top_p = torch.gather(v, 1, order), torch.gather(p, 1, order)
    cand = cids.long()[(top_p - k).clamp(0, c - 1)]
    state = torch.gather(ids, 1, top_p.clamp(max=k - 1))
    return top_v, torch.where(top_p < k, state, cand.to(ids.dtype))


def _scores(rng, mode, q, c, span):
    x = rng.integers(-6, 7, size=(q, c)).astype(np.float32)
    if mode == "boundary ties":
        for b in range(span, c, span):                  # the top value,
            x[:, max(0, b - 7): b + 7] = 50.0           # across each cut
    elif mode == "nan / -inf ranges":
        x[:, :span] = np.nan
        x[:, span: 2 * span] = NEG_INF
        x[-1, 2 * span:] = np.nan                       # a row of < k
        x[-1, -3:] = 1.0
    elif mode == "signed zeros":
        x = np.where(rng.random((q, c)) < 0.5, -0.0, 0.0).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("mode,q,c,k,splits", [
    ("boundary ties", 2, 500, 20, 4),
    ("nan / -inf ranges", 3, 400, 16, 5),
    ("unsorted state", 3, 300, 12, 3),
    ("k > span", 2, 120, 50, 6),
    ("all equal", 1, 640, 25, 8),
    ("signed zeros", 2, 200, 30, 4),
    ("one range", 4, 96, 10, 1),
])
def test_two_stage_model_equals_plain_version(mode, q, c, k, splits):
    rng = np.random.default_rng(len(mode) * 1000 + c)
    n_splits, span = topk.ranges(c, splits)
    assert n_splits == splits
    if mode == "unsorted state":
        vals = torch.from_numpy(rng.integers(-6, 7, size=(q, k))
                                .astype(np.float32))
        vals[:, 2] = float("nan")
        ids = torch.from_numpy(rng.permutation(q * k).reshape(q, k)
                               .astype(np.int32) + 10_000)
    else:
        vals, ids = ops.empty_state(q, k, "cpu")
    scores = (torch.full((q, c), 0.5) if mode == "all equal"
              else _scores(rng, mode, q, c, span))
    cids = torch.arange(c, dtype=torch.int32) + 7
    for step in range(2):                     # given state, then full
        want = ref.topk_update_ref(vals, ids, scores, cids)
        _same(_two_stage(vals, ids, scores, cids, n_splits, span), want)
        vals, ids = want
        scores, cids = scores.flip(1).contiguous(), cids + c
    if mode == "all equal":
        assert ids[0].tolist() == list(range(7, 7 + k))


@pytest.mark.parametrize("q,c,k,mode", [(1, 20_000, 100, "ties"),
                                        (2, 9_000, 256, "neginf")])
def test_split_shapes_match_lax_top_k(q, c, k, mode):
    """At a C that the wrapper splits into ranges on the card, the plain
    version (what the wrapper runs on the CPU) and the two-stage model at
    that split equal the reference's oracle.  The kernels' split path is
    held against the plain version on the card by ``chip_smoke.py``."""
    rng = np.random.default_rng(c + k)
    splits, span = topk.split_plan(q, c, SMS)
    assert splits > 1
    vals = np.full((q, k), NEG_INF, np.float32)
    ids = np.full((q, k), -1, np.int32)
    for step in range(2):
        scores = rng.integers(-40, 41, size=(q, c)).astype(np.float32)
        if mode == "neginf":
            scores[rng.random(scores.shape) < 0.3] = NEG_INF
        cids = (np.arange(c) + step * c).astype(np.int32)
        want = jref.topk_update_ref(jnp.asarray(vals), jnp.asarray(ids),
                                    jnp.asarray(scores), jnp.asarray(cids))
        want = np.asarray(want[0]), np.asarray(want[1])
        v, i = torch.from_numpy(vals.copy()), torch.from_numpy(ids.copy())
        topk.topk_update_(v, i, torch.from_numpy(scores),
                          torch.from_numpy(cids))
        model = _two_stage(torch.from_numpy(vals.copy()),
                           torch.from_numpy(ids.copy()),
                           torch.from_numpy(scores), torch.from_numpy(cids),
                           splits, span)
        for got in ((v, i), model):
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
        vals, ids = want[0].copy(), want[1].copy()
    assert topk.LAUNCHES["topk_update"] == 0              # plain on the CPU

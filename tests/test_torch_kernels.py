"""The port's streaming top-k (plain versions of K1 / K2 and
``superchunk_update``) against the reference's Pallas kernels.

The same numpy inputs, made from a seed, go through ``repro`` (Pallas in
interpret mode, as the reference's own tests run it on the CPU, and the
``lax.top_k`` oracles of ``repro.kernels.ref``) and through
``repro_torch`` on the CPU.  Inputs are integer-valued, so every dot
product is exact in float32 and float64 alike: ids and values must be
**bitwise equal** (tolerance 0), ties included.  NaN is held against the
reference's ``jax`` heap backend, not its Pallas kernel, which wipes a
query's whole tile on one NaN (see ROADMAP.md, reference fault 3).
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


def _ints(rng, *shape, lo=-2, hi=3):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _empty(q, k):
    return (np.full((q, k), NEG_INF, np.float32),
            np.full((q, k), -1, np.int32))


def _port_update(vals, ids, scores, cids):
    v, i = torch.from_numpy(vals.copy()), torch.from_numpy(ids.copy())
    ops.topk_update(v, i, torch.from_numpy(scores),
                    torch.from_numpy(cids))
    return v.numpy(), i.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("q,c,k,mode", [
    (5, 40, 7, "ties"), (3, 10, 16, "ties"),         # k > C
    (9, 300, 12, "neginf"), (1, 33, 1, "ties")])
def test_topk_update_matches_pallas(q, c, k, mode):
    rng = np.random.default_rng(q * c + k)
    vals, ids = _empty(q, k)
    for step in range(2):                            # empty, then full state
        scores = _ints(rng, q, c, lo=-3, hi=4)
        if mode == "neginf":
            scores[rng.random(scores.shape) < 0.3] = NEG_INF
        cids = (np.arange(c) + 5 + step * c).astype(np.int32)
        want = jops.topk_update(jnp.asarray(vals), jnp.asarray(ids),
                                scores, cids, interpret=True)
        _assert_same(jref.topk_update_ref(jnp.asarray(vals),
                                          jnp.asarray(ids),
                                          jnp.asarray(scores),
                                          jnp.asarray(cids)), want)
        got = _port_update(vals, ids, scores, cids)
        _assert_same(got, want)
        vals, ids = got


def test_topk_update_nan_follows_jax_heap():
    """NaN never surfaces an id and removes only itself."""
    rng = np.random.default_rng(7)
    q, c, k = 4, 50, 10
    heap = JaxHeap(q, k, impl="jax")
    vals, ids = _empty(q, k)
    for step in range(3):
        scores = _ints(rng, q, c, lo=-3, hi=4)
        scores[rng.random(scores.shape) < 0.2] = np.nan
        cids = (np.arange(c) + step * c).astype(np.int32)
        heap.update(scores, cids)
        vals, ids = _port_update(vals, ids, scores, cids)
    _assert_same((vals, ids), (np.asarray(heap.vals),
                               np.asarray(heap.ids)))


@pytest.mark.parametrize("q,n,d,k,offset,n_valid,dup", [
    (6, 40, 16, 5, 0, None, False),
    (13, 70, 8, 9, 1000, None, True),      # id_offset, duplicated rows
    (4, 30, 8, 6, 17, 11, False),          # n_valid < N
    (3, 6, 8, 10, 3, None, True),          # k > N
])
def test_fused_score_topk_matches_pallas(q, n, d, k, offset, n_valid, dup):
    rng = np.random.default_rng(n + k)
    queries = _ints(rng, q, d)
    docs = _ints(rng, n, d)
    if dup:
        docs[n // 2:] = docs[: n - n // 2]
    want = jtopk.fused_score_topk_pallas(
        jnp.asarray(queries), jnp.asarray(docs), k, id_offset=offset,
        n_valid=n_valid, bn=16, interpret=True)
    if n_valid is None and k <= n:
        _assert_same(jref.fused_score_topk_ref(
            jnp.asarray(queries), jnp.asarray(docs), k, offset), want)
    got = ops.fused_score_topk(torch.from_numpy(queries),
                               torch.from_numpy(docs), k, id_offset=offset,
                               n_valid=n_valid)
    _assert_same((got[0].numpy(), got[1].numpy()), want)


def test_fused_score_topk_neginf_and_empty():
    rng = np.random.default_rng(3)
    queries = _ints(rng, 5, 8, lo=1, hi=3)               # positive
    docs = _ints(rng, 12, 8)
    docs[[2, 7]] = NEG_INF                               # -inf scores
    want = jops.fused_score_topk(jnp.asarray(queries), jnp.asarray(docs),
                                 14, interpret=True)
    got = ops.fused_score_topk(torch.from_numpy(queries),
                               torch.from_numpy(docs), 14)
    _assert_same((got[0].numpy(), got[1].numpy()), want)
    assert (got[1][:, 10:] == -1).all()                  # never surfaced
    want = jops.fused_score_topk(jnp.asarray(queries),
                                 jnp.zeros((0, 8), jnp.float32), 4)
    got = ops.fused_score_topk(torch.from_numpy(queries),
                               torch.zeros((0, 8)), 4)
    _assert_same((got[0].numpy(), got[1].numpy()), want)


@pytest.mark.parametrize("merge", ["kernel", "torch"])
@pytest.mark.parametrize("score", ["fused", "torch"])
def test_superchunk_update_matches_reference_scan(score, merge):
    """Every port score x merge pair == every reference score x merge pair
    of the scan, bitwise, with ragged and padded (n_valid == 0) steps."""
    rng = np.random.default_rng(5)
    q, s, c, d, k = 7, 4, 12, 8, 9
    queries = _ints(rng, q, d)
    tile = _ints(rng, s, c, d)
    tile[2, :4] = tile[0, :4]                            # cross-step ties
    offsets = np.array([0, 12, 24, 36], np.int32)
    n_valids = np.array([12, 12, 7, 0], np.int32)
    vals, ids = _empty(q, k)
    v, i = torch.from_numpy(vals.copy()), torch.from_numpy(ids.copy())
    for _ in range(2):                                   # two superchunks
        ops.superchunk_update(v, i, torch.from_numpy(queries),
                              torch.from_numpy(tile),
                              torch.from_numpy(offsets),
                              torch.from_numpy(n_valids),
                              score=score, merge=merge)
        outs = [jops.superchunk_update(
            jnp.asarray(vals), jnp.asarray(ids), queries, tile, offsets,
            n_valids, k=k, score=js, merge=jm, interpret=True)
            for js in ("jax", "pallas_fused") for jm in ("jax", "pallas")]
        for out in outs:
            _assert_same((v.numpy(), i.numpy()), out)
        vals, ids = (np.asarray(outs[0][0]), np.asarray(outs[0][1]))
        offsets = offsets + 48


def test_superchunk_nan_scores_follow_jax_heap():
    """A NaN doc row drops only that row on every port path."""
    rng = np.random.default_rng(9)
    q, s, c, d, k = 3, 2, 8, 4, 6
    queries = _ints(rng, q, d)
    tile = _ints(rng, s, c, d)
    tile[1, 2] = np.nan
    heap = JaxHeap(q, k, impl="jax")
    for st in range(s):
        heap.update(queries @ tile[st].T,
                    np.arange(st * c, (st + 1) * c, dtype=np.int32))
    for score, merge in (("fused", "kernel"), ("torch", "kernel"),
                         ("torch", "torch")):
        v, i = ops.empty_state(q, k, "cpu")
        ops.superchunk_update(v, i, torch.from_numpy(queries),
                              torch.from_numpy(tile),
                              torch.tensor([0, c], dtype=torch.int32),
                              torch.tensor([c, c], dtype=torch.int32),
                              score=score, merge=merge)
        _assert_same((v.numpy(), i.numpy()),
                     (np.asarray(heap.vals), np.asarray(heap.ids)))


def test_select_rule_ties_signed_zeros_and_unsorted_state():
    """Stable descending order over [state | candidates]: the earlier
    entry wins a tie, -0.0 ties +0.0 (as ``jnp.argsort`` and the Pallas
    kernel compare; ``lax.top_k`` orders +0.0 first), and the state's
    own order breaks ties between state entries."""
    vals = torch.tensor([[1.0, 3.0, 1.0]])
    ids = torch.tensor([[10, 11, 12]], dtype=torch.int32)
    scores = torch.tensor([[1.0, -0.0, 0.0, 3.0]])
    cids = torch.tensor([20, 21, 22, 23], dtype=torch.int32)
    v, i = ref.topk_update_ref(vals, ids, scores, cids)
    assert v.tolist() == [[3.0, 3.0, 1.0]]
    assert i.tolist() == [[11, 23, 10]]
    v, i = ref.topk_update_ref(*ops.empty_state(1, 4, "cpu"), scores, cids)
    assert i.tolist() == [[23, 20, 21, 22]]


def test_wrappers_validate_inputs():
    v, i = ops.empty_state(2, 4, "cpu")
    scores = torch.zeros((2, 5))
    cids = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must be"):
        topk.topk_update_(*ops.empty_state(2, topk.MAX_K + 1, "cpu"),
                          scores, cids)
    with pytest.raises(ValueError, match="float32"):
        topk.topk_update_(v, i, scores.double(), cids)
    with pytest.raises(ValueError, match="contiguous"):
        topk.topk_update_(v, i, torch.zeros((5, 2)).T, cids)
    with pytest.raises(ValueError, match="do not match"):
        topk.topk_update_(v, i, scores, cids[:3])
    with pytest.raises(ValueError, match="queries"):
        topk.fused_score_topk_(v, i, torch.zeros((3, 8)),
                               torch.zeros((1, 4, 8)),
                               torch.zeros(1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown score"):
        ops.superchunk_update(v, i, torch.zeros((2, 8)),
                              torch.zeros((1, 4, 8)),
                              torch.zeros(1, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32),
                              score="pallas_fused")
    assert topk.LAUNCHES == {"fused_score_topk": 0, "topk_update": 0}

"""The port's FastResultHeapq (python | torch | kernel impls, on the CPU)
against the reference's (python | jax | pallas), on the example grid of
``tests/test_property_search_stack.py``: ties, NaN, -inf, k > corpus and
merge order.  Same numpy scores into both; finalized values and ids must
be bitwise equal (tolerance 0: selection does no arithmetic).

Signed zeros: ``lax.top_k`` orders +0.0 ahead of -0.0, while the port
(like the reference's Pallas kernel and ``jnp.argsort``) treats them as
a tie.  The grid's rounded scores contain -0.0, so inputs are mapped to
+0.0 before the cross-package comparison; the port's own signed-zero
rule is pinned in ``test_torch_kernels.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.core.result_heap import FastResultHeapq as JaxHeap
from repro_torch.core.result_heap import FastResultHeapq

torch.set_num_threads(1)

# port impl -> the reference impl with the same tie rule
PAIRS = {"python": "python", "torch": "jax", "kernel": "jax"}
MODES = ("unique", "ties", "nan", "neginf", "mixed")
GRID = [(3, 40, 7, 4), (1, 5, 12, 2), (4, 17, 17, 3), (2, 8, 3, 1)]


def _make_scores(q, n, seed, mode):
    """The generator of test_property_search_stack, zeros made +0.0."""
    rng = np.random.default_rng(seed)
    if mode == "unique":
        return rng.permutation(q * n).astype(np.float32).reshape(q, n)
    scores = rng.normal(size=(q, n)).astype(np.float32)
    if mode == "ties":
        scores = np.round(scores)
    elif mode == "nan":
        scores[rng.random(size=scores.shape) < 0.15] = np.nan
    elif mode == "neginf":
        scores[rng.random(size=scores.shape) < 0.15] = -np.inf
    elif mode == "mixed":
        scores = np.round(scores * 2)
        scores[rng.random(size=scores.shape) < 0.1] = np.nan
        scores[rng.random(size=scores.shape) < 0.1] = -np.inf
    return np.where(scores == 0, np.float32(0.0), scores)


def _stream(heap_cls, impl, scores, k, n_chunks, via_merge, **kw):
    q, n = scores.shape
    heap = heap_cls(q, k, impl=impl, **kw)
    edges = np.linspace(0, n, n_chunks + 1).astype(int)
    for lo, hi in zip(edges, edges[1:]):
        if lo == hi:
            continue
        ids = np.arange(lo, hi, dtype=np.int32)
        if via_merge:
            shard = heap_cls(q, k, impl=impl, **kw)
            shard.update(scores[:, lo:hi], ids)
            heap.merge_arrays(*shard.finalize())
        else:
            heap.update(scores[:, lo:hi], ids)
    return heap.finalize()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("impl", sorted(PAIRS))
@pytest.mark.parametrize("mode", MODES)
def test_heap_grid_matches_reference(impl, mode):
    for (q, n, k, chunks), via_merge in itertools.product(GRID,
                                                          [False, True]):
        scores = _make_scores(q, n, seed=q * n + k, mode=mode)
        got = _stream(FastResultHeapq, impl, scores, k, chunks, via_merge,
                      device="cpu")
        want = _stream(JaxHeap, PAIRS[impl], scores, k, chunks, via_merge)
        assert got[1].dtype == np.int64
        _assert_same(got, want)


@pytest.mark.parametrize("mode", ("unique", "mixed"))
def test_kernel_heap_matches_reference_pallas_heap(mode):
    # the reference's pallas heap runs in interpret mode: small grid
    for n, k in ((20, 5), (12, 15)):
        scores = _make_scores(2, n, seed=3, mode=mode)
        _assert_same(_stream(FastResultHeapq, "kernel", scores, k, 2,
                             False, device="cpu"),
                     _stream(JaxHeap, "pallas", scores, k, 2, False))


@pytest.mark.parametrize("impl", sorted(PAIRS))
@pytest.mark.parametrize("mode", ("unique", "ties"))
def test_merge_order_matches_reference(impl, mode):
    """Merging shard states in any order: the same result as the
    reference merging them in that order."""
    for q, n, k, shards in [(3, 30, 6, 3), (2, 11, 4, 5), (1, 6, 9, 2)]:
        scores = _make_scores(q, n, seed=n + k, mode=mode)
        edges = np.linspace(0, n, shards + 1).astype(int)
        states = [_stream(JaxHeap, PAIRS[impl], scores[:, lo:hi] if hi > lo
                          else scores[:, :0], k, 1, False)
                  for lo, hi in zip(edges, edges[1:])]
        states = [(v, np.where(i >= 0, i + lo, -1))
                  for (v, i), lo in zip(states, edges)]
        for order in np.random.default_rng(17).permutation(
                [list(range(shards))] * 3, axis=1):
            got = FastResultHeapq(q, k, impl=impl, device="cpu")
            want = JaxHeap(q, k, impl=PAIRS[impl])
            for si in order:
                got.merge_arrays(*states[si])
                want.merge_arrays(*states[si])
            _assert_same(got.finalize(), want.finalize())


def test_heap_state_hand_off():
    heap = FastResultHeapq(2, 3, impl="kernel", device="cpu")
    vals = torch.tensor([[1.0, 5.0, 3.0], [2.0, 2.0, -1.0]])
    ids = torch.tensor([[7, 8, 9], [1, 2, 3]], dtype=torch.int32)
    heap.adopt_state(vals, ids)
    v, i = heap.finalize_device()
    assert v.tolist() == [[5.0, 3.0, 1.0], [2.0, 2.0, -1.0]]
    assert i.tolist() == [[8, 9, 7], [1, 2, 3]]
    with pytest.raises(ValueError, match="state"):
        heap.adopt_state(vals[:1], ids[:1])
    py = FastResultHeapq(2, 3, impl="python", device="cpu")
    with pytest.raises(ValueError, match="python"):
        py.adopt_state(vals, ids)
    with pytest.raises(ValueError, match="heap impl"):
        FastResultHeapq(2, 3, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="k <="):
        FastResultHeapq(2, 300, impl="kernel", device="cpu")

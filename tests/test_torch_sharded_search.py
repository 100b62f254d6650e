"""W > 1 workers, the port against the reference.

The round-versioned ``FairSharder``, the multi-worker
``ShardedSearchDriver``, ``SimulatedCluster`` / ``InMemoryAllGather`` and
the injector's chunk and gather points.  On fixed embeddings (the
``_load_from`` arrays, a warm cache) every score_impl x heap_impl pair
of the port returns at W in {2, 4}, on every rank, a result bitwise
equal to its W = 1 result; against the reference's W = 1 run (JAX on
the CPU, the same encoder weights through ``params_from_jax``) ids agree
wherever neighbouring scores are more than ``TOL = 1e-5`` apart and
scores within ``TOL``.  The sharder and the injector are driven with the
same calls on both packages.  Barrier and acquire waits are lowered to a
few seconds, so a deadlock fails fast instead of hanging the run.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import fair_sharding as ref_sharding
from repro.core import faults as ref_faults
from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.embedding_cache import EmbeddingCache as RefCache
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.launch import distributed as ref_dist
from repro_torch.core import fair_sharding, faults
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.core.result_heap import FastResultHeapq
from repro_torch.core.sharded_search import (ProcessAllGather,
                                            ShardedSearchDriver)
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import embedding_bag, ops, topk
from repro_torch.launch import distributed
from repro_torch.launch.distributed import InMemoryAllGather, SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

pytestmark = pytest.mark.distributed

torch.set_num_threads(1)

TOL = 1e-5
DIM = 32
METRICS = ("ndcg@10", "recall@10")
SCORE_IMPLS = ("numpy", "torch", "fused")
HEAP_IMPLS = ("python", "torch", "kernel")
PAIRS = [(s, h) for s in SCORE_IMPLS for h in HEAP_IMPLS]
WAIT_S = 5.0


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a test within seconds, on both packages."""
    for cls in (fair_sharding.FairSharder, ref_sharding.FairSharder):
        monkeypatch.setattr(cls, "ACQUIRE_TIMEOUT_S", WAIT_S)
    monkeypatch.setattr(InMemoryAllGather, "BARRIER_TIMEOUT_S", WAIT_S)


# -- driver level (synthetic embeddings, no encoder) -------------------------


def _load_from(docs):
    return lambda lo, hi: docs[lo:hi]


@pytest.fixture()
def synth():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    docs = rng.normal(size=(230, 16)).astype(np.float32)
    return q, docs


def _driver(score, heap, w=1, rank=0, cluster=None, **kw):
    kw.setdefault("chunk_size", 37)
    kw.setdefault("superchunk_size", 4)
    if cluster is not None:
        kw.update(sharder=cluster.sharder, gather=cluster.gather)
    return ShardedSearchDriver(n_workers=w, worker_index=rank,
                               score_impl=score, heap_impl=heap,
                               device="cpu", **kw)


def _cluster_run(w, make_driver, search):
    """All ranks' results of one round of W drivers."""
    cluster = SimulatedCluster(w)
    drivers = [make_driver(rank, cluster) for rank in range(w)]
    return cluster.run(lambda rank: search(drivers[rank])), drivers


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("score,heap", PAIRS)
def test_driver_w1_matches_argsort_oracle(synth, score, heap):
    """A single-worker driver is exactly brute-force top-k."""
    q, docs = synth
    vals, pos = _driver(score, heap).search(q, len(docs), _load_from(docs),
                                            10)
    full = q.astype(np.float64) @ docs.astype(np.float64).T
    oracle = np.argsort(-full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(pos, oracle)
    np.testing.assert_allclose(vals, np.take_along_axis(full, oracle, 1),
                               rtol=1e-6)


@pytest.mark.parametrize("w", (2, 4))
@pytest.mark.parametrize("score,heap", PAIRS)
def test_simulated_cluster_matches_w1(synth, score, heap, w):
    """W drivers + the in-memory all-gather == the W = 1 driver bitwise,
    every rank the same merged result, and each rank scored its own
    contiguous shard of one round."""
    q, docs = synth
    want = _driver(score, heap).search(q, len(docs), _load_from(docs), 10)
    outs, drivers = _cluster_run(
        w, lambda rank, cl: _driver(score, heap, w, rank, cl),
        lambda d: d.search(q, len(docs), _load_from(docs), 10))
    for out in outs:
        _assert_bitwise(out, want)
    bounds = [(d.stats["lo"], d.stats["hi"]) for d in drivers]
    assert [lo for lo, _ in bounds] == [0] + [hi for _, hi in bounds[:-1]]
    assert bounds[-1][1] == len(docs)
    assert {d.stats["round"] for d in drivers} == {0}


@pytest.mark.parametrize("w", (1, 2))
def test_prefetch_does_not_change_results(synth, w):
    q, docs = synth
    outs = {}
    for prefetch in (False, True):
        outs[prefetch], _ = _cluster_run(
            w, lambda rank, cl: _driver("numpy", "kernel", w, rank, cl,
                                        chunk_size=23, prefetch=prefetch),
            lambda d: d.search(q, len(docs), _load_from(docs), 7))
    for a, b in zip(outs[True], outs[False]):
        _assert_bitwise(a, b)


def test_each_rank_loads_its_shard_once_in_order(synth):
    q, docs = synth
    calls = {0: [], 1: []}

    def loader(rank):
        def load(lo, hi):
            calls[rank].append((lo, hi))
            return docs[lo:hi]
        return load

    _, drivers = _cluster_run(
        2, lambda rank, cl: _driver("numpy", "kernel", 2, rank, cl,
                                    chunk_size=50),
        lambda d: d.search(q, len(docs), loader(d.worker_index), 5))
    assert calls == {0: [(0, 50), (50, 100), (100, 115)],
                     1: [(115, 165), (165, 215), (215, 230)]}
    assert [d.stats["chunks"] for d in drivers] == [3, 3]
    assert [d.stats["items"] for d in drivers] == [115, 115]


@pytest.mark.parametrize("score,heap", PAIRS)
def test_cluster_with_fewer_docs_than_workers(synth, score, heap):
    """3 docs over 4 workers: an empty shard is legal and the merged
    result still equals W = 1, the tail empty."""
    q, docs = synth
    docs = docs[:3]
    want = _driver(score, heap, chunk_size=8).search(
        q, 3, _load_from(docs), 5)
    outs, drivers = _cluster_run(
        4, lambda rank, cl: _driver(score, heap, 4, rank, cl, chunk_size=8),
        lambda d: d.search(q, 3, _load_from(docs), 5))
    for out in outs:
        _assert_bitwise(out, want)
    assert (want[1][:, 3:] == -1).all()
    assert sorted(d.stats["items"] for d in drivers) == [0, 1, 1, 1]


@pytest.mark.parametrize("score,heap", PAIRS)
def test_ties_across_ranks_keep_the_lower_position(score, heap):
    """An all-equal-scores corpus: whatever the shards, the tie rule of
    W = 1 holds — the lower position wins on the device heaps, since
    ranks merge in rank order and hold increasing position ranges (the
    python heap keeps heapq's larger id, at every W alike)."""
    q = np.ones((3, 8), np.float32)
    docs = np.full((50, 8), 0.5, np.float32)
    want = _driver(score, heap, chunk_size=6).search(
        q, len(docs), _load_from(docs), 10)
    order = np.arange(49, 39, -1) if heap == "python" else np.arange(10)
    np.testing.assert_array_equal(want[1], np.tile(order, (3, 1)))
    outs, _ = _cluster_run(
        4, lambda rank, cl: _driver(score, heap, 4, rank, cl, chunk_size=6),
        lambda d: d.search(q, len(docs), _load_from(docs), 10))
    for out in outs:
        _assert_bitwise(out, want)


def test_cluster_propagates_worker_errors():
    """A worker's error aborts the gather and reaches the caller, while
    its siblings blocked in the barrier are released at once."""
    cluster = SimulatedCluster(3)

    def worker(rank):
        if rank == 1:
            raise ValueError("boom on rank 1")
        return cluster.gather.merge(FastResultHeapq(2, 3, device="cpu"),
                                    rank)

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom on rank 1"):
        cluster.run(worker)
    assert time.monotonic() - t0 < WAIT_S


def test_barrier_timeout_breaks_instead_of_hanging():
    """A rank that never arrives breaks the barrier after the timeout."""
    gather = InMemoryAllGather(2)
    gather.BARRIER_TIMEOUT_S = 0.2
    t0 = time.monotonic()
    with pytest.raises(threading.BrokenBarrierError):
        gather.merge(FastResultHeapq(2, 3, device="cpu"), 0)
    assert time.monotonic() - t0 < WAIT_S


def test_driver_validates_its_rank_and_sharder():
    with pytest.raises(ValueError, match="worker_index 2"):
        ShardedSearchDriver(n_workers=2, worker_index=2, device="cpu")
    with pytest.raises(ValueError, match="sharder has 1"):
        ShardedSearchDriver(n_workers=2, sharder=fair_sharding.FairSharder(1),
                            device="cpu")


def test_process_gather_needs_a_gloo_backend(synth, monkeypatch):
    """Under a default group without gloo the transport raises at its
    first gather, before any collective, and names the way out."""
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
    q, docs = synth
    heap = FastResultHeapq(q.shape[0], 5, device="cpu")
    with pytest.raises(RuntimeError, match="'nccl'.*init_distributed"):
        ProcessAllGather().merge(heap, 0)
    drv = _driver("torch", "kernel", w=2, gather=ProcessAllGather())
    with pytest.raises(RuntimeError, match="gathers host tensors over gloo"):
        drv.search(q, docs.shape[0], _load_from(docs), 5)


@pytest.mark.parametrize("pkg", (ref_sharding, fair_sharding),
                         ids=("reference", "port"))
def test_round_stable_bounds_under_staggered_updates(pkg):
    """A worker reporting its round must not move the bounds its siblings
    of the same round still have to read."""
    s = pkg.FairSharder(2)
    before = s.bounds(1000)
    s.update(0, 500, 0.1)
    assert s.bounds(1000) == before
    s.update(1, 500, 10.0)
    after = s.bounds(1000)
    assert after != before
    assert after[0][1] - after[0][0] > after[1][1] - after[1][0]


# -- the sharder on both packages ---------------------------------------------


def _both_sharders(n):
    return ref_sharding.FairSharder(n), fair_sharding.FairSharder(n)


def test_bounds_sequence_matches_reference():
    """A fixed sequence of rounds and round-tagged reports (stragglers,
    an empty shard, late and duplicate reports) gives both packages the
    same bounds, round numbers and throughput EMA."""
    rng = np.random.default_rng(5)
    ref, port = _both_sharders(3)
    for rnd in range(12):
        total = int(rng.integers(0, 5000))
        got = [[s.acquire(w, total) for w in range(3)] for s in (ref, port)]
        assert got[0] == got[1]
        assert [r for r, _ in got[1]] == [rnd] * 3
        for w in rng.permutation(3):
            lo, hi = got[1][w][1][w]
            secs = float(rng.uniform(0.01, 2.0)) * (5 if w == 2 else 1)
            for s in (ref, port):
                s.update(int(w), hi - lo, secs, round_no=rnd)
                s.update(int(w), hi - lo, 9.0, round_no=rnd - 1)  # late
        np.testing.assert_array_equal(port.throughput, ref.throughput)


@pytest.mark.parametrize("pkg", (ref_sharding, fair_sharding),
                         ids=("reference", "port"))
def test_generation_mismatch_does_not_consume_the_round(pkg):
    sharder = pkg.FairSharder(2)
    r0, _ = sharder.acquire(0, 100, generation=(5, 0))
    assert r0 == 0
    with pytest.raises(pkg.GenerationMismatch) as ei:
        sharder.acquire(1, 100, generation=(6, 0))
    assert (ei.value.agreed, ei.value.mine, ei.value.round_no) == (
        (5, 0), (6, 0), 0)
    r1, _ = sharder.acquire(1, 100, generation=(5, 0))
    assert r1 == 0
    sharder.update(0, 50, 0.1, round_no=0)
    sharder.update(1, 50, 0.1, round_no=0)
    assert sharder.acquire(0, 100, generation=(6, 0))[0] == 1
    assert sharder.acquire(1, 100, generation=(6, 0))[0] == 1


@pytest.mark.parametrize("pkg", (ref_sharding, fair_sharding),
                         ids=("reference", "port"))
def test_generation_agreement_ignored_when_unpinned(pkg):
    sharder = pkg.FairSharder(2)
    sharder.acquire(0, 10)
    sharder.acquire(1, 10, generation=(1, 0))   # the first *keyed* acquirer
    sharder.update(0, 5, 0.1, round_no=0)
    sharder.update(1, 5, 0.1, round_no=0)
    assert sharder.acquire(0, 10, generation=(2, 0))[0] == 1


def test_acquire_timeout_and_abort_diagnostics_match_reference():
    """The same calls raise ShardAborted with the same message on both
    packages: a timed-out wait names the blocking round and the workers
    it waits on; an abort releases a blocked waiter with its cause."""
    msgs = []
    for s in _both_sharders(2):
        s.ACQUIRE_TIMEOUT_S = 0.1
        assert s.acquire(0, 100)[0] == 0
        s.update(0, 50, 1.0, round_no=0)
        with pytest.raises(Exception) as ei:
            s.acquire(0, 100)                 # round 1 blocks on worker 1
        assert type(ei.value).__name__ == "ShardAborted"
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "round 0" in msgs[1] and "workers [1]" in msgs[1]
    assert "no round committed yet" in msgs[1]

    msgs = []
    for s in _both_sharders(2):
        s.acquire(0, 100)
        errs = []

        def blocked():
            try:
                s.acquire(0, 100)
            except Exception as e:            # noqa: BLE001 — inspected
                errs.append(e)

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.05)
        boom = RuntimeError("worker 1 exploded")
        s.abort(boom)
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
        (err,) = errs
        assert err.__cause__ is boom
        msgs.append(str(err))
    assert msgs[0] == msgs[1]
    assert "aborted while worker 0 waited for round 1" in msgs[1]


# -- the injector -------------------------------------------------------------


def test_fault_validation():
    with pytest.raises(ValueError, match="fault kind"):
        faults.Fault(kind="meteor")
    with pytest.raises(ValueError, match="fault phase"):
        faults.Fault(kind="crash", phase="orbit")
    with pytest.raises(ValueError, match="torn-write point"):
        faults.Fault(kind="torn_write", point="nowhere")


def test_injector_fires_once_and_logs():
    inj = faults.FaultInjector([faults.Fault(kind="crash", worker=1,
                                             round=0)])
    inj.on_chunk(0, 0, 0)                   # wrong worker: no fire
    inj.on_chunk(1, 1, 0)                   # wrong round: no fire
    with pytest.raises(faults.InjectedCrash):
        inj.on_chunk(1, 0, 0)
    inj.on_chunk(1, 0, 0)                   # one-shot: spent
    assert inj.fired == [("crash", 1, 0, "load")]


def test_injector_repeat_fires_every_match():
    inj = faults.FaultInjector([faults.Fault(kind="crash", repeat=True)])
    for _ in range(3):
        with pytest.raises(faults.InjectedCrash):
            inj.on_chunk(0, 0, 0)
    assert len(inj.fired) == 3


def test_injector_stall_sleeps_instead_of_raising():
    inj = faults.FaultInjector([faults.Fault(kind="stall", stall_s=0.1)])
    t0 = time.monotonic()
    inj.on_chunk(0, 0, 0)
    assert time.monotonic() - t0 >= 0.09


def test_injector_gather_drop():
    inj = faults.FaultInjector([faults.Fault(kind="drop", worker=2,
                                             phase="gather")])
    inj.on_gather(0, 0)
    with pytest.raises(faults.InjectedTransportDrop):
        inj.on_gather(2, 0)
    assert inj.fired == [("drop", 2, 0, "gather")]


def test_chunk_faults_never_fire_at_cache_points():
    """A driver fault and a cache fault share one injector without
    firing at each other's points."""
    inj = faults.FaultInjector([faults.Fault(kind="crash"),
                                faults.Fault(kind="stall", stall_s=0.0)])
    inj.on_cache("payload")
    assert inj.fired == []
    cache_stall = faults.Fault(kind="stall", point="meta")
    assert cache_stall.phase == "cache"
    inj = faults.FaultInjector([cache_stall])
    inj.on_chunk(0, 0, 0)
    assert inj.fired == []


def _recording(pkg):
    class Recording(pkg.FaultInjector):
        def __init__(self, faults_):
            super().__init__(faults_)
            self.chunk_calls = []

        def on_chunk(self, worker, round_no, chunk_index, phase="load"):
            self.chunk_calls.append((worker, round_no, chunk_index, phase))
            super().on_chunk(worker, round_no, chunk_index, phase)
    return Recording


@pytest.mark.parametrize("s", (1, 8))
@pytest.mark.parametrize("j", (0, 5, 11))
def test_chunk_fault_fires_at_the_reference_chunk_index(synth, s, j):
    """A crash at chunk j fires at the same chunk index on the port's
    superchunk executor (S = 1 and S = 8) as on the reference's per-chunk
    stream: the same on_chunk calls, the same message."""
    q, docs = synth
    runs = []
    for pkg, make in (
            (ref_faults, lambda inj: RefDriver(
                score_impl="numpy", chunk_size=16, fault_injector=inj)),
            (faults, lambda inj: _driver(
                "fused", "kernel", chunk_size=16, superchunk_size=s,
                fault_injector=inj))):
        inj = _recording(pkg)([pkg.Fault(kind="crash", chunk=j)])
        with pytest.raises(pkg.InjectedCrash) as ei:
            make(inj).search(q, len(docs), _load_from(docs), 5)
        runs.append((inj.chunk_calls, inj.fired, str(ei.value)))
    assert runs[0] == runs[1]
    assert runs[1][0][-1] == (0, 0, j, "load")


def test_chunk_fault_index_at_w2_matches_reference(synth):
    """At W = 2 each rank counts chunks from its own shard's start, and
    a stall on rank 1's third chunk fires there on both packages."""
    q, docs = synth
    fired = []
    for pkg, cluster_cls, make in (
            (ref_faults, ref_dist.SimulatedCluster,
             lambda rank, cl, inj: RefDriver(
                 n_workers=2, worker_index=rank, sharder=cl.sharder,
                 gather=cl.gather, score_impl="numpy", heap_impl="python",
                 chunk_size=16, fault_injector=inj)),
            (faults, SimulatedCluster,
             lambda rank, cl, inj: _driver(
                 "torch", "kernel", 2, rank, cl, chunk_size=16,
                 superchunk_size=8, fault_injector=inj))):
        inj = _recording(pkg)([pkg.Fault(kind="stall", worker=1, chunk=2,
                                         stall_s=0.01)])
        cluster = cluster_cls(2)
        drivers = [make(rank, cluster, inj) for rank in range(2)]
        cluster.run(lambda rank: drivers[rank].search(
            q, len(docs), _load_from(docs), 5))
        fired.append((inj.fired, sorted(inj.chunk_calls)))
    assert fired[0] == fired[1]
    assert fired[1][0] == [("stall", 1, 0, "load")]


@pytest.mark.parametrize("kind", ("crash", "drop"))
def test_w2_fault_reraises_the_original_error(synth, kind):
    """A crash on rank 1 (or a drop of its state against the barrier
    transport) reaches the caller as the injected error, not as a
    sibling's BrokenBarrierError, without a hang — on both packages."""
    q, docs = synth
    for pkg, cluster_cls, make in (
            (ref_faults, ref_dist.SimulatedCluster,
             lambda rank, cl, inj: RefDriver(
                 n_workers=2, worker_index=rank, sharder=cl.sharder,
                 gather=cl.gather, score_impl="numpy", heap_impl="python",
                 chunk_size=16, fault_injector=inj)),
            (faults, SimulatedCluster,
             lambda rank, cl, inj: _driver(
                 "fused", "kernel", 2, rank, cl, chunk_size=16,
                 fault_injector=inj))):
        fault = (pkg.Fault(kind="crash", worker=1, chunk=1)
                 if kind == "crash" else
                 pkg.Fault(kind="drop", worker=1, phase="gather"))
        inj = pkg.FaultInjector([fault])
        cluster = cluster_cls(2)
        drivers = [make(rank, cluster, inj) for rank in range(2)]
        want = (pkg.InjectedCrash if kind == "crash"
                else pkg.InjectedTransportDrop)
        t0 = time.monotonic()
        with pytest.raises(want):
            cluster.run(lambda rank: drivers[rank].search(
                q, len(docs), _load_from(docs), 5))
        assert time.monotonic() - t0 < WAIT_S
        assert inj.fired == [(kind, 1, 0, "load" if kind == "crash"
                              else "gather")]


# -- W = 2 over a compaction crash (test_faults.py, flat) --------------------


def _mutated_cache(root):
    cache = EmbeddingCache(str(root), dim=8)
    rng = np.random.default_rng(0)
    cache.cache_records([f"d{i}" for i in range(24)],
                        rng.normal(size=(24, 8)).astype(np.float32))
    cache.delete_records(["d3", "d10"])
    cache.cache_records(["d5"], np.full((1, 8), 2.0, np.float32))
    return cache


@pytest.mark.parametrize("point", ("compact_payload", "compact_meta",
                                   "compact_swap"))
def test_compaction_crash_then_w2_search_matches_oracle(tmp_path, point):
    """A crash at each compaction point reopens to one generation, and a
    W = 2 search over the reopened cache is bitwise the W = 1 search."""
    cache = _mutated_cache(tmp_path / "c")
    gen0 = cache.generation
    cache.fault_injector = faults.FaultInjector(
        [faults.Fault(kind="torn_write", point=point)])
    with pytest.raises(faults.InjectedCrash):
        cache.compact()
    reopened = EmbeddingCache(str(tmp_path / "c"), dim=8)
    assert reopened.generation == gen0
    assert reopened.epoch == (1 if point == "compact_swap" else 0)
    with reopened.snapshot() as snap:
        assert snap.n_live == 22
        docs = snap.get_range(0, snap.n_live).astype(np.float32)
    q = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    want = _driver("numpy", "python", chunk_size=16).search(
        q, len(docs), _load_from(docs), 5)
    for score, heap in (("numpy", "python"), ("fused", "kernel")):
        outs, _ = _cluster_run(
            2, lambda rank, cl: _driver(score, heap, 2, rank, cl,
                                        chunk_size=8),
            lambda d: d.search(q, len(docs), _load_from(docs), 5))
        for out in outs:
            _assert_bitwise(out, want)


# -- launch counters under threads --------------------------------------------


class _SwitchingDict(dict):
    """A counter mapping whose item reads give up the interpreter lock,
    so other threads run between an increment's read and its write, as
    they may inside any bare ``counts[name] += 1``."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counters_count_exactly_under_threads():
    """8 threads x 10,000 bumps of each kernel's counter (and 1,000 of a
    counter that yields mid-increment), with the interpreter switching
    threads as often as it can: no count is lost, and
    ``launch_counts`` / ``reset_launch_counts`` see every kernel."""
    ops.reset_launch_counts()
    switching = _SwitchingDict(k=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for i in range(10_000):
                topk.count_launch(topk.LAUNCHES, "fused_score_topk")
                topk.count_launch(topk.LAUNCHES, "topk_update")
                topk.count_launch(embedding_bag.LAUNCHES, "embedding_bag")
                topk.count_launch(embedding_bag.LAUNCHES,
                                  "embedding_bag_backward")
                if i % 10 == 0:
                    topk.count_launch(switching, "k")

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert dict(switching) == {"k": 8_000}
    assert ops.launch_counts() == {"fused_score_topk": 80_000,
                                   "topk_update": 80_000,
                                   "embedding_bag": 80_000,
                                   "embedding_bag_backward": 80_000}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# -- evaluator level (real encoder) -------------------------------------------


@pytest.fixture(scope="module")
def port(tiny_lm_cfg, tiny_params):
    fields = {f: getattr(tiny_lm_cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "activation", "norm", "qkv_bias",
        "rope_theta", "pooling")}
    cfg = tf.LMConfig(**fields, dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, tiny_params), cfg,
                             device="cpu")
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    collator = RetrievalCollator(DataArguments(vocab_size=257),
                                 HashTokenizer(257))

    def make(score_impl="fused", heap_impl="kernel", rank=0, world=1,
             cluster=None, **kw):
        # encode_batch_size=20: a ragged last chunk for every shard split
        args = EvaluationArguments(topk=10, encode_batch_size=20,
                                   score_impl=score_impl,
                                   heap_impl=heap_impl, metrics=METRICS)
        if cluster is not None:
            kw.update(gather=cluster.gather, sharder=cluster.sharder)
        return RetrievalEvaluator(args, retriever, collator, params,
                                  device="cpu", process_index=rank,
                                  process_count=world, **kw)
    return make


@pytest.fixture(scope="module")
def env(tiny_retriever, tiny_params, retrieval_data, tmp_path_factory):
    """The reference's W = 1 numpy runs (online, and warm over its own
    cache), computed once."""
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ref = JaxEvaluator(JaxEvalArgs(topk=10, encode_batch_size=20,
                                   score_impl="numpy", metrics=METRICS),
                       tiny_retriever, coll, tiny_params,
                       process_index=0, process_count=1)
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    path = str(tmp_path_factory.mktemp("w_matrix") / "cache")
    ref_cache = RefCache(path, dim=DIM)
    ref.search(queries, corpus, cache=ref_cache)
    return {"online": ref.search(queries, corpus),
            "warm": ref.search(queries, corpus, cache=ref_cache),
            "cache_path": path}


@pytest.fixture(scope="module")
def warm_cache(env):
    """The reference's warm cache directory, opened by the port: both
    packages' warm passes score the same float16 rows."""
    return EmbeddingCache(env["cache_path"], dim=DIM)


def _separated(vals):
    inf = np.full_like(vals[:, :1], np.inf)
    up = np.concatenate([inf, vals[:, :-1]], 1) - vals
    down = vals - np.concatenate([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def _assert_close_ranking(got, want):
    """scores within TOL, ids equal where the ranking is unambiguous."""
    (gqh, gi, gv), (wqh, wi, wv) = got, want
    np.testing.assert_array_equal(gqh, wqh)
    np.testing.assert_allclose(gv, wv, atol=TOL, rtol=0)
    sep = _separated(wv)
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(gi[sep], wi[sep])


def _evaluator_search(port, score, world, queries, corpus, caches,
                      heap="kernel"):
    """All ranks' (q_hashes, ids, scores) of one W-worker search."""
    if world == 1:
        return [port(score, heap).search(queries, corpus, cache=caches[0])]
    cluster = SimulatedCluster(world)
    evs = [port(score, heap, rank, world, cluster)
           for rank in range(world)]
    return cluster.run(lambda rank: evs[rank].search(queries, corpus,
                                                     cache=caches[rank]))


@pytest.mark.parametrize("regime", ("warm", "online"))
@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("score", SCORE_IMPLS)
def test_matrix_matches_reference(port, env, warm_cache, retrieval_data,
                                  score, world, regime):
    """score_impl x W against the reference's W = 1 numpy run, every rank
    identical; on the warm cache bitwise equal to the port's W = 1."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    cache = warm_cache if regime == "warm" else None
    outs = _evaluator_search(port, score, world, queries, corpus,
                             [cache] * world)
    for out in outs:
        _assert_close_ranking(out, env[regime])
        _assert_bitwise(out, outs[0])
    if regime == "warm":
        want = port(score).search(queries, corpus, cache=warm_cache)
        _assert_bitwise(outs[0], want)


@pytest.mark.parametrize("score", ("numpy", "torch"))
def test_cold_worker_caches_cover_the_corpus_once(port, env, retrieval_data,
                                                  tmp_path, score):
    """Cold per-worker caches (each worker encodes its own shard): the
    ranking matches the reference's W = 1, and the worker caches jointly
    hold every corpus row exactly once."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    caches = [EmbeddingCache(str(tmp_path / f"w{r}"), dim=DIM)
              for r in range(2)]
    outs = _evaluator_search(port, score, 2, queries, corpus, caches)
    for out in outs:
        _assert_close_ranking(out, env["online"])
    assert sum(len(c) for c in caches) == len(corpus)
    ids = []
    for c in caches:
        with c.snapshot() as snap:
            ids.append(snap.ids.copy())
    assert len(np.unique(np.concatenate(ids))) == len(corpus)


def test_shared_cold_cache_stays_consistent(port, retrieval_data, tmp_path):
    """Two workers filling one cache directory: every corpus id lands
    once and is readable, and warm passes over it are bitwise
    repeatable and equal to W = 1."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    cache = EmbeddingCache(str(tmp_path / "shared"), dim=DIM)
    _evaluator_search(port, "torch", 2, queries, corpus, [cache] * 2)
    assert len(cache) == len(corpus)
    assert cache.get(list(corpus)).shape == (len(corpus), DIM)
    warm1 = _evaluator_search(port, "torch", 2, queries, corpus, [cache] * 2)
    warm2 = _evaluator_search(port, "torch", 2, queries, corpus, [cache] * 2)
    _assert_bitwise(warm1[0], warm2[0])
    _assert_bitwise(warm1[1], port("torch").search(queries, corpus,
                                                   cache=cache))


def test_live_cache_generation_mismatch_re_prepares(port, warm_cache,
                                                    retrieval_data,
                                                    tmp_path):
    """Rows added between rank 0's and rank 1's prepare: rank 1's acquire
    gets GenerationMismatch with the round not consumed, re-prepares at
    the agreed key, and both ranks return the W = 1 search of the agreed
    snapshot."""
    import shutil
    shutil.copytree(warm_cache.path, tmp_path / "live")
    cache = EmbeddingCache(str(tmp_path / "live"), dim=DIM)
    texts = list(retrieval_data["queries"].values())[:6]
    key0 = cache.generation_key
    cluster = SimulatedCluster(2)
    evs = [port("fused", "kernel", rank, 2, cluster) for rank in range(2)]
    acquired = threading.Event()
    acquire = cluster.sharder.acquire

    def acquire_then_signal(worker, *args, **kw):
        try:
            return acquire(worker, *args, **kw)
        finally:
            if worker == 0:
                acquired.set()

    cluster.sharder.acquire = acquire_then_signal
    mismatches = []

    def worker(rank):
        if rank == 1:
            assert acquired.wait(WAIT_S)
            rng = np.random.default_rng(9)
            cache.cache_records([f"new{i}" for i in range(4)],
                                rng.normal(size=(4, DIM)).astype(np.float32))
        prepared = evs[rank].prepare_cache_corpus(cache)
        try:
            return evs[rank].search_texts(texts, prepared)
        except fair_sharding.GenerationMismatch as e:
            mismatches.append((rank, e.round_no, e.agreed, e.mine))
            prepared.close()
            prepared = evs[rank].prepare_cache_corpus(cache, e.agreed)
            return evs[rank].search_texts(texts, prepared)
        finally:
            prepared.close()

    outs = cluster.run(worker)
    assert cache.generation_key != key0
    assert mismatches == [(1, 0, key0, cache.generation_key)]
    assert [ev.last_search_stats["generation"] for ev in evs] == [key0] * 2
    assert [ev.last_search_stats["round"] for ev in evs] == [0, 0]
    single = port("fused", "kernel")
    prepared = single.prepare_cache_corpus(cache, key0)
    try:
        want = single.search_texts(texts, prepared)
    finally:
        prepared.close()
    for out in outs:
        _assert_bitwise(out, want)


def test_mine_hard_negatives_writes_on_rank_0_only(port, warm_cache,
                                                   retrieval_data, tmp_path):
    args = (retrieval_data["queries"], retrieval_data["corpus"],
            retrieval_data["qrels"])
    cluster = SimulatedCluster(2)
    evs = [port("torch", "kernel", rank, 2, cluster) for rank in range(2)]
    paths = [tmp_path / f"negs{r}.tsv" for r in range(2)]
    outs = cluster.run(lambda rank: evs[rank].mine_hard_negatives(
        *args, depth=8, output_path=str(paths[rank]), cache=warm_cache))
    assert outs[0] == outs[1]
    assert paths[0].exists() and not paths[1].exists()
    assert len(paths[0].read_text().splitlines()) == len(outs[0])


class _RecordingGather:
    """A caller's transport: any object with ``merge(heap, rank)``."""

    def __init__(self, inner):
        self.inner = inner
        self.ranks = []

    def merge(self, heap, worker_index):
        self.ranks.append(worker_index)
        return self.inner.merge(heap, worker_index)


@pytest.mark.parametrize("world", (2, 4))
def test_evaluator_takes_a_caller_gather(port, warm_cache, retrieval_data,
                                         world):
    """``gather=`` takes any object with ``merge``; the driver reduces
    through it once per rank, and the result equals W = 1."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    cluster = SimulatedCluster(world)
    gather = _RecordingGather(cluster.gather)
    evs = [port("fused", "kernel", rank, world, gather=gather,
                sharder=cluster.sharder) for rank in range(world)]
    assert all(ev.gather is gather for ev in evs)
    outs = cluster.run(lambda rank: evs[rank].search(queries, corpus,
                                                     cache=warm_cache))
    assert sorted(gather.ranks) == list(range(world))
    want = port("fused").search(queries, corpus, cache=warm_cache)
    for out in outs:
        _assert_bitwise(out, want)


def test_evaluator_process_defaults_without_a_group(port):
    ev = port()
    assert (ev.process_index, ev.process_count, ev.gather) == (0, 1, None)
    assert ev.sharder.n == 1
    assert distributed.init_distributed() == (0, 1)

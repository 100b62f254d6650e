"""Fault tolerance, the port against the reference.

``repro_torch.core.faults`` (the injector with its ``retry`` phase and
``from_seed``, ``WorkerHealth``, ``ResilientAllGather``), the sharder's
dead workers (``mark_dead`` / ``absolve`` / exact-zero shares) and frozen
round partitions, the driver's shard rescoring and request deadlines,
``SimulatedCluster(resilient=True)`` and ``repro_torch.training.
fault_tolerance``: the cases of the reference's ``tests/test_faults.py``,
its chaos matrix over a flat corpus and over an IVF search space (cuts
snapped to cluster edges) alike.

The chaos matrix — a crash, a stall past the round deadline or a
dropped gather send at worker 1, W in {2, 4}, three backend pairs —
holds every rank of the port's resilient cluster against the
reference's no-fault W = 1 search on the same seeded numpy inputs (ids
equal, scores within ``TOL = 1e-5``) and bitwise against the port's own
W = 1 search, with coverage 1.  The reference's resilient cluster is not
run here: it can merge a shard twice when a sibling acquires a round
after a crash (its bounds are computed outside the sharder's lock, after
``mark_dead`` has changed the shares), which the port's frozen round
partitions rule out — ``test_frozen_partition_*`` pin that down without
timing.  Every wait is bounded: acquire waits are lowered to seconds,
stalls and deadlines are a few hundred ms.
"""

import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import fair_sharding as ref_sharding
from repro.core import faults as ref_faults
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro_torch.core import fair_sharding
from repro_torch.core import faults as port_faults
from repro_torch.core.fair_sharding import FairSharder, ShardAborted
from repro_torch.core.faults import (Fault, FaultInjector, InjectedCrash,
                                     InjectedTransportDrop,
                                     ResilientAllGather, SearchOutcome,
                                     WorkerHealth, full_coverage)
from repro_torch.core.result_heap import FastResultHeapq
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.launch.distributed import SimulatedCluster
from repro_torch.training.fault_tolerance import (Heartbeat,
                                                  PreemptionGuard,
                                                  resilient_loop)

pytestmark = pytest.mark.faults

torch.set_num_threads(1)

TOL = 1e-5
N_DOCS, DIM, N_Q, K = 200, 16, 6, 5
PAIRS = (("fused", "kernel"), ("torch", "kernel"), ("torch", "torch"))
WAIT_S = 5.0
# a stall outlasts the round deadline, so the stalled shard is recovered
ROUND_DEADLINE_S, STALL_S = 0.15, 0.4


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a test within seconds, on both packages."""
    for cls in (fair_sharding.FairSharder, ref_sharding.FairSharder):
        monkeypatch.setattr(cls, "ACQUIRE_TIMEOUT_S", WAIT_S)


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(N_Q, DIM)).astype(np.float32)
    docs = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    return q, docs


def _load_from(docs):
    return lambda lo, hi: docs[lo:hi]


@pytest.fixture(scope="module")
def ref_oracle(synth):
    """The reference's no-fault W = 1 search (numpy scores)."""
    q, docs = synth
    return RefDriver(score_impl="numpy", chunk_size=16).search(
        q, N_DOCS, _load_from(docs), K)


def _driver(score, heap, w=1, rank=0, cluster=None, injector=None, **kw):
    kw.setdefault("chunk_size", 16)
    kw.setdefault("superchunk_size", 4)
    if cluster is not None:
        kw.update(sharder=cluster.sharder, gather=cluster.gather)
    return ShardedSearchDriver(n_workers=w, worker_index=rank,
                               score_impl=score, heap_impl=heap,
                               fault_injector=injector, device="cpu", **kw)


def _w1(synth, score, heap, n_docs=N_DOCS):
    q, docs = synth
    return _driver(score, heap).search(q, n_docs, _load_from(docs), K)


def _run_cluster(synth, score, heap, w, injector, *, deadline_s=None,
                 round_deadline_s=ROUND_DEADLINE_S, max_retries=2,
                 backoff_s=0.01, searches=1):
    """W resilient drivers sharing one injector -> (the last search's
    outs per rank, the cluster, the drivers)."""
    q, docs = synth
    cluster = SimulatedCluster(w, resilient=True)
    drivers = [_driver(score, heap, w, rank, cluster, injector,
                       round_deadline_s=round_deadline_s,
                       max_shard_retries=max_retries,
                       retry_backoff_s=backoff_s)
               for rank in range(w)]
    outs = None
    for _ in range(searches):
        outs = cluster.run(lambda rank: drivers[rank].search(
            q, N_DOCS, _load_from(docs), K, deadline_s=deadline_s))
    return outs, cluster, drivers


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _assert_matches_reference(out, ref):
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=TOL)


# -- the injector -------------------------------------------------------------


def test_fault_validation_takes_the_retry_phase():
    assert Fault(kind="crash", phase="retry").phase == "retry"
    with pytest.raises(ValueError):
        Fault(kind="meteor")
    with pytest.raises(ValueError):
        Fault(kind="crash", phase="orbit")


@pytest.mark.parametrize("mod", (ref_faults, port_faults),
                         ids=("reference", "port"))
def test_retry_phase_fires_only_on_rescores(mod):
    """A ``retry`` fault ignores the owner's ``load`` stream and fires on
    a rescore, identically on both packages."""
    inj = mod.FaultInjector([mod.Fault(kind="crash", round=0,
                                       phase="retry", repeat=True)])
    inj.on_chunk(1, 0, 0)                   # load phase: no fire
    for _ in range(2):
        with pytest.raises(mod.InjectedCrash):
            inj.on_chunk(0, 0, 0, "retry")
    inj.on_chunk(0, 1, 0, "retry")          # another round
    assert inj.fired == [("crash", 0, 0, "retry")] * 2


@pytest.mark.parametrize("seed", (0, 7, 8, 123))
def test_from_seed_draws_the_reference_schedule(seed):
    """Same seed, same faults on both packages (every field), and a
    deterministic schedule."""
    kw = dict(n_workers=4, n_faults=5, rounds=(0, 6), stall_s=0.3)
    ref = ref_faults.FaultInjector.from_seed(seed, **kw)
    got = FaultInjector.from_seed(seed, **kw)
    fields = ("kind", "round", "worker", "phase", "chunk", "point",
              "stall_s", "repeat")
    assert ([[getattr(f, n) for n in fields] for f in got.faults]
            == [[getattr(f, n) for n in fields] for f in ref.faults])
    assert got.faults == FaultInjector.from_seed(seed, **kw).faults
    assert all(f.kind in ("crash", "stall", "drop") for f in got.faults)


def test_from_seed_differs_across_seeds():
    a = FaultInjector.from_seed(7, n_workers=4, n_faults=3)
    c = FaultInjector.from_seed(8, n_workers=4, n_faults=3)
    assert a.faults != c.faults


def test_search_outcome_unpacks_like_a_tuple():
    v, i = np.zeros((2, 3)), np.ones((2, 3), np.int64)
    out = SearchOutcome((v, i), coverage=full_coverage(2))
    a, b = out
    assert a is v and b is i
    assert not out.degraded
    np.testing.assert_array_equal(out.coverage, [1.0, 1.0])


def test_resilient_gather_needs_the_round_context():
    gather = ResilientAllGather(2)
    heap = FastResultHeapq(2, 3, impl="torch", device="cpu")
    with pytest.raises(TypeError, match="round context"):
        gather.merge(heap, 0)


# -- the chaos matrix: fault x W x backend pair -------------------------------


def _fault_for(kind):
    if kind == "drop":
        return Fault(kind="drop", worker=1, round=0, phase="gather")
    return Fault(kind=kind, worker=1, round=0, phase="load", stall_s=STALL_S)


@pytest.mark.parametrize("score,heap", PAIRS)
@pytest.mark.parametrize("w", (2, 4))
@pytest.mark.parametrize("kind", ("crash", "stall", "drop"))
def test_recovery_is_bitwise_equal_to_no_fault_run(synth, ref_oracle, kind,
                                                   w, score, heap):
    """Worker 1 crashes / stalls past the round deadline / loses its
    gather send: a survivor rescores its shard, and every rank returns
    the port's no-fault W = 1 result bitwise (the reference's within
    TOL, ids equal), with full coverage."""
    want = _w1(synth, score, heap)
    inj = FaultInjector([_fault_for(kind)])
    outs, cluster, drivers = _run_cluster(synth, score, heap, w, inj)
    assert inj.fired == [(kind, 1, 0, "gather" if kind == "drop"
                          else "load")]
    for out in outs:
        _assert_bitwise(out, want)
        _assert_matches_reference(out, ref_oracle)
        np.testing.assert_array_equal(out.coverage, full_coverage(N_Q))
        assert not out.degraded
    # worker 1's round-0 shard (an equal split) was rescored exactly once
    rescored = [r for d in drivers if d.stats for r in d.stats["rescored"]]
    assert rescored == [FairSharder(w).bounds(N_DOCS)[1]]
    assert cluster.health.is_dead(1) == (kind == "crash")


@pytest.mark.parametrize("score,heap", PAIRS)
def test_round_after_crash_repartitions_over_survivors(synth, ref_oracle,
                                                       score, heap):
    """The round after a crash: the dead rank gets an exact-zero share,
    nobody rescores, and every slot still holds the no-fault result."""
    want = _w1(synth, score, heap)
    inj = FaultInjector([Fault(kind="crash", worker=1, round=0)])
    outs, cluster, drivers = _run_cluster(synth, score, heap, 4, inj,
                                          searches=2)
    assert cluster.health.is_dead(1)
    lo, hi = cluster.sharder.bounds(N_DOCS)[1]
    assert lo == hi, f"dead worker kept a non-empty shard {(lo, hi)}"
    live = [d.stats for r, d in enumerate(drivers) if r != 1]
    assert all(st["round"] == 1 and not st["rescored"] for st in live)
    assert sum(st["items"] for st in live) == N_DOCS
    for out in outs:
        _assert_bitwise(out, want)
        _assert_matches_reference(out, ref_oracle)
        np.testing.assert_array_equal(out.coverage, full_coverage(N_Q))


# -- the chaos matrix's ivf half: the same faults over an IVF search space -----

# the IVF-shaped search space of the reference's chaos matrix: cuts snap to
# these cluster edges
IVF_EDGES = np.array([0, 40, 80, 120, 160, 200], np.int64)


def _ivf_space(pkg=None):
    from repro.core.evaluator import IVFSearchSpace as RefSpace
    from repro_torch.core.evaluator import IVFSearchSpace
    return (RefSpace if pkg == "reference" else IVFSearchSpace)(
        N_DOCS, IVF_EDGES)


def _run_ivf_cluster(synth, score, heap, w, injector, searches=1):
    q, docs = synth
    cluster = SimulatedCluster(w, resilient=True)
    drivers = [_driver(score, heap, w, rank, cluster, injector,
                       round_deadline_s=ROUND_DEADLINE_S,
                       retry_backoff_s=0.01)
               for rank in range(w)]
    outs = None
    for _ in range(searches):
        outs = cluster.run(lambda rank: drivers[rank].search(
            q, _ivf_space(), _load_from(docs), K))
    return outs, cluster, drivers


@pytest.fixture(scope="module")
def ref_ivf_oracle(synth):
    """The reference's no-fault W = 1 search over its IVF space."""
    q, docs = synth
    return RefDriver(score_impl="numpy", chunk_size=16).search(
        q, _ivf_space("reference"), _load_from(docs), K)


@pytest.mark.parametrize("score,heap", PAIRS)
@pytest.mark.parametrize("w", (2, 4))
@pytest.mark.parametrize("kind", ("crash", "stall", "drop"))
def test_ivf_recovery_is_bitwise_equal_to_no_fault_run(
        synth, ref_ivf_oracle, kind, w, score, heap):
    """The chaos matrix over an IVF search space: worker 1's shard, a
    run of whole clusters, is rescored once on its snapped bounds, and
    every rank returns the port's no-fault W = 1 result bitwise (the
    reference's within TOL, ids equal), with full coverage."""
    q, docs = synth
    want = _driver(score, heap).search(q, _ivf_space(), _load_from(docs), K)
    inj = FaultInjector([_fault_for(kind)])
    outs, cluster, drivers = _run_ivf_cluster(synth, score, heap, w, inj)
    assert inj.fired == [(kind, 1, 0, "gather" if kind == "drop"
                          else "load")]
    for out in outs:
        _assert_bitwise(out, want)
        _assert_matches_reference(out, ref_ivf_oracle)
        np.testing.assert_array_equal(out.coverage, full_coverage(N_Q))
    rescored = [r for d in drivers if d.stats for r in d.stats["rescored"]]
    snapped = FairSharder(w).bounds(N_DOCS, IVF_EDGES)
    assert snapped == ref_sharding.FairSharder(w).bounds(N_DOCS, IVF_EDGES)
    assert rescored == [snapped[1]]
    assert set(snapped[1]) <= set(IVF_EDGES.tolist())
    assert cluster.health.is_dead(1) == (kind == "crash")


@pytest.mark.parametrize("score,heap", PAIRS)
def test_ivf_round_after_crash_repartitions_over_survivors(
        synth, ref_ivf_oracle, score, heap):
    """The round after a crash over an IVF space: the dead rank's shard
    is empty, every cut re-snapped to a cluster edge, nobody rescores,
    and every rank still holds the no-fault result."""
    q, docs = synth
    want = _driver(score, heap).search(q, _ivf_space(), _load_from(docs), K)
    inj = FaultInjector([Fault(kind="crash", worker=1, round=0)])
    outs, cluster, drivers = _run_ivf_cluster(synth, score, heap, 4, inj,
                                              searches=2)
    assert cluster.health.is_dead(1)
    # the partition round 1 froze, read from the survivors' own shards (a
    # bounds() recomputed now would see round 1's timings in the EMA):
    # contiguous in rank order over [0, N_DOCS), so the dead rank 1's
    # shard, between ranks 0 and 2, is empty; every cut a cluster edge
    live = [d.stats for r, d in enumerate(drivers) if r != 1]
    assert all(st["round"] == 1 and not st["rescored"] for st in live)
    cuts = [(st["lo"], st["hi"]) for st in live]
    assert cuts[0][0] == 0 and cuts[-1][1] == N_DOCS
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all(lo <= hi for lo, hi in cuts)
    assert {b for lo_hi in cuts for b in lo_hi} <= set(IVF_EDGES.tolist())
    for out in outs:
        _assert_bitwise(out, want)
        _assert_matches_reference(out, ref_ivf_oracle)
        np.testing.assert_array_equal(out.coverage, full_coverage(N_Q))


def test_retry_budget_exhaustion_degrades_with_partial_coverage(synth):
    """Every rescue attempt crashes too: past the retry budget the round
    resolves partial — the same on every rank, coverage 0.5, degraded —
    with the positions of worker 0's shard alone, exactly."""
    q, docs = synth
    inj = FaultInjector([
        Fault(kind="crash", worker=1, round=0, phase="load"),
        Fault(kind="crash", round=0, phase="retry", repeat=True)])
    outs, _, drivers = _run_cluster(synth, "torch", "kernel", 2, inj,
                                    max_retries=1)
    assert inj.fired.count(("crash", 0, 0, "retry")) == 2
    half = _w1(synth, "torch", "kernel", n_docs=N_DOCS // 2)
    for out in outs:
        assert out.degraded
        np.testing.assert_allclose(out.coverage, 0.5)
        _assert_bitwise(out, half)
    full = q.astype(np.float64) @ docs[:N_DOCS // 2].astype(np.float64).T
    np.testing.assert_array_equal(
        outs[0][1], np.argsort(-full, axis=1, kind="stable")[:, :K])
    assert drivers[0].stats["retry_dispatch_rounds"] == 0


def test_request_deadline_degrades_instead_of_blocking(synth):
    """A crash whose rescuer is itself stalled: the other survivors hit
    the request deadline and resolve partial at once (coverage = the
    shards that arrived) instead of waiting out the stalled recovery."""
    deadline_s, stall_s = 0.2, 0.8
    inj = FaultInjector([
        Fault(kind="crash", worker=1, round=0, phase="load"),
        Fault(kind="stall", round=0, phase="retry", stall_s=stall_s,
              repeat=True)])
    t0 = time.monotonic()
    outs, _, drivers = _run_cluster(synth, "torch", "kernel", 4, inj,
                                    deadline_s=deadline_s,
                                    round_deadline_s=0.05)
    for out in outs:
        assert out.degraded
        np.testing.assert_allclose(out.coverage, 0.75)
        _assert_bitwise(out, outs[0])
    rescuers = [r for r, d in enumerate(drivers)
                if r != 1 and d.stats["rescored"]]
    assert len(rescuers) == 1
    waiters = [d.stats for r, d in enumerate(drivers)
               if r not in (1, *rescuers)]
    assert len(waiters) == 2
    # the waiters resolved near the deadline, not after the stall
    assert all(st["gather_seconds"] < deadline_s + 0.3 for st in waiters)
    assert time.monotonic() - t0 < stall_s + 5.0


def test_no_survivor_left_degrades_to_reporting_ranks(synth):
    """Both of a W = 2 cluster's recovery paths dead-end (the only
    survivor's rescue crashes): partial result, no hang."""
    inj = FaultInjector([
        Fault(kind="crash", worker=0, round=0, phase="load"),
        Fault(kind="crash", round=0, phase="retry", repeat=True)])
    outs, cluster, _ = _run_cluster(synth, "torch", "kernel", 2, inj,
                                    max_retries=0)
    assert outs[0].degraded and outs[1].degraded
    np.testing.assert_allclose(outs[0].coverage, 0.5)
    assert cluster.health.dead == {0}


def test_cluster_with_every_rank_dead_raises(synth):
    """Every rank crashes: ``run`` raises the crash, and a later ``run``
    with nobody left raises ShardAborted (no hang, no empty result)."""
    q, docs = synth
    inj = FaultInjector([Fault(kind="crash", round=0, repeat=True)])
    cluster = SimulatedCluster(2, resilient=True)
    drivers = [_driver("torch", "torch", 2, r, cluster, inj)
               for r in range(2)]
    with pytest.raises(InjectedCrash):
        cluster.run(lambda r: drivers[r].search(q, N_DOCS,
                                                _load_from(docs), K))
    assert cluster.health.dead == {0, 1}
    with pytest.raises(ShardAborted, match="no live worker"):
        cluster.run(lambda r: None)


def test_barrier_cluster_still_propagates_a_drop(synth):
    """Without ``resilient`` a drop aborts the round, as before."""
    q, docs = synth
    inj = FaultInjector([Fault(kind="drop", worker=1, round=0,
                               phase="gather")])
    cluster = SimulatedCluster(2)
    drivers = [_driver("torch", "torch", 2, r, cluster, inj)
               for r in range(2)]
    with pytest.raises(InjectedTransportDrop):
        cluster.run(lambda r: drivers[r].search(q, N_DOCS,
                                                _load_from(docs), K))


# -- fault 5's cause: the round partition, frozen -----------------------------


def test_frozen_partition_survives_mark_dead():
    """acquire(0) -> mark_dead(1) -> acquire(2), acquire(3): every
    acquirer of round 0 gets round 0's partition; round 1 gives rank 1
    an empty shard.  (The reference hands ranks 2 and 3 the survivors'
    partition of the same round, overlapping rank 1's orphan.)"""
    port, ref = FairSharder(4), ref_sharding.FairSharder(4)
    first = port.acquire(0, 1000)
    assert first == ref.acquire(0, 1000)
    port.mark_dead(1)
    ref.mark_dead(1)
    assert port.acquire(2, 1000) == port.acquire(3, 1000) == first
    late = [ref.acquire(w, 1000)[1] for w in (2, 3)]
    assert late[0] == late[1] != first[1]          # the reference's race
    assert late[0][1][0] == late[0][1][1]
    for w in (0, 2, 3):
        port.update(w, 250, 1.0, round_no=0)
    r, bounds = port.acquire(0, 1000)
    assert r == 1 and bounds[1][0] == bounds[1][1]
    assert sum(hi - lo for lo, hi in bounds) == 1000


def test_frozen_partition_checks_generation_then_size():
    """A generation mismatch rolls the issue back before any size check;
    at the agreed generation another size raises, also unconsumed."""
    s = FairSharder(2)
    s.acquire(0, 100, generation=(1, 0))
    with pytest.raises(fair_sharding.GenerationMismatch):
        s.acquire(1, 90, generation=(2, 0))
    with pytest.raises(ValueError, match="partitioned over 100"):
        s.acquire(1, 90, generation=(1, 0))
    assert s.acquire(1, 100, generation=(1, 0)) == (0, [(0, 50), (50, 100)])


class _HoldingSharder:
    """The cluster's sharder, with rank ``held``'s acquire held until
    rank ``victim`` is marked dead (the reference's losing order)."""

    def __init__(self, sharder, held: int, victim: int):
        self._s = sharder
        self._held, self._victim = held, victim
        self._dead = threading.Event()

    def __getattr__(self, name):
        return getattr(self._s, name)

    def acquire(self, worker, *args, **kw):
        if worker == self._held:
            assert self._dead.wait(WAIT_S), "victim never marked dead"
        return self._s.acquire(worker, *args, **kw)

    def mark_dead(self, worker):
        self._s.mark_dead(worker)
        if worker == self._victim:
            self._dead.set()


@pytest.mark.parametrize("score,heap", PAIRS)
def test_frozen_partition_driver_level_no_duplicate_ids(synth, score, heap):
    """W = 4, rank 1 crashes at its first chunk and rank 3 acquires only
    after that: no row holds a duplicate id and every rank is bitwise
    equal to W = 1."""
    q, docs = synth
    want = _w1(synth, score, heap)
    inj = FaultInjector([Fault(kind="crash", worker=1, round=0)])
    cluster = SimulatedCluster(4, resilient=True)
    held = _HoldingSharder(cluster.sharder, held=3, victim=1)
    cluster.sharder = held
    cluster.gather.sharder = held
    drivers = [_driver(score, heap, 4, r, cluster, inj,
                       round_deadline_s=ROUND_DEADLINE_S)
               for r in range(4)]
    outs = cluster.run(lambda r: drivers[r].search(q, N_DOCS,
                                                   _load_from(docs), K))
    assert held._dead.is_set()
    bounds = [d.stats["lo"] for r, d in enumerate(drivers) if r != 1]
    assert bounds == [0, 100, 150]
    for out in outs:
        for row in out[1]:
            assert len(set(row.tolist())) == K
        _assert_bitwise(out, want)


# -- the sharder's dead workers, both packages --------------------------------


def _both(n):
    return FairSharder(n), ref_sharding.FairSharder(n)


def test_mark_dead_zeroes_share_and_unblocks_round():
    for s in _both(4):
        for w in range(4):
            s.acquire(w, 100)
        for w in (0, 2, 3):
            s.update(w, 25, 1.0, round_no=0)
        s.mark_dead(1)                          # round 0 commits without it
        r, bounds = s.acquire(0, 100)
        assert r == 1
        assert bounds[1][0] == bounds[1][1]
        assert sum(b - a for a, b in bounds) == 100


def test_dead_worker_bookkeeping_matches_reference():
    """One script of acquires, reports, deaths and absolutions on both
    sharders: the same bounds, EMA and diagnostics at every step."""
    port, ref = _both(4)
    seen = []
    for s in (port, ref):
        log = []
        for w in range(4):
            log.append(s.acquire(w, 997))
        for w, secs in ((0, 1.0), (2, 0.5), (3, 2.0)):
            s.update(w, log[w][1][w][1] - log[w][1][w][0], secs,
                     round_no=0)
        s.absolve(1, 0)                         # recovered: round commits
        log.append(s.throughput.tolist())
        s.mark_dead(2)
        for w in (0, 1, 3):
            log.append(s.acquire(w, 997))
        s.absolve(1, 7)                         # a future round: buffered
        for w in (0, 1, 3):
            s.update(w, 300, 1.5 + w, round_no=1)
        log.append(s.throughput.tolist())
        log.append(s.bounds(50))
        s.ACQUIRE_TIMEOUT_S = 0.05
        log.append(s.acquire(0, 10))
        s.update(0, 10, 1.0, round_no=2)
        with pytest.raises(ShardAborted if s is port
                           else ref_sharding.ShardAborted) as ei:
            s.acquire(0, 10)                    # round 3 waits on 1 and 3
        log.append(str(ei.value))
        seen.append(log)
    assert seen[0] == seen[1]
    assert "dead workers: [2]" in seen[0][-1]
    assert "workers [1, 3]" in seen[0][-1]


def test_absolve_is_noop_for_committed_rounds():
    for s in _both(2):
        s.acquire(0, 10), s.acquire(1, 10)
        s.update(0, 5, 1.0, round_no=0)
        s.update(1, 5, 1.0, round_no=0)
        before = s.throughput.copy()
        s.absolve(0, 0)                         # round 0 already committed
        s.absolve(1, 5)                         # future round: buffered only
        np.testing.assert_array_equal(s.throughput, before)


def test_all_dead_shares_raise():
    for s, exc in zip(_both(2), (ShardAborted, ref_sharding.ShardAborted)):
        s.mark_dead(0)
        s.mark_dead(1)
        with pytest.raises(exc, match="all 2 workers are dead"):
            s.shares(100)


# -- WorkerHealth and the Heartbeat --------------------------------------------


def test_heartbeat_requires_path_or_sink():
    with pytest.raises(ValueError):
        Heartbeat()


def test_heartbeat_hands_each_beat_to_its_sink():
    beats = []
    with Heartbeat(interval=0.02, sink=beats.append) as hb:
        hb.update(3)
        time.sleep(0.1)
    assert beats and beats[-1]["step"] == 3
    assert {"step", "time", "pid"} <= set(beats[-1])


def test_worker_health_is_the_dead_set():
    """The board holds reported deaths only: a silent worker is the
    round deadline's to catch."""
    health = WorkerHealth(3)
    assert health.live() == [0, 1, 2] and health.dead == set()
    health.mark_dead(1)
    assert health.is_dead(1) and not health.is_dead(0)
    assert health.dead == {1}
    assert health.live() == [0, 2]


@pytest.mark.parametrize("w", (2, 4))
def test_resilient_cluster_without_faults_rescores_nothing(synth, w):
    """With no fault, the resilient cluster marks no rank dead, no rank
    rescores in any round, and every round is the W = 1 result,
    bitwise."""
    q, docs = synth
    want = _w1(synth, "torch", "kernel")
    cluster = SimulatedCluster(w, resilient=True)
    drivers = [_driver("torch", "kernel", w, rank, cluster,
                       round_deadline_s=ROUND_DEADLINE_S)
               for rank in range(w)]
    for round_no in range(3):
        outs = cluster.run(lambda rank: drivers[rank].search(
            q, N_DOCS, _load_from(docs), K))
        assert cluster.health.dead == set()
        assert all(d.stats["round"] == round_no and not d.stats["rescored"]
                   for d in drivers)
        for out in outs:
            _assert_bitwise(out, want)
            assert not out.degraded


def test_heartbeat_file_sink_still_writes(tmp_path):
    path = str(tmp_path / "hb.json")
    with Heartbeat(path, interval=10.0) as hb:
        hb.update(42)
    payload = json.load(open(path))
    assert payload["step"] == 42 and "time" in payload


def test_preemption_guard_turns_sigterm_into_a_flag():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.should_exit
        if signal.getsignal(signal.SIGTERM) == guard._handler:
            signal.raise_signal(signal.SIGTERM)
        else:                               # not the main thread: no hook
            guard._handler(signal.SIGTERM, None)
        assert guard.should_exit
    assert signal.getsignal(signal.SIGTERM) == before


# -- resilient_loop -------------------------------------------------------------


def test_resilient_loop_completes_without_failures():
    seen = []
    end = resilient_loop(seen.append, 0, 5, on_failure=lambda e: 0)
    assert end == 5 and seen == [0, 1, 2, 3, 4]


def test_resilient_loop_restores_and_resumes():
    calls, failed = [], []

    def step(i):
        calls.append(i)
        if i == 2 and not failed:
            raise RuntimeError("transient")

    def on_failure(e):
        failed.append(e)
        return 1                            # "restore" to step 1

    assert resilient_loop(step, 0, 4, on_failure) == 4
    assert calls == [0, 1, 2, 1, 2, 3]      # resumed from the restore
    assert len(failed) == 1


def test_resilient_loop_gives_up_after_max_consecutive_failures():
    def step(i):
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError, match="persistent"):
        resilient_loop(step, 0, 3, on_failure=lambda e: 0, max_failures=2)


def test_resilient_loop_does_not_swallow_interrupts():
    def step(i):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        resilient_loop(step, 0, 3, on_failure=lambda e: 0)

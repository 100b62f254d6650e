"""Fault injection and fault-tolerant shard recovery (the chaos layer).

The port's counterpart of ``repro.core.faults``.  A W-worker search
degrades instead of collapsing:

  * :class:`FaultInjector` — the deterministic injector, from an
    explicit :class:`Fault` schedule or :meth:`FaultInjector.from_seed`,
    at every point the stack has: the search driver calls ``on_chunk``
    before each streamed chunk is scored (worker crashes and stalls, in
    the ``load`` phase of a worker's own shard or the ``retry`` phase of
    a survivor rescoring an orphaned one) and ``on_gather`` when a
    worker hands its shard state to the gather (transport drops);
    :class:`~repro_torch.core.embedding_cache.EmbeddingCache` calls
    ``on_cache`` between the write steps of an append, a delete or a
    compaction (torn writes and stalls).
  * :class:`WorkerHealth` — the board of a W-worker cluster's dead
    workers (a stalled one is caught by the round deadline).
  * :class:`ResilientAllGather` — the fault-tolerant in-process gather:
    a worker that died, whose state was dropped in flight or that missed
    the round deadline has its shard rescored by a survivor (the same
    kernels over the same rows, bounded retries with exponential
    backoff, a deterministic assignee) and merged **at the dead rank's
    merge position**, so a recovered round is bitwise equal to the
    no-fault round.  When the retry budget or the request deadline runs
    out, the round resolves to a partial top-k with coverage < 1.
  * :class:`SearchOutcome` — a result tuple that still unpacks like a
    plain one, carrying per-query ``coverage`` and ``degraded``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.result_heap import FastResultHeapq


class InjectedFault(RuntimeError):
    """Base class for scheduled failures raised by :class:`FaultInjector`."""


class InjectedCrash(InjectedFault):
    """A scheduled worker (or cache-write) crash."""


class InjectedTransportDrop(InjectedFault):
    """A scheduled gather-transport loss: the worker survives but its
    merged shard state never reaches its siblings."""


@dataclass(frozen=True)
class Fault:
    """One scheduled failure.  ``None`` fields are wildcards.

    kind : ``crash`` | ``stall`` | ``drop`` | ``torn_write``
    round : search round (the FairSharder's issued round number) the
        fault fires in; ``None`` = any round.
    worker : target rank; ``None`` = any worker.
    phase : ``load`` (primary chunk streaming) | ``retry`` (a survivor
        rescoring an orphaned shard) | ``gather`` | ``cache``.  Left
        out, it is ``cache`` for a torn write and for a stall given a
        ``point`` (a cache stall), else ``load``.
    chunk : fire on the n-th chunk event of the matching scoring pass
        (crash/stall only); ``None`` = the first.
    point : torn-write location: ``payload`` (between the vector payload
        and the id-index append — a mid-append crash), ``meta``
        (payloads written, ``meta.json`` never replaced), ``tombstone``
        (tombstones appended, meta never replaced), or one of the
        compaction points — ``compact_payload`` (new epoch's payload
        written, meta still names the old epoch), ``compact_meta``
        (catch-up appended, meta not yet replaced), ``compact_swap``
        (meta replaced, old epoch's files not yet retired).  Left out,
        ``payload``.
    stall_s : sleep duration for ``stall``.
    repeat : fire on every matching event instead of once.
    """

    kind: str
    round: int | None = None
    worker: int | None = None
    phase: str | None = None
    chunk: int | None = None
    point: str | None = None
    stall_s: float = 0.25
    repeat: bool = False

    def __post_init__(self):
        if self.kind not in ("crash", "stall", "drop", "torn_write"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.phase is None:
            cache = self.kind == "torn_write" or (
                self.kind == "stall" and self.point is not None)
            object.__setattr__(self, "phase", "cache" if cache else "load")
        if self.point is None:
            object.__setattr__(self, "point", "payload")
        if self.phase not in ("load", "retry", "gather", "cache"):
            raise ValueError(f"unknown fault phase {self.phase!r}")
        if self.point not in ("payload", "meta", "tombstone",
                              "compact_payload", "compact_meta",
                              "compact_swap"):
            raise ValueError(f"unknown torn-write point {self.point!r}")


class FaultInjector:
    """Deterministic fault scheduler.

    Construct with an explicit fault list, or :meth:`from_seed` for a
    seed-derived schedule (same seed, same faults).  The stack consults the injector
    at its named fault points (chunk loads, gather sends, cache writes);
    each :class:`Fault` fires once (unless ``repeat``) and every firing
    is recorded in :attr:`fired` as ``(kind, worker, round, phase)`` —
    ``(kind, None, None, "cache:<point>")`` at a cache point.
    Thread-safe: one injector may be shared by all workers of a
    simulated cluster.
    """

    def __init__(self, faults=()):
        self.faults = list(faults)
        self.fired: list[tuple] = []
        self._spent: set[int] = set()
        self._lock = threading.Lock()

    @classmethod
    def from_seed(cls, seed: int, n_workers: int, *, n_faults: int = 1,
                  rounds: tuple[int, int] = (0, 4),
                  kinds=("crash", "stall", "drop"),
                  stall_s: float = 0.25) -> "FaultInjector":
        """A reproducible schedule: ``n_faults`` draws of (kind, worker,
        round) from ``np.random.default_rng(seed)``, drawn as the
        reference draws them, so one seed gives both packages the same
        faults.  Each takes its kind's default phase (a ``drop`` drawn
        here is in the ``load`` phase, where no gather point looks, as in
        the reference)."""
        rng = np.random.default_rng(seed)
        faults = [Fault(kind=str(rng.choice(list(kinds))),
                        worker=int(rng.integers(0, n_workers)),
                        round=int(rng.integers(rounds[0], rounds[1])),
                        stall_s=stall_s)
                  for _ in range(n_faults)]
        return cls(faults)

    # -- fault points ---------------------------------------------------------
    def on_chunk(self, worker: int, round_no: int, chunk_index: int,
                 phase: str = "load") -> None:
        """Called before each streamed chunk is scored.  May raise
        :class:`InjectedCrash` (the worker dies here) or sleep (a stalled
        / slow chunk load)."""
        with self._lock:
            candidates = [
                (idx, f) for idx, f in enumerate(self.faults)
                if f.kind in ("crash", "stall") and f.phase == phase
                and (f.worker is None or f.worker == worker)
                and (f.round is None or f.round == round_no)
                and (f.chunk or 0) == chunk_index
                and (f.repeat or idx not in self._spent)]
            if not candidates:
                return
            idx, f = candidates[0]
            self._spent.add(idx)
            self.fired.append((f.kind, worker, round_no, phase))
        if f.kind == "crash":
            raise InjectedCrash(
                f"injected crash: worker {worker} round {round_no} "
                f"chunk {chunk_index} ({phase})")
        time.sleep(f.stall_s)

    def on_gather(self, worker: int, round_no: int) -> None:
        """Called when a worker hands its shard state to the gather
        transport; raises :class:`InjectedTransportDrop` when this
        worker's state is scheduled to be lost in flight."""
        with self._lock:
            for idx, f in enumerate(self.faults):
                if f.kind != "drop" or f.phase != "gather":
                    continue
                if f.worker is not None and f.worker != worker:
                    continue
                if f.round is not None and f.round != round_no:
                    continue
                if not f.repeat and idx in self._spent:
                    continue
                self._spent.add(idx)
                self.fired.append((f.kind, worker, round_no, "gather"))
                break
            else:
                return
        raise InjectedTransportDrop(
            f"injected transport drop: worker {worker} round {round_no}")

    def on_cache(self, point: str) -> None:
        """Called by :class:`~repro_torch.core.embedding_cache.EmbeddingCache`
        between the write steps of one append / compaction; raises
        :class:`InjectedCrash` (``torn_write`` — a process dying with a
        torn write on disk) or sleeps (``stall`` in the ``cache`` phase —
        a slow disk hanging mid-protocol while readers keep serving)."""
        with self._lock:
            hit = None
            for idx, f in enumerate(self.faults):
                if f.kind != "torn_write" and not (
                        f.kind == "stall" and f.phase == "cache"):
                    continue
                if f.point != point:
                    continue
                if not f.repeat and idx in self._spent:
                    continue
                self._spent.add(idx)
                self.fired.append((f.kind, None, None, f"cache:{point}"))
                hit = f
                break
        if hit is None:
            return
        if hit.kind == "torn_write":
            raise InjectedCrash(f"injected torn write at cache point "
                                f"{point!r}")
        time.sleep(hit.stall_s)


class SearchOutcome(tuple):
    """A result tuple that still unpacks like the plain tuple every call
    site expects, plus:

    ``coverage``  — per-query fraction of the round's search space that
        was actually scored (``1.0`` everywhere on a clean round).
    ``degraded``  — True when any coverage < 1.
    """

    coverage: np.ndarray | None
    degraded: bool

    def __new__(cls, items, coverage=None, degraded: bool = False):
        self = super().__new__(cls, tuple(items))
        self.coverage = coverage
        self.degraded = bool(degraded)
        return self


def full_coverage(n_queries: int) -> np.ndarray:
    return np.ones(n_queries, np.float32)


# -- worker health ------------------------------------------------------------


class WorkerHealth:
    """Dead-worker board of a W-worker cluster.

    Deaths are reported explicitly (:meth:`mark_dead`: a worker thread
    raising, or the gather's :meth:`ResilientAllGather.notify_death`);
    A worker that is alive but silent (a stall) is caught by the round
    deadline, not here: in one process a heartbeat thread keeps beating
    while its worker is stuck, so staleness is left to a transport whose
    liveness signal can go quiet.
    """

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._dead: set[int] = set()
        self._lock = threading.Lock()

    def mark_dead(self, worker: int) -> None:
        with self._lock:
            self._dead.add(worker)

    def is_dead(self, worker: int) -> bool:
        with self._lock:
            return worker in self._dead

    @property
    def dead(self) -> set[int]:
        with self._lock:
            return set(self._dead)

    def live(self) -> list[int]:
        with self._lock:
            return [w for w in range(self.n_workers) if w not in self._dead]


# -- resilient gather ---------------------------------------------------------


@dataclass
class _Round:
    """Book-keeping of one search round's gather and recovery."""

    bounds: list[tuple[int, int]]
    total: int
    n_queries: int
    k: int
    impl: str
    device: torch.device
    t0: float = field(default_factory=time.monotonic)
    # rank -> finalized (vals, ids); a recovery installs at the orphan's rank
    contrib: dict[int, tuple] = field(default_factory=dict)
    # ranks whose state was lost in flight this round (drop faults)
    undelivered: set[int] = field(default_factory=set)
    given_up: set[int] = field(default_factory=set)
    claimed: dict[int, int] = field(default_factory=dict)   # rank -> rescuer
    attempts: dict[int, int] = field(default_factory=dict)
    participants: set[int] = field(default_factory=set)
    deadline: float | None = None          # absolute request deadline
    merged: tuple | None = None            # (vals, ids, coverage)


class ResilientAllGather:
    """Fault-tolerant in-process shard gather (all-gather semantics).

    The resilient counterpart of ``launch.distributed.InMemoryAllGather``
    for drivers that pass their round context
    (``ShardedSearchDriver._reduce`` calls :meth:`merge_resilient`).
    Contributions are keyed per (round, rank).  Instead of a barrier,
    each worker waits on a condition variable until every expected shard
    state is present; when one is not (its owner died, its state was
    dropped in flight, or the round deadline lapsed), a survivor chosen
    deterministically rescores the orphaned shard through the driver's
    ``rescore`` callback (the same kernels over the same rows) and
    installs the result at the orphan's rank.  Recovery retries are
    bounded, with exponential backoff; on exhaustion, or when the
    round's request deadline passes, the round resolves **partial**: the
    merge of the shards that did arrive, with coverage < 1.

    Every worker of a round returns the same merged arrays: the merge is
    computed once, under the lock, in ascending rank order into a heap
    of the round's impl on the round's heap device — exactly as
    ``InMemoryAllGather`` and ``ProcessAllGather`` merge — so a fully
    recovered round is bitwise equal to the no-fault round.

    In-process only, as in the reference: across processes a dead rank
    cannot be told apart from a slow collective.
    """

    # how long a waiter sleeps between looks when no wake-up (a death
    # notice, a contribution) arrives
    _POLL_S = 0.02
    # resolved rounds kept, so a stalled straggler waking up late still
    # finds its round's merged result
    _KEEP_ROUNDS = 16

    def __init__(self, world_size: int, health: WorkerHealth | None = None,
                 sharder=None):
        self.world_size = world_size
        self.health = (health if health is not None
                       else WorkerHealth(world_size))
        self.sharder = sharder
        self._rounds: dict[int, _Round] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    # -- cluster-side notifications -------------------------------------------
    def notify_death(self, worker: int) -> None:
        """A worker thread died: wake every waiter, so its shard is
        reassigned now instead of after the round deadline."""
        self.health.mark_dead(worker)
        with self._cv:
            self._cv.notify_all()

    def merge(self, heap, worker_index: int):
        """Barrier-style merging has no round to recover: resilient
        merging needs the driver's round context (:meth:`merge_resilient`);
        use ``InMemoryAllGather`` for a barrier."""
        raise TypeError(
            "ResilientAllGather requires the driver's round context; "
            "use InMemoryAllGather for barrier-style merging")

    # -- the resilient merge --------------------------------------------------
    def _get_round(self, round_no: int, bounds, heap) -> _Round:
        st = self._rounds.get(round_no)
        if st is None:
            st = _Round(bounds=list(bounds),
                        total=max((hi for _, hi in bounds), default=0),
                        n_queries=heap.n_queries, k=heap.k, impl=heap.impl,
                        device=heap.device)
            self._rounds[round_no] = st
            for r in [r for r in self._rounds
                      if r < round_no - self._KEEP_ROUNDS]:
                del self._rounds[r]
        return st

    @staticmethod
    def _pending_ranks(st: _Round) -> list[int]:
        """Ranks with a non-empty shard not yet merged nor given up."""
        return [r for r, (lo, hi) in enumerate(st.bounds)
                if hi > lo and r not in st.contrib and r not in st.given_up]

    def _give_up(self, st: _Round, ranks, round_no: int) -> None:
        """Resolve without ``ranks``: count their round as reported, so
        the sharder's round commit does not wait for them."""
        for r in ranks:
            st.given_up.add(r)
            self._absolve(r, round_no)

    def _absolve(self, rank: int, round_no: int) -> None:
        absolve = getattr(self.sharder, "absolve", None)
        if absolve is not None:
            absolve(rank, round_no)

    def _compute_merge(self, st: _Round, round_no: int) -> tuple:
        """Merge the present contributions in ascending rank order — once
        per round, under the lock."""
        merged = FastResultHeapq(st.n_queries, st.k, impl=st.impl,
                                 device=st.device)
        covered = 0
        for rank in sorted(st.contrib):
            merged.merge_arrays(*st.contrib[rank])
            lo, hi = st.bounds[rank]
            covered += hi - lo
        vals, ids = merged.finalize()
        cov = 1.0 if st.total == 0 else covered / st.total
        st.merged = (vals, ids, np.full(st.n_queries, cov, np.float32))
        self._give_up(st, self._pending_ranks(st), round_no)
        self._cv.notify_all()
        return st.merged

    def _owner_failed(self, st: _Round, rank: int,
                      round_deadline_s: float) -> bool:
        if rank in st.undelivered or self.health.is_dead(rank):
            return True
        return time.monotonic() > st.t0 + round_deadline_s

    def merge_resilient(self, heap: FastResultHeapq, worker_index: int,
                        round_no: int, bounds, rescore, *,
                        dropped: bool = False,
                        round_deadline_s: float = 30.0,
                        max_retries: int = 2, backoff_s: float = 0.05,
                        deadline_s: float | None = None) -> tuple:
        """One worker's gather of ``round_no`` -> ``(vals, ids,
        coverage)``.

        ``bounds`` is the round's whole partition (the same on every
        caller: ``FairSharder.acquire`` freezes it per round);
        ``rescore(lo, hi) -> (vals, ids)`` reruns this driver's scoring
        over an orphaned shard.  ``dropped`` marks this worker's own state
        as lost in flight: it joins the recovery but installs nothing.
        ``deadline_s`` (the request's budget) bounds the wait from this
        call on; past it the round resolves partial.
        """
        vals, ids = heap.finalize()
        my_lo, my_hi = bounds[worker_index]
        with self._cv:
            st = self._get_round(round_no, bounds, heap)
            st.participants.add(worker_index)
            if deadline_s is not None:
                due = time.monotonic() + deadline_s
                st.deadline = due if st.deadline is None else min(
                    st.deadline, due)
            if dropped:
                st.undelivered.add(worker_index)
            elif (st.merged is None and my_hi > my_lo
                  and worker_index not in st.contrib):
                # a straggler arriving after its shard was recovered and
                # the round merged leaves the resolved round alone
                st.contrib[worker_index] = (vals, ids)
            self._cv.notify_all()

        while True:
            rescue = None
            with self._cv:
                if st.merged is not None:
                    return st.merged
                pending = self._pending_ranks(st)
                if not pending:
                    return self._compute_merge(st, round_no)
                if st.deadline is not None and time.monotonic() > st.deadline:
                    # the request deadline passed: resolve partial now;
                    # a recovery in flight finds the round merged
                    self._give_up(st, pending, round_no)
                    return self._compute_merge(st, round_no)
                actionable = [r for r in pending if r not in st.claimed
                              and self._owner_failed(st, r,
                                                     round_deadline_s)]
                if actionable:
                    # deterministic assignee: the live participants by
                    # rank, rotated by the orphan's rank and attempt count
                    rank = actionable[0]
                    dead = self.health.dead
                    cands = sorted(p for p in st.participants
                                   if p not in dead)
                    if not cands:
                        # nobody left to rescue: resolve partial
                        self._give_up(st, pending, round_no)
                        return self._compute_merge(st, round_no)
                    attempt = st.attempts.get(rank, 0)
                    if cands[(rank + attempt) % len(cands)] == worker_index:
                        st.claimed[rank] = worker_index
                        rescue = (rank, attempt)
                    else:
                        self._cv.wait(self._POLL_S)
                else:
                    self._cv.wait(self._POLL_S)
            if rescue is None:
                continue
            rank, attempt = rescue
            if attempt:
                time.sleep(backoff_s * 2 ** (attempt - 1))
            try:
                r_vals, r_ids = rescore(*st.bounds[rank])
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                with self._cv:
                    st.claimed.pop(rank, None)
                    st.attempts[rank] = attempt + 1
                    if st.attempts[rank] > max_retries:
                        self._give_up(st, [rank], round_no)
                    self._cv.notify_all()
                if not isinstance(exc, Exception):
                    raise                   # an interrupt or exit: not retried
                continue
            with self._cv:
                st.claimed.pop(rank, None)
                if st.merged is None and rank not in st.contrib:
                    st.contrib[rank] = (r_vals, r_ids)
                    self._absolve(rank, round_no)
                self._cv.notify_all()

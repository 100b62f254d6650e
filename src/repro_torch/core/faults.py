"""Fault injection and search outcomes with coverage metadata.

The port's part of ``repro.core.faults`` so far:

  * :class:`FaultInjector` — the deterministic, schedule-driven injector
    with its :class:`Fault` records, at every point the stack
    has: the search driver calls ``on_chunk`` before each streamed chunk
    is scored (worker crashes and stalls) and ``on_gather`` when a
    worker hands its shard state to a barrier transport (transport
    drops, which propagate); :class:`~repro_torch.core.embedding_cache.
    EmbeddingCache` calls ``on_cache`` between the write steps of an
    append, a delete or a compaction (torn writes and stalls).
  * :class:`SearchOutcome` — a result tuple carrying per-query coverage.

``WorkerHealth``, ``ResilientAllGather``, degraded coverage, the
``retry`` phase (a survivor rescoring an orphaned shard) and
``FaultInjector.from_seed`` come with the fault-tolerance slice (ROADMAP
queue 1 item 4), whose chaos runs call them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np


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
    phase : ``load`` (primary chunk streaming) | ``gather`` |
        ``cache``.  Left
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
        if self.phase not in ("load", "gather", "cache"):
            raise ValueError(f"unknown fault phase {self.phase!r}")
        if self.point not in ("payload", "meta", "tombstone",
                              "compact_payload", "compact_meta",
                              "compact_swap"):
            raise ValueError(f"unknown torn-write point {self.point!r}")


class FaultInjector:
    """Deterministic fault scheduler.

    Construct with an explicit fault list.  The stack consults the injector
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

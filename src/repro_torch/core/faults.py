"""Fault injection and search outcomes with coverage metadata.

The port's part of ``repro.core.faults`` so far:

  * :class:`FaultInjector` — the deterministic, schedule-driven
    injector with its :class:`Fault` records, at the points the
    single-worker stack has: :class:`~repro_torch.core.embedding_cache.
    EmbeddingCache` calls ``on_cache`` between the write steps of an
    append, a delete or a compaction (torn writes and stalls).  The
    driver's chunk and gather points (worker crashes, stalls, transport
    drops, seed-drawn schedules) come with the multi-worker slice, which
    calls them, together with ``ResilientAllGather`` and degraded
    coverage.
  * :class:`SearchOutcome` — a result tuple carrying per-query coverage.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np


class InjectedFault(RuntimeError):
    """Base class for scheduled failures raised by :class:`FaultInjector`."""


class InjectedCrash(InjectedFault):
    """A scheduled crash (a cache write torn mid-protocol)."""


@dataclass(frozen=True)
class Fault:
    """One scheduled cache failure.

    kind : ``torn_write`` (the writing process dies at ``point``) |
        ``stall`` (the write hangs ``stall_s`` at ``point`` while
        readers keep serving).
    point : ``payload`` (between the vector payload and the id-index
        append — a mid-append crash), ``meta`` (payloads written,
        ``meta.json`` never replaced), ``tombstone`` (tombstones
        appended, meta never replaced), or one of the compaction points
        — ``compact_payload`` (new epoch's payload written, meta still
        names the old epoch), ``compact_meta`` (catch-up appended, meta
        not yet replaced), ``compact_swap`` (meta replaced, old epoch's
        files not yet retired).
    stall_s : sleep duration for ``stall``.
    repeat : fire on every matching event instead of once.
    """

    kind: str
    point: str = "payload"
    stall_s: float = 0.25
    repeat: bool = False

    def __post_init__(self):
        if self.kind not in ("torn_write", "stall"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.point not in ("payload", "meta", "tombstone",
                              "compact_payload", "compact_meta",
                              "compact_swap"):
            raise ValueError(f"unknown torn-write point {self.point!r}")


class FaultInjector:
    """Deterministic fault scheduler.

    Construct with an explicit fault list; the cache consults the
    injector at its named write points, each :class:`Fault` fires once
    (unless ``repeat``) and every firing is recorded in :attr:`fired`
    for assertions, as ``(kind, None, None, "cache:<point>")`` — the
    reference's record, whose two middle fields are a worker and a
    round.  Thread-safe.
    """

    def __init__(self, faults=()):
        self.faults = list(faults)
        self.fired: list[tuple] = []
        self._spent: set[int] = set()
        self._lock = threading.Lock()

    def on_cache(self, point: str) -> None:
        """Called by :class:`~repro_torch.core.embedding_cache.EmbeddingCache`
        between the write steps of one append / compaction; raises
        :class:`InjectedCrash` (``torn_write`` — a process dying with a
        torn write on disk) or sleeps (``stall`` — a slow disk hanging
        mid-protocol while readers keep serving)."""
        with self._lock:
            hit = None
            for idx, f in enumerate(self.faults):
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

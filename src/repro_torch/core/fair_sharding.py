"""Fair sharding: throughput-weighted shard sizes (paper §3.5).

The port's own copy of the part of ``repro.core.fair_sharding`` that the
single-worker search driver calls: :meth:`FairSharder.bounds` and
:meth:`FairSharder.update` (the reference's driver calls ``acquire``
only when it runs more than one worker).  Round-versioned ``acquire``,
dead workers, round aborts, generation-agreed rounds and cluster-edge
snapping come with the multi-worker, fault and IVF slices.

Mixing devices with different throughput (or pods with stragglers) stalls
the fast ones under equal sharding.  ``FairSharder`` keeps an EMA of
per-worker throughput and splits each round's items proportionally, so all
workers finish together.

The EMA commits **per round**: ``update`` buffers observations and only
folds them into the EMA once every worker has reported the round, so
shard bounds stay frozen while a round is in flight.  With one worker
every report commits at once.
"""

from __future__ import annotations

import threading

import numpy as np


class FairSharder:
    def __init__(self, n_workers: int, alpha: float = 0.5,
                 min_share: float = 0.01):
        self.n = n_workers
        self.alpha = alpha
        self.min_share = min_share
        self.throughput = np.ones(n_workers, np.float64)
        # round -> {worker: items/s} (None = reported with no timing
        # signal: an empty shard)
        self._pending: dict[int, dict[int, float | None]] = {}
        self._lock = threading.Lock()
        self._committed = 0                  # rounds folded into the EMA

    def shares(self, total_items: int) -> list[int]:
        """Split ``total_items`` proportionally to throughput.

        Shares are non-negative and sum to ``total_items`` exactly: the
        floor() pass leaves a remainder in ``[0, n]`` which goes to the
        fastest workers, one item each.
        """
        assert total_items >= 0, total_items
        with self._lock:
            w = np.maximum(self.throughput, 1e-9)
        frac = np.maximum(w / w.sum(), self.min_share)
        frac = frac / frac.sum()
        sizes = np.floor(frac * total_items).astype(int)
        rem = int(total_items - sizes.sum())
        assert 0 <= rem <= self.n, (
            f"floor remainder {rem} outside [0, {self.n}] "
            f"(total_items={total_items}, frac sum={frac.sum()!r})")
        order = np.argsort(-w, kind="stable")
        for i in range(rem):
            sizes[order[i % self.n]] += 1
        return sizes.tolist()

    def bounds(self, total_items: int) -> list[tuple[int, int]]:
        """Contiguous ``[lo, hi)`` per worker covering ``total_items``."""
        ends = np.cumsum(self.shares(total_items))
        starts = np.concatenate([[0], ends[:-1]])
        return list(zip(starts.tolist(), ends.tolist()))

    def update(self, worker: int, items: int, seconds: float) -> None:
        """Report one worker's round observation.

        The report lands on the earliest uncommitted round this worker
        has not reported; once every worker has reported that round, its
        observations fold into the EMA and the round commits.  A worker
        with an empty shard reports ``items == 0`` and counts toward the
        round without moving its EMA.
        """
        with self._lock:
            round_no = self._committed
            while worker in self._pending.get(round_no, {}):
                round_no += 1
            bucket = self._pending.setdefault(round_no, {})
            bucket[worker] = (items / seconds if items > 0 and seconds > 0
                              else None)
            while len(self._pending.get(self._committed, {})) == self.n:
                for wk, obs in self._pending.pop(self._committed).items():
                    if obs is not None:
                        self.throughput[wk] = (
                            self.alpha * obs
                            + (1 - self.alpha) * self.throughput[wk])
                self._committed += 1

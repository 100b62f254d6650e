"""Fair sharding: throughput-weighted shard sizes (paper §3.5).

The port's own copy of ``repro.core.fair_sharding``: shares, bounds
(snapped to cluster edges for an IVF search space: ``bounds(total,
boundaries=)``), round-versioned and generation-agreed
:meth:`FairSharder.acquire`, round aborts, round-tagged reports, and dead
workers (:meth:`FairSharder.mark_dead` gives them exact-zero shares,
:meth:`FairSharder.absolve` counts a recovered worker's round as
reported).

Mixing devices with different throughput (or pods with stragglers) stalls
the fast ones under equal sharding.  ``FairSharder`` keeps an EMA of
per-worker throughput and splits each round's items proportionally, so all
workers finish together.  A slow worker's share shrinks on the next round.

The EMA commits **per round**: ``update`` buffers observations and only
folds them into the EMA once every worker has reported the round, so
shard bounds stay frozen while a round is in flight — essential when one
sharder instance is shared by W workers (``SimulatedCluster``) that
partition at different wall-clock times.  With one worker every report
commits at once.

Each round's partition is also **frozen**: the first acquirer of round r
computes its bounds under the lock and every later acquirer of r gets
that same list, so a worker marked dead mid-round changes the shares of
the first round not yet partitioned, never of one in flight.  (The
reference computes the bounds after the lock is released, so a sibling
acquiring the same round after a ``mark_dead`` gets a partition over the
survivors while the others hold the W-worker one, and a shard is scored
twice.)

On a real cluster each process holds its own replica and only observes
its own rank, so the search driver exchanges observations through the
gather transport (``ProcessAllGather.exchange_observations``): every
replica then commits the identical complete round and all processes
keep computing identical bounds.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class GenerationMismatch(RuntimeError):
    """Raised by :meth:`FairSharder.acquire` when this worker's pinned
    corpus generation disagrees with the round's agreed generation (the
    first acquirer's key wins).  The round is *not* consumed: the caller
    re-prepares its corpus at :attr:`agreed` (e.g.
    ``cache.snapshot(agreed)``) and re-acquires the same round."""

    def __init__(self, round_no: int, agreed, mine):
        super().__init__(
            f"round {round_no}: this worker is pinned to generation "
            f"{mine} but the round agreed on {agreed}; re-prepare at "
            f"the agreed generation and re-acquire")
        self.round_no = round_no
        self.agreed = agreed
        self.mine = mine


class ShardAborted(RuntimeError):
    """A sibling worker died mid-round (or a round wait timed out, or no
    live worker is left to shard across); this worker's wait was
    released.  Secondary casualty — cluster runners filter it in favour
    of the original error (like ``threading.BrokenBarrierError``).  The
    message says how many rounds committed, which workers the blocking
    round still waits on and which are dead."""


class FairSharder:
    # acquire gives up after this long waiting for the previous round to
    # commit — a missing sibling report means a worker died
    ACQUIRE_TIMEOUT_S = 300.0

    def __init__(self, n_workers: int, alpha: float = 0.5,
                 min_share: float = 0.01):
        self.n = n_workers
        self.alpha = alpha
        self.min_share = min_share
        self.throughput = np.ones(n_workers, np.float64)
        # round -> {worker: items/s} (None = reported with no timing
        # signal: an empty shard, or an absolved / recovered worker)
        self._pending: dict[int, dict[int, float | None]] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._committed = 0                  # rounds folded into the EMA
        self._issued = [0] * n_workers       # rounds begun, per worker
        # round -> agreed corpus generation key (first acquirer wins)
        self._round_gen: dict[int, object] = {}
        # round -> (total_items, boundaries, bounds): the partition its
        # first acquirer computed, handed to every later acquirer of it
        self._round_bounds: dict[int, tuple[int, tuple | None, list]] = {}
        self._abort_exc: BaseException | None = None
        self._dead: set[int] = set()

    def shares(self, total_items: int) -> list[int]:
        """Split ``total_items`` proportionally to throughput.

        Shares are non-negative and sum to ``total_items`` exactly: the
        floor() pass leaves a remainder in ``[0, n]`` which goes to the
        fastest live workers, one item each.  ``total_items < n`` is
        legal: the workers left without an item get empty (contiguous)
        bounds.

        Workers reported dead (:meth:`mark_dead`) get an exact-zero share
        — ``min_share`` applies to live workers only — so the partition
        covers the corpus with survivors alone.  With every worker dead
        this raises :class:`ShardAborted`.
        """
        with self._lock:
            return self._shares_locked(total_items)

    def _shares_locked(self, total_items: int) -> list[int]:
        """:meth:`shares` with the lock held by the caller."""
        assert total_items >= 0, total_items
        if len(self._dead) >= self.n:
            raise ShardAborted(
                f"all {self.n} workers are dead; no survivor left to "
                f"shard {total_items} items across")
        live = np.array([wk not in self._dead for wk in range(self.n)])
        w = np.where(live, np.maximum(self.throughput, 1e-9), 0.0)
        frac = np.zeros(self.n, np.float64)
        lf = np.maximum(w[live] / w[live].sum(), self.min_share)
        frac[live] = lf / lf.sum()
        sizes = np.floor(frac * total_items).astype(int)
        rem = int(total_items - sizes.sum())
        assert 0 <= rem <= self.n, (
            f"floor remainder {rem} outside [0, {self.n}] "
            f"(total_items={total_items}, frac sum={frac.sum()!r})")
        order = [int(i) for i in np.argsort(-w, kind="stable") if live[i]]
        for i in range(rem):
            sizes[order[i % len(order)]] += 1
        return sizes.tolist()

    def bounds(self, total_items: int,
               boundaries=None) -> list[tuple[int, int]]:
        """Contiguous ``[lo, hi)`` per worker covering ``total_items``
        (dead workers' bounds are empty).

        ``boundaries`` (optional, sorted, from 0 to ``total_items``)
        restricts where cuts may land: each proportional cut snaps to
        the nearest boundary (the lower one on a tie), and the snapped
        cuts are made monotone, so the shards still partition
        ``[0, total_items)`` exactly.  The IVF search space passes its
        cluster edges, so every shard is a run of whole clusters; a
        worker whose share is finer than a cluster may get an empty
        shard, and a dead worker's stays empty.
        """
        with self._lock:
            return self._bounds_locked(total_items, boundaries)

    def _bounds_locked(self, total_items: int,
                       boundaries=None) -> list[tuple[int, int]]:
        ends = np.cumsum(self._shares_locked(total_items))
        if boundaries is not None and total_items > 0:
            bnd = np.asarray(boundaries, np.int64)
            idx = np.clip(np.searchsorted(bnd, ends[:-1]), 1, len(bnd) - 1)
            below, above = bnd[idx - 1], bnd[idx]
            snapped = np.where(ends[:-1] - below <= above - ends[:-1],
                               below, above)
            ends = np.concatenate([np.maximum.accumulate(snapped),
                                   ends[-1:]])
        starts = np.concatenate([[0], ends[:-1]])
        return list(zip(starts.tolist(), ends.tolist()))

    def _round_diagnostics(self) -> str:
        """Lock held.  Which round is blocking, who has not reported, and
        who is dead."""
        bucket = self._pending.get(self._committed, {})
        missing = [wk for wk in range(self.n)
                   if wk not in self._dead and wk not in bucket]
        parts = [f"rounds 0..{self._committed - 1} committed"
                 if self._committed else "no round committed yet",
                 f"round {self._committed} still pending reports from "
                 f"workers {missing}"]
        if self._dead:
            parts.append(f"dead workers: {sorted(self._dead)}")
        return "; ".join(parts)

    def acquire(self, worker: int, total_items: int, boundaries=None,
                generation=None) -> tuple[int, list[tuple[int, int]]]:
        """Round-versioned partition: ``(round_no, bounds)``.

        A worker's r-th call blocks until rounds ``0..r-1`` have all
        committed, so every worker reads the *same* EMA state for the
        same logical round.  It never blocks when rounds are already
        ordered (the gather's barrier, or ``n == 1``).  The wait gives
        up after :attr:`ACQUIRE_TIMEOUT_S` and is released by
        :meth:`abort`, both with :class:`ShardAborted`.

        ``generation`` (optional, any comparable key — the cache's
        ``(generation, epoch)``) makes the round *generation-agreed*:
        the first keyed acquirer's key becomes the round's generation,
        and a later acquirer pinned to a different one gets
        :class:`GenerationMismatch` without consuming the round — it
        re-prepares at the agreed key and re-acquires, so all W workers
        of a round score the same corpus snapshot.  That check comes
        first: a worker pinned to another generation may be sizing
        another corpus.

        ``boundaries`` snaps the cuts as :meth:`bounds` does.  The
        round's bounds are frozen at its first acquire (computed under
        the lock), and every later acquirer of the round gets the same
        list, whatever :meth:`mark_dead` did in between; one that passes
        another ``total_items`` or other ``boundaries`` than the round's
        (a rank that selected another IVF search space) raises
        ``ValueError`` without consuming the round.
        """
        with self._cv:
            r = self._issued[worker]
            self._issued[worker] += 1
            deadline = time.monotonic() + self.ACQUIRE_TIMEOUT_S
            while self._committed < r and self._abort_exc is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ShardAborted(
                        f"worker {worker} waited "
                        f"{self.ACQUIRE_TIMEOUT_S}s for round {r - 1} "
                        f"to commit: {self._round_diagnostics()}")
                self._cv.wait(remaining)
            if self._abort_exc is not None:
                raise ShardAborted(
                    f"sharder aborted while worker {worker} waited for "
                    f"round {r}: {self._round_diagnostics()}"
                ) from self._abort_exc
            if generation is not None:
                agreed = self._round_gen.setdefault(r, generation)
                if agreed != generation:
                    # roll the issue back: the round was not consumed
                    self._issued[worker] -= 1
                    raise GenerationMismatch(r, agreed, generation)
            edges = (None if boundaries is None else
                     tuple(np.asarray(boundaries, np.int64).tolist()))
            frozen = self._round_bounds.get(r)
            if frozen is None:
                bounds = self._bounds_locked(total_items, boundaries)
                self._round_bounds[r] = (total_items, edges, bounds)
            elif frozen[:2] != (total_items, edges):
                self._issued[worker] -= 1
                what = (f"{total_items} items" if frozen[0] != total_items
                        else "other cut boundaries")
                raise ValueError(
                    f"worker {worker} acquired round {r} for {what}, but "
                    f"the round was partitioned over {frozen[0]} items"
                    + ("" if frozen[1] is None else
                       f" cut at {len(frozen[1]) - 1} cluster edges"))
            else:
                bounds = frozen[2]
            return r, list(bounds)

    def abort(self, exc: BaseException | None = None) -> None:
        """Release workers blocked in :meth:`acquire` when a sibling
        dies mid-round (mirrors the gather transports' abort)."""
        with self._cv:
            self._abort_exc = exc if exc is not None else RuntimeError(
                "aborted")
            self._cv.notify_all()

    def mark_dead(self, worker: int) -> None:
        """Remove ``worker`` from the cluster: it gets exact-zero shares
        from the first round not yet partitioned on (see :meth:`shares`;
        a partitioned round keeps its bounds) and rounds stop waiting for
        its reports — a round blocked on it alone commits at once.
        Unlike :meth:`abort`, survivors keep running."""
        with self._cv:
            self._dead.add(worker)
            self._try_commit_locked()
            self._cv.notify_all()

    def absolve(self, worker: int, round_no: int) -> None:
        """Count ``worker`` as having reported ``round_no`` without a
        throughput observation — its shard was recovered by a survivor
        (or given up), so the round may commit without it.  A no-op for
        rounds already committed."""
        with self._cv:
            if round_no < self._committed:
                return
            self._pending.setdefault(round_no, {}).setdefault(worker, None)
            self._try_commit_locked()

    def update(self, worker: int, items: int, seconds: float,
               round_no: int | None = None) -> None:
        """Report one worker's round observation.

        The observation is buffered per round; once every live worker has
        reported (or been absolved for) the oldest uncommitted round, its
        observations fold into the EMA and the round commits.  A worker
        with an empty shard reports ``items == 0`` and counts toward the
        round without moving its EMA.

        ``round_no`` tags the observation with the round it belongs to
        (from :meth:`acquire`).  Without it, the report lands on the
        earliest uncommitted round this worker has not reported.
        Reports for rounds already committed (a stalled straggler
        finishing after its shard was recovered) are dropped.
        """
        with self._cv:
            if round_no is None:
                round_no = self._committed
                while worker in self._pending.get(round_no, {}):
                    round_no += 1
            if round_no < self._committed:
                return
            bucket = self._pending.setdefault(round_no, {})
            if items > 0 and seconds > 0:
                bucket[worker] = items / seconds
            else:
                bucket.setdefault(worker, None)
            self._try_commit_locked()

    def _try_commit_locked(self) -> None:
        """Commit every leading round whose live workers all reported."""
        while True:
            needed = [wk for wk in range(self.n) if wk not in self._dead]
            bucket = self._pending.get(self._committed)
            if not needed or bucket is None or any(
                    wk not in bucket for wk in needed):
                return
            for wk, obs in self._pending.pop(self._committed).items():
                if obs is not None and wk not in self._dead:
                    self.throughput[wk] = (
                        self.alpha * obs
                        + (1 - self.alpha) * self.throughput[wk])
            self._round_gen.pop(self._committed, None)
            self._round_bounds.pop(self._committed, None)
            self._committed += 1
            self._cv.notify_all()

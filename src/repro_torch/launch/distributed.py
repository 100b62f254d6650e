"""Multi-worker launch utilities for the sharded search driver.

Two ways to get a W-worker cluster:

  * **processes** — :func:`init_distributed` wraps
    ``torch.distributed.init_process_group`` (driven by the environment
    ``torchrun`` sets, or by explicit arguments) and returns this
    process's ``(rank, world_size)``; the evaluator then uses
    ``ProcessAllGather`` by default.  The same script runs unchanged in
    one process or many.
  * **simulated** — :class:`SimulatedCluster` runs W real
    ``ShardedSearchDriver`` / ``RetrievalEvaluator`` instances inside one
    process (worker threads), wired to a shared ``FairSharder`` and a
    deterministic :class:`InMemoryAllGather` — or, with
    ``resilient=True``, a :class:`~repro_torch.core.faults.
    ResilientAllGather` whose survivors recover a dead worker's shard.

Determinism: ``InMemoryAllGather.merge`` folds rank states in rank order
(exactly like ``ProcessAllGather``), so the merged ranking is independent
of thread scheduling and every worker returns an identical result.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from repro_torch.core.fair_sharding import FairSharder, ShardAborted
from repro_torch.core.faults import ResilientAllGather, WorkerHealth
from repro_torch.core.result_heap import FastResultHeapq


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> tuple[int, int]:
    """Join a process group when a multi-process launch is requested;
    return ``(rank, world_size)``.

    Explicit ``init_method`` / ``world_size`` / ``rank`` (e.g.
    ``init_method="file:///tmp/rdzv"``) win; otherwise a ``WORLD_SIZE``
    above 1 in the environment (``torchrun`` sets it with ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``) joins through ``env://``.
    Without either this is a no-op and returns ``(0, 1)``, so the same
    script runs on one process or many.  An already initialised group is
    reused.  The group is gloo: the search's cross-rank traffic is
    finalized (Q, k) states on the host (``ProcessAllGather``).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        if env_world <= 1:
            return 0, 1
        dist.init_process_group("gloo", init_method=init_method or "env://")
    elif world_size > 1:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world_size, rank=rank)
    else:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class InMemoryAllGather:
    """Deterministic in-process stand-in for ``ProcessAllGather``.

    W worker threads each contribute their local (Q, k) state; a barrier
    guarantees all states are present; every worker then merges them
    **in rank order** into a heap on its own heap's device and returns
    an identical merged result.  A second barrier keeps a fast worker
    from starting the next round while a slow one still reads this
    round's states.  Each barrier wait gives up after
    :attr:`BARRIER_TIMEOUT_S`, which breaks the barrier for every
    worker (``threading.BrokenBarrierError``) instead of hanging.
    """

    BARRIER_TIMEOUT_S = 300.0

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._states: dict[int, tuple] = {}
        self._barrier = threading.Barrier(world_size)

    def abort(self) -> None:
        """Break the barrier so sibling workers fail fast instead of
        deadlocking when one worker dies mid-round."""
        self._barrier.abort()

    def merge(self, heap: FastResultHeapq,
              worker_index: int) -> FastResultHeapq:
        vals, ids = heap.finalize()
        self._states[worker_index] = (vals, ids)
        self._barrier.wait(self.BARRIER_TIMEOUT_S)   # all W states visible
        merged = FastResultHeapq(vals.shape[0], heap.k, impl=heap.impl,
                                 device=heap.device)
        for rank in range(self.world_size):
            merged.merge_arrays(*self._states[rank])
        self._barrier.wait(self.BARRIER_TIMEOUT_S)   # all read: reusable
        return merged


class SimulatedCluster:
    """W real driver/evaluator instances in one process.

    Construct once, hand ``gather`` and ``sharder`` to W drivers (or
    evaluators with ``process_index=rank, process_count=W``), then
    ``run(worker_fn)`` executes ``worker_fn(rank)`` on W threads and
    returns all ranks' results.  Because the gather merges in rank
    order, all results are identical.

    A worker raising aborts the gather and the sharder, so its siblings
    are released from their waits; ``run`` then re-raises the original
    error rather than a sibling's secondary ``BrokenBarrierError`` /
    ``ShardAborted``.

    ``resilient=True`` swaps the barrier gather for a
    :class:`~repro_torch.core.faults.ResilientAllGather` wired to a
    shared :class:`~repro_torch.core.faults.WorkerHealth` board
    (:attr:`health`, None otherwise): a worker raising no longer aborts
    its siblings — the cluster marks it dead (on the board, in the
    sharder, and wakes the gather), the survivors recover its shard
    inside the round, and later ``run`` calls skip the dead rank.  A
    stalled worker is recovered by the round deadline.  ``run`` returns
    the first live rank's result (all live ranks' are identical) in
    every dead rank's slot, and raises :class:`ShardAborted` (or the
    last error) when no rank is left.
    """

    def __init__(self, world_size: int, resilient: bool = False):
        self.world_size = world_size
        self.sharder = FairSharder(world_size)
        if resilient:
            self.health = WorkerHealth(world_size)
            self.gather = ResilientAllGather(world_size, health=self.health,
                                             sharder=self.sharder)
        else:
            self.health = None
            self.gather = InMemoryAllGather(world_size)

    def run(self, worker_fn: Callable[[int], object]) -> list:
        results: list = [None] * self.world_size
        errors: list = [None] * self.world_size
        resilient = self.health is not None
        dead_before = self.health.dead if resilient else set()

        def target(rank: int) -> None:
            try:
                results[rank] = worker_fn(rank)
            except BaseException as exc:     # noqa: BLE001 — re-raised below
                errors[rank] = exc
                if resilient:
                    # degrade, don't collapse: the sharder stops waiting
                    # for this rank and the gather hands its shard on
                    self.sharder.mark_dead(rank)
                    self.gather.notify_death(rank)
                else:
                    self.gather.abort()
                    # siblings may equally be blocked waiting for this
                    # rank's round report (a round-versioned acquire)
                    self.sharder.abort(exc)

        threads = [threading.Thread(target=target, args=(rank,),
                                    name=f"sim-worker-{rank}")
                   for rank in range(self.world_size)
                   if rank not in dead_before]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if resilient:
            live = [rank for rank in range(self.world_size)
                    if rank not in dead_before and errors[rank] is None]
            if not live:
                for exc in errors:
                    if exc is not None:
                        raise exc
                raise ShardAborted(
                    f"no live worker left of {self.world_size}")
            for rank in range(self.world_size):
                if rank in dead_before or errors[rank] is not None:
                    results[rank] = results[live[0]]
            return results
        for exc in errors:
            if exc is not None and not isinstance(
                    exc, (threading.BrokenBarrierError, ShardAborted)):
                raise exc
        for exc in errors:                   # only barrier casualties left
            if exc is not None:
                raise exc
        return results

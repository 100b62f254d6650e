"""ShardedSearchDriver: the multi-worker search engine (paper §3.5).

The port's counterpart of ``repro.core.sharded_search``: one worker's
view of a W-worker sharded dense search, the same code path for W = 1
and W > 1:

  * **partition** — :class:`~repro_torch.core.fair_sharding.FairSharder`
    splits ``[0, n_docs)`` across workers (throughput EMA; at W > 1 a
    round-versioned, generation-agreed :meth:`~repro_torch.core.
    fair_sharding.FairSharder.acquire`), with the round's throughput
    reported back; an IVF search space's cuts snap to its cluster
    edges;
  * **stream**    — each worker pulls its slice through a caller-supplied
    ``load_chunk(lo, hi)`` with double-buffered prefetch (in
    ``chunk_size`` chunks, or a superchunk at a time), or from a chunk
    source exposing ``open_slice``;
  * **score**     — a backend (``SCORE_BACKENDS``) folds each chunk into
    a :class:`FastResultHeapq`; the device backends instead fold whole
    superchunks through ``kernels.ops.superchunk_update``;
  * **reduce**    — at W > 1 the per-worker (Q, k) states merge through
    a :class:`ShardGather` transport in rank order: an ``O(Q·k·W)``
    reduction, never ``O(Q·N)``.  Through a resilient gather
    (``core.faults.ResilientAllGather``) a shard whose owner died, was
    dropped in flight or missed the round deadline is rescored by a
    survivor over the same rows (:meth:`ShardedSearchDriver.
    _rescore_shard`), and a round whose retry budget or request deadline
    ran out resolves partial, with coverage < 1.

Transports: :class:`ProcessAllGather` (processes over
``torch.distributed``) and ``repro_torch.launch.distributed.
InMemoryAllGather`` (W drivers in one process) merge rank states in rank
order, so every worker computes an identical merged ranking.

A round is two phases: scoring (acquire the round, stream, score, report)
on the caller's thread, and the reduce (gather, merge, finalize).
:meth:`ShardedSearchDriver.search` runs both; :meth:`ShardedSearchDriver.
search_async` runs the reduce on a driver-owned thread and returns a
Future, and :meth:`ShardedSearchDriver.close` drains that thread.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Protocol

import numpy as np
import torch

from repro_torch.core.fair_sharding import FairSharder
from repro_torch.core.faults import (FaultInjector, InjectedTransportDrop,
                                     SearchOutcome, full_coverage)
from repro_torch.core.result_heap import (FastResultHeapq, to_numpy,
                                          to_tensor)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

# -- score backends -----------------------------------------------------------
#
# backend(q_emb, chunk_embs, id_offset, heap, k) folds one corpus chunk
# into the heap; id_offset is the chunk's global corpus position (int32
# positions on device; the host maps positions back to 63-bit hashes).


def _as_device(x, device: torch.device) -> torch.Tensor:
    return to_tensor(x, device, torch.float32)


def _score_numpy(q_emb, embs, id_offset: int, heap: FastResultHeapq,
                 k: int) -> None:
    embs = to_numpy(embs)
    positions = np.arange(id_offset, id_offset + embs.shape[0],
                          dtype=np.int32)
    # float64 sums rounded once, like kernels.ref.score_matrix on the CPU,
    # so the host baseline agrees bitwise with the other CPU backends
    scores = to_numpy(q_emb).astype(np.float64) @ embs.astype(np.float64).T
    heap.update(scores.astype(np.float32), positions)


def _score_torch(q_emb, embs, id_offset: int, heap: FastResultHeapq,
                 k: int) -> None:
    dev = heap.device
    embs = _as_device(embs, dev)
    scores = ref.score_matrix(_as_device(q_emb, dev), embs)
    positions = torch.arange(id_offset, id_offset + embs.shape[0],
                             dtype=torch.int32, device=dev)
    heap.update(scores, positions)


def _score_fused(q_emb, embs, id_offset: int, heap: FastResultHeapq,
                 k: int) -> None:
    dev = heap.device
    vals, ids = kops.fused_score_topk(_as_device(q_emb, dev),
                                      _as_device(embs, dev), k,
                                      id_offset=id_offset)
    heap.merge_arrays(vals, ids)


SCORE_BACKENDS: dict[str, Callable] = {
    "numpy": _score_numpy,
    "torch": _score_torch,
    "fused": _score_fused,
}


def get_score_backend(name: str) -> Callable:
    try:
        return SCORE_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown score_impl {name!r}; expected one of "
            f"{sorted(SCORE_BACKENDS)}") from None


# -- shard-state transports ---------------------------------------------------


class ShardGather(Protocol):
    """Reduces per-worker (Q, k) heap states to one merged state.

    ``merge`` must return the *same* merged ranking on every worker
    (allgather semantics), and must merge rank states in rank order so
    tie-breaking is deterministic across transports.
    """

    def merge(self, heap: FastResultHeapq,
              worker_index: int) -> FastResultHeapq: ...


class ProcessAllGather:
    """Multi-process transport over ``torch.distributed``.

    Every process contributes its finalized local (Q, k) state (host
    arrays: float32 scores, int64 positions); each then merges all W
    states in rank order — the O(Q·k·W) cross-process reduction — into a
    heap of the local heap's impl on the local heap's device, so this
    transport is interchangeable with ``launch.distributed.
    InMemoryAllGather``.

    The states are gathered as CPU tensors over the default group, which
    must be gloo (as :func:`~repro_torch.launch.distributed.
    init_distributed` makes it) or a mixed backend that carries CPU
    tensors over gloo (``"cpu:gloo,cuda:nccl"``): they are tiny, NCCL
    refuses two ranks on one card, and a finalized state is on the host
    already.  Any other backend raises at the first gather.  No
    reference to the group is kept: one that outlives
    ``destroy_process_group`` makes gloo abort the process at exit.
    """

    @staticmethod
    def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
        import torch.distributed as dist
        backend = str(dist.get_backend())
        if "gloo" not in backend:
            raise RuntimeError(
                f"ProcessAllGather gathers host tensors over gloo, but the "
                f"default process group's backend is {backend!r}; join it "
                f"through init_distributed() (gloo) or with a backend that "
                f"includes gloo, e.g. 'cpu:gloo,cuda:nccl'")
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t)
        return out

    def merge(self, heap: FastResultHeapq,
              worker_index: int) -> FastResultHeapq:
        vals, ids = heap.finalize()
        all_v = self._all_gather(torch.from_numpy(
            np.ascontiguousarray(vals, np.float32)))
        all_i = self._all_gather(torch.from_numpy(
            np.ascontiguousarray(ids, np.int64)))
        merged = FastResultHeapq(vals.shape[0], heap.k, impl=heap.impl,
                                 device=heap.device)
        for v, i in zip(all_v, all_i):
            merged.merge_arrays(v, i)
        return merged

    def exchange_observations(self, worker_index: int, items: int,
                              seconds: float) -> list[tuple[int, int,
                                                            float]]:
        """Allgather every worker's round observation so each process's
        local ``FairSharder`` replica commits the identical round (a
        process reporting only its own rank would leave the round
        incomplete forever and freeze the EMA).  Ranks and item counts
        travel as int64 and seconds as float64, so a count above 2^24
        (the reference packs it into float32) arrives exact; only the
        EMA reads them, never a result."""
        counts = self._all_gather(torch.tensor([worker_index, items],
                                               dtype=torch.int64))
        secs = self._all_gather(torch.tensor([seconds],
                                             dtype=torch.float64))
        return [(int(c[0]), int(c[1]), float(t[0]))
                for c, t in zip(counts, secs)]


# -- superchunk autotune ------------------------------------------------------
#
# How many chunks S to fold into one superchunk call is a machine
# property: the ratio of per-call overhead (Python + launches) to
# per-chunk device work.  Both are measured once per (shape, backend,
# device) key, with a synchronise after each timed call, and S is sized
# so the overhead is ~5% of the superchunk's work.

_NOOP_CALL_S: dict[str, float] = {}
_AUTOTUNE_CACHE: dict[tuple, int] = {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _noop_call_seconds(device: torch.device) -> float:
    """Cost of one trivial device op plus a synchronise."""
    key = str(device)
    if key not in _NOOP_CALL_S:
        x = torch.zeros((8, 8), dtype=torch.float32, device=device)
        x.add_(1)
        _sync(device)
        best = math.inf
        for _ in range(5):
            t0 = time.perf_counter()
            x.add_(1)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        _NOOP_CALL_S[key] = best
    return _NOOP_CALL_S[key]


def autotune_superchunk_size(n_queries: int, dim: int, chunk_size: int,
                             k: int, score_impl: str, merge_impl: str,
                             device: str | torch.device = "cuda", *,
                             overhead_target: float = 0.05,
                             floor: int = 8, ceiling: int = 256) -> int:
    """Pick S so per-superchunk call overhead is ~``overhead_target`` of
    its device work.  Cached per (shape, backend, device) key."""
    device = resolve_device(device)
    key = (n_queries, dim, chunk_size, k, score_impl, merge_impl,
           str(device))
    if key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]
    # deterministic synthetic data (values are irrelevant to the timing)
    q = (torch.arange(max(n_queries * dim, 1), dtype=torch.float32,
                      device=device)[: n_queries * dim]
         .reshape(n_queries, dim) % 7.0)
    tile = (torch.arange(chunk_size * dim, dtype=torch.float32,
                         device=device).reshape(1, chunk_size, dim) % 5.0)
    offs = torch.zeros(1, dtype=torch.int32, device=device)
    nvs = torch.full((1,), chunk_size, dtype=torch.int32, device=device)

    def one_step() -> float:
        v, i = kops.empty_state(n_queries, k, device)
        _sync(device)
        t0 = time.perf_counter()
        kops.superchunk_update(v, i, q, tile, offs, nvs, score=score_impl,
                               merge=merge_impl)
        _sync(device)
        return time.perf_counter() - t0

    one_step()                                # first use builds / warms
    per_chunk = min(one_step() for _ in range(3))
    overhead = _noop_call_seconds(device)
    compute = max(per_chunk - overhead, 1e-7)
    s = int(math.ceil(overhead / (overhead_target * compute)))
    s = max(floor, min(ceiling, s))
    _AUTOTUNE_CACHE[key] = s
    return s


# -- the driver ---------------------------------------------------------------

# pull contract: (lo, hi) -> embeddings.  Objects exposing
# ``open_slice(lo, hi, chunk_size)`` (chunk sources, e.g. the bucketed
# encode pipeline) are accepted wherever a ChunkLoader is.
ChunkLoader = Callable[[int, int], "np.ndarray | torch.Tensor"]


class ShardedSearchDriver:
    """One worker's view of a W-worker sharded dense search.

    :meth:`search` runs one round (scoring, then the reduce) and returns
    its result; :meth:`search_async` runs the scoring phase on the
    caller's thread and hands the reduce to a driver-owned thread,
    returning a Future; :meth:`close` drains that thread.
    ``RetrievalEvaluator.make_driver`` builds a driver from an
    evaluator's arguments.

    Parameters
    ----------
    n_workers / worker_index : cluster shape and this worker's rank.
    sharder : :class:`FairSharder` of ``n_workers``; pass the *same*
        instance to all drivers of a cluster in one process
        (``SimulatedCluster``), or a replica per process (the gather then
        exchanges observations).  A fresh one by default.
    score_impl / heap_impl : backend names (``SCORE_BACKENDS``,
        ``FastResultHeapq.HEAP_IMPLS``).
    chunk_size : corpus items per streamed chunk.
    prefetch : double-buffer chunk loads (chunk ``i+1``'s load overlaps
        chunk ``i``'s scoring).  Never changes results.
    gather : :class:`ShardGather` transport merging the W workers'
        states; ``None`` means local only (W = 1).
    superchunk_size : chunks folded into one ``superchunk_update`` call
        (device backends only).  ``0`` = autotune; ``1`` = one call per
        chunk; ``N > 1`` = fixed.  Host backends (``score_impl='numpy'``
        / ``heap_impl='python'``) always stream per chunk.  Never changes
        results.
    superchunk_max_mb : cap on one superchunk's (S, C, d) float32 rows.
    fault_injector : optional :class:`~repro_torch.core.faults.
        FaultInjector` consulted at the chunk and gather fault points.
    round_deadline_s / max_shard_retries / retry_backoff_s : recovery
        settings handed to a resilient gather (one with
        ``merge_resilient``): how long a round waits for a silent worker
        before its shard goes to a survivor, how many rescore attempts an
        orphaned shard gets, and the base of the exponential backoff
        between attempts.  Barrier transports ignore them.
    device : where the heap state and the device backends run.
    """

    def __init__(self, *, n_workers: int = 1, worker_index: int = 0,
                 sharder: FairSharder | None = None,
                 score_impl: str = "fused", heap_impl: str = "kernel",
                 chunk_size: int = 32, prefetch: bool = True,
                 gather: ShardGather | None = None,
                 superchunk_size: int = 0, superchunk_max_mb: int = 64,
                 fault_injector: FaultInjector | None = None,
                 round_deadline_s: float = 30.0,
                 max_shard_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 device: str | torch.device = "cuda"):
        if not 0 <= worker_index < n_workers:
            raise ValueError(
                f"worker_index {worker_index} outside [0, {n_workers})")
        get_score_backend(score_impl)
        if heap_impl not in FastResultHeapq.HEAP_IMPLS:
            raise ValueError(f"unknown heap_impl {heap_impl!r}")
        if superchunk_size < 0:
            raise ValueError(
                f"superchunk_size must be >= 0, got {superchunk_size}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.device = resolve_device(device)
        self.n_workers = n_workers
        self.worker_index = worker_index
        self.sharder = sharder if sharder is not None else FairSharder(
            n_workers)
        if self.sharder.n != n_workers:
            raise ValueError(f"the sharder has {self.sharder.n} workers, "
                             f"the driver {n_workers}")
        self.score_impl = score_impl
        self.heap_impl = heap_impl
        self.chunk_size = chunk_size
        self.prefetch = prefetch
        self.gather = gather
        self.superchunk_size = superchunk_size
        self.superchunk_max_mb = superchunk_max_mb
        self.fault_injector = fault_injector
        self.round_deadline_s = round_deadline_s
        self.max_shard_retries = max_shard_retries
        self.retry_backoff_s = retry_backoff_s
        # per-round observability (serve logging, chip_smoke.py)
        self.stats: dict = {}
        # round counter of the single-worker path (W > 1 uses the
        # sharder-global round from FairSharder.acquire)
        self._local_round = 0
        # search_async's reduce thread, started at its first call
        self._reduce_pool: ThreadPoolExecutor | None = None

    def partition(self, n_docs) -> list[tuple[int, int]]:
        """All workers' ``[lo, hi)`` bounds for this round (a count or a
        sized corpus).  A sized object may expose
        ``partition_boundaries`` (sorted cut points covering ``[0,
        len)``: the IVF search space's cluster edges); the cuts then
        snap to them, so every shard is a run of whole clusters."""
        boundaries = getattr(n_docs, "partition_boundaries", None)
        if not isinstance(n_docs, (int, np.integer)):
            n_docs = len(n_docs)
        return self.sharder.bounds(int(n_docs), boundaries)

    # -- chunk stream -----------------------------------------------------
    def _pipelined_chunks(self, lo: int, hi: int, load_chunk: ChunkLoader,
                          span: int | None = None):
        """Yield ``(offset, embeddings)`` over ``[lo, hi)``.

        A chunk source (``open_slice``) yields ``chunk_size`` chunks and
        runs its own host/device overlap, so the prefetch thread stands
        down for it.  A plain callable is asked for ``span`` rows at a
        time (default ``chunk_size``; the superchunk executor asks for a
        whole superchunk) by one loader thread that keeps exactly one
        load in flight ahead of scoring.
        """
        open_slice = getattr(load_chunk, "open_slice", None)
        if open_slice is not None:
            if hi > lo:
                yield from open_slice(lo, hi, self.chunk_size)
            return
        span = span or self.chunk_size
        bounds = [(off, min(off + span, hi)) for off in range(lo, hi, span)]
        if not self.prefetch or len(bounds) <= 1:
            for off, end in bounds:
                yield off, load_chunk(off, end)
            return
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="chunk-prefetch") as ex:
            fut = ex.submit(load_chunk, *bounds[0])
            for i, (off, _) in enumerate(bounds):
                embs = fut.result()
                if i + 1 < len(bounds):
                    fut = ex.submit(load_chunk, *bounds[i + 1])
                yield off, embs

    def _chunk_iter(self, lo: int, hi: int, load_chunk: ChunkLoader,
                    round_no: int, phase: str, span: int | None = None):
        """The streamed pieces, with the chunk fault point of ``phase``
        (``load`` for this worker's shard, ``retry`` for a rescore)
        applied before each piece is scored: once per ``chunk_size``
        chunk of the piece, with the chunk's index in the slice — the
        index the reference's per-chunk stream gives it, whatever the
        superchunk size."""
        chunks = self._pipelined_chunks(lo, hi, load_chunk, span)
        if self.fault_injector is None:
            return chunks

        def faulty():
            c = self.chunk_size
            try:
                for off, embs in chunks:
                    first = (off - lo) // c
                    for ci in range(first, first - (-embs.shape[0] // c)):
                        self.fault_injector.on_chunk(self.worker_index,
                                                     round_no, ci, phase)
                    yield off, embs
            finally:
                # an injected crash abandons the slice mid-stream: close
                # the stream now so its prefetch thread shuts down
                chunks.close()
        return faulty()

    # -- superchunk executor ----------------------------------------------
    def _merge_impl(self) -> str:
        return "kernel" if self.heap_impl == "kernel" else "torch"

    def _resolve_superchunk_size(self, n_queries: int, dim: int,
                                 k: int) -> int:
        """Effective S for this search (config / autotune / memory cap)."""
        if self.superchunk_size == 1:
            return 1
        s = (self.superchunk_size if self.superchunk_size > 1 else
             autotune_superchunk_size(n_queries, dim, self.chunk_size, k,
                                      self.score_impl, self._merge_impl(),
                                      self.device))
        tile_bytes = max(1, self.chunk_size * max(dim, 1) * 4)
        cap = max(1, (self.superchunk_max_mb << 20) // tile_bytes)
        return max(1, min(s, cap))

    def _search_superchunk(self, q_emb: torch.Tensor, heap: FastResultHeapq,
                           pieces, topk: int, s: int) -> int:
        """Fold the slice into the device-resident (Q, k) state with one
        ``superchunk_update`` call per S chunks, in place.

        ``pieces`` are contiguous ``(offset, rows)`` runs: whole
        superchunks from a plain loader, ``chunk_size`` chunks from a
        chunk source (concatenated here).  A superchunk already on the
        device in float32 is scored as a view; one on the host (a cache
        read) goes up in one copy; only a ragged tail is padded.
        Per-step offsets and valid counts are built on the device.
        Returns the number of calls."""
        n_q, dim = q_emb.shape
        c = self.chunk_size
        dev = self.device
        state_v, state_i = kops.empty_state(n_q, topk, dev)
        calls = 0

        def flush(off: int, buf: list) -> None:
            nonlocal calls
            rows = (_as_device(buf[0], dev) if len(buf) == 1 else
                    torch.cat([_as_device(e, dev) for e in buf]))
            n = rows.shape[0]
            steps = -(-n // c)
            if n < steps * c:
                rows = torch.cat([rows, rows.new_zeros((steps * c - n, dim))])
            start = torch.arange(steps, dtype=torch.int32, device=dev) * c
            kops.superchunk_update(
                state_v, state_i, q_emb, rows.view(steps, c, dim),
                start + off, (n - start).clamp_(max=c),
                score=self.score_impl, merge=self._merge_impl())
            calls += 1

        buf, buf_off, buf_rows = [], 0, 0
        for off, embs in pieces:
            if not buf:
                buf_off = off
            buf.append(embs)
            buf_rows += embs.shape[0]
            if buf_rows >= s * c:
                flush(buf_off, buf)
                buf, buf_rows = [], 0
        if buf:
            flush(buf_off, buf)
        heap.adopt_state(state_v, state_i)
        return calls

    def _tracked(self, chunks):
        """Pass chunks through, recording where their embeddings live."""
        for off, embs in chunks:
            self._chunk_devices.add(str(getattr(embs, "device", "cpu")))
            yield off, embs

    def _score_range(self, q_emb, lo: int, hi: int, load_chunk: ChunkLoader,
                     topk: int, round_no: int, phase: str = "load"):
        """Score ``[lo, hi)`` into a fresh heap -> (heap, calls, executor,
        superchunk_size).  The one scoring routine for this worker's own
        shard (``phase="load"``) and for a survivor rescoring an orphaned
        one (``phase="retry"``): the same chunking, executor and kernels,
        so a recovered shard's state is bitwise what its owner would have
        produced."""
        n_queries = q_emb.shape[0]
        heap = FastResultHeapq(n_queries, topk, impl=self.heap_impl,
                               device=self.device)
        if n_queries == 0:
            return heap, 0, "per_chunk", 1
        scan_ok = (self.score_impl in ("torch", "fused")
                   and self.heap_impl in ("torch", "kernel") and hi > lo)
        s = (self._resolve_superchunk_size(n_queries, q_emb.shape[1], topk)
             if scan_ok else 1)
        if scan_ok and s > 1:
            pieces = self._tracked(self._chunk_iter(
                lo, hi, load_chunk, round_no, phase,
                span=s * self.chunk_size))
            return (heap, self._search_superchunk(
                _as_device(q_emb, self.device), heap, pieces, topk, s),
                "superchunk", s)
        chunks = self._tracked(self._chunk_iter(lo, hi, load_chunk,
                                                round_no, phase))
        backend = get_score_backend(self.score_impl)
        calls = 0
        for off, embs in chunks:
            backend(q_emb, embs, off, heap, topk)
            calls += 1
        return heap, calls, "per_chunk", s

    def _report(self, round_no: int, items: int, seconds: float) -> None:
        """Round-tagged throughput reports (W > 1).  A shared sharder
        hears every worker directly; with a sharder replica per process
        the transport exchanges the observations, or no replica would
        ever see a complete round."""
        reports = [(self.worker_index, items, seconds)]
        exchange = getattr(self.gather, "exchange_observations", None)
        if exchange is not None:
            reports = exchange(self.worker_index, items, seconds)
        for rank, n, secs in reports:
            self.sharder.update(rank, n, secs, round_no=round_no)

    def _rescore_shard(self, q_emb, lo: int, hi: int,
                       load_chunk: ChunkLoader, topk: int, round_no: int,
                       stats: dict):
        """The resilient gather's recovery callback: score an orphaned
        sibling shard ``[lo, hi)`` as its owner would (``_score_range``
        in the ``retry`` phase) and return its finalized ``(vals, ids)``.
        Its calls, chunks and seconds add to this round's ``stats``
        (``retry_dispatch_rounds``, ``retry_chunks``, ``retry_seconds``)
        and ``[lo, hi)`` to ``stats["rescored"]``; a rescore that raises
        adds nothing."""
        t0 = time.monotonic()
        heap, calls, _, _ = self._score_range(q_emb, lo, hi, load_chunk,
                                              topk, round_no, phase="retry")
        out = heap.finalize()
        stats["retry_dispatch_rounds"] += calls
        stats["retry_chunks"] += -(-(hi - lo) // self.chunk_size)
        stats["retry_seconds"] += time.monotonic() - t0
        stats["rescored"].append((lo, hi))
        return out

    def _score_local(self, q_emb, n_docs, load_chunk: ChunkLoader,
                     topk: int, deadline_s: float | None = None,
                     generation=None):
        """The scoring phase of one round: acquire the round and its
        bounds, stream this worker's shard into a **fresh** (Q, k) heap
        and set :attr:`stats`; at W > 1 also synchronise the device and
        report the round's throughput.  Every call builds its own heap,
        so a previous round's state may still be merging
        (:meth:`search_async`) while this round scores.  Returns
        ``(heap, stats, t0, ctx)``: the reduce phase writes its times
        into that round's own stats dict (at W = 1 the round's
        ``seconds``, which end after the finalize, as its untagged report
        does), and ``ctx`` is what a resilient gather needs — the round's
        whole partition, the request deadline and the rescore callback.
        The cuts snap to the sized object's ``partition_boundaries`` as
        in :meth:`partition`, so a rescore works on the round's snapped
        bounds too."""
        boundaries = getattr(n_docs, "partition_boundaries", None)
        if not isinstance(n_docs, (int, np.integer)):
            n_docs = len(n_docs)
        if self.n_workers > 1:
            round_no, bounds = self.sharder.acquire(
                self.worker_index, int(n_docs), boundaries,
                generation=generation)
        else:
            round_no = self._local_round
            self._local_round += 1
            bounds = self.sharder.bounds(int(n_docs), boundaries)
        lo, hi = bounds[self.worker_index]
        self._chunk_devices: set[str] = set()
        t0 = time.monotonic()
        heap, calls, executor, s = self._score_range(q_emb, lo, hi,
                                                     load_chunk, topk,
                                                     round_no)
        seconds = None
        if self.n_workers > 1:
            _sync(self.device)
            seconds = time.monotonic() - t0
            self._report(round_no, hi - lo, seconds)
        stats = {"lo": lo, "hi": hi, "items": hi - lo,
                 "chunks": -(-max(hi - lo, 0) // self.chunk_size),
                 "seconds": seconds, "executor": executor,
                 "superchunk_size": s, "dispatch_rounds": calls,
                 "retry_dispatch_rounds": 0, "retry_chunks": 0,
                 "retry_seconds": 0.0, "rescored": [],
                 "generation": generation, "round": round_no,
                 "query_device": str(getattr(q_emb, "device", "cpu")),
                 "chunk_devices": sorted(self._chunk_devices)}
        self.stats = stats
        ctx = {"bounds": bounds, "deadline_s": deadline_s,
               "rescore": lambda rlo, rhi: self._rescore_shard(
                   q_emb, rlo, rhi, load_chunk, topk, round_no, stats)}
        return heap, stats, t0, ctx

    def _reduce(self, heap: FastResultHeapq, stats: dict, t0: float,
                ctx: dict) -> SearchOutcome:
        """The reduce phase: at W > 1 the gather fault point, the
        all-gather and rank-order merge (through a resilient gather, with
        orphaned shards rescored and the round's coverage), then the host
        finalize; at W = 1 the finalize and the round's untagged
        report."""
        if self.n_workers > 1:
            g0 = time.monotonic()
            resilient = getattr(self.gather, "merge_resilient", None)
            if resilient is not None:
                dropped = False
                if self.fault_injector is not None:
                    try:
                        self.fault_injector.on_gather(self.worker_index,
                                                      stats["round"])
                    except InjectedTransportDrop:
                        # this worker's state is lost in flight; it stays
                        # alive and joins the recovery instead
                        dropped = True
                vals, pos, coverage = resilient(
                    heap, self.worker_index, stats["round"], ctx["bounds"],
                    ctx["rescore"], dropped=dropped,
                    round_deadline_s=self.round_deadline_s,
                    max_retries=self.max_shard_retries,
                    backoff_s=self.retry_backoff_s,
                    deadline_s=ctx["deadline_s"])
                stats["gather_seconds"] = time.monotonic() - g0
                return SearchOutcome((vals, pos), coverage=coverage,
                                     degraded=bool((coverage < 1.0).any()))
            if self.gather is not None:
                if self.fault_injector is not None:
                    # a drop against a barrier transport propagates
                    self.fault_injector.on_gather(self.worker_index,
                                                  stats["round"])
                heap = self.gather.merge(heap, self.worker_index)
            vals, pos = heap.finalize()
            # the reduce: waiting for the siblings, the all-gather, the
            # rank-order merge and the host finalize
            stats["gather_seconds"] = time.monotonic() - g0
        else:
            vals, pos = heap.finalize()
            stats["seconds"] = time.monotonic() - t0
            # untagged: the report lands on the sharder's next open round,
            # which a sharder shared across per-search drivers keeps
            # counting
            self.sharder.update(0, stats["items"], stats["seconds"])
        return SearchOutcome((vals, pos), coverage=full_coverage(len(vals)))

    def search(self, q_emb, n_docs, load_chunk: ChunkLoader,
               topk: int, deadline_s: float | None = None,
               generation=None) -> SearchOutcome:
        """Score this worker's shard of the corpus, then reduce.

        ``n_docs`` is a count or a sized corpus object.  Returns
        ``(scores (Q, k), positions (Q, k))`` as numpy arrays (a
        :class:`SearchOutcome` with full coverage) — the merged result,
        identical on every worker, when a gather transport is set.
        Positions are global corpus offsets and ``-1`` marks empty
        slots.

        ``generation`` is a prepared corpus's snapshot key.  At W > 1 it
        pins the round to one corpus generation through the sharder's
        agreement (:meth:`FairSharder.acquire`): a
        :class:`~repro_torch.core.fair_sharding.GenerationMismatch`
        raises before any scoring or reporting, so the caller can
        re-prepare at the agreed key and call again for the same round.
        One worker scores whatever snapshot its loader reads, so there
        the key is only recorded in :attr:`stats`.

        ``deadline_s`` (a resilient gather only) bounds how long the
        reduce may spend recovering orphaned shards; past it the round
        resolves partial — ``degraded`` set and per-query ``coverage``
        < 1 — instead of raising.
        """
        return self._reduce(*self._score_local(q_emb, n_docs, load_chunk,
                                               topk, deadline_s,
                                               generation))

    def search_async(self, q_emb, n_docs, load_chunk: ChunkLoader,
                     topk: int, deadline_s: float | None = None,
                     generation=None) -> Future:
        """Like :meth:`search`, but the reduce phase runs on a
        driver-owned thread and the result comes back as a Future.

        The scoring phase runs on the caller's thread, so when this
        returns the caller may score the next round while this round's
        gather, merge and finalize are in flight (the round pipelining
        behind ``ServeFrontend``).  Reduces run one at a time in
        submission order, so results, and the gather transport's
        rank-order merge, are bitwise those of :meth:`search`.
        """
        scored = self._score_local(q_emb, n_docs, load_chunk, topk,
                                   deadline_s, generation)
        if self._reduce_pool is None:
            self._reduce_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shard-reduce")
        return self._reduce_pool.submit(self._reduce, *scored)

    def close(self) -> None:
        """Drain and shut down the reduce thread of :meth:`search_async`
        (a no-op when it was never used).  Idempotent."""
        if self._reduce_pool is not None:
            self._reduce_pool.shutdown(wait=True)
            self._reduce_pool = None

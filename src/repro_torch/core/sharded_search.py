"""ShardedSearchDriver: the search engine, single worker (paper §3.5).

The port's counterpart of ``repro.core.sharded_search`` at W = 1:

  * **partition** — :class:`~repro_torch.core.fair_sharding.FairSharder`
    bounds of ``[0, n_docs)`` (one worker: the whole corpus), with the
    round's throughput reported back;
  * **stream**    — the slice is pulled through a caller-supplied
    ``load_chunk(lo, hi)`` with double-buffered prefetch (in
    ``chunk_size`` chunks, or a superchunk at a time), or from a chunk
    source exposing ``open_slice``;
  * **score**     — a backend (``SCORE_BACKENDS``) folds each chunk into
    a :class:`FastResultHeapq`; the device backends instead fold whole
    superchunks through ``kernels.ops.superchunk_update``.

Multi-worker transports (process all-gather over ``torch.distributed``,
merge-fn gathers, resilient gathers) and ``search_async`` come with the
multi-worker slice.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.core.fair_sharding import FairSharder
from repro_torch.core.faults import SearchOutcome, full_coverage
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
    """The single-worker search driver.

    Parameters
    ----------
    sharder : :class:`FairSharder` (one worker); a fresh one by default.
    score_impl / heap_impl : backend names (``SCORE_BACKENDS``,
        ``FastResultHeapq.HEAP_IMPLS``).
    chunk_size : corpus items per streamed chunk.
    prefetch : double-buffer chunk loads (chunk ``i+1``'s load overlaps
        chunk ``i``'s scoring).  Never changes results.
    superchunk_size : chunks folded into one ``superchunk_update`` call
        (device backends only).  ``0`` = autotune; ``1`` = one call per
        chunk; ``N > 1`` = fixed.  Host backends (``score_impl='numpy'``
        / ``heap_impl='python'``) always stream per chunk.  Never changes
        results.
    superchunk_max_mb : cap on one superchunk's (S, C, d) float32 rows.
    device : where the heap state and the device backends run.
    """

    def __init__(self, *, sharder: FairSharder | None = None,
                 score_impl: str = "fused", heap_impl: str = "kernel",
                 chunk_size: int = 32, prefetch: bool = True,
                 superchunk_size: int = 0, superchunk_max_mb: int = 64,
                 device: str | torch.device = "cuda"):
        get_score_backend(score_impl)
        if heap_impl not in FastResultHeapq.HEAP_IMPLS:
            raise ValueError(f"unknown heap_impl {heap_impl!r}")
        if superchunk_size < 0:
            raise ValueError(
                f"superchunk_size must be >= 0, got {superchunk_size}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.device = resolve_device(device)
        self.sharder = sharder if sharder is not None else FairSharder(1)
        if self.sharder.n != 1:
            raise ValueError("this driver runs one worker; the sharder "
                             f"has {self.sharder.n}")
        self.score_impl = score_impl
        self.heap_impl = heap_impl
        self.chunk_size = chunk_size
        self.prefetch = prefetch
        self.superchunk_size = superchunk_size
        self.superchunk_max_mb = superchunk_max_mb
        # per-round observability (serve logging, chip_smoke.py)
        self.stats: dict = {}

    def partition(self, n_docs) -> list[tuple[int, int]]:
        """``[lo, hi)`` bounds for this round (a count or a sized corpus)."""
        if not isinstance(n_docs, (int, np.integer)):
            n_docs = len(n_docs)
        return self.sharder.bounds(int(n_docs))

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
                     topk: int):
        """Score ``[lo, hi)`` into a fresh heap -> (heap, calls, executor,
        superchunk_size)."""
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
            pieces = self._tracked(self._pipelined_chunks(
                lo, hi, load_chunk, span=s * self.chunk_size))
            return (heap, self._search_superchunk(
                _as_device(q_emb, self.device), heap, pieces, topk, s),
                "superchunk", s)
        chunks = self._tracked(self._pipelined_chunks(lo, hi, load_chunk))
        backend = get_score_backend(self.score_impl)
        calls = 0
        for off, embs in chunks:
            backend(q_emb, embs, off, heap, topk)
            calls += 1
        return heap, calls, "per_chunk", s

    def search(self, q_emb, n_docs, load_chunk: ChunkLoader,
               topk: int, generation=None) -> SearchOutcome:
        """Encode→score→top-k over the corpus.

        ``n_docs`` is a count or a sized corpus object.  Returns
        ``(scores (Q, k), positions (Q, k))`` as numpy arrays (a
        :class:`SearchOutcome` with full coverage); positions are global
        corpus offsets and ``-1`` marks empty slots.

        ``generation`` is a prepared corpus's snapshot key.  One worker
        scores whatever snapshot its loader reads, so the key is only
        recorded in :attr:`stats`; the multi-worker driver (not ported
        yet) hands it to the sharder so that every worker of a round
        scores the same snapshot.
        """
        lo, hi = self.partition(n_docs)[0]
        self._chunk_devices: set[str] = set()
        t0 = time.monotonic()
        heap, calls, executor, s = self._score_range(q_emb, lo, hi,
                                                     load_chunk, topk)
        vals, pos = heap.finalize()
        seconds = time.monotonic() - t0
        # untagged: the report lands on the sharder's next open round,
        # which a sharder shared across per-search drivers keeps counting
        self.sharder.update(0, hi - lo, seconds)
        self.stats = {"lo": lo, "hi": hi, "items": hi - lo,
                      "chunks": -(-max(hi - lo, 0) // self.chunk_size),
                      "seconds": seconds, "executor": executor,
                      "superchunk_size": s, "dispatch_rounds": calls,
                      "generation": generation,
                      "query_device": str(getattr(q_emb, "device", "cpu")),
                      "chunk_devices": sorted(self._chunk_devices)}
        return SearchOutcome((vals, pos), coverage=full_coverage(len(vals)))

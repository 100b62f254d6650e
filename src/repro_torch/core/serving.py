"""Continuous-batching serve frontend.

The port's counterpart of ``repro.core.serving``:

  * **admission** — :meth:`ServeFrontend.submit` accepts concurrent
    single-query (or small-batch) requests onto a bounded queue and
    returns a Future.  When the queue is full the submit fast-fails
    with :class:`ServeOverloadError` (the 503 path) instead of letting
    latency grow without bound; once accepted, a request is never
    dropped — overload, shutdown, and backend errors all resolve its
    Future (result or exception).
  * **adaptive micro-batching** — a dispatcher thread coalesces queued
    requests into one micro-batch, flushing at ``max_batch`` coalesced
    queries or ``max_wait_ms`` after the batch's first request,
    whichever comes first — so a lone query pays at most the wait, and
    a burst amortizes encode + score over the whole batch.  A request
    that would overflow the forming micro-batch is carried whole into
    the next one.
  * **batched execute, per-request demux** — the coalesced texts are
    padded to a power-of-two rung (the encode and superchunk shapes are
    then the rung ladder ``1, 2, 4, ..., max_batch``, all warmable up
    front), encoded through the bucketed encode pipeline and scored
    against the prepared (device-resident) corpus; the merged
    ``(ids, scores)`` rows split back to each request's Future by
    position, so concurrent clients may reuse query ids freely.
  * **round pipelining** — with :class:`EvaluatorServeBackend`,
    micro-batch ``r``'s merge and finalize run on the driver's reduce
    thread (``ShardedSearchDriver.search_async``) while the dispatcher
    already encodes and scores micro-batch ``r + 1``.  Each round scores
    into a fresh (Q, k) state, so no state is shared between rounds in
    flight.
  * **deadlines** — ``submit(deadline_ms=)`` resolves a request still
    queued past its deadline with a degraded empty result, and a
    dispatched one hands its remaining budget (the micro-batch's
    tightest) to the backend as ``deadline_s``, which bounds a resilient
    round's shard recovery: the request then resolves with a partial,
    ``degraded`` result instead of waiting; ``search(timeout=)`` abandons
    a request the caller stopped waiting for, and coalescing skips it.
  * **clean shutdown** — :meth:`ServeFrontend.close` stops admission,
    drains every queued request through the normal batch path, joins
    the dispatcher and the backend's reduce thread, and only then
    returns.

Backends: :class:`EvaluatorServeBackend` (one evaluator — one process,
or one rank of a ``torch.distributed`` group — with a persistent driver
and a prepared corpus) and :class:`ClusterServeBackend` (W evaluators
through ``SimulatedCluster``, the ``launch.serve --workers N`` path).
Each returns per query what a solo ``RetrievalEvaluator.search_texts``
of that query returns — except on an IVF corpus probed below its
cluster count, where a micro-batch scans the union of its queries'
probed clusters: a superset of each query's own, so a coalesced query's
top-k is an exact top-k over that union and scores at least its solo
search's.

Both backends take ``deadline_s``; any backend whose ``begin`` / ``run``
accepts it gets the micro-batch's tightest remaining budget.  Rounds that
come back degraded (a resilient cluster out of retries or time) count in
``ServeFrontend.stats["degraded"]``, one per request.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Sequence

import numpy as np

from repro_torch.core.config import EvaluationArguments
from repro_torch.core.fair_sharding import GenerationMismatch
from repro_torch.core.faults import SearchOutcome


class ServeError(RuntimeError):
    """Base class for serve-frontend errors."""


class ServeOverloadError(ServeError):
    """Admission control rejected the request (queue full — the
    503-style fast-fail; resubmit with backoff)."""


class ServeClosedError(ServeError):
    """The frontend is shut down (or shutting down) and accepts no new
    requests."""


class ServeTimeoutError(ServeError):
    """A blocking :meth:`ServeFrontend.search` wait timed out; the
    request was marked abandoned so the dispatcher skips it instead of
    encoding and scoring work nobody will read."""


class _Request:
    __slots__ = ("texts", "n", "future", "t_submit", "deadline",
                 "abandoned")

    def __init__(self, texts: list[str], deadline_ms: float | None = None):
        self.texts = texts
        self.n = len(texts)
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        # absolute deadline: past it the request resolves degraded-empty
        # (coverage 0) instead of being scored — never dropped
        self.deadline = (None if deadline_ms is None
                         else self.t_submit + deadline_ms / 1e3)
        # set when a blocking search() wait gave up on this request; its
        # Future is already resolved (ServeTimeoutError), so the
        # dispatcher skips it entirely
        self.abandoned = False

    def remaining_s(self, now: float) -> float | None:
        return None if self.deadline is None else self.deadline - now


_SENTINEL = object()


# -- backends -----------------------------------------------------------------


def _warm_live_cache(evaluator, corpus, cache) -> None:
    """Encode the seed corpus's missing rows into the live cache (one
    committed generation when anything was missing)."""
    if corpus:
        cv = evaluator._corpus_view(corpus)
        if len(cv):
            evaluator.encode_corpus(np.asarray(cv.id_hashes), cv.texts(),
                                    cache)


class EvaluatorServeBackend:
    """One evaluator, one persistent driver, one prepared corpus.

    ``begin(texts, topk)`` encodes the micro-batch, runs the driver's
    scoring phase on the dispatcher thread and hands the reduce (merge,
    finalize, positions to ids) to the driver's reduce thread, returning
    a Future, so the dispatcher can start the next micro-batch while
    this one merges.

    With ``live_cache`` the corpus is the cache's live document set: each
    micro-batch is pinned to the newest committed generation at dispatch
    time, a mutation committed mid-stream takes effect at the next
    micro-batch, and a micro-batch in flight finishes on the snapshot it
    pinned — a superseded prepared corpus (and its pinned snapshot) is
    closed only once its last round has reduced.  Without ``live_cache``
    the corpus is prepared device-resident.
    """

    def __init__(self, evaluator, corpus, cache=None, *, live_cache=None):
        self.ev = evaluator
        self.on_device = evaluator.args.score_impl != "numpy"
        self.live_cache = live_cache
        self._swap_lock = threading.Lock()
        self._inflight: dict[int, int] = {}     # id(prepared) -> rounds
        self._retired: dict[int, object] = {}   # superseded, still in flight
        if live_cache is not None:
            # serve the cache's own live set, mutations included
            _warm_live_cache(evaluator, corpus, live_cache)
            self.prepared = evaluator.prepare_cache_corpus(live_cache)
        else:
            # the expensive pass: corpus encode / cache warm-up, once
            self.prepared = evaluator.prepare_corpus(
                corpus, cache=cache, device_resident=True)
        self.driver = evaluator.make_driver()

    def _acquire(self):
        """The prepared corpus this micro-batch scores — refreshed to the
        newest committed cache generation at the micro-batch boundary
        (on the dispatcher thread, so a refresh never races another)."""
        if self.live_cache is None:
            return self.prepared
        with self._swap_lock:
            cur = self.prepared
            if self.live_cache.generation_key != cur.generation:
                self.prepared = self.ev.prepare_cache_corpus(
                    self.live_cache)
                if self._inflight.get(id(cur), 0):
                    self._retired[id(cur)] = cur   # close when drained
                else:
                    cur.close()
                cur = self.prepared
            self._inflight[id(cur)] = self._inflight.get(id(cur), 0) + 1
            return cur

    def _release(self, prepared) -> None:
        if self.live_cache is None:
            return
        with self._swap_lock:
            k = id(prepared)
            n = self._inflight.get(k, 0) - 1
            if n > 0:
                self._inflight[k] = n
                return
            self._inflight.pop(k, None)
            retired = self._retired.pop(k, None)
        if retired is not None:
            retired.close()

    def begin(self, texts: Sequence[str], topk: int,
              deadline_s: float | None = None) -> Future:
        prepared = self._acquire()
        try:
            q_emb = self.ev._encode_texts(list(texts), True,
                                          device=self.on_device,
                                          min_batch_dim=1)
            # this micro-batch's search space: the prepared corpus as it
            # is (flat), or the union of the batch's probed clusters (IVF)
            sized, load_chunk, to_ids = prepared.round_for(q_emb)
            inner = self.driver.search_async(
                q_emb, sized, load_chunk, topk, deadline_s=deadline_s,
                generation=prepared.generation)
        except BaseException:
            self._release(prepared)
            raise
        outer: Future = Future()

        def _done(f: Future) -> None:
            try:
                out = f.result()
                vals, pos = out
                outer.set_result(SearchOutcome(
                    (to_ids(pos), vals),
                    coverage=out.coverage, degraded=out.degraded))
            except BaseException as exc:   # noqa: BLE001 — routed to caller
                outer.set_exception(exc)
            finally:
                self._release(prepared)

        inner.add_done_callback(_done)
        return outer

    def close(self) -> None:
        self.driver.close()
        with self._swap_lock:
            stale = list(self._retired.values())
            self._retired.clear()
            stale.append(self.prepared)
        for p in stale:
            p.close()


class ClusterServeBackend:
    """W evaluators in one process (``SimulatedCluster``) — the
    ``launch.serve --workers N`` path.  Each micro-batch runs one sharded
    round: every rank scores its fair shard and merges through the
    in-memory all-gather; rank 0's (identical) result is returned — on a
    resilient cluster, the first live rank's.

    With ``live_cache`` (one cache shared by every rank) each micro-batch
    pins one ``(generation, epoch)`` key for all W ranks before the
    round starts, so the sharder's generation agreement passes by
    construction; a rank that still meets a
    :class:`~repro_torch.core.fair_sharding.GenerationMismatch` (a
    prepared corpus pinned before a mutation slipped in) re-prepares at
    the round's agreed key and retries — the losing acquire does not
    consume the round.  Without ``live_cache`` each rank prepares the
    corpus device-resident.
    """

    def __init__(self, evaluators, cluster, corpus, caches=None, *,
                 live_cache=None):
        if len(evaluators) != cluster.world_size:
            raise ValueError(
                f"{len(evaluators)} evaluators for a world of "
                f"{cluster.world_size}")
        self.evs = list(evaluators)
        self.cluster = cluster
        self.live_cache = live_cache
        if live_cache is not None:
            _warm_live_cache(self.evs[0], corpus, live_cache)
            self.prepared = [ev.prepare_cache_corpus(live_cache)
                             for ev in self.evs]
        else:
            caches = (caches if caches is not None
                      else [None] * len(self.evs))
            self.prepared = [
                ev.prepare_corpus(corpus, cache=c, device_resident=True)
                for ev, c in zip(self.evs, caches)]

    def _refresh(self) -> None:
        """Pin every rank to one key — the newest committed generation —
        at the micro-batch boundary.  Reading the key once and passing
        it explicitly means a mutation landing mid-refresh waits for the
        next micro-batch instead of splitting the round."""
        key = self.live_cache.generation_key
        for i, ev in enumerate(self.evs):
            if self.prepared[i].generation != key:
                old = self.prepared[i]
                self.prepared[i] = ev.prepare_cache_corpus(
                    self.live_cache, generation=key)
                old.close()

    def _rank_search(self, rank: int, texts, topk: int,
                     deadline_s: float | None):
        while True:
            try:
                return self.evs[rank].search_texts(
                    texts, self.prepared[rank], topk, min_batch_dim=1,
                    deadline_s=deadline_s)
            except GenerationMismatch as e:
                if self.live_cache is None:
                    raise
                # losing acquire: roll forward to the round's agreed
                # snapshot and retry (the sharder did not consume the
                # round for this worker)
                old = self.prepared[rank]
                self.prepared[rank] = self.evs[rank].prepare_cache_corpus(
                    self.live_cache, generation=e.agreed)
                old.close()

    def run(self, texts: Sequence[str], topk: int,
            deadline_s: float | None = None):
        if self.live_cache is not None:
            self._refresh()
        outs = self.cluster.run(
            lambda rank: self._rank_search(rank, texts, topk, deadline_s))
        return outs[0]

    def close(self) -> None:
        for p in self.prepared:
            p.close()


# -- the frontend -------------------------------------------------------------


def _settings(args: EvaluationArguments, topk, max_batch, max_wait_ms,
              max_queue) -> EvaluationArguments:
    """``args`` with the knobs that are not None put in: its
    ``__post_init__`` validates them, naming the field."""
    given = {name: v for name, v in (("topk", topk),
                                     ("serve_max_batch", max_batch),
                                     ("serve_max_wait_ms", max_wait_ms),
                                     ("serve_max_queue", max_queue))
             if v is not None}
    return dataclasses.replace(args, **given)


class ServeFrontend:
    """Queue + dispatcher turning concurrent requests into micro-batches.

    Parameters
    ----------
    backend : object with ``begin(texts, topk) -> Future[(ids, scores)]``
        (pipelined) or ``run(texts, topk) -> (ids, scores)`` (synchronous),
        e.g. :class:`EvaluatorServeBackend` / :class:`ClusterServeBackend`,
        or any callable for tests.
    topk : results per query (default 10).
    max_batch : flush when this many queries have coalesced.
    max_wait_ms : flush this long after a batch's first request even if
        under ``max_batch`` (0 = never wait: each flush takes whatever
        is already queued).
    max_queue : pending-request bound (admission control).

    Knobs left as None take ``EvaluationArguments``' ``serve_max_*``
    defaults, and every knob is validated there (:func:`_settings`).
    """

    def __init__(self, backend, *, topk: int | None = None,
                 max_batch: int | None = None,
                 max_wait_ms: float | None = None,
                 max_queue: int | None = None):
        settings = _settings(EvaluationArguments(topk=10), topk, max_batch,
                             max_wait_ms, max_queue)
        topk, max_batch = settings.topk, settings.serve_max_batch
        max_wait_ms = settings.serve_max_wait_ms
        max_queue = settings.serve_max_queue
        if not (callable(backend) or hasattr(backend, "begin")
                or hasattr(backend, "run")):
            raise ValueError(
                "backend must expose begin(texts, topk) or "
                "run(texts, topk), or be callable")
        self.backend = backend
        self.topk = topk
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = {"accepted": 0, "rejected": 0, "completed": 0,
                      "failed": 0, "batches": 0, "queries": 0,
                      "flush_full": 0, "flush_deadline": 0,
                      "flush_drain": 0, "max_batch_seen": 0,
                      "abandoned": 0, "expired": 0, "degraded": 0}
        # does the backend take a deadline_s kwarg (the micro-batch's
        # tightest remaining request budget)?
        target = getattr(backend, "begin", None)
        if target is None:
            target = getattr(backend, "run", backend)
        try:
            self._backend_deadline = ("deadline_s" in
                                      inspect.signature(target).parameters)
        except (TypeError, ValueError):
            self._backend_deadline = False
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._carry: _Request | None = None
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()

    # -- classmethod constructors ---------------------------------------------
    @classmethod
    def _from_backend(cls, backend, args, topk, max_batch, max_wait_ms,
                      max_queue) -> "ServeFrontend":
        """A frontend whose unset knobs come from ``args`` (an
        ``EvaluationArguments``: ``topk`` and ``serve_*``)."""
        settings = _settings(args, topk, max_batch, max_wait_ms, max_queue)
        return cls(backend, topk=settings.topk,
                   max_batch=settings.serve_max_batch,
                   max_wait_ms=settings.serve_max_wait_ms,
                   max_queue=settings.serve_max_queue)

    @classmethod
    def from_evaluator(cls, evaluator, corpus, cache=None, *,
                       topk: int | None = None,
                       max_batch: int | None = None,
                       max_wait_ms: float | None = None,
                       max_queue: int | None = None,
                       live: bool = False) -> "ServeFrontend":
        """Frontend over one evaluator (knob defaults come from its
        ``EvaluationArguments.serve_*`` / ``topk`` fields).  ``live=True``
        serves the cache's live document set with between-micro-batch
        generation swaps (``cache`` required; ``corpus`` just warms it)."""
        if live and cache is None:
            raise ValueError("live=True requires a cache")
        backend = EvaluatorServeBackend(
            evaluator, corpus, None if live else cache,
            live_cache=cache if live else None)
        return cls._from_backend(backend, evaluator.args, topk, max_batch,
                                 max_wait_ms, max_queue)

    @classmethod
    def from_cluster(cls, evaluators, cluster, corpus, caches=None, *,
                     topk: int | None = None,
                     max_batch: int | None = None,
                     max_wait_ms: float | None = None,
                     max_queue: int | None = None,
                     live: bool = False) -> "ServeFrontend":
        """Frontend over W simulated workers (``launch.serve
        --workers N``); knob defaults from rank 0's arguments.
        ``live=True`` serves the shared cache's live set (every rank
        pins the same generation per micro-batch); the first cache in
        ``caches`` is the shared live cache."""
        if live and not (caches and caches[0] is not None):
            raise ValueError("live=True requires a cache in caches[0]")
        backend = ClusterServeBackend(
            evaluators, cluster, corpus, None if live else caches,
            live_cache=caches[0] if live else None)
        return cls._from_backend(backend, evaluators[0].args, topk,
                                 max_batch, max_wait_ms, max_queue)

    # -- request admission ----------------------------------------------------
    def _submit(self, request, deadline_ms: float | None) -> _Request:
        if isinstance(request, str):
            texts = [request]
        elif isinstance(request, dict):
            texts = list(request.values())
        else:
            texts = list(request)
        if not texts:
            raise ValueError("empty request")
        if len(texts) > self.max_batch:
            raise ValueError(
                f"request of {len(texts)} queries exceeds max_batch="
                f"{self.max_batch}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        req = _Request(texts, deadline_ms)
        with self._lock:
            if self._closed:
                raise ServeClosedError("frontend is closed")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.stats["rejected"] += 1
                raise ServeOverloadError(
                    f"queue full ({self._queue.maxsize} pending "
                    f"requests); retry with backoff") from None
            self.stats["accepted"] += 1
        return req

    def submit(self, request, deadline_ms: float | None = None) -> Future:
        """Accept one request — a single query text, a sequence of
        texts, or an ``{id: text}`` dict — and return a Future resolving
        to ``(doc_id_hashes (q, topk), scores (q, topk))`` with one row
        per query, in request order.

        ``deadline_ms`` bounds the request's wait in the queue: a request
        still queued past its deadline resolves at once with a degraded
        empty result (ids ``-1``, scores ``-inf``, coverage 0) instead of
        being scored; a dispatched one hands its remaining budget to a
        backend that takes ``deadline_s``.  Either way the Future
        resolves (accepted requests are never dropped).  Results are
        :class:`~repro_torch.core.faults.SearchOutcome` tuples with
        ``.degraded`` / ``.coverage`` set when the backend reports
        coverage.

        Raises :class:`ServeOverloadError` when the queue is full and
        :class:`ServeClosedError` after :meth:`close`.
        """
        return self._submit(request, deadline_ms).future

    def search(self, request, timeout: float | None = None,
               deadline_ms: float | None = None):
        """Blocking convenience wrapper: submit + wait.

        On ``timeout`` the request is marked **abandoned** — the
        dispatcher skips it during coalescing instead of spending encode
        and score on a result nobody will read — its Future resolves
        with :class:`ServeTimeoutError`, and the same error is raised
        here.
        """
        req = self._submit(request, deadline_ms)
        try:
            return req.future.result(timeout)
        except _FutureTimeout:
            req.abandoned = True
            with self._lock:
                self.stats["abandoned"] += 1
            exc = ServeTimeoutError(
                f"request not served within {timeout}s; abandoned "
                f"(coalescing will skip it)")
            try:
                # resolve the Future so no accepted request is ever left
                # unresolved; a dispatch racing us wins harmlessly
                req.future.set_exception(exc)
            except Exception:
                pass
            raise exc from None

    # -- dispatcher -----------------------------------------------------------
    def _expire(self, req: _Request) -> None:
        """Resolve a deadline-expired queued request with a degraded
        empty result; the accepted-never-dropped invariant holds."""
        ids = np.full((req.n, self.topk), -1, np.int64)
        scores = np.full((req.n, self.topk), -np.inf, np.float32)
        cov = np.zeros(req.n, np.float32)
        try:
            req.future.set_result(SearchOutcome((ids, scores),
                                                coverage=cov,
                                                degraded=True))
        except Exception:                  # cancelled by the caller
            pass
        with self._lock:
            self.stats["expired"] += 1

    def _admissible(self, req: _Request) -> bool:
        """Should this queued request still be scored?  Abandoned ones
        are skipped (their Future is already resolved); deadline-expired
        ones resolve degraded-empty here."""
        if req.abandoned:
            return False
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._expire(req)
            return False
        return True

    def _collect(self) -> tuple[list[_Request], str | None, bool]:
        """Block for the next micro-batch.  Returns ``(batch, flush
        reason, stop)``; an empty batch with ``stop`` means shutdown."""
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                first = self._queue.get()
                if first is _SENTINEL:
                    return [], None, True
            if self._admissible(first):
                break
        batch, n = [first], first.n
        deadline = time.monotonic() + self.max_wait_s
        reason = "full"
        while n < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                nxt = (self._queue.get(timeout=timeout) if timeout > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                reason = "deadline"
                break
            if nxt is _SENTINEL:
                return batch, "drain", True
            if not self._admissible(nxt):
                continue
            if n + nxt.n > self.max_batch:
                self._carry = nxt          # keeps arrival order intact
                break
            batch.append(nxt)
            n += nxt.n
        return batch, reason, False

    def _loop(self) -> None:
        while True:
            batch, reason, stop = self._collect()
            if batch:
                self._dispatch(batch, reason)
            if stop:
                if self._carry is not None:
                    carry, self._carry = self._carry, None
                    if self._admissible(carry):
                        self._dispatch([carry], "drain")
                return

    def _dispatch(self, batch: list[_Request], reason: str) -> None:
        texts = [t for req in batch for t in req.texts]
        n_real = len(texts)
        # pad the micro-batch to its power-of-two rung (demux reads only
        # the real rows): the encode shapes and the superchunk autotune
        # are keyed on the query count, so the steady state sees only
        # the rung ladder {1, 2, 4, ..., max_batch}, all warmable
        rung = 1
        while rung < n_real:
            rung *= 2
        texts = texts + [texts[0]] * (rung - n_real)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["queries"] += n_real
            self.stats[f"flush_{reason}"] += 1
            self.stats["max_batch_seen"] = max(
                self.stats["max_batch_seen"], n_real)
        # a backend taking deadline_s gets the tightest member budget
        kwargs = {}
        if self._backend_deadline:
            now = time.monotonic()
            remaining = [req.remaining_s(now) for req in batch
                         if req.deadline is not None]
            if remaining:
                kwargs["deadline_s"] = max(min(remaining), 1e-3)
        begin = getattr(self.backend, "begin", None)
        try:
            if begin is not None:
                # pipelined: scoring ran inline; merge and demux complete
                # on the backend's reduce thread while we collect the
                # next micro-batch
                fut = begin(texts, self.topk, **kwargs)
                fut.add_done_callback(
                    lambda f, b=batch: self._demux(b, f))
            else:
                run = getattr(self.backend, "run", self.backend)
                self._finish(batch, run(texts, self.topk, **kwargs))
        except BaseException as exc:       # noqa: BLE001 — routed to futures
            self._fail(batch, exc)

    def _demux(self, batch: list[_Request], fut: Future) -> None:
        try:
            out = fut.result()
        except BaseException as exc:       # noqa: BLE001 — routed to futures
            self._fail(batch, exc)
            return
        self._finish(batch, out)

    def _finish(self, batch: list[_Request], out) -> None:
        ids, scores = out
        coverage = getattr(out, "coverage", None)
        ids = np.asarray(ids)
        scores = np.asarray(scores)
        off = 0
        n_degraded = 0
        for req in batch:
            rows = (ids[off: off + req.n], scores[off: off + req.n])
            if coverage is not None:
                cov = np.asarray(coverage)[off: off + req.n]
                degraded = bool((cov < 1.0).any())
                rows = SearchOutcome(rows, coverage=cov,
                                     degraded=degraded)
                n_degraded += degraded
            try:
                req.future.set_result(rows)
            except Exception:              # cancelled by the caller
                pass
            off += req.n
        with self._lock:
            self.stats["completed"] += len(batch)
            self.stats["degraded"] += n_degraded

    def _fail(self, batch: list[_Request], exc: BaseException) -> None:
        for req in batch:
            try:
                req.future.set_exception(exc)
            except Exception:              # cancelled by the caller
                pass
        with self._lock:
            self.stats["failed"] += len(batch)

    # -- shutdown -------------------------------------------------------------
    def close(self) -> None:
        """Stop admission, drain every queued request, join the
        dispatcher and the backend's reduce thread.  Every accepted
        Future is resolved when this returns.  Idempotent."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            # the sentinel lands after every accepted request (submit
            # holds the lock and refuses once _closed), so the
            # dispatcher drains everything first
            self._queue.put(_SENTINEL)
        self._thread.join()
        close_backend = getattr(self.backend, "close", None)
        if close_backend is not None:
            close_backend()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

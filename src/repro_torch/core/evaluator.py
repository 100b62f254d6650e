"""RetrievalEvaluator: evaluation + hard-negative mining (paper §3.5).

The port's counterpart of ``repro.core.evaluator``.  Every search entry
point is a thin instantiation of
:class:`~repro_torch.core.sharded_search.ShardedSearchDriver`:

  * :meth:`RetrievalEvaluator.search` / :meth:`evaluate` /
    :meth:`mine_hard_negatives` — the paper's pipeline: the corpus is
    encoded online through the bucketed encode pipeline and streamed,
    device-resident, into the driver's superchunk executor;
  * the same with ``cache=`` an :class:`~repro_torch.core.
    embedding_cache.EmbeddingCache` — the paper's "w/ cached embeddings"
    path: a first (cold) pass encodes on the host and writes the cache,
    later (warm) passes pin a snapshot that covers the corpus and stream
    its float16 rows off the mmap, cast to float32 and uploaded once per
    superchunk, with no corpus encoding;
  * :meth:`evaluate_suite` — N datasets, each on its own and then as
    one combined corpus: a ``ConcatView`` of the datasets' views, so the
    union is never built on disk or in RAM;
  * :meth:`prepare_corpus` (``device_resident=True``) +
    :meth:`search_texts` — the serving regime: the corpus is encoded
    once and kept on the card, each request encodes its queries and
    scores them;
  * :meth:`prepare_cache_corpus` + :meth:`search_texts` — a live
    corpus: the cache's own live set at one pinned generation, while
    writers add, re-embed, delete and compact.

With ``index_impl="ivf"`` every prepared corpus sits behind an
:class:`~repro_torch.index.ivf.IVFIndex` (k-means over the corpus rows,
persisted under ``{cache}/ivf_k{K}`` when there is a cache): each round
selects its query batch's ``ivf_nprobe`` nearest clusters
(:meth:`PreparedCorpus.round_for`) and the driver scans only their rows,
with the same kernels; ``nprobe == nclusters`` scans every row.

Every entry point runs unchanged on 1..W workers: with
``process_count > 1`` (by default the ``torch.distributed`` world, see
``repro_torch.launch.distributed.init_distributed``) each worker scores
its shard of the corpus and the gather transport merges the W states, so
every worker returns the same ranking; ``SimulatedCluster`` runs W
evaluators in one process.  Under its resilient gather a worker's death
costs no round: the survivors rescore its shard, and a search given
``deadline_s`` that runs out of recovery time returns a partial result
whose ``coverage`` (a :class:`~repro_torch.core.faults.SearchOutcome`)
says how much of the corpus it saw.

Scoring is ``EvaluationArguments.score_impl`` (``numpy | torch |
fused``) and the heap ``heap_impl`` (``python | torch | kernel``); all
combinations return the same rankings.  Queries and corpora are
``{id: text}`` dicts or :class:`~repro_torch.data.views.DatasetView`s.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.config import EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.encode_pipeline import (EncodePipeline,
                                              PipelineChunkSource)
from repro_torch.core.fair_sharding import FairSharder
from repro_torch.core.faults import FaultInjector, SearchOutcome
from repro_torch.core.metrics import compute_metrics
from repro_torch.core.result_heap import to_tensor
from repro_torch.core.sharded_search import (ProcessAllGather,
                                             ShardedSearchDriver)
from repro_torch.data.table import stable_id_hash, stable_id_hash_array
from repro_torch.data.views import ConcatView, DatasetView, as_view
from repro_torch.device import resolve_device
from repro_torch.index.ivf import IVFIndex, corpus_digest


def select_hard_negatives(q_ids: Sequence[str], run_ids: np.ndarray,
                          scores: np.ndarray,
                          qrels: dict[str, dict[str, float]],
                          hash_to_raw: dict[int, str],
                          exclude_positives: bool = True
                          ) -> list[tuple[str, str, float]]:
    """Turn ranked (Q, depth) id hashes into negative qrel triplets."""
    out: list[tuple[str, str, float]] = []
    for qi, q in enumerate(q_ids):
        row = run_ids[qi]
        keep = row >= 0
        if exclude_positives:
            pos = [d for d, g in qrels.get(q, {}).items() if g > 0]
            if pos:
                keep &= ~np.isin(row, stable_id_hash_array(pos))
        out.extend(
            (q, hash_to_raw[h], s)
            for h, s in zip(row[keep].tolist(),
                            scores[qi][keep].tolist()))
    return out


def format_metrics_table(results: dict[str, dict]) -> str:
    """Markdown table: one row per dataset, one column per metric."""
    if not results:
        return "(no results)\n"
    metrics = list(next(iter(results.values())).keys())
    widths = [max(len("dataset"),
                  *(len(n) for n in results))] + [
        max(len(m), 6) for m in metrics]

    def fmt_row(cells):
        return "| " + " | ".join(
            c.ljust(w) for c, w in zip(cells, widths)) + " |\n"
    out = fmt_row(["dataset"] + metrics)
    out += "|" + "|".join("-" * (w + 2) for w in widths) + "|\n"
    for name, vals in results.items():
        out += fmt_row([name] + [f"{vals[m]:.4f}" for m in metrics])
    return out


class PreparedCorpus:
    """A corpus resolved once for repeated searches: its id hashes, the
    sized object the sharder partitions, and the chunk loader the driver
    streams (cache snapshot reads, encode pipeline or device-resident
    slices).

    A cache-backed preparation pins a :class:`~repro_torch.core.
    embedding_cache.CacheSnapshot`: ``generation`` carries its
    ``(generation, epoch)`` key, and searches against this corpus read
    exactly that view (concurrent mutations and compactions never show
    through).  :meth:`close` releases the pin, so compaction may retire
    the old epoch's files; other corpora have ``generation is None`` and
    :meth:`close` does nothing.
    """

    __slots__ = ("hashes", "n_docs", "load_chunk", "sized", "generation",
                 "snapshot")

    def __init__(self, hashes: np.ndarray, n_docs: int, load_chunk,
                 sized=None, generation=None, snapshot=None):
        self.hashes = hashes
        self.n_docs = n_docs
        self.load_chunk = load_chunk
        self.sized = n_docs if sized is None else sized
        self.generation = generation
        self.snapshot = snapshot

    def __len__(self) -> int:
        return self.n_docs

    def close(self) -> None:
        if self.snapshot is not None:
            self.snapshot.close()

    def positions_to_ids(self, pos: np.ndarray) -> np.ndarray:
        """Map the driver's int32 global positions to 63-bit id hashes
        on the host (-1 marks empty slots)."""
        return np.where(pos >= 0, self.hashes[np.clip(pos, 0, None)], -1)

    def round_for(self, q_emb):
        """The ``(sized, load_chunk, positions_to_ids)`` of one search
        round against this query batch.  A flat corpus scans the same
        ``[0, n_docs)`` every round, so its members come back as they
        are; :class:`IVFPreparedCorpus` derives a per-batch search space
        from the query embeddings."""
        return self.sized, self.load_chunk, self.positions_to_ids


class IVFSearchSpace:
    """The sized object of one IVF round: the concatenation of the
    selected clusters' permutation slices, positions ``[0,
    n_selected)``.  ``partition_boundaries`` are the cluster edges inside
    that space, so the :class:`FairSharder` cuts shards at whole
    clusters."""

    __slots__ = ("n_selected", "partition_boundaries")

    def __init__(self, n_selected: int, partition_boundaries: np.ndarray):
        self.n_selected = n_selected
        self.partition_boundaries = partition_boundaries

    def __len__(self) -> int:
        return self.n_selected


class IVFPreparedCorpus(PreparedCorpus):
    """A corpus prepared behind an :class:`~repro_torch.index.ivf.
    IVFIndex`.

    ``fetch_rows(rows)`` serves arbitrary store rows (a cache snapshot's
    rows, or an index into the encoded corpus).  Each :meth:`round_for`
    selects the batch's ``nprobe`` nearest clusters on the host (a query
    batch on the card comes down once) and presents their concatenated
    permutation slices as the round's search space: the driver and the
    kernels see an ordinary ``[0, n_selected)`` corpus.  With
    ``rows_device`` (a store on the card) the round's row indices go to
    that device once, and every chunk gathers from them there.  With
    ``nprobe == n_clusters`` the space is the whole corpus in cluster
    order.
    """

    __slots__ = ("index", "fetch_rows", "nprobe", "rows_device")

    def __init__(self, hashes: np.ndarray, n_docs: int, fetch_rows,
                 index, nprobe: int, generation=None, snapshot=None,
                 rows_device: torch.device | None = None):
        super().__init__(hashes, n_docs, load_chunk=None,
                         generation=generation, snapshot=snapshot)
        self.index = index
        self.fetch_rows = fetch_rows
        self.nprobe = int(nprobe)
        self.rows_device = rows_device

    def round_for(self, q_emb):
        clusters = self.index.select(q_emb, self.nprobe)
        sel_rows = self.index.gather_rows(clusters)
        sized = IVFSearchSpace(len(sel_rows),
                               self.index.slice_boundaries(clusters))
        fetch = self.fetch_rows
        rows = (sel_rows if self.rows_device is None else
                torch.from_numpy(sel_rows).to(self.rows_device))

        def load_chunk(lo: int, hi: int):
            return fetch(rows[lo:hi])

        def positions_to_ids(pos: np.ndarray) -> np.ndarray:
            if len(sel_rows) == 0:
                return np.full(np.shape(pos), -1, np.int64)
            # sel-space position -> store row -> id hash
            store = sel_rows[np.clip(pos, 0, None)]
            return np.where(pos >= 0, self.hashes[store], -1)

        return sized, load_chunk, positions_to_ids


def _snapshot_readers(snap, rows_map=None):
    """``(get_range, fetch_rows)`` reading a pinned snapshot's rows as
    float32: live-space positions, or, with ``rows_map`` (a row plan's
    positions), the corpus's positions mapped through it."""
    if rows_map is None:
        return (lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
                lambda rows: snap.get_rows(rows).astype(np.float32))
    return (lambda lo, hi: snap.get_rows(rows_map[lo:hi]).astype(
                np.float32),
            lambda rows: snap.get_rows(rows_map[rows]).astype(np.float32))


class RetrievalEvaluator:
    """Parameters
    ----------
    args : :class:`EvaluationArguments`.
    retriever : encoder holder (``retriever.encoder.encode``,
        ``format_query`` / ``format_passage``).
    collator : :class:`RetrievalCollator` (tokenizer + length budgets).
    params : the encoder's parameters, on ``device``.
    device : where encoding and the device backends run; ``"cuda"`` by
        default, and construction raises when no card is present unless
        ``device="cpu"`` is passed.
    process_index / process_count : this worker's rank and the number of
        workers; by default the ``torch.distributed`` rank and world
        size when a process group is initialised, else 0 and 1.
    gather : the transport merging the workers' states, any object with
        ``merge(heap, worker_index)`` (a
        :class:`~repro_torch.core.sharded_search.ShardGather`, e.g.
        ``SimulatedCluster.gather``); by default a
        :class:`~repro_torch.core.sharded_search.ProcessAllGather` when
        ``process_count > 1``, else none.
    sharder : a :class:`FairSharder` shared across searches (and across
        the evaluators of a ``SimulatedCluster``); a fresh
        ``FairSharder(process_count)`` by default.
    fault_injector : a :class:`~repro_torch.core.faults.FaultInjector`
        every driver of this evaluator consults (chaos tests, ``serve
        --chaos``); none by default.
    """

    def __init__(self, args: EvaluationArguments, retriever, collator,
                 params, *, device: str | torch.device = "cuda",
                 process_index: int | None = None,
                 process_count: int | None = None,
                 gather=None, sharder: FairSharder | None = None,
                 fault_injector: FaultInjector | None = None):
        self.device = resolve_device(device)
        self.args = args
        self.retriever = retriever
        self.collator = collator
        self.params = params
        dist = torch.distributed
        joined = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if joined else 0
        if process_count is None:
            process_count = dist.get_world_size() if joined else 1
        self.process_index = process_index
        self.process_count = process_count
        self.sharder = (FairSharder(process_count) if sharder is None
                        else sharder)
        if gather is not None:
            self.gather = gather
        elif process_count > 1:
            self.gather = ProcessAllGather()
        else:
            self.gather = None
        self.fault_injector = fault_injector
        self.encode_pipeline = (EncodePipeline(
            self._encode_batch, collator.tokenizer,
            append_eos=collator.append_eos,
            pad_to_multiple=collator.args.pad_to_multiple,
            buckets=args.encode_buckets,
            batch_size=args.encode_batch_size,
            tokenizer_workers=args.tokenizer_workers,
            depth=args.encode_pipeline_depth, device=self.device)
            if args.encode_buckets > 0 else None)
        # (corpus_obj, key list, DictView): dict corpora are wrapped and
        # hashed once, reused across search/evaluate/mine_hard_negatives
        self._corpus_view_cache: tuple[dict, list, DatasetView] | None = None
        # the last search's driver stats (executor, calls, devices)
        self.last_search_stats: dict = {}

    # -- encoding ------------------------------------------------------------
    def _encode_batch(self, params, batch):
        return self.retriever.encoder.encode(params, batch)

    def _encode_texts(self, texts: Sequence[str], is_query: bool,
                      device: bool = False, min_batch_dim: int = 8):
        """Encode texts -> (N, d) float32: a tensor on ``self.device``
        with ``device=True``, else a numpy array.  ``min_batch_dim``
        floors the pipeline's small-input batch dim."""
        fmt = (self.retriever.format_query if is_query
               else self.retriever.format_passage)
        bs = (self.args.query_batch_size if is_query
              else self.args.encode_batch_size)
        max_len = self.collator.max_len_for(is_query)
        if self.encode_pipeline is not None:
            return self.encode_pipeline.encode(
                self.params, list(texts), max_len, fmt=fmt, device=device,
                batch_size=bs, min_batch_dim=min_batch_dim)
        out = []
        for lo in range(0, len(texts), bs):
            chunk = [fmt(t) for t in texts[lo: lo + bs]]
            batch = self.collator.encode_texts(chunk, max_len)
            batch = {name: torch.from_numpy(a).to(self.device)
                     for name, a in batch.items()}
            with torch.no_grad():
                out.append(self._encode_batch(self.params, batch))
        enc = (torch.cat(out) if out
               else torch.empty((0, 0), device=self.device))
        return enc if device else enc.cpu().numpy()

    def encode_corpus(self, ids: Sequence, texts: Sequence[str],
                      cache: EmbeddingCache | None = None,
                      device: bool = False):
        """Encode a corpus slice, reading and writing ``cache``.

        Cached ids are read from the cache; the missing ones are encoded
        on the host and appended to it.  The result is a float32 numpy
        array (the cache stores numpy rows), except with no cache and
        ``device=True``: the encoder's output then stays on the device
        (the online regime, no host round trip per chunk)."""
        if cache is None and device:
            return self._encode_texts(texts, False, device=True)
        if cache is not None and len(cache):
            have = cache.has(ids)
        else:
            have = np.zeros(len(ids), bool)
        embs = np.empty((len(ids), 0), np.float32)
        missing = np.flatnonzero(~have)
        if len(missing):
            enc = self._encode_texts([texts[i] for i in missing], False)
            embs = np.empty((len(ids), enc.shape[1]), np.float32)
            embs[missing] = enc
            if cache is not None:
                cache.cache_records([ids[i] for i in missing], enc)
        hit = np.flatnonzero(have)
        if len(hit):
            got = cache.get([ids[i] for i in hit])
            if embs.shape[1] == 0:
                embs = np.empty((len(ids), got.shape[1]), np.float32)
            embs[hit] = got
        return embs

    def _corpus_view(self, corpus) -> DatasetView:
        """Coerce a corpus/query container to a view; dicts are wrapped
        once per (object, key list)."""
        if isinstance(corpus, DatasetView):
            return corpus
        if isinstance(corpus, dict):
            keys = list(corpus.keys())
            cached = self._corpus_view_cache
            if (cached is not None and cached[0] is corpus
                    and cached[1] == keys):
                return cached[2]
            view = as_view(corpus)
            self._corpus_view_cache = (corpus, keys, view)
            return view
        return as_view(corpus)

    # -- search --------------------------------------------------------------
    def make_driver(self) -> ShardedSearchDriver:
        """A driver of this evaluator's settings (backends, chunking,
        superchunk size, rank, sharder, gather, fault injector, recovery
        settings, device): the one way its searches and the serve
        backends (``core.serving``) build one."""
        return ShardedSearchDriver(
            n_workers=self.process_count, worker_index=self.process_index,
            sharder=self.sharder, gather=self.gather,
            score_impl=self.args.score_impl,
            heap_impl=self.args.heap_impl,
            chunk_size=self.args.encode_batch_size,
            prefetch=self.args.async_prefetch,
            superchunk_size=self.args.superchunk_size,
            superchunk_max_mb=self.args.superchunk_max_mb,
            fault_injector=self.fault_injector,
            round_deadline_s=self.args.round_deadline_s,
            max_shard_retries=self.args.shard_retries,
            retry_backoff_s=self.args.shard_retry_backoff_s,
            device=self.device)

    def _on_device(self) -> bool:
        return self.args.score_impl != "numpy"

    def prepare_corpus(self, corpus, cache: EmbeddingCache | None = None,
                       *, device_resident: bool = False) -> PreparedCorpus:
        """Resolve a corpus once for repeated searches against it.

        * ``device_resident=True`` encodes the whole corpus now (through
          ``cache`` when given, warming it) and keeps the embeddings
          where scoring happens (the card for the device backends, the
          host for ``numpy``): chunk loads become zero-copy slices.
        * A ``cache`` that covers the corpus: a snapshot is pinned and
          its row plan resolved once — ``("range", None)`` when the live
          rows are the corpus in order, else ``("rows", positions)`` —
          and chunk loads become snapshot reads cast to float32, which
          the driver uploads once per superchunk.
        * Online (no cache): chunks are encoded as the driver streams
          them, through the bucketed encode pipeline.
        * A cache that does not cover the corpus: each chunk is looked
          up, and its missing rows encoded and cached (one generation
          per chunk that had any), as it streams.

        With ``index_impl="ivf"`` the corpus is prepared behind an IVF
        index instead (:meth:`_prepare_ivf`).
        """
        on_device = self._on_device()
        corpus_v = self._corpus_view(corpus)
        texts = corpus_v.texts()
        hashes = np.asarray(corpus_v.id_hashes)
        n_docs = len(corpus_v)
        if self.args.index_impl == "ivf" and n_docs > 0:
            return self._prepare_ivf(corpus_v, cache,
                                     device_resident=device_resident)
        if device_resident:
            embs = self.encode_corpus(hashes, texts, cache,
                                      device=on_device)
            if on_device:
                embs = to_tensor(embs, self.device, torch.float32)
            return PreparedCorpus(hashes, n_docs, lambda lo, hi: embs[lo:hi])
        plan = snap = None
        if cache is not None and len(cache):
            snap = cache.snapshot()
            plan = snap.row_plan(hashes)
            if plan is None:
                snap.close()
                snap = None
        if plan is not None:
            kind, rows = plan
            if kind == "range":
                def load_chunk(lo: int, hi: int):
                    return snap.get_range(lo, hi).astype(np.float32)
            else:
                def load_chunk(lo: int, hi: int):
                    return snap.get_rows(rows[lo:hi]).astype(np.float32)
        elif cache is None and self.encode_pipeline is not None:
            load_chunk = PipelineChunkSource(
                self.encode_pipeline, self.params, texts,
                self.collator.max_len_for(False),
                fmt=self.retriever.format_passage, device=on_device)
        elif cache is None:
            def load_chunk(lo: int, hi: int):
                return self._encode_texts(texts[lo:hi], False,
                                          device=on_device)
        else:
            c = self.args.encode_batch_size

            def load_chunk(lo: int, hi: int):
                # one lookup (and one cache commit of its missing rows)
                # per chunk, as the reference's per-chunk loads make, so
                # a cold pass advances the generation alike at any
                # superchunk size.  Cache keys are stable hashes, so the
                # hashed id slice addresses it for raw-id dicts and
                # views alike.
                return np.concatenate([
                    self.encode_corpus(hashes[a:min(a + c, hi)],
                                       texts[a:min(a + c, hi)], cache)
                    for a in range(lo, hi, c)])
        return PreparedCorpus(hashes, n_docs, load_chunk, sized=corpus_v,
                              generation=snap.key if snap else None,
                              snapshot=snap)

    def _ivf_index(self, get_range, hashes: np.ndarray, n_docs: int,
                   dim: int, cache: EmbeddingCache | None, generation):
        """The IVF index over ``n_docs`` rows served by ``get_range``:
        loaded from ``{cache.path}/ivf_k{K}`` when a persisted one
        matches the corpus digest (the id hashes, the build knobs and
        the snapshot ``generation``), else built here on this
        evaluator's device and, with a cache, saved there."""
        a = self.args
        k = int(min(a.ivf_nclusters, n_docs))
        digest = corpus_digest(hashes, seed=a.ivf_seed,
                               train_steps=a.ivf_train_steps,
                               train_batch=a.ivf_train_batch,
                               generation=generation)
        index_dir = (os.path.join(cache.path, f"ivf_k{k}")
                     if cache is not None else None)
        index = None
        if index_dir is not None:
            index = IVFIndex.load(index_dir, expect_n=n_docs,
                                  expect_dim=dim, expect_clusters=k,
                                  expect_digest=digest)
        if index is None:
            index = IVFIndex.build(get_range, n_docs, k, seed=a.ivf_seed,
                                   train_steps=a.ivf_train_steps,
                                   train_batch=a.ivf_train_batch,
                                   device=self.device)
            if index_dir is not None:
                index.save(index_dir, digest=digest)
        return index

    def _prepare_ivf(self, corpus_v: DatasetView,
                     cache: EmbeddingCache | None, *,
                     device_resident: bool = False) -> IVFPreparedCorpus:
        """Prepare a corpus behind a cluster-pruned IVF index.

        The quantizer trains off contiguous ``get_range`` reads of a
        corpus-ordered row store: a pinned snapshot of ``cache`` when it
        covers the corpus (and the corpus is not wanted device-resident),
        else the embeddings encoded here (warming ``cache`` when given),
        kept on the card with ``device_resident=True`` for the device
        backends and on the host otherwise.  With a cache the index
        persists under ``{cache.path}/ivf_k{K}`` (:meth:`_ivf_index`), so
        a restart reloads it instead of retraining; any mismatch
        rebuilds.
        """
        on_device = self._on_device()
        hashes = np.asarray(corpus_v.id_hashes)
        n_docs = len(corpus_v)
        plan = snap = None
        rows_device = None
        if cache is not None and len(cache) and not device_resident:
            snap = cache.snapshot()
            plan = snap.row_plan(hashes)
            if plan is None:
                snap.close()
                snap = None
        if plan is not None:
            dim = cache.dim
            get_range, fetch_rows = _snapshot_readers(snap, plan[1])
        else:
            resident = device_resident and on_device
            embs = self.encode_corpus(hashes, corpus_v.texts(), cache,
                                      device=resident)
            if resident:
                store = to_tensor(embs, self.device, torch.float32)
                rows_device = self.device
            else:
                store = np.asarray(embs, np.float32)
            dim = store.shape[1]

            def get_range(lo: int, hi: int):
                return store[lo:hi]

            def fetch_rows(rows):
                return store[rows]
        try:
            index = self._ivf_index(get_range, hashes, n_docs, dim, cache,
                                    snap.key if snap else None)
        except BaseException:
            if snap is not None:
                snap.close()
            raise
        return IVFPreparedCorpus(hashes, n_docs, fetch_rows, index,
                                 self.args.ivf_nprobe,
                                 generation=snap.key if snap else None,
                                 snapshot=snap, rows_device=rows_device)

    def prepare_cache_corpus(self, cache: EmbeddingCache,
                             generation=None) -> PreparedCorpus:
        """Prepare the cache's own live set for search: the corpus is
        whatever is live in the pinned snapshot (adds, re-embeds and
        deletes included), in live-space order.  ``generation`` takes an
        int or a ``(generation, epoch)`` key to pin an earlier view.
        For the flat index preparation is no work at all, so a server
        can swap generations between requests cheaply; with
        ``index_impl="ivf"`` it loads the snapshot's persisted index or
        builds one (the digest holds the generation, so a new generation
        rebuilds: :meth:`_prepare_ivf_snapshot`)."""
        snap = cache.snapshot(generation)
        if self.args.index_impl == "ivf" and snap.n_live > 0:
            return self._prepare_ivf_snapshot(cache, snap)

        def load_chunk(lo: int, hi: int):
            return snap.get_range(lo, hi).astype(np.float32)

        return PreparedCorpus(snap.ids, snap.n_live, load_chunk,
                              generation=snap.key, snapshot=snap)

    def _prepare_ivf_snapshot(self, cache: EmbeddingCache,
                              snap) -> IVFPreparedCorpus:
        """IVF preparation over a pinned snapshot's live rows (the live
        counterpart of :meth:`_prepare_ivf`): rows are read off the
        snapshot, as its flat preparation reads them."""
        get_range, fetch_rows = _snapshot_readers(snap)
        try:
            index = self._ivf_index(get_range, snap.ids, snap.n_live,
                                    cache.dim, cache, snap.key)
        except BaseException:
            snap.close()
            raise
        return IVFPreparedCorpus(snap.ids, snap.n_live, fetch_rows, index,
                                 self.args.ivf_nprobe, generation=snap.key,
                                 snapshot=snap)

    def _search_embedded(self, q_emb, prepared: PreparedCorpus,
                         topk: int, deadline_s: float | None = None):
        """One round against ``prepared``: its search space for this
        query batch (:meth:`PreparedCorpus.round_for`), the driver's
        search -> (outcome, positions_to_ids)."""
        sized, load_chunk, to_ids = prepared.round_for(q_emb)
        driver = self.make_driver()
        out = driver.search(q_emb, sized, load_chunk, topk,
                            deadline_s=deadline_s,
                            generation=prepared.generation)
        self.last_search_stats = driver.stats
        return out, to_ids

    def search_prepared(self, queries, prepared: PreparedCorpus,
                        topk: int | None = None,
                        deadline_s: float | None = None) -> SearchOutcome:
        """:meth:`search` against an already-prepared corpus.
        ``deadline_s`` bounds a resilient round's recovery (see
        ``ShardedSearchDriver.search``); the outcome carries its
        coverage."""
        topk = topk or self.args.topk
        q_view = self._corpus_view(queries)
        q_emb = self._encode_texts(q_view.texts(), True,
                                   device=self._on_device())
        out, to_ids = self._search_embedded(q_emb, prepared, topk,
                                            deadline_s)
        vals, pos = out
        return SearchOutcome((np.asarray(q_view.id_hashes),
                              to_ids(pos), vals),
                             coverage=out.coverage, degraded=out.degraded)

    def search_texts(self, texts: Sequence[str], prepared: PreparedCorpus,
                     topk: int | None = None, min_batch_dim: int = 8,
                     deadline_s: float | None = None) -> SearchOutcome:
        """Raw-text query search against a prepared corpus — the serve
        backends' entry point.  Returns ``(doc_id_hashes (Q, k), scores
        (Q, k))``, with the round's coverage (``deadline_s`` as in
        :meth:`search_prepared`)."""
        topk = topk or self.args.topk
        q_emb = self._encode_texts(list(texts), True,
                                   device=self._on_device(),
                                   min_batch_dim=min_batch_dim)
        out, to_ids = self._search_embedded(q_emb, prepared, topk,
                                            deadline_s)
        vals, pos = out
        return SearchOutcome((to_ids(pos), vals),
                             coverage=out.coverage, degraded=out.degraded)

    def search(self, queries, corpus, topk: int | None = None,
               cache: EmbeddingCache | None = None) -> SearchOutcome:
        """Dense retrieval: -> (qid_hashes, doc_id_hashes (Q, k), scores).

        Device-side top-k tracks int32 global corpus positions; they are
        mapped back to id hashes on the host.  With ``cache``, the corpus
        is read from it where it covers the corpus, else encoded into it
        (:meth:`prepare_corpus`).
        """
        prepared = self.prepare_corpus(corpus, cache)
        try:
            return self.search_prepared(queries, prepared, topk)
        finally:
            prepared.close()

    # -- public API ----------------------------------------------------------
    def evaluate(self, queries, corpus,
                 qrels: dict[str, dict[str, float]],
                 cache: EmbeddingCache | None = None) -> dict:
        """Metrics for one (queries, corpus, qrels) scenario; ``qrels``
        may be keyed by raw ids or by stable hashes.  A degraded search
        (a resilient round that ran out of recovery) adds ``coverage``
        (the mean fraction of the corpus scored) and ``degraded``, so its
        numbers are never read as full-coverage ones."""
        out = self.search(queries, corpus, cache=cache)
        q_hashes, run_ids, _ = out
        qrels_h = {
            stable_id_hash(q): {stable_id_hash(d): float(g)
                                for d, g in docs.items()}
            for q, docs in qrels.items()}
        report = compute_metrics(self.args.metrics, run_ids, q_hashes,
                                 qrels_h)
        if out.degraded:
            report["coverage"] = float(np.asarray(out.coverage).mean())
            report["degraded"] = True
        return report

    def evaluate_suite(self, scenarios: dict[str, dict], *,
                       combined: bool = True,
                       cache: EmbeddingCache | None = None,
                       out_dir: str | None = None,
                       suite_name: str = "evalsuite") -> dict:
        """Evaluate N datasets — per-dataset AND as one combined corpus.

        ``scenarios`` maps a dataset name to ``{"queries", "corpus",
        "qrels"}`` (dicts or views).  The combined pass concatenates the
        query and corpus *views* (``ConcatView``) and unions the qrels,
        so queries are scored against the union of all corpora without
        the union ever being built on disk or in RAM.  Dataset id
        spaces must be disjoint (namespace your ids per dataset, e.g.
        via ``view.map(..., rekey=True)``) — collisions raise.

        One shared ``cache`` (keyed by stable doc-id hash) serves every
        per-dataset pass and the combined pass.  Runs on 1..W workers
        unchanged: under a gather transport every worker computes
        identical tables and only worker 0 writes
        ``{out_dir}/{suite_name}.json`` / ``.md``.
        """
        results: dict[str, dict] = {}
        for name, sc in scenarios.items():
            results[name] = self.evaluate(sc["queries"], sc["corpus"],
                                          sc["qrels"], cache=cache)
        if combined and len(scenarios) > 1:
            q_views = [self._corpus_view(sc["queries"])
                       for sc in scenarios.values()]
            c_views = [self._corpus_view(sc["corpus"])
                       for sc in scenarios.values()]
            for kind, views in (("query", q_views), ("doc", c_views)):
                all_h = np.concatenate(
                    [np.asarray(v.id_hashes) for v in views])
                if len(np.unique(all_h)) != len(all_h):
                    raise ValueError(
                        f"duplicate {kind} ids across suite datasets — "
                        f"namespace ids per dataset (e.g. "
                        f"view.map(..., rekey=True)) before combining")
            merged_qrels: dict = {}
            for sc in scenarios.values():
                merged_qrels.update(sc["qrels"])
            results["combined"] = self.evaluate(
                ConcatView(*q_views), ConcatView(*c_views), merged_qrels,
                cache=cache)
        if out_dir is not None and self.process_index == 0:
            os.makedirs(out_dir, exist_ok=True)
            payload = {"suite": suite_name, "metrics": self.args.metrics,
                       "datasets": list(scenarios),
                       "results": results}
            with open(os.path.join(out_dir, f"{suite_name}.json"),
                      "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            with open(os.path.join(out_dir, f"{suite_name}.md"), "w") as f:
                f.write(format_metrics_table(results))
        return results

    def mine_hard_negatives(self, queries, corpus,
                            qrels: dict[str, dict[str, float]],
                            depth: int | None = None,
                            exclude_positives: bool = True,
                            output_path: str | None = None,
                            cache: EmbeddingCache | None = None):
        """Top-ranked non-positives per query -> negative qrel triplets."""
        depth = depth or self.args.topk
        q_ids = self._corpus_view(queries).raw_ids()
        _, run_ids, scores = self.search(queries, corpus, topk=depth,
                                         cache=cache)
        corpus_v = self._corpus_view(corpus)
        hashes = np.asarray(corpus_v.id_hashes)
        hash_to_raw = dict(zip(hashes.tolist(), corpus_v.raw_ids()))
        out = select_hard_negatives(q_ids, run_ids, scores, qrels,
                                    hash_to_raw, exclude_positives)
        # every worker computes the identical merged triplets, so only
        # worker 0 writes: W workers racing one path would tear the file
        if output_path and self.process_index == 0:
            with open(output_path, "w") as f:
                for q, d, s in out:
                    f.write(f"{q}\t{d}\t{s}\n")
        return out

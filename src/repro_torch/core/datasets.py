"""User-facing dataset classes (paper §3.2.2).

Datasets are composed of one or more :class:`MaterializedQRel` sources,
each with its own on-the-fly processing (filter/relabel/sample), combined
lazily — no pre-processed files, fully VCS-trackable via the configs.

The port's copy of the reference's ``core/datasets.py``: the training
datasets :class:`BinaryDataset` and :class:`MultiLevelDataset`, which
draw from the reference's ``np.random.default_rng((seed, qid, i))``
streams, so both packages yield the same items from the same files; and
:class:`EncodingDataset` over the port's
:class:`~repro_torch.core.embedding_cache.EmbeddingCache`.  It imports
numpy and no torch module.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.config import DataArguments, MaterializedQRelConfig
from repro_torch.core.materialized_qrel import MaterializedQRel
from repro_torch.data.views import ConcatView, TableView


def _as_mqrels(cfgs, cache_root) -> list[MaterializedQRel]:
    if isinstance(cfgs, (MaterializedQRelConfig, MaterializedQRel)):
        cfgs = [cfgs]
    return [c if isinstance(c, MaterializedQRel)
            else MaterializedQRel(c, cache_root) for c in cfgs]


def _sources_view(sources: Sequence[MaterializedQRel], which: str):
    """Lazy concat view over the sources' query/corpus tables, deduped
    by table path (sources over the same file share one mmap table)."""
    seen: dict = {}
    for m in sources:
        table = getattr(m, which)
        seen.setdefault(table.path, table)
    views = [TableView(t) for t in seen.values()]
    return views[0] if len(views) == 1 else ConcatView(*views)


_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "trove_cache")


class BinaryDataset:
    """Positives + negatives -> (query, [pos, neg...]) training instances."""

    def __init__(self, data_args: DataArguments,
                 format_query: Callable[[str], str],
                 format_passage: Callable[..., str],
                 positives, negatives,
                 cache_root: str = _CACHE_ROOT, seed: int = 0):
        self.args = data_args
        self.format_query = format_query
        self.format_passage = format_passage
        self.pos = _as_mqrels(positives, cache_root)
        self.neg = _as_mqrels(negatives, cache_root)
        self.seed = seed
        qids = np.unique(np.concatenate(
            [m.query_id_hashes for m in self.pos]))
        # keep only queries that still have >= 1 positive after each
        # source's on-the-fly processing (group_random_k=0, a filter):
        # an empty positive group is a shorter epoch, not an IndexError
        has_pos = np.fromiter(
            (any(len(m.group(int(q))[0]) > 0 for m in self.pos)
             for q in qids), bool, count=len(qids))
        self.qids = qids[has_pos]

    def __len__(self):
        return len(self.qids)

    def corpus_view(self):
        """Lazy combined corpus of all sources (positives + negatives)."""
        return _sources_view(self.pos + self.neg, "corpus")

    def queries_view(self):
        """Lazy combined query table of the positive sources."""
        return _sources_view(self.pos, "queries")

    def __getitem__(self, i: int) -> dict:
        qid = int(self.qids[i])
        rng = np.random.default_rng((self.seed, qid, i))
        pos_dids, _ = self._merged_group(self.pos, qid)
        neg_dids, _ = self._merged_group(self.neg, qid)
        if len(pos_dids) == 0:
            raise IndexError(f"query {qid} has no positives")
        pos_did = int(rng.choice(pos_dids))
        n_neg = self.args.group_size - 1
        negs: list[int] = []
        if n_neg > 0 and len(neg_dids):
            neg_pool = neg_dids[~np.isin(neg_dids, pos_dids)]
            if len(neg_pool) == 0:
                neg_pool = neg_dids
            negs = list(rng.choice(
                neg_pool, size=n_neg, replace=len(neg_pool) < n_neg))
        src = self.pos[0]
        passages = [self.format_passage(src.doc_text(pos_did))]
        for d in negs:
            passages.append(self.format_passage(self._doc_text(int(d))))
        return {
            "query_id": qid,
            "query": self.format_query(src.query_text(qid)),
            "passages": passages,
        }

    def _doc_text(self, did: int) -> str:
        for m in self.pos + self.neg:
            try:
                return m.doc_text(did)
            except KeyError:
                continue
        raise KeyError(did)

    @staticmethod
    def _merged_group(sources: Sequence[MaterializedQRel], qid: int):
        dids, scores = [], []
        for m in sources:
            d, s = m.group(qid)
            dids.append(d)
            scores.append(s)
        return (np.concatenate(dids) if dids else np.empty(0, np.int64),
                np.concatenate(scores) if scores else np.empty(0, np.float32))


class MultiLevelDataset:
    """Graded-relevance instances from multiple processed sources.

    Each source contributes (doc, label) pairs after its own on-the-fly
    processing; per query the dataset samples ``group_size`` docs,
    label-descending with random tie-break, padding labels with -1.
    """

    def __init__(self, data_args: DataArguments,
                 format_query, format_passage, sources,
                 cache_root: str = _CACHE_ROOT, seed: int = 0):
        self.args = data_args
        self.format_query = format_query
        self.format_passage = format_passage
        self.sources = _as_mqrels(sources, cache_root)
        self.seed = seed
        self.qids = np.unique(np.concatenate(
            [m.query_id_hashes for m in self.sources]))

    def __len__(self):
        return len(self.qids)

    def corpus_view(self):
        """Lazy combined corpus of all sources."""
        return _sources_view(self.sources, "corpus")

    def __getitem__(self, i: int) -> dict:
        qid = int(self.qids[i])
        rng = np.random.default_rng((self.seed, qid, i))
        dids, labels = BinaryDataset._merged_group(self.sources, qid)
        if len(dids) == 0:
            raise IndexError(f"query {qid} has no documents")
        # de-dup docs across sources: keep max label
        order = np.argsort(dids, kind="stable")
        dids, labels = dids[order], labels[order]
        uniq, starts = np.unique(dids, return_index=True)
        max_lab = np.maximum.reduceat(labels, starts)
        g = self.args.group_size
        jitter = rng.random(len(uniq))
        pick = np.lexsort((jitter, -max_lab))[:g]
        sel_d, sel_l = uniq[pick], max_lab[pick]
        passages = [self.format_passage(self._doc_text(int(d)))
                    for d in sel_d]
        out_labels = np.full(g, -1.0, np.float32)
        out_labels[: len(sel_l)] = sel_l
        while len(passages) < g:       # pad short groups
            passages.append(passages[-1])
        return {
            "query_id": qid,
            "query": self.format_query(self._query_text(qid)),
            "passages": passages,
            "labels": out_labels,
        }

    def _query_text(self, qid):
        for m in self.sources:
            try:
                return m.query_text(qid)
            except KeyError:
                continue
        raise KeyError(qid)

    def _doc_text(self, did):
        for m in self.sources:
            try:
                return m.doc_text(did)
            except KeyError:
                continue
        raise KeyError(did)

    def dev_groups(self, n: int | None = None):
        """(query, docs, labels) groups for training-time IR metrics."""
        n = len(self) if n is None else min(n, len(self))
        return [self[i] for i in range(n)]


class EncodingDataset:
    """Items to encode at inference; embedding-cache aware (paper §3.2.2).

    ``dataset[i]`` returns the cached embedding when available, else text
    (from ``texts``, or the title-prefixed record ``table.get(id)``).
    """

    def __init__(self, ids: Sequence, texts: Sequence[str] | None = None,
                 table=None, cache=None, format_fn=None):
        self.ids = list(ids)
        self.texts = texts
        self.table = table
        self.cache = cache
        self.format_fn = format_fn or (lambda t: t)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int) -> dict:
        rid = self.ids[i]
        if self.cache is not None and rid in self.cache:
            return {"id": rid, "embedding": self.cache.get_one(rid)}
        if self.texts is not None:
            text = self.texts[i]
        else:
            rec = self.table.get(rid)
            text = f"{rec.get('title', '')} {rec.get('text', '')}".strip()
        return {"id": rid, "text": self.format_fn(text)}

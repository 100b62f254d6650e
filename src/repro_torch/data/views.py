"""Lazy dataset-view algebra (paper §3.2): load, filter, select,
transform and combine retrieval datasets on the fly, with no
materialized copies.

A :class:`DatasetView` is an ordered, id-indexed collection of record
dicts that is *never* resident as a whole: rows materialize per access
(``row(i)``) or per chunk (``open_slice``), so resident memory stays
O(touched rows) through arbitrary compositions — the paper's 2.6x
memory-reduction mechanism extended from single tables to whole
dataset expressions.  The port's own copy of the reference's
``data/views.py``: the same compositions give the same rows, id hashes
and raw ids in either package.  It imports numpy and no torch module.

Combinators (all lazy, all composable)::

    v = TableView(table)                      # leaf over an mmap table
    v = v.filter(lambda r: len(r["text"]) > 8)
    v = v.map(lambda r: {**r, "text": r["text"].lower()})
    v = v.select(["doc3", "doc1"])            # id (or position) subset
    v = ConcatView(v, other)                  # or  v + other
    v = InterleaveView(a, b, c)               # round-robin combine

Index discipline: a view may hold O(n) *int64 index/id arrays* (like
``MaterializedQRel``'s grouped qrel arrays) but never O(n) row
payloads.  ``FilterView`` therefore streams its parent once, chunk by
chunk, to build its kept-position index the first time a length, id or
row is requested — rows evaluated by the predicate are dropped
immediately.

Streaming contract: ``open_slice(lo, hi, chunk_size)`` yields ordered
``(offset, rows)`` chunks, mirroring the embedding chunk-source
contract of ``ShardedSearchDriver`` one layer below — the evaluator
zips the two so a search over ``ConcatView(a, b)`` scores per chunk
and the combined corpus never exists on disk or in RAM.  After each
chunk is consumed the view ``evict``s it: mmap-backed leaves advise
the touched payload pages away, so even a full scan's resident set
stays flat.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np

from repro_torch.data.table import (MMapTable, stable_id_hash,
                                    stable_id_hash_array)


def row_text(rec: dict) -> str:
    """Canonical text of a record (title-prefixed, like ``doc_text``)."""
    title = rec.get("title", "")
    return f"{title} {rec.get('text', '')}".strip() if title \
        else str(rec.get("text", ""))


class ViewTexts(Sequence):
    """Lazy ``Sequence[str]`` adapter over a view's row texts.

    Slices materialize only the requested span (the encode pipeline
    pulls window-sized slices), so handing this to
    ``PipelineChunkSource`` keeps the O(touched rows) property.
    """

    def __init__(self, view: "DatasetView"):
        self.view = view

    def __len__(self) -> int:
        return len(self.view)

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self.view))
            if step != 1:
                return [self.view.text(j) for j in range(lo, hi, step)]
            return [row_text(r) for r in self.view.rows(lo, hi)]
        return self.view.text(i)

    def __iter__(self) -> Iterator[str]:
        for lo in range(0, len(self.view), 1024):
            yield from self[lo: lo + 1024]


class DatasetView:
    """Base class: ordered, id-indexed, lazily materialized records.

    Subclasses implement ``__len__``, ``row(i)`` and ``_hashes()``;
    everything else (chunked streaming, id lookup, combinators, text
    adapters) is shared.
    """

    # -- required surface -----------------------------------------------------
    def __len__(self) -> int:
        raise NotImplementedError

    def row(self, i: int) -> dict:
        raise NotImplementedError

    def _hashes(self) -> np.ndarray:
        raise NotImplementedError

    # -- ids ------------------------------------------------------------------
    @property
    def id_hashes(self) -> np.ndarray:
        """int64 (n,) stable id hashes in view order (cached)."""
        h = getattr(self, "_id_hashes", None)
        if h is None:
            h = np.asarray(self._hashes(), np.int64)
            self._id_hashes = h
        return h

    def _ensure_sorted(self):
        if getattr(self, "_sorted_ids", None) is None:
            self._sort = np.argsort(self.id_hashes, kind="stable")
            self._sorted_ids = self.id_hashes[self._sort]

    def index_of(self, raw_or_hash) -> int:
        """View position of an id (raw or hashed) — O(log n)."""
        h = (int(raw_or_hash) & 0x7FFFFFFFFFFFFFFF
             if isinstance(raw_or_hash, (int, np.integer))
             else stable_id_hash(raw_or_hash))
        self._ensure_sorted()
        pos = int(np.searchsorted(self._sorted_ids, h))
        if pos >= len(self._sorted_ids) or self._sorted_ids[pos] != h:
            raise KeyError(raw_or_hash)
        return int(self._sort[pos])

    def get(self, raw_or_hash) -> dict:
        return self.row(self.index_of(raw_or_hash))

    def __contains__(self, raw_or_hash) -> bool:
        try:
            self.index_of(raw_or_hash)
            return True
        except KeyError:
            return False

    def raw_id(self, i: int):
        return self.row(i).get("_id", int(self.id_hashes[i]))

    def raw_ids(self) -> list:
        """All raw ids (materializes ids only, not row payloads)."""
        out = []
        for lo in range(0, len(self), 1024):
            out.extend(r.get("_id") for r in self.rows(
                lo, min(lo + 1024, len(self))))
        return out

    # -- rows -----------------------------------------------------------------
    def rows(self, lo: int, hi: int) -> list[dict]:
        """Materialize one bounded span (combinators may specialize)."""
        return [self.row(i) for i in range(lo, hi)]

    def text(self, i: int) -> str:
        return row_text(self.row(i))

    def texts(self) -> ViewTexts:
        return ViewTexts(self)

    def iter_rows(self) -> Iterator[dict]:
        for off, chunk in self.open_slice(0, len(self), 1024):
            yield from chunk

    def open_slice(self, lo: int, hi: int, chunk_size: int):
        """Yield ordered ``(offset, rows)`` chunks over ``[lo, hi)``.

        Each chunk holds exactly ``chunk_size`` rows (the tail may be
        ragged); after the consumer resumes, the previous chunk's
        source pages are advised away (``evict``) so a full streaming
        scan keeps a flat resident set.
        """
        hi = min(hi, len(self))
        for off in range(lo, hi, max(chunk_size, 1)):
            end = min(off + chunk_size, hi)
            yield off, self.rows(off, end)
            self.evict(off, end)

    def evict(self, lo: int, hi: int) -> None:
        """Hint that rows ``[lo, hi)`` were consumed (best effort)."""

    # -- combinators ----------------------------------------------------------
    def filter(self, fn: Callable[[dict], bool]) -> "FilterView":
        return FilterView(self, fn)

    def map(self, fn: Callable[[dict], dict], *,
            rekey: bool = False) -> "MapView":
        return MapView(self, fn, rekey=rekey)

    def select(self, sel) -> "SelectView":
        return SelectView(self, sel)

    def concat(self, *others: "DatasetView") -> "ConcatView":
        return ConcatView(self, *others)

    def __add__(self, other: "DatasetView") -> "ConcatView":
        return ConcatView(self, other)

    def interleave(self, *others: "DatasetView") -> "InterleaveView":
        return InterleaveView(self, *others)


# -- leaves -------------------------------------------------------------------


class TableView(DatasetView):
    """Leaf over an :class:`MMapTable` — rows stay on disk until read."""

    def __init__(self, table: MMapTable):
        self.table = table

    def __len__(self) -> int:
        return len(self.table)

    def row(self, i: int) -> dict:
        return self.table.row(i)

    def _hashes(self) -> np.ndarray:
        return np.asarray(self.table.id_hashes, np.int64)

    def evict(self, lo: int, hi: int) -> None:
        self.table.advise_dontneed(lo, hi)


class DictView(DatasetView):
    """Leaf over an in-memory ``{raw_id: text}`` mapping (the legacy
    evaluator corpus format).  Texts are read from the dict *live* so
    callers that mutate values see fresh rows."""

    def __init__(self, mapping: dict):
        self._d = mapping
        self._keys = list(mapping.keys())

    def __len__(self) -> int:
        return len(self._keys)

    def row(self, i: int) -> dict:
        key = self._keys[i]
        return {"_id": key, "text": self._d[key]}

    def text(self, i: int) -> str:
        return str(self._d[self._keys[i]])

    def rows(self, lo: int, hi: int) -> list[dict]:
        return [{"_id": k, "text": self._d[k]}
                for k in self._keys[lo:hi]]

    def raw_id(self, i: int):
        return self._keys[i]

    def raw_ids(self) -> list:
        return list(self._keys)

    def _hashes(self) -> np.ndarray:
        return stable_id_hash_array(self._keys)


class RecordsView(DatasetView):
    """Leaf over an in-memory record list (tests, synthetic sources)."""

    def __init__(self, records: Sequence[dict], id_key: str = "_id"):
        self._recs = list(records)
        self._id_key = id_key

    def __len__(self) -> int:
        return len(self._recs)

    def row(self, i: int) -> dict:
        return self._recs[i]

    def rows(self, lo: int, hi: int) -> list[dict]:
        return list(self._recs[lo:hi])

    def _hashes(self) -> np.ndarray:
        return stable_id_hash_array(
            [r.get(self._id_key, i) for i, r in enumerate(self._recs)])


# -- combinators --------------------------------------------------------------


class FilterView(DatasetView):
    """Rows of ``parent`` where ``fn(row)`` is truthy, in parent order.

    The kept-position index (int64, O(n_kept)) builds lazily on first
    use by streaming the parent chunk by chunk — candidate rows are
    evaluated and dropped, never retained.
    """

    def __init__(self, parent: DatasetView, fn: Callable[[dict], bool]):
        self.parent = parent
        self.fn = fn
        self._idx: np.ndarray | None = None

    def _index(self) -> np.ndarray:
        if self._idx is None:
            kept: list[int] = []
            for off, chunk in self.parent.open_slice(
                    0, len(self.parent), 1024):
                kept.extend(off + j for j, r in enumerate(chunk)
                            if self.fn(r))
            self._idx = np.asarray(kept, np.int64)
        return self._idx

    def __len__(self) -> int:
        return len(self._index())

    def row(self, i: int) -> dict:
        return self.parent.row(int(self._index()[i]))

    def rows(self, lo: int, hi: int) -> list[dict]:
        idx = self._index()[lo:hi]
        return [self.parent.row(int(i)) for i in idx]

    def _hashes(self) -> np.ndarray:
        return np.asarray(self.parent.id_hashes)[self._index()]

    def evict(self, lo: int, hi: int) -> None:
        idx = self._index()[lo:hi]
        if len(idx):
            self.parent.evict(int(idx[0]), int(idx[-1]) + 1)


class MapView(DatasetView):
    """``fn(row)`` applied on every read (on-the-fly transform).

    By default ``fn`` must preserve ``_id`` (ids are answered from the
    parent without materializing rows).  Pass ``rekey=True`` for
    id-rewriting transforms (e.g. namespacing ``_id`` per source
    before a concat): ids are then recomputed by streaming the view
    once, rows still never retained.
    """

    def __init__(self, parent: DatasetView, fn: Callable[[dict], dict],
                 *, rekey: bool = False):
        self.parent = parent
        self.fn = fn
        self.rekey = rekey

    def __len__(self) -> int:
        return len(self.parent)

    def row(self, i: int) -> dict:
        return self.fn(self.parent.row(i))

    def rows(self, lo: int, hi: int) -> list[dict]:
        return [self.fn(r) for r in self.parent.rows(lo, hi)]

    def _hashes(self) -> np.ndarray:
        if not self.rekey:
            return np.asarray(self.parent.id_hashes)
        out = np.empty(len(self), np.int64)
        for off, chunk in self.parent.open_slice(0, len(self), 1024):
            for j, r in enumerate(chunk):
                out[off + j] = stable_id_hash(self.fn(r).get("_id", off + j))
        return out

    def evict(self, lo: int, hi: int) -> None:
        self.parent.evict(lo, hi)


class SelectView(DatasetView):
    """Subset/reorder of ``parent`` by positions or (raw/hashed) ids."""

    def __init__(self, parent: DatasetView, sel):
        self.parent = parent
        if isinstance(sel, np.ndarray) and sel.dtype.kind == "b":
            if len(sel) != len(parent):
                raise IndexError(
                    f"boolean mask length {len(sel)} != view length "
                    f"{len(parent)}")
            idx = np.nonzero(sel)[0].astype(np.int64)
        elif isinstance(sel, np.ndarray) and sel.dtype.kind in "iu":
            idx = sel.astype(np.int64)
        elif len(sel) and all(isinstance(s, (int, np.integer))
                              and not isinstance(s, bool) for s in sel):
            idx = np.asarray(sel, np.int64)
        else:                                   # raw ids -> positions
            idx = np.asarray([parent.index_of(s) for s in sel], np.int64)
        n = len(parent)
        if len(idx) and (idx.min() < -n or idx.max() >= n):
            raise IndexError(
                f"select positions outside [-{n}, {n})")
        self._idx = np.where(idx < 0, idx + n, idx)

    def __len__(self) -> int:
        return len(self._idx)

    def row(self, i: int) -> dict:
        return self.parent.row(int(self._idx[i]))

    def rows(self, lo: int, hi: int) -> list[dict]:
        return [self.parent.row(int(i)) for i in self._idx[lo:hi]]

    def _hashes(self) -> np.ndarray:
        return np.asarray(self.parent.id_hashes)[self._idx]

    def evict(self, lo: int, hi: int) -> None:
        idx = self._idx[lo:hi]
        if len(idx):
            self.parent.evict(int(idx.min()), int(idx.max()) + 1)


class _MultiView(DatasetView):
    """Shared machinery for multi-parent combinators: a lazily built
    ``(child, child_pos)`` mapping per view position."""

    def __init__(self, *parents: DatasetView):
        if not parents:
            raise ValueError("need at least one view")
        self.parents = list(parents)
        self._child: np.ndarray | None = None       # (n,) parent index
        self._pos: np.ndarray | None = None         # (n,) position in parent

    def _build(self) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _mapping(self):
        if self._child is None:
            self._child, self._pos = self._build()
        return self._child, self._pos

    def __len__(self) -> int:
        return sum(len(p) for p in self.parents)

    def row(self, i: int) -> dict:
        child, pos = self._mapping()
        return self.parents[int(child[i])].row(int(pos[i]))

    def rows(self, lo: int, hi: int) -> list[dict]:
        child, pos = self._mapping()
        return [self.parents[int(c)].row(int(p))
                for c, p in zip(child[lo:hi], pos[lo:hi])]

    def _hashes(self) -> np.ndarray:
        child, pos = self._mapping()
        out = np.empty(len(child), np.int64)
        for j, p in enumerate(self.parents):
            m = child == j
            out[m] = np.asarray(p.id_hashes)[pos[m]]
        return out

    def evict(self, lo: int, hi: int) -> None:
        child, pos = self._mapping()
        c, p = child[lo:hi], pos[lo:hi]
        for j, parent in enumerate(self.parents):
            pj = p[c == j]
            if len(pj):
                parent.evict(int(pj.min()), int(pj.max()) + 1)


class ConcatView(_MultiView):
    """Parents back to back: ``a[0..] b[0..] ...`` — the combined-corpus
    view (union eval without a union corpus)."""

    @property
    def _offsets(self) -> np.ndarray:
        # lazy: len() of a FilterView parent forces its index scan, so
        # building a concat must stay free until first access
        off = getattr(self, "_offsets_", None)
        if off is None:
            off = np.cumsum([0] + [len(p) for p in self.parents])
            self._offsets_ = off
        return off

    def _build(self):
        lens = [len(p) for p in self.parents]
        child = np.repeat(np.arange(len(lens)), lens).astype(np.int64)
        pos = np.concatenate(
            [np.arange(n, dtype=np.int64) for n in lens]) if lens \
            else np.empty(0, np.int64)
        return child, pos

    def row(self, i: int) -> dict:
        # direct offset arithmetic (no mapping arrays needed)
        if i < 0:
            i += len(self)
        j = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self.parents[j].row(i - int(self._offsets[j]))

    def rows(self, lo: int, hi: int) -> list[dict]:
        out: list[dict] = []
        for j, p in enumerate(self.parents):
            a = max(lo, int(self._offsets[j]))
            b = min(hi, int(self._offsets[j + 1]))
            if a < b:
                out.extend(p.rows(a - int(self._offsets[j]),
                                  b - int(self._offsets[j])))
        return out

    def _hashes(self) -> np.ndarray:
        if not self.parents:
            return np.empty(0, np.int64)
        return np.concatenate(
            [np.asarray(p.id_hashes, np.int64) for p in self.parents])

    def evict(self, lo: int, hi: int) -> None:
        for j, p in enumerate(self.parents):
            a = max(lo, int(self._offsets[j]))
            b = min(hi, int(self._offsets[j + 1]))
            if a < b:
                p.evict(a - int(self._offsets[j]),
                        b - int(self._offsets[j]))


class InterleaveView(_MultiView):
    """Round-robin combine: position ``i`` of every live parent before
    position ``i+1`` of any (parents that run out drop from the
    rotation) — the training-mixture combinator."""

    def _build(self):
        lens = [len(p) for p in self.parents]
        k = len(lens)
        child = np.repeat(np.arange(k), lens).astype(np.int64)
        pos = np.concatenate(
            [np.arange(n, dtype=np.int64) for n in lens]) if lens \
            else np.empty(0, np.int64)
        # round-robin order == sort by (parent position, parent index)
        order = np.argsort(pos * k + child, kind="stable")
        return child[order], pos[order]


def as_view(obj) -> DatasetView:
    """Coerce common corpus/query containers to a view.

    Accepts an existing view (returned as-is), an ``{id: text}`` dict
    (the legacy evaluator format), an :class:`MMapTable`, or a record
    list.
    """
    if isinstance(obj, DatasetView):
        return obj
    if isinstance(obj, dict):
        return DictView(obj)
    if isinstance(obj, MMapTable):
        return TableView(obj)
    if isinstance(obj, (list, tuple)) and (
            not obj or isinstance(obj[0], dict)):
        return RecordsView(obj)
    raise TypeError(
        f"cannot view {type(obj).__name__}; expected DatasetView, dict, "
        f"MMapTable, or record list")

"""Lazy dataset views: the leaves the evaluator needs in this slice.

A :class:`DatasetView` is an ordered, id-indexed collection of record
dicts whose rows materialize per access.  This module holds the base
class, the in-memory ``{id: text}`` leaf (:class:`DictView`), the lazy
text adapter (:class:`ViewTexts`) and :func:`as_view`.  The mmap-table
leaf and the combinators (filter / map / select / concat / interleave)
come with a later slice.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from repro_torch.data.table import stable_id_hash, stable_id_hash_array


def row_text(rec: dict) -> str:
    """Canonical text of a record (title-prefixed)."""
    title = rec.get("title", "")
    return f"{title} {rec.get('text', '')}".strip() if title \
        else str(rec.get("text", ""))


class ViewTexts(Sequence):
    """Lazy ``Sequence[str]`` adapter over a view's row texts.

    Slices materialize only the requested span (the encode pipeline
    pulls window-sized slices).
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

    Subclasses implement ``__len__``, ``row(i)`` and ``_hashes()``.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def row(self, i: int) -> dict:
        raise NotImplementedError

    def _hashes(self) -> np.ndarray:
        raise NotImplementedError

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

    def rows(self, lo: int, hi: int) -> list[dict]:
        """Materialize one bounded span."""
        return [self.row(i) for i in range(lo, hi)]

    def text(self, i: int) -> str:
        return row_text(self.row(i))

    def texts(self) -> ViewTexts:
        return ViewTexts(self)


class DictView(DatasetView):
    """Leaf over an in-memory ``{raw_id: text}`` mapping.  Texts are read
    from the dict *live* so callers that mutate values see fresh rows."""

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


def as_view(obj) -> DatasetView:
    """Coerce a corpus/query container to a view: an existing view is
    returned as-is, an ``{id: text}`` dict is wrapped in a
    :class:`DictView`."""
    if isinstance(obj, DatasetView):
        return obj
    if isinstance(obj, dict):
        return DictView(obj)
    raise TypeError(
        f"cannot view {type(obj).__name__}; expected DatasetView or dict")

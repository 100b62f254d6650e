"""Memory-mapped, ID-indexed record tables (the paper's Arrow-table role).

The port's own copy of the reference's ``data/table.py``: the same id
hashes, fingerprints and on-disk layout byte for byte, so a table that
either package builds opens in the other.

A table directory holds:
  ids.npy      int64 hashed ids, insertion order        (mmap'd)
  sortidx.npy  argsort(ids) permutation                 (mmap'd)
  offsets.npy  int64 (n+1,) byte offsets into payload   (mmap'd)
  payload.bin  concatenated UTF-8 JSON rows             (mmap'd)
  meta.json    fingerprint + row count

Design property the paper relies on (Table 1): resident memory is
O(touched rows), not O(dataset) — only the pages of rows actually read are
faulted in.  Lookups are O(log n) via searchsorted on the mmap'd id index.
Builds are atomic (tmp dir + os.replace) and fingerprinted so rebuilds are
skipped when the source is unchanged (Table 4: TTFS ~ 0 after first run).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Iterable, Iterator

import numpy as np


_HASH_MASK = 0x7FFFFFFFFFFFFFFF


def stable_id_hash(raw_id: str | int) -> int:
    """Stable 63-bit id hash (strings and ints share the space)."""
    if isinstance(raw_id, (int, np.integer)):
        return int(raw_id) & _HASH_MASK
    h = hashlib.blake2b(str(raw_id).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & _HASH_MASK


def stable_id_hash_array(ids) -> np.ndarray:
    """Vectorized ``stable_id_hash`` over a sequence -> int64 (n,).

    Integer ids mask in one numpy op; string ids hash in a single pass
    (blake2b is per-element by nature, but callers hash each id set once
    and reuse the array instead of re-looping per search call).
    """
    if isinstance(ids, np.ndarray) and ids.dtype.kind in "iu":
        return ids.astype(np.int64) & _HASH_MASK
    if len(ids) and all(isinstance(i, (int, np.integer)) for i in ids):
        try:
            return np.asarray(ids, np.int64) & _HASH_MASK
        except OverflowError:     # ints beyond int64: mask in Python like
            pass                  # stable_id_hash does
        return np.fromiter((int(i) & _HASH_MASK for i in ids), np.int64,
                           count=len(ids))
    return np.fromiter((stable_id_hash(i) for i in ids), np.int64,
                       count=len(ids))


def file_fingerprint(path: str, extra: str = "") -> str:
    st = os.stat(path)
    key = f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}:{extra}"
    return hashlib.blake2b(key.encode(), digest_size=16).hexdigest()


def config_fingerprint(obj: Any) -> str:
    return hashlib.blake2b(repr(obj).encode(), digest_size=16).hexdigest()


def atomic_write_dir(final_dir: str):
    """Context manager: build into a tmp dir, atomically move into place."""

    class _Ctx:
        def __enter__(self):
            os.makedirs(os.path.dirname(final_dir) or ".", exist_ok=True)
            self.tmp = tempfile.mkdtemp(
                dir=os.path.dirname(final_dir) or ".",
                prefix=".tmp_" + os.path.basename(final_dir))
            return self.tmp

        def __exit__(self, exc_type, *a):
            if exc_type is not None:
                shutil.rmtree(self.tmp, ignore_errors=True)
                return False
            if os.path.exists(final_dir):
                shutil.rmtree(self.tmp, ignore_errors=True)
            else:
                os.replace(self.tmp, final_dir)
            return False

    return _Ctx()


class MMapTable:
    """ID-indexed mmap'd record store."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self._ids = np.load(os.path.join(path, "ids.npy"), mmap_mode="r")
        self._sort = np.load(os.path.join(path, "sortidx.npy"), mmap_mode="r")
        self._offsets = np.load(
            os.path.join(path, "offsets.npy"), mmap_mode="r")
        self._payload = np.memmap(
            os.path.join(path, "payload.bin"), dtype=np.uint8, mode="r")
        self._sorted_ids = None     # materialized lazily for fast lookup

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, records: Iterable[dict], path: str,
              fingerprint: str = "", id_key: str = "_id") -> "MMapTable":
        with atomic_write_dir(path) as tmp:
            ids: list[int] = []
            offsets = [0]
            with open(os.path.join(tmp, "payload.bin"), "wb") as payload:
                for rec in records:
                    raw = rec.get(id_key, len(ids))
                    rec = dict(rec)
                    rec[id_key] = raw if isinstance(raw, str) else int(raw)
                    ids.append(stable_id_hash(raw))
                    blob = json.dumps(rec, ensure_ascii=False).encode()
                    payload.write(blob)
                    offsets.append(offsets[-1] + len(blob))
            ids_arr = np.asarray(ids, np.int64)
            sortidx = np.argsort(ids_arr, kind="stable")
            sorted_ids = ids_arr[sortidx]
            dup = np.nonzero(sorted_ids[1:] == sorted_ids[:-1])[0]
            if dup.size:
                raise ValueError(
                    f"id hash collision/duplicate ids ({dup.size}) "
                    f"building {path}")
            np.save(os.path.join(tmp, "ids.npy"), ids_arr)
            np.save(os.path.join(tmp, "sortidx.npy"),
                    sortidx.astype(np.int64))
            np.save(os.path.join(tmp, "offsets.npy"),
                    np.asarray(offsets, np.int64))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"n": len(ids_arr), "fingerprint": fingerprint}, f)
        return cls(path)

    @classmethod
    def build_cached(cls, records_fn, cache_dir: str,
                     fingerprint: str) -> "MMapTable":
        """Reuse the table if the fingerprint matches (paper: TTFS)."""
        path = os.path.join(cache_dir, fingerprint)
        meta = os.path.join(path, "meta.json")
        if os.path.exists(meta):
            try:
                with open(meta) as f:
                    if json.load(f).get("fingerprint") == fingerprint:
                        return cls(path)
            except (json.JSONDecodeError, OSError):
                shutil.rmtree(path, ignore_errors=True)
        return cls.build(records_fn(), path, fingerprint)

    # -- access ---------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.meta["n"])

    @property
    def id_hashes(self) -> np.ndarray:
        return self._ids

    def row(self, i: int) -> dict:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return json.loads(bytes(self._payload[lo:hi]).decode())

    def _ensure_sorted(self):
        if self._sorted_ids is None:
            self._sorted_ids = np.asarray(self._ids)[np.asarray(self._sort)]

    def index_of(self, raw_or_hash) -> int:
        h = (raw_or_hash if isinstance(raw_or_hash, (int, np.integer))
             else stable_id_hash(raw_or_hash))
        self._ensure_sorted()
        pos = int(np.searchsorted(self._sorted_ids, h))
        if pos >= len(self._sorted_ids) or self._sorted_ids[pos] != h:
            raise KeyError(raw_or_hash)
        return int(self._sort[pos])

    def indices_of(self, hashes: np.ndarray) -> np.ndarray:
        self._ensure_sorted()
        pos = np.searchsorted(self._sorted_ids, hashes)
        pos = np.clip(pos, 0, len(self._sorted_ids) - 1)
        ok = self._sorted_ids[pos] == hashes
        if not ok.all():
            missing = hashes[~ok][:5]
            raise KeyError(f"{(~ok).sum()} ids not in table, e.g. {missing}")
        return np.asarray(self._sort)[pos]

    def get(self, raw_or_hash) -> dict:
        return self.row(self.index_of(raw_or_hash))

    def __contains__(self, raw_or_hash) -> bool:
        try:
            self.index_of(raw_or_hash)
            return True
        except KeyError:
            return False

    def iter_rows(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.row(i)

    def advise_dontneed(self, lo_row: int, hi_row: int) -> None:
        """Advise the payload pages of rows ``[lo_row, hi_row)`` away.

        Streaming consumers (``views.TableView.open_slice``) call this
        after a chunk is consumed so a full scan's resident set stays
        flat instead of faulting the whole payload in.  Only pages
        fully inside the byte range are dropped (boundary pages are
        shared with neighbouring rows); clean file-backed pages re-fault
        on the next access, so this is purely a residency hint.
        Best effort: platforms without ``mmap.madvise`` no-op.
        """
        try:
            import mmap as _mmap
            mm = self._payload._mmap            # the backing mmap object
            page = _mmap.PAGESIZE
            start = int(self._offsets[max(lo_row, 0)])
            end = int(self._offsets[min(hi_row, len(self))])
            start = -(-start // page) * page    # round up
            end = (end // page) * page          # round down
            if end > start:
                mm.madvise(_mmap.MADV_DONTNEED, start, end - start)
        except (AttributeError, ValueError, OSError):
            pass

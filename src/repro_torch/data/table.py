"""Stable 63-bit id hashes (the reference's ``data/table.py`` id space).

Only the hashing half of the reference module: the memory-mapped record
tables come with a later slice.  Hashes are identical to
``repro.data.table.stable_id_hash`` for every id.
"""

from __future__ import annotations

import hashlib

import numpy as np

_HASH_MASK = 0x7FFFFFFFFFFFFFFF


def stable_id_hash(raw_id: str | int) -> int:
    """Stable 63-bit id hash (strings and ints share the space)."""
    if isinstance(raw_id, (int, np.integer)):
        return int(raw_id) & _HASH_MASK
    h = hashlib.blake2b(str(raw_id).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & _HASH_MASK


def stable_id_hash_array(ids) -> np.ndarray:
    """Vectorized ``stable_id_hash`` over a sequence -> int64 (n,)."""
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

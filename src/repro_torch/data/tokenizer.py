"""Deterministic hashing tokenizer (offline stand-in for HF tokenizers).

Splits on whitespace/punctuation; each token maps to a stable
blake2-hashed id.  No vocabulary files, fully reproducible.  The port
keeps its own copy of the reference tokenizer: ids are identical to
``repro.data.tokenizer.HashTokenizer``'s for every text.

The batch path (``batch_encode_ids`` / ``batch_encode``) hashes each
*unique* token of the batch exactly once via ``np.unique`` and maps ids
back through the inverse index.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    pad_id = 0
    bos_id = 1
    eos_id = 2
    n_special = 3

    def __init__(self, vocab_size: int = 50304, lowercase: bool = True):
        if vocab_size <= self.n_special:
            raise ValueError(f"vocab_size must exceed {self.n_special}, "
                             f"got {vocab_size}")
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self._cache: dict[str, int] = {}

    def _token_id(self, tok: str) -> int:
        tid = self._cache.get(tok)
        if tid is None:
            h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
            tid = self.n_special + int.from_bytes(h, "little") % (
                self.vocab_size - self.n_special)
            if len(self._cache) < 1_000_000:
                self._cache[tok] = tid
        return tid

    def encode(self, text: str, max_len: int | None = None,
               append_eos: bool = False) -> list[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self._token_id(t) for t in _TOKEN_RE.findall(text)]
        if append_eos:
            ids.append(self.eos_id)
        if max_len is not None:
            ids = ids[:max_len]
            # truncation may leave nothing to overwrite (max_len == 0 or
            # an empty text): only re-pin the eos on a non-empty tail
            if append_eos and ids and ids[-1] != self.eos_id:
                ids[-1] = self.eos_id
        return ids

    def batch_encode_ids(self, texts: list[str],
                         max_len: int | None = None,
                         append_eos: bool = False) -> list[list[int]]:
        """Tokenize a batch; hash each unique token once (``np.unique``).

        Returns exactly ``[self.encode(t, max_len, append_eos) for t in
        texts]``.
        """
        if not texts:
            return []
        if self.lowercase:
            texts = [t.lower() for t in texts]
        rows = [_TOKEN_RE.findall(t) for t in texts]
        flat = [t for row in rows for t in row]
        if flat:
            uniq, inverse = np.unique(np.asarray(flat, dtype=object),
                                      return_inverse=True)
            uniq_ids = np.fromiter((self._token_id(t) for t in uniq),
                                   np.int64, count=len(uniq))
            flat_ids = uniq_ids[inverse]
        else:
            flat_ids = np.empty(0, np.int64)
        out: list[list[int]] = []
        pos = 0
        for row in rows:
            ids = flat_ids[pos: pos + len(row)].tolist()
            pos += len(row)
            if append_eos:
                ids.append(self.eos_id)
            if max_len is not None:
                ids = ids[:max_len]
                if append_eos and ids and ids[-1] != self.eos_id:
                    ids[-1] = self.eos_id
            out.append(ids)
        return out

    def batch_encode(self, texts: list[str], max_len: int,
                     append_eos: bool = False,
                     pad_to_multiple: int = 1):
        """Returns (tokens (B, L) int32, mask (B, L) int32) numpy arrays."""
        enc = self.batch_encode_ids(texts, max_len, append_eos)
        longest = max((len(e) for e in enc), default=1)
        longest = max(longest, 1)
        if pad_to_multiple > 1:
            longest = -(-longest // pad_to_multiple) * pad_to_multiple
        longest = min(longest, max_len) if max_len else longest
        return pad_token_rows(enc, longest, self.pad_id)


def pad_token_rows(rows: list[list[int]], length: int, pad_id: int = 0,
                   n_rows: int | None = None):
    """Stack ragged id rows into ((B, L) tokens, (B, L) mask) int32.

    ``n_rows`` > len(rows) appends all-pad rows (mask 0) — the encode
    pipeline's fixed-batch-dim ragged tail.  Rows longer than ``length``
    are truncated.
    """
    b = len(rows) if n_rows is None else n_rows
    length = max(length, 1)
    toks = np.full((b, length), pad_id, np.int32)
    mask = np.zeros((b, length), np.int32)
    for i, e in enumerate(rows):
        e = e[:length]
        toks[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return toks, mask

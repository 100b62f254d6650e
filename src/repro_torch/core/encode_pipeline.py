"""Bucketed encode pipeline (paper §3.5 "no overhead").

The port's counterpart of ``repro.core.encode_pipeline``:

  * **shape buckets** — texts are sorted by token length and each
    fixed-batch-dim batch is padded to the smallest rung of a geometric
    length ladder (:func:`bucket_ladder`), so the encoder sees a set of
    (B, L) shapes bounded by the ladder, and padding tracks the text
    lengths.  The original order is restored on output.
    ``stats["compiles"]`` counts the distinct (B, L) shapes encoded (the
    reference counts XLA compiles, one per shape).
  * **tokenize-ahead** — :meth:`EncodePipeline.stream` tokenizes up to
    ``depth`` windows ahead of the encode stage on a background thread.
  * **device-resident output** — ``device=True`` keeps embeddings on the
    pipeline's device, flowing into the search driver through
    :class:`PipelineChunkSource` with no host round-trip per chunk.

Rankings are unchanged by bucketing: it only regroups rows and pads with
masked tokens, and every batch row is encoded independently.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.data.tokenizer import HashTokenizer, pad_token_rows
from repro_torch.device import resolve_device


def bucket_ladder(max_len: int, n_buckets: int = 6,
                  multiple: int = 8) -> tuple[int, ...]:
    """Geometric padded-length ladder: ``multiple`` ... ``max_len``.

    Rungs are multiples of ``multiple``, strictly increasing, and the top
    rung is exactly ``max_len``.  At most ``n_buckets`` rungs; duplicates
    from rounding collapse.
    """
    max_len = max(int(max_len), 1)
    multiple = max(int(multiple), 1)
    if n_buckets <= 1 or max_len <= multiple:
        return (max_len,)
    rungs = []
    for i in range(n_buckets):
        frac = (max_len / multiple) ** (i / (n_buckets - 1))
        rung = -(-int(round(multiple * frac)) // multiple) * multiple
        rungs.append(min(rung, max_len))
    rungs[-1] = max_len
    return tuple(sorted(set(rungs)))


class EncodePipeline:
    """Parallel tokenize -> shape-bucketed batches -> device encode.

    Parameters
    ----------
    encode_fn : ``(params, {"tokens", "mask"}) -> (B, d)`` encoder, given
        int32 tensors on ``device``.
    tokenizer : :class:`HashTokenizer` (or a duck-type with
        ``batch_encode_ids`` and ``pad_id``).
    append_eos / pad_to_multiple : collator tokenization settings.
    buckets : ladder rung count.
    batch_size : fixed batch dim; ragged tails pad up with masked rows.
    tokenizer_workers : host tokenization threads (<=1 = inline).
    depth : windows tokenized ahead of the encode stage in
        :meth:`stream` (0 = synchronous).
    device : where the encoder runs.
    """

    def __init__(self, encode_fn: Callable, tokenizer: HashTokenizer, *,
                 append_eos: bool = False, pad_to_multiple: int = 8,
                 buckets: int = 6, batch_size: int = 32,
                 tokenizer_workers: int = 2, depth: int = 2,
                 device: str | torch.device = "cuda"):
        self.encode_fn = encode_fn
        self.tokenizer = tokenizer
        self.append_eos = append_eos
        self.pad_to_multiple = max(pad_to_multiple, 1)
        self.buckets = buckets
        self.batch_size = max(batch_size, 1)
        self.tokenizer_workers = max(tokenizer_workers, 1)
        self.depth = max(depth, 0)
        self.device = resolve_device(device)
        self.stats = {"compiles": 0, "batches": 0, "tokens_real": 0,
                      "tokens_padded": 0, "windows": 0}
        self._shapes: set[tuple[int, int]] = set()
        self._ladders: dict[int, tuple[int, ...]] = {}

    def _encode_batch(self, params, toks: np.ndarray,
                      mask: np.ndarray) -> torch.Tensor:
        self._shapes.add(toks.shape)
        self.stats["compiles"] = len(self._shapes)
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        with torch.no_grad():
            return self.encode_fn(params, batch)

    # -- stage 1: host tokenization -------------------------------------------
    def tokenize(self, texts: Sequence[str], max_len: int,
                 fmt: Callable[[str], str] | None = None
                 ) -> list[list[int]]:
        """Token-id rows for ``texts``, fanned over the tokenizer pool."""
        texts = [fmt(t) for t in texts] if fmt is not None else list(texts)
        if (self.tokenizer_workers <= 1
                or len(texts) < 4 * self.tokenizer_workers):
            return self.tokenizer.batch_encode_ids(texts, max_len,
                                                   self.append_eos)
        step = -(-len(texts) // self.tokenizer_workers)
        with ThreadPoolExecutor(self.tokenizer_workers,
                                thread_name_prefix="tokenize") as pool:
            parts = list(pool.map(
                lambda lo: self.tokenizer.batch_encode_ids(
                    texts[lo: lo + step], max_len, self.append_eos),
                range(0, len(texts), step)))
        return [row for part in parts for row in part]

    # -- stage 2: shape bucketing ---------------------------------------------
    def ladder(self, max_len: int) -> tuple[int, ...]:
        lad = self._ladders.get(max_len)
        if lad is None:
            lad = bucket_ladder(max_len, self.buckets, self.pad_to_multiple)
            self._ladders[max_len] = lad
        return lad

    def _fit(self, length: int, ladder: tuple[int, ...]) -> int:
        for rung in ladder:
            if rung >= length:
                return rung
        return ladder[-1]

    def _batch_dim(self, n: int, batch_size: int,
                   min_batch: int = 8) -> int:
        """Fixed batch dim: ``batch_size`` once the input covers it; a
        power of two below it (floored at ``min_batch``) for small
        inputs.  Rows beyond ``n`` are masked either way."""
        if n >= batch_size:
            return batch_size
        b = max(1, min(min_batch, batch_size))
        while b < n:
            b <<= 1
        return min(b, batch_size)

    # -- stage 3: device encode -----------------------------------------------
    def _encode_window(self, params, enc: list[list[int]], max_len: int,
                       device: bool, batch_size: int,
                       min_batch_dim: int = 8):
        """Encode one window of token rows; output rows restored to the
        window's original order (on the device or on the host)."""
        n = len(enc)
        if n == 0:
            return (torch.empty((0, 0), device=self.device) if device
                    else np.empty((0, 0), np.float32))
        ladder = self.ladder(max_len)
        b = self._batch_dim(n, batch_size, min_batch_dim)
        lengths = np.fromiter((len(e) for e in enc), np.int64, count=n)
        order = np.argsort(lengths, kind="stable")
        parts, perm = [], []
        for lo in range(0, n, b):
            idx = order[lo: lo + b]
            rows = [enc[i] for i in idx]
            rung = self._fit(max(lengths[idx].max(), 1), ladder)
            toks, mask = pad_token_rows(rows, rung, self.tokenizer.pad_id,
                                        n_rows=b)
            parts.append(self._encode_batch(params, toks, mask)[: len(idx)])
            perm.append(idx)
            self.stats["batches"] += 1
            self.stats["tokens_real"] += int(lengths[idx].sum())
            self.stats["tokens_padded"] += b * rung
        inverse = np.empty(n, np.int64)
        inverse[np.concatenate(perm)] = np.arange(n)
        self.stats["windows"] += 1
        out =torch.cat(parts)[torch.from_numpy(inverse).to(self.device)]
        return out if device else out.cpu().numpy()

    # -- public API -----------------------------------------------------------
    def encode(self, params, texts: Sequence[str], max_len: int, *,
               fmt: Callable[[str], str] | None = None,
               device: bool = False, batch_size: int | None = None,
               min_batch_dim: int = 8):
        """One-shot ordered encode of ``texts`` -> (N, d)."""
        enc = self.tokenize(texts, max_len, fmt)
        return self._encode_window(params, enc, max_len, device,
                                   batch_size or self.batch_size,
                                   min_batch_dim)

    def stream(self, params, texts: Sequence[str], *, lo: int, hi: int,
               chunk_size: int, max_len: int,
               fmt: Callable[[str], str] | None = None,
               device: bool = False):
        """Yield ``(offset, (chunk, d) embeddings)`` over ``texts[lo:hi)``
        in original order, ``chunk_size`` rows at a time.

        Texts are processed in windows (several chunks each, so length
        sorting has room to work); window ``w + 1`` tokenizes on a
        background thread while window ``w`` encodes.
        """
        window = max(chunk_size, self.batch_size) * 8
        spans = [(s, min(s + window, hi)) for s in range(lo, hi, window)]
        if not spans:
            return

        def tok(span):
            return self.tokenize(texts[span[0]: span[1]], max_len, fmt)

        def emit(span, enc):
            ws, we = span
            embs = self._encode_window(params, enc, max_len, device,
                                       self.batch_size)
            for off in range(ws, we, chunk_size):
                yield off, embs[off - ws: min(off - ws + chunk_size,
                                              we - ws)]

        if self.depth == 0 or len(spans) == 1:
            for span in spans:
                yield from emit(span, tok(span))
            return
        with ThreadPoolExecutor(self.depth,
                                thread_name_prefix="tokenize-ahead") as ex:
            pending = deque(ex.submit(tok, span)
                            for span in spans[: self.depth])
            for i, span in enumerate(spans):
                enc = pending.popleft().result()
                if self.depth + i < len(spans):
                    pending.append(ex.submit(tok, spans[self.depth + i]))
                yield from emit(span, enc)


class PipelineChunkSource:
    """Pull-based pipeline view for ``ShardedSearchDriver``: an object with
    ``open_slice(lo, hi, chunk_size)`` returning an ordered
    ``(offset, embeddings)`` iterator over the slice."""

    def __init__(self, pipeline: EncodePipeline, params,
                 texts: Sequence[str], max_len: int, *,
                 fmt: Callable[[str], str] | None = None,
                 device: bool = False):
        self.pipeline = pipeline
        self.params = params
        self.texts = texts
        self.max_len = max_len
        self.fmt = fmt
        self.device = device

    def open_slice(self, lo: int, hi: int, chunk_size: int):
        return self.pipeline.stream(
            self.params, self.texts, lo=lo, hi=hi, chunk_size=chunk_size,
            max_len=self.max_len, fmt=self.fmt, device=self.device)

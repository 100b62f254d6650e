"""FastResultHeapq: streaming top-k tracking with matrix ops (paper §3.5).

A fixed (Q, k) buffer merged against each incoming score chunk.  Three
interchangeable impls:

  * ``python`` — the heapq baseline the paper benchmarks against
  * ``torch``  — the plain sort-based merge (``kernels.ref``)
  * ``kernel`` — the streaming top-k merge kernel (K2), in place

``torch`` and ``kernel`` return identical results; ``python`` agrees on
values and on ids wherever scores are unique (heapq keeps the larger id
on a tie, the device impls the earlier candidate).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core.config import HEAP_IMPLS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def to_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (tensor or array-like) as a contiguous ``dtype`` tensor on
    ``device``.  A host array is copied only when it is read-only (a
    memmap slice) or not C-contiguous, so a chunk the loader has just
    cast to float32 goes to the card without another host copy.  A
    writable C-contiguous array that needs neither a transfer nor a
    cast (``device`` the CPU, ``dtype`` its own) is not copied at all:
    the tensor aliases it, and writes through either show in both."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device=device, dtype=dtype).contiguous()


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FastResultHeapq:
    """Tracks top-k (score, doc_id) per query over streamed score chunks.

    Device-side ids are int32 *positions* (e.g. global corpus offsets);
    callers map positions back to 63-bit id hashes on the host.

    NaN and -inf scores mean "never retrieve": such candidates never
    surface a doc id, in any impl.
    """

    HEAP_IMPLS = HEAP_IMPLS

    def __init__(self, n_queries: int, k: int, impl: str = "kernel",
                 device: str | torch.device = "cuda"):
        if impl not in self.HEAP_IMPLS:
            raise ValueError(f"unknown heap impl {impl!r}; expected one "
                             f"of {list(self.HEAP_IMPLS)}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if impl == "kernel" and k > ops.topk.MAX_K:
            raise ValueError(f"the kernel heap takes k <= "
                             f"{ops.topk.MAX_K}, got {k}")
        if n_queries < 0:
            raise ValueError(f"n_queries must be >= 0, got {n_queries}")
        self.k = k
        self.n_queries = n_queries
        self.impl = impl
        self.device = resolve_device(device)
        if impl == "python":
            self._heaps: list[list[tuple[float, int]]] = [
                [] for _ in range(n_queries)]
        else:
            self.vals, self.ids = ops.empty_state(n_queries, k, self.device)

    def _tensor(self, x, dtype) -> torch.Tensor:
        return to_tensor(x, self.device, dtype)

    def update(self, scores, chunk_ids):
        """scores (Q, C) for C docs with ids chunk_ids (C,)."""
        if self.impl == "python":
            s = to_numpy(scores)
            cid = to_numpy(chunk_ids)
            for q in range(self.n_queries):
                h = self._heaps[q]
                for c in range(s.shape[1]):
                    sc = float(s[q, c])
                    if sc != sc or sc == -np.inf:    # never retrieve
                        continue
                    item = (sc, int(cid[c]))
                    if len(h) < self.k:
                        heapq.heappush(h, item)
                    elif item > h[0]:
                        heapq.heapreplace(h, item)
            return
        scores = self._tensor(scores, torch.float32)
        chunk_ids = self._tensor(chunk_ids, torch.int32)
        if self.impl == "kernel":
            # the heap owns its state, so the kernel merges into it in
            # place (the reference donates the same buffers)
            ops.topk_update(self.vals, self.ids, scores, chunk_ids)
            return
        self.vals, self.ids = ref.topk_update_ref(self.vals, self.ids,
                                                  scores, chunk_ids)

    def merge_arrays(self, vals, ids):
        """Merge per-query candidate arrays vals (Q, m), ids (Q, m).

        The entry point for fused score + top-k output: each corpus chunk
        arrives already reduced to (Q, k').  ``ids`` < 0 marks empty
        slots (vals must be -inf there).  Per-row ids do not fit K2's
        shared (C,) chunk ids, so both device impls merge with the plain
        sort, as the reference does.
        """
        if self.impl == "python":
            v = to_numpy(vals)
            i = to_numpy(ids)
            for q in range(self.n_queries):
                h = self._heaps[q]
                for c in range(v.shape[1]):
                    sc = float(v[q, c])
                    if i[q, c] < 0 or sc != sc or sc == -np.inf:
                        continue
                    item = (sc, int(i[q, c]))
                    if len(h) < self.k:
                        heapq.heappush(h, item)
                    elif item > h[0]:
                        heapq.heapreplace(h, item)
            return
        self.vals, self.ids = ref.select_topk(
            self.vals, self.ids, self._tensor(vals, torch.float32),
            self._tensor(ids, torch.int32))

    def merge(self, other: "FastResultHeapq"):
        """Merge another heap's state (cross-shard top-k reduction)."""
        self.merge_arrays(*other.finalize())

    def adopt_state(self, vals: torch.Tensor, ids: torch.Tensor):
        """Install a device-resident (Q, k) state wholesale — the hand-off
        point of the superchunk executor.  Device impls only."""
        if self.impl == "python":
            raise ValueError("the python impl has no array state")
        if tuple(vals.shape) != (self.n_queries, self.k):
            raise ValueError(f"state {tuple(vals.shape)} != "
                             f"({self.n_queries}, {self.k})")
        self.vals = self._tensor(vals, torch.float32)
        self.ids = self._tensor(ids, torch.int32)

    def finalize_device(self):
        """Stable descending sort of the state -> (vals (Q, k), ids int32)
        as device tensors, no host transfer (device impls only)."""
        if self.impl == "python":
            raise ValueError("the python impl finalizes on the host")
        vals, order = torch.sort(self.vals, dim=1, descending=True,
                                 stable=True)
        return vals, torch.gather(self.ids, 1, order)

    def finalize(self):
        """-> (scores (Q,k) desc-sorted, doc_ids (Q,k)); -1 id == empty."""
        if self.impl == "python":
            vals = np.full((self.n_queries, self.k), -np.inf, np.float32)
            ids = np.full((self.n_queries, self.k), -1, np.int64)
            for q, h in enumerate(self._heaps):
                for j, (s, d) in enumerate(sorted(h, reverse=True)):
                    vals[q, j] = s
                    ids[q, j] = d
            return vals, ids
        vals, ids = self.finalize_device()
        return to_numpy(vals), to_numpy(ids).astype(np.int64)

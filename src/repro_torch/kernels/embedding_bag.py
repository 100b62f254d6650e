"""Wrapper of the EmbeddingBag kernel (CUDA C++, ``csrc/embedding_bag.cu``).

K4 :func:`embedding_bag_` replaces the TPU kernel
``src/repro/kernels/embedding_bag.py::embedding_bag_pallas``: bag sums
``out[b] = sum_l table[idx[b, l]] * weights[b, l]`` with ``idx < 0`` as
padding, accumulated in float32 and written in the table's dtype.  The
source note in ``csrc/embedding_bag.cu`` says what bounds the kernel on
an H100 and what its design does about it.

The wrapper checks device, dtype, shape and contiguity and raises on
anything else.  For CPU tensors it runs the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel on the
current stream, in the tiles and slot passes of :func:`bag_plan`, or
raises — there is no fallback.  Each launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.topk import (LAUNCH_LOCK, _MAX_SMEM, _check,
                                      _launch, count_launch, sm_count)

TABLE_DTYPES = (torch.float32, torch.bfloat16)
# A block's threads at most, and the longest slot pass the kernel's
# register stages hold (csrc/embedding_bag.cu: kMaxThreads, by_pass).
MAX_THREADS = 256
MAX_PASS = 40
# The slot pass where the grid fills the card: enough gathers in flight
# per thread, few registers.
SHORT_PASS = 8
# Bags a tile holds at most: its ids sit in shared memory, which the SM's
# L1 shares with the table rows, so small tiles leave L1 to the hot rows.
TILE_BAGS = 24
# Shared memory a tile's ids and weights may take (long bags).
TILE_SMEM = 48 * 1024

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"embedding_bag": 0}


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        LAUNCHES["embedding_bag"] = 0


def vector_bytes(dim: int, elt_bytes: int) -> int:
    """Bytes of one piece of a row: the widest load, up to 16 bytes, that
    divides a row of ``dim`` elements of ``elt_bytes`` (the kernel also
    narrows it to the table's and the output's address alignment)."""
    row = dim * elt_bytes
    return min(16, row & -row)


def tile_smem(bags: int, n_slots: int, weighted: bool) -> int:
    """Shared memory of a tile: its ids (and weights), ``n_slots | 1``
    4-byte values a bag."""
    return bags * (n_slots | 1) * 4 * (2 if weighted else 1)


def bag_plan(b: int, n_slots: int, dim: int, elt_bytes: int,
             sms: int) -> tuple[int, int]:
    """K4's (bags per tile, slots per pass) for B bags of L = ``n_slots``
    slots over a table of ``dim`` columns of ``elt_bytes`` each, on a card
    of ``sms`` streaming multiprocessors.

    A block takes a tile of consecutive bags, one thread per piece of a
    bag's row (:func:`vector_bytes`): TILE_BAGS bags, fewer where their
    pieces would pass MAX_THREADS threads or their ids and weights
    TILE_SMEM, and fewer still where the grid would leave SMs without a
    tile (at B = 512, 3 bags a tile give 171 blocks).  A pass issues all
    its slots' gathers before it adds them: the whole bag, up to MAX_PASS
    slots, where the grid's threads cannot fill the card and each
    gather's round trip is the time; SHORT_PASS where they can, so a
    thread holds few registers.  Measured on an H100 at DeepFM's shapes
    (``scripts/k4_shapes.py --sweep``; PERF.md).
    """
    pieces = dim * elt_bytes // vector_bytes(dim, elt_bytes)
    bags = min(TILE_BAGS, max(1, MAX_THREADS // pieces))
    bags = min(bags, max(1, TILE_SMEM // tile_smem(1, n_slots, True)))
    bags = min(bags, max(1, b // sms))
    fills = b * pieces >= 4 * sms * MAX_THREADS
    return bags, max(1, min(n_slots, SHORT_PASS if fills else MAX_PASS))


def embedding_bag_(out: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor | None = None) -> None:
    """K4, into ``out``: ``out[b] = sum_l table[idx[b, l]] * weights[b, l]``.

    table (V, D) float32 or bfloat16 with V >= 1; idx (B, L) int32, -1 =
    padding; weights (B, L) float32 or None (all ones); out (B, D) in the
    table's dtype.  Edge semantics are the plain version's
    (:func:`repro_torch.kernels.ref.embedding_bag_ref`).
    """
    if not isinstance(table, torch.Tensor) or table.dtype not in TABLE_DTYPES:
        raise ValueError(f"table must be a float32 or bfloat16 tensor, got "
                         f"{getattr(table, 'dtype', type(table).__name__)}")
    dev = table.device
    _check(table, "table", table.dtype, 2, dev)
    _check(idx, "idx", torch.int32, 2, dev)
    _check(out, "out", table.dtype, 2, dev)
    (v, d), (b, n_slots) = table.shape, idx.shape
    if v < 1:
        raise ValueError("table has no rows")
    if out.shape != (b, d):
        raise ValueError(f"out {tuple(out.shape)} != ({b}, {d})")
    if weights is not None:
        _check(weights, "weights", torch.float32, 2, dev)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx "
                             f"{tuple(idx.shape)}")
    if dev.type == "cpu":
        out.copy_(ref.embedding_bag_ref(table, idx, weights))
        return
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA or CPU tensors, got {dev}")
    if b * d == 0:
        return
    if tile_smem(1, n_slots, weights is not None) > _MAX_SMEM:
        raise ValueError(f"L={n_slots} slots: one bag's ids and weights "
                         f"pass a block's {_MAX_SMEM} bytes of shared memory")
    bags, n_pass = bag_plan(b, n_slots, d, table.element_size(),
                            sm_count(dev))
    from repro_torch.kernels._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        _launch(lib.repro_embedding_bag, table.data_ptr(),
                int(table.dtype == torch.bfloat16), idx.data_ptr(),
                None if weights is None else weights.data_ptr(), b, n_slots,
                v, d, bags, n_pass, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch(LAUNCHES, "embedding_bag")

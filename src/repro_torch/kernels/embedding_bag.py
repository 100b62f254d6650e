"""Wrappers of the EmbeddingBag kernels (CUDA C++, ``csrc/embedding_bag.cu``
and ``csrc/embedding_bag_backward.cu``).

K4 :func:`embedding_bag_` replaces the TPU kernel
``src/repro/kernels/embedding_bag.py::embedding_bag_pallas``: bag sums
``out[b] = sum_l table[idx[b, l]] * weights[b, l]`` with ``idx < 0`` as
padding, accumulated in float32 and written in the table's dtype.  K4T
:func:`embedding_bag_backward_` is its backward, the table's gradient,
which the reference leaves to XLA's scatter-add (it has no Pallas
backward).  The source notes in ``csrc/`` say what bounds each kernel on
an H100 and what its design does about it.  K4T is bound by writing the
dense (V, D) gradient: it writes every row exactly once (no fill before
it), in one launch; the wrapper's only other work is the stable sort of
the ids, which :class:`BagKeys` lets bag sums over the same ids share.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  For CPU tensors it runs the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel on the
current stream (K4 in the tiles and slot passes of :func:`bag_plan`, K4T
in the row tiles of :func:`backward_plan`), or raises — there is no
fallback; for meta tensors (the dry run's) it runs the same checks, and
K4T its sort, and launches nothing.  Each launch adds one to its
kernel's entry of :data:`LAUNCHES`.  On the card and on meta a call
hands its float32 operations and bytes (:func:`bag_cost`,
:func:`bag_backward_cost`) to an active ``launch.roofline.CostMode``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.topk import (LAUNCH_LOCK, _MAX_SMEM, _check,
                                      _launch, check_device, count_launch,
                                      report_cost, sm_count)

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

# K4T's plan (csrc/embedding_bag_backward.cu; every plan gives the same
# bits): a block's threads, the output bytes a tile of rows holds at
# most, and the bytes a block writes from which a second wave of blocks
# pays: the best measured on an H100 at DeepFM's and Wide&Deep's
# train_batch (``scripts/k4t_shapes.py --sweep``; PERF.md).  A batch
# stages at most BACKWARD_VALS float32 products (the kernel's
# kValsFloats).
BACKWARD_THREADS = 256
BACKWARD_TILE_BYTES = 16 * 1024
BACKWARD_VALS = 2560
BACKWARD_WAVE_BYTES = 1 << 20
# One SM's shared memory, threads and registers on sm_90 (228 KB, 1 KB of
# it kept for each resident block; 2048 threads; 65,536 registers), and
# K4T's registers a thread at most (its __launch_bounds__(1024)).
SM_SMEM = 233_472
SM_THREADS = 2048
SM_REGS = 65_536
BACKWARD_REGS = 64

# Kernel launches since the last reset_launch_counts(), by kernel name.
LAUNCHES = {"embedding_bag": 0, "embedding_bag_backward": 0}


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def bag_cost(b: int, n_slots: int, dim: int, elt_bytes: int,
             weighted: bool, rows: int | None = None) -> tuple[int, int]:
    """K4's work on B bags of L = ``n_slots`` over a table of ``dim``
    columns of ``elt_bytes``: (float32 operations, 2 a slot and column,
    padding included; bytes: the ids (and weights) read once, ``rows``
    table rows read once and the (B, D) output written).  ``rows``
    defaults to every slot, padding included (the wrapper cannot see the
    ids without a sync); a caller that knows the distinct rows the ids
    touch passes them."""
    rows = b * n_slots if rows is None else rows
    return (2 * b * n_slots * dim,
            4 * b * n_slots * (2 if weighted else 1)
            + elt_bytes * (rows + b) * dim)


def bag_backward_cost(b: int, n_slots: int, v: int, dim: int,
                      elt_bytes: int, weighted: bool,
                      slots: int | None = None) -> tuple[int, int]:
    """K4T's kernel's work for a (V, D) gradient from B bags of L slots:
    (float32 operations, 2 a slot and column, ``slots`` defaulting to
    every slot, padding included; bytes: the ids (and weights) and the
    (B, D) gradient read once, the dense (V, D) output written once).
    The sort before it (:func:`backward_keys`) is torch's, counted as its
    own operations."""
    slots = b * n_slots if slots is None else slots
    return (2 * slots * dim,
            4 * b * n_slots * (2 if weighted else 1)
            + elt_bytes * (b + v) * dim)


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
    check_device(dev)
    if b * d == 0:
        return
    if tile_smem(1, n_slots, weights is not None) > _MAX_SMEM:
        raise ValueError(f"L={n_slots} slots: one bag's ids and weights "
                         f"pass a block's {_MAX_SMEM} bytes of shared memory")
    cost = bag_cost(b, n_slots, d, table.element_size(), weights is not None)
    if dev.type == "meta":
        report_cost("embedding_bag", cost)
        return
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
    report_cost("embedding_bag", cost)


def _round16(x: int) -> int:
    return (x + 15) & ~15


def backward_batch(threads: int, dim: int) -> int:
    """Entries one K4T batch takes: one per thread, fewer where their
    products (``dim`` float32 each) would pass BACKWARD_VALS."""
    return min(threads, max(1, BACKWARD_VALS // dim))


def backward_smem(tile_rows: int, threads: int, dim: int) -> int:
    """Shared memory of a K4T block (the kernel's ``layout``): the tile's
    float32 sums (4 spare for the alignment shift), the batch's products,
    keys and run starts, and the warps' run counts."""
    batch = backward_batch(threads, dim)
    return (_round16(4 * (tile_rows * dim + 4)) + _round16(4 * batch * dim)
            + _round16(4 * batch) + _round16(4 * (batch + 1))
            + _round16(4 * 32))


def backward_tile_rows(v: int, dim: int, elt_bytes: int,
                       tile_bytes: int = BACKWARD_TILE_BYTES) -> int:
    """Rows of one K4T tile: as many as ``tile_bytes`` of output hold, a
    multiple of the rows that make whole 16-byte pieces (so every tile
    starts at the same alignment as the first), at most V."""
    row = dim * elt_bytes
    quantum = 16 // math.gcd(row, 16)
    return min(v, max(quantum, tile_bytes // row // quantum * quantum))


def backward_entry_work(dim: int) -> int:
    """How K4T's persistent blocks share the rows out: each gets an equal
    share of V * D * elt bytes plus this many for every entry (an entry's
    gathers and adds take about as long as writing that many bytes; the
    best of a half, one and two times this at D = 1 and 10, measured on an
    H100 with ``scripts/k4t_shapes.py --sweep``)."""
    return 160 + 10 * dim


def backward_plan(v: int, dim: int, elt_bytes: int, sms: int, *,
                  tile_bytes: int = BACKWARD_TILE_BYTES,
                  threads: int = BACKWARD_THREADS) -> tuple[int, int, int]:
    """K4T's (tile rows, threads, grid) for a (V, D) gradient of
    ``elt_bytes`` elements on a card of ``sms`` SMs.

    The blocks are persistent: as many as fit on every SM at once (by
    threads, registers and :func:`backward_smem`), twice as many where
    each would write BACKWARD_WAVE_BYTES or more (a second wave, which
    the card's scheduler hands to the SMs that finish first, evens out
    blocks the kernel's split left uneven), at most one per tile.  Each
    walks a contiguous run of rows in tiles of :func:`backward_tile_rows`
    rows, the runs balanced by work in the kernel (a row's bytes,
    :func:`backward_entry_work` an entry).
    """
    threads = max(threads, 32 * -(-dim // 32))    # a thread a column
    rows = backward_tile_rows(v, dim, elt_bytes, tile_bytes)
    smem = backward_smem(rows, threads, dim)
    per_sm = max(1, min(SM_THREADS // threads,
                        SM_REGS // (BACKWARD_REGS * threads),
                        SM_SMEM // (smem + 1024), 32))
    resident = sms * per_sm
    waves = 2 if v * dim * elt_bytes >= resident * BACKWARD_WAVE_BYTES else 1
    return rows, threads, min(-(-v // rows), resident * waves)


def backward_keys(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4T's index preparation: the (B, L) ids' rows, padding read as row
    0, sorted stably, and each sorted entry's flat position ``b * L + l``
    (both (B*L,) int32).  The stable sort keeps every row's contributions
    in ascending flat position, the order K4T adds them in."""
    keys, order = torch.sort(idx.reshape(-1).clamp(min=0), stable=True)
    return keys, order.to(torch.int32)


class BagKeys:
    """One (B, L) idx's :func:`backward_keys`, sorted at first use and kept,
    so bag sums over the same ids (DeepFM's linear term and FM sum) share
    one sort in their backward.  Nothing sorts until a backward on the
    card asks (:meth:`sorted`): a forward under ``no_grad``, serving, and
    the plain path on the CPU never do.

    ``idx`` is normalised as :func:`repro_torch.kernels.ops.embedding_bag`
    normalises its ids (int32, contiguous); :meth:`ids_for` hands that
    tensor back for ``idx`` itself and raises for any other ids.
    """

    def __init__(self, idx: torch.Tensor):
        self.source = idx
        self.idx = idx.to(torch.int32).contiguous()
        self._sorted: tuple[torch.Tensor, torch.Tensor] | None = None
        self._version = -1

    def ids_for(self, idx: torch.Tensor) -> torch.Tensor:
        """The holder's int32 ids, if ``idx`` is the tensor it was built on
        (or that tensor's normalised form); raises ValueError otherwise."""
        if idx is self.source or idx is self.idx:
            return self.idx
        same = (isinstance(idx, torch.Tensor) and idx.dtype == torch.int32
                and idx.device == self.idx.device
                and idx.shape == self.idx.shape and idx.is_contiguous()
                and idx.data_ptr() == self.idx.data_ptr())
        if not same:
            raise ValueError("BagKeys was built on other ids than these")
        return self.idx

    def sorted(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys, order) of :func:`backward_keys`, sorted on the first call;
        raises if the ids changed in place since."""
        if self._sorted is None:
            self._sorted = backward_keys(self.idx)
            self._version = self.idx._version
        elif self.idx._version != self._version:
            raise RuntimeError("the ids of a BagKeys changed in place after "
                               "they were sorted")
        return self._sorted


def embedding_bag_backward_(out: torch.Tensor, grad_out: torch.Tensor,
                            idx: torch.Tensor,
                            weights: torch.Tensor | None = None, *,
                            keys: BagKeys | None = None) -> None:
    """K4T, into ``out``: the gradient of :func:`embedding_bag_` with
    respect to its table, ``out[r] = sum over idx[b, l] = r of
    grad_out[b] * weights[b, l]``.

    grad_out (B, D) float32 or bfloat16; idx (B, L) int32, -1 = padding;
    weights (B, L) float32 or None (all ones); out (V, D) in grad_out's
    dtype, V >= 1, written whole (rows no id touches are 0: the kernel
    writes every row once, so ``out`` needs no fill, and B = 0 or L = 0
    give zeros from the same launch).  Edge semantics and the order of
    each row's sum are the plain version's
    (:func:`repro_torch.kernels.ref.embedding_bag_backward_ref`).  On the
    card the ids are sorted first (:func:`backward_keys`), by ``keys`` (a
    :class:`BagKeys` of ``idx``, shared with other calls on the same ids)
    where given; the plain path ignores ``keys``.
    """
    if not isinstance(grad_out, torch.Tensor) or (
            grad_out.dtype not in TABLE_DTYPES):
        got = getattr(grad_out, "dtype", type(grad_out).__name__)
        raise ValueError(f"grad_out must be a float32 or bfloat16 tensor, "
                         f"got {got}")
    dev = grad_out.device
    _check(grad_out, "grad_out", grad_out.dtype, 2, dev)
    _check(idx, "idx", torch.int32, 2, dev)
    _check(out, "out", grad_out.dtype, 2, dev)
    (b, d), (v, n_slots) = grad_out.shape, (out.shape[0], idx.shape[1])
    if v < 1:
        raise ValueError("out has no rows")
    if out.shape[1] != d or idx.shape[0] != b:
        raise ValueError(f"out {tuple(out.shape)}, grad_out "
                         f"{tuple(grad_out.shape)} and idx "
                         f"{tuple(idx.shape)} do not agree")
    if weights is not None:
        _check(weights, "weights", torch.float32, 2, dev)
        if weights.shape != idx.shape:
            raise ValueError(f"weights {tuple(weights.shape)} != idx "
                             f"{tuple(idx.shape)}")
    if keys is not None:
        keys.ids_for(idx)
    if dev.type == "cpu":
        out.copy_(ref.embedding_bag_backward_ref(grad_out, idx, v, weights))
        return
    check_device(dev)
    n = b * n_slots
    if n >= 2 ** 31:
        raise ValueError(f"B*L = {n} ids: flat positions pass int32")
    if d == 0:
        return
    if d > 1024:
        raise ValueError(f"D={d}: K4T adds a row's columns with a thread "
                         f"each, at most 1024")
    elt = grad_out.element_size()
    cost = bag_backward_cost(b, n_slots, v, d, elt, weights is not None)
    if dev.type == "meta":
        # the card's sort, so a meta count holds the same operations
        if keys is not None:
            keys.sorted()
        else:
            backward_keys(idx)
        report_cost("embedding_bag_backward", cost)
        return
    rows, threads, grid = backward_plan(v, d, elt, sm_count(dev))
    if backward_smem(rows, threads, d) > _MAX_SMEM:
        raise ValueError(f"D={d}: one row of K4T's tile passes a block's "
                         f"{_MAX_SMEM} bytes of shared memory")
    sorted_keys, order = (keys.sorted() if keys is not None
                          else backward_keys(idx))
    from repro_torch.kernels._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        _launch(lib.repro_embedding_bag_backward, grad_out.data_ptr(),
                int(grad_out.dtype == torch.bfloat16), idx.data_ptr(),
                None if weights is None else weights.data_ptr(),
                sorted_keys.data_ptr(), order.data_ptr(), n, n_slots, v, d,
                rows, threads, grid, backward_entry_work(d), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch(LAUNCHES, "embedding_bag_backward")
    report_cost("embedding_bag_backward", cost)

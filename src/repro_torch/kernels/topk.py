"""Wrappers of the streaming top-k kernels (CUDA C++ in ``csrc/``).

K1 :func:`fused_score_topk_` (``csrc/topk.cu``) replaces the TPU kernel
``src/repro/kernels/topk.py::fused_score_topk_pallas`` and, taking a
whole superchunk per launch, the scan that hosted it; it splits the
superchunk's rows into ranges (:func:`fused_split_plan`), keeps each
range's top-k and merges them into the state in a second kernel.  K2
:func:`topk_update_` (``csrc/topk_update.cu``) replaces
``topk_update_pallas``; it splits the column axis into ranges
(:func:`split_plan`) and, with more than one, merges the ranges' top-k in
a second kernel, the same merge pass as K1's (``csrc/topk_select.cuh``).
Both update the (Q, k) state **in place**, as the TPU kernels alias their
state inputs and outputs.  The source notes say what bounds each kernel
on an H100 and what its design does about it.

A wrapper checks device, dtype, shape and contiguity and raises on
anything else.  For CPU tensors it runs the plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel on the
current stream or raises — there is no fallback; for meta tensors (the
dry run's, which hold no data) it runs the same checks and launches
nothing.  Each launch adds one to the kernel's count in
:data:`LAUNCHES`.  On the card and on meta a call hands its float32
operations and bytes (:func:`fused_cost`, :func:`update_cost`, the bound
``chip_smoke.py`` reckons) to an active ``launch.roofline.CostMode``
(:func:`report_cost`), so a meta count and a card count agree.
"""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref

# Largest k the kernels take (csrc/topk_select.cuh kMaxK).
MAX_K = 256
# Shared memory one block may use on Hopper (227 KB).
_MAX_SMEM = 232_448
# Fewest columns in one of K2's ranges: two tiles of 1024, and 8 k for
# every k the kernel takes, so the merge pass reads at most 1/8 as many
# entries as the ranges do.
MIN_SPAN = 8 * MAX_K
# K1's block tiles (csrc/topk.cu Wide, Narrow): rows per tile -> (queries
# per block, rows of one warp's slab of the tile, the fewest rows of one
# of its ranges: a warp with no row of its range in a tile skips the
# products).
FUSED_TILES = {128: (32, 32), 32: (16, 8)}

# Kernel launches since the last reset_launch_counts(), by kernel name.
LAUNCHES = {"fused_score_topk": 0, "topk_update": 0}
# Guards every launch count: W worker threads launch at once, and a bare
# `+= 1` is a read-modify-write that may lose a count between threads.
LAUNCH_LOCK = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one to ``counts[name]`` under :data:`LAUNCH_LOCK`."""
    with LAUNCH_LOCK:
        counts[name] += 1


def reset_launch_counts() -> None:
    with LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def report_cost(name: str, cost: tuple[int, int]) -> None:
    """Hand one kernel call's ``(float32 operations, bytes)`` to each
    active dispatch mode that takes kernel reports (a ``kernel_report``
    method: ``launch.roofline.CostMode``).  The mode stack is the one
    autograd carries into its backward threads, so a backward's kernel
    reports too."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        take = getattr(mode, "kernel_report", None)
        if take is not None:
            take(name, {"float32": cost[0]}, cost[1])


def check_device(dev: torch.device) -> None:
    """Raise unless ``dev`` is one the wrappers take past their plain
    (CPU) path: a card's, or meta."""
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"the kernels take CUDA, CPU or meta tensors, got "
                         f"{dev}")


def fused_cost(q: int, d: int, s: int, c: int, k: int,
               rows: int) -> tuple[int, int]:
    """K1's work on Q queries of width d over an (S, C, d) superchunk of
    which ``rows`` are scored: (float32 operations, 2 d a query and row;
    bytes: the queries, the tile and its per-step offsets and counts read
    once, the (Q, k) state read and written).  The wrapper, which cannot
    read the counts without a sync, counts every row; a caller that knows
    them passes the valid rows."""
    return (2 * q * rows * d,
            4 * (q * d + s * c * d + 2 * s) + 2 * q * k * 8)


def update_cost(q: int, c: int, k: int) -> tuple[int, int]:
    """K2's work merging a (Q, C) chunk into a (Q, k) state: (one float32
    comparison a score; bytes: the scores and chunk ids read once, the
    state read and written)."""
    return q * c, 4 * (q * c + c) + 2 * q * k * 8


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(vals: torch.Tensor, ids: torch.Tensor) -> None:
    _check(vals, "vals", torch.float32, 2, vals.device)
    _check(ids, "ids", torch.int32, 2, vals.device)
    if ids.shape != vals.shape:
        raise ValueError(f"ids {tuple(ids.shape)} != vals "
                         f"{tuple(vals.shape)}")
    k = vals.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def _launch(fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        from repro_torch.kernels._build import load_library
        msg = load_library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {code} "
                           f"({msg})")


def fused_score_topk_(vals: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor, tile: torch.Tensor,
                      offsets: torch.Tensor, n_valids: torch.Tensor) -> None:
    """K1, in place: fold the (S, C, d) superchunk ``tile`` into the
    (Q, k) state ``(vals, ids)``.

    Step ``s`` scores rows ``r < n_valids[s]`` of ``tile[s]`` against
    ``queries`` (Q, d) with id ``offsets[s] + r``; ``offsets`` and
    ``n_valids`` are (S,) int32 on the state's device.
    """
    _check_state(vals, ids)
    dev = vals.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(tile, "tile", torch.float32, 3, dev)
    _check(offsets, "offsets", torch.int32, 1, dev)
    _check(n_valids, "n_valids", torch.int32, 1, dev)
    q, k = vals.shape
    s, c, d = tile.shape
    if queries.shape != (q, d):
        raise ValueError(f"queries {tuple(queries.shape)} != ({q}, {d})")
    if offsets.shape != (s,) or n_valids.shape != (s,):
        raise ValueError(f"offsets/n_valids must be ({s},), got "
                         f"{tuple(offsets.shape)}/{tuple(n_valids.shape)}")
    if q == 0 or s * c == 0:
        return
    if dev.type == "cpu":
        v, i = ref.fused_score_topk_ref(vals, ids, queries, tile, offsets,
                                        n_valids)
        vals.copy_(v)
        ids.copy_(i)
        return
    check_device(dev)
    if s * c + k >= 2 ** 31:
        raise ValueError(f"S*C={s * c} rows: positions k + row must fit in "
                         f"int32")
    cost = fused_cost(q, d, s, c, k, s * c)
    if dev.type == "meta":
        report_cost("fused_score_topk", cost)
        return
    rows, n_splits, span = fused_split_plan(q, s * c, sm_count(dev))
    lib = _library_for(dev, k)
    ws_v, ws_p = fused_workspace(q, n_splits, span, k, rows, dev)
    with torch.cuda.device(dev):
        _launch(lib.repro_fused_score_topk, queries.data_ptr(),
                tile.data_ptr(), offsets.data_ptr(), n_valids.data_ptr(), q,
                d, s, c, k, rows, n_splits, span, vals.data_ptr(),
                ids.data_ptr(), ws_v.data_ptr(), ws_p.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch(LAUNCHES, "fused_score_topk")
    report_cost("fused_score_topk", cost)


def fused_split_plan(q: int, n: int, sms: int) -> tuple[int, int, int]:
    """K1's (rows, splits, span) for Q queries over the N = S*C rows of a
    superchunk on a card of ``sms`` streaming multiprocessors: the block
    tile's rows (a key of FUSED_TILES) and its row ranges (see
    :func:`ranges`; they may cross the superchunk's steps).

    The grid is ceil(Q / queries per block) query tiles by ``splits`` row
    ranges: as many ranges as give each SM one block (a wide block takes
    most of an SM's shared memory, so one more would start a second
    wave), each of at least a warp's slab of rows; one range where the
    query tiles alone fill the card.  The wide tile (32 queries a block,
    each loaded row serving all 32) where its grid gives at least half
    the SMs a block; else the narrow one (16 queries), whose blocks are
    an eighth the size, so a small superchunk spreads over the card.
    Every range hands on up to min(span, k + rows) entries per query to
    the merge pass, so longer ranges would merge fewer but leave SMs idle.
    """
    for rows, (queries, slab) in FUSED_TILES.items():
        tiles = -(-q // queries)
        splits = max(1, min(sms // tiles, n // slab))
        if 2 * tiles * splits >= sms:
            break
    return (rows, *ranges(n, splits))


def fused_workspace(q: int, splits: int, span: int, k: int, rows: int,
                    device):
    """K1's scratch for tiles of ``rows`` rows: the values of each range's
    survivors, a superset of its top k, (Q, splits, min(span, k + rows))
    f32, and their positions int32."""
    shape = (q, splits, min(span, k + rows))
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def split_plan(q: int, c: int, sms: int) -> tuple[int, int]:
    """K2's (splits, span) for Q queries of C columns on a card of ``sms``
    streaming multiprocessors: see :func:`ranges`.

    One range where the Q queries alone give a block to every SM;
    otherwise enough ranges for one block on each SM, each of at least
    MIN_SPAN columns.  One block per SM measured fastest at Q = 1,
    C = 10^6, k = 100 on an H100 (``chip_smoke.py`` times half, one and
    two blocks per SM): more ranges shorten stage 1 but lengthen the
    one-block merge of stage 2 by more.
    """
    splits = 1 if q >= sms else min(-(-sms // q), c // MIN_SPAN)
    return ranges(c, max(1, splits))


def ranges(c: int, splits: int) -> tuple[int, int]:
    """(splits, span) for C columns (K2) or superchunk rows (K1) cut into
    at most ``splits`` ranges: ``[r * span, min((r + 1) * span, c))`` form
    range ``r`` for ``r < splits``, each a block of its own, none empty
    (so there may be fewer than asked).  The span is a multiple of 4, so
    every range of K2's columns starts at the same offset in its 16-byte
    group."""
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    splits = min(splits, c)
    span = -(-c // splits)
    span += -span % 4
    return -(-c // span), span


def workspace(q: int, splits: int, k: int, device):
    """K2's scratch for ``splits`` > 1: each range's top-k values (Q,
    splits, k) f32 and positions (Q, splits, k) int32; None, None for one
    range."""
    if splits == 1:
        return None, None
    return (torch.empty((q, splits, k), dtype=torch.float32, device=device),
            torch.empty((q, splits, k), dtype=torch.int32, device=device))


def topk_update_(vals: torch.Tensor, ids: torch.Tensor,
                 scores: torch.Tensor, chunk_ids: torch.Tensor) -> None:
    """K2, in place: merge ``scores`` (Q, C) f32 with ``chunk_ids`` (C,)
    int32 into the (Q, k) state ``(vals, ids)``.  NaN scores count as
    -inf."""
    _check_state(vals, ids)
    dev = vals.device
    _check(scores, "scores", torch.float32, 2, dev)
    _check(chunk_ids, "chunk_ids", torch.int32, 1, dev)
    q, k = vals.shape
    c = scores.shape[1]
    if scores.shape[0] != q or chunk_ids.shape != (c,):
        raise ValueError(f"scores {tuple(scores.shape)} / chunk_ids "
                         f"{tuple(chunk_ids.shape)} do not match state "
                         f"({q}, {k})")
    if q == 0 or c == 0:
        return
    if dev.type == "cpu":
        v, i = ref.topk_update_ref(vals, ids, scores, chunk_ids)
        vals.copy_(v)
        ids.copy_(i)
        return
    check_device(dev)
    if dev.type == "meta":
        report_cost("topk_update", update_cost(q, c, k))
        return
    n_splits, span = split_plan(q, c, sm_count(dev))
    if c + span + k >= 2 ** 31:
        raise ValueError(f"C={c} columns: positions k + column must fit "
                         f"in int32")
    lib = _cuda_library(dev)
    ws_v, ws_p = workspace(q, n_splits, k, dev)
    with torch.cuda.device(dev):
        _launch(lib.repro_topk_update, vals.data_ptr(), ids.data_ptr(),
                scores.data_ptr(), chunk_ids.data_ptr(), q, c, k, n_splits,
                span, None if ws_v is None else ws_v.data_ptr(),
                None if ws_p is None else ws_p.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    count_launch(LAUNCHES, "topk_update")
    report_cost("topk_update", update_cost(q, c, k))


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev`` (a CUDA device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cuda_library(dev: torch.device):
    """The loaded kernel library, for tensors on ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA, CPU or meta tensors, got "
                         f"{dev}")
    from repro_torch.kernels._build import load_library
    return load_library()


def _library_for(dev: torch.device, k: int):
    """The loaded kernel library, after checking K1's launch fits."""
    lib = _cuda_library(dev)
    need = lib.repro_topk_smem_bytes(k)
    if need > _MAX_SMEM:
        raise ValueError(f"k={k} needs {need} bytes of shared memory per "
                         f"block; the card offers {_MAX_SMEM}")
    return lib

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
current stream or raises — there is no fallback.  Each launch adds one
to :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.topk import _check, _launch

TABLE_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"embedding_bag": 0}


def reset_launch_counts() -> None:
    LAUNCHES["embedding_bag"] = 0


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
    from repro_torch.kernels._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        _launch(lib.repro_embedding_bag, table.data_ptr(),
                int(table.dtype == torch.bfloat16), idx.data_ptr(),
                None if weights is None else weights.data_ptr(), b, n_slots,
                v, d, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["embedding_bag"] += 1

"""Collectives over named axes of a bound mesh.

The port's counterpart of ``psum`` / ``all_gather`` inside the
reference's ``shard_map``.  Each operation runs over a set of mesh axes
(:meth:`Mesh.group`) and is an all-gather of every member's tensor,
ordered by the members' :meth:`Mesh.shard_index` along the axes:

  * :func:`all_gather` concatenates the pieces along a dimension (a
    dimension split over ``("pod", "data")`` comes back pod-major, as the
    partition specs lay it out);
  * :func:`all_reduce` adds them left to right in that order (``"sum"``,
    or ``"mean"``: the sum divided by the member count; bf16 / f16
    accumulate in float32 and round once), so every member gets the same
    bits, run after run;
  * :func:`reduce_scatter` is the all-reduce's slice along a dimension
    that belongs to this rank.

Backend: the process group's own.  Under ``nccl`` (a card per rank) the
tensors stay on their card.  Under ``gloo`` (ranks sharing one card:
NCCL refuses two ranks on one card, and gloo's CUDA support covers only
broadcast and all-reduce) a tensor goes through host memory as raw bytes,
so every dtype travels exactly.  There is no fallback: a failed
collective raises.

:data:`WIRE_BYTES` counts what this rank hands to the transport: a
tensor's bytes times the other members (the ring all-gather's share),
per operation; :func:`reset_counts` zeroes it.  A collective over axes
whose sizes multiply to 1 moves nothing and returns its input.
"""

from __future__ import annotations

import threading

import torch

OPS = ("all_reduce", "all_gather", "reduce_scatter")

_LOCK = threading.Lock()
WIRE_BYTES = dict.fromkeys(OPS, 0)
CALLS = dict.fromkeys(OPS, 0)


def reset_counts() -> None:
    with _LOCK:
        for op in OPS:
            WIRE_BYTES[op] = 0
            CALLS[op] = 0


def counts() -> dict:
    """``{"wire_bytes": {op: n}, "calls": {op: n}}`` since the last
    :func:`reset_counts`."""
    with _LOCK:
        return {"wire_bytes": dict(WIRE_BYTES), "calls": dict(CALLS)}


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _gather_pieces(t: torch.Tensor, mesh, axes, op: str) -> list:
    """Every member's ``t`` (same shape and dtype on each), in shard
    order along ``axes``; this rank's own piece is ``t`` itself."""
    import torch.distributed as dist

    group = mesh.group(axes)
    members = mesh.members(axes)
    n = len(members)
    t = t.contiguous()
    with _LOCK:
        WIRE_BYTES[op] += t.numel() * t.element_size() * (n - 1)
        CALLS[op] += 1
    order = dist.get_process_group_ranks(group)
    if dist.get_backend(group) == "nccl":
        got = [torch.empty_like(t) for _ in order]
        dist.all_gather(got, t, group=group)
        by_rank = dict(zip(order, got))
    else:
        # through pinned host buffers (the caching host allocator keeps
        # them); only the other members' pieces go back to the card
        pinned = t.is_cuda

        def host_buffer():
            return torch.empty(t.numel() * t.element_size(),
                               dtype=torch.uint8, pin_memory=pinned)

        raw = t.detach().reshape(-1).view(torch.uint8)
        if pinned:
            raw = host_buffer().copy_(raw)
        parts = [raw if r == mesh.rank else host_buffer() for r in order]
        dist.all_gather(parts, raw, group=group)
        by_rank = {r: p.to(t.device, non_blocking=True).view(t.dtype)
                   .reshape(t.shape) for r, p in zip(order, parts)
                   if r != mesh.rank}
    by_rank[mesh.rank] = t
    return [by_rank[r] for r in members]


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` in shard order."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return t
    return torch.cat(_gather_pieces(t, mesh, axes, "all_gather"), dim=dim)


def _reduce(pieces: list, op: str) -> torch.Tensor:
    """Left to right in shard order; a 16-bit float sum accumulates in
    float32 and rounds once (so its rounding does not depend on the member
    count), a mean divides the rounded sum."""
    dtype = pieces[0].dtype
    wide = dtype in (torch.bfloat16, torch.float16)
    out = pieces[0].float() if wide else pieces[0].clone()
    for p in pieces[1:]:
        out.add_(p)
    if wide:
        out = out.to(dtype)
    if op == "mean":
        out.div_(len(pieces))
    return out


def _check_op(op: str) -> None:
    if op not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {op!r}")


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """The members' tensors reduced in shard order (``op`` sum or mean);
    a new tensor, the same bits on every member."""
    _check_op(op)
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return t
    return _reduce(_gather_pieces(t, mesh, axes, "all_reduce"), op)


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """This rank's slice along ``dim`` of the members' reduced tensors
    (``t.shape[dim]`` must divide by the member count)."""
    _check_op(op)
    axes = _axes(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    full = _reduce(_gather_pieces(t, mesh, axes, "reduce_scatter"), op)
    return full.chunk(n, dim=dim)[mesh.shard_index(axes)].contiguous()


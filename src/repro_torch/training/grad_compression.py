"""Gradient compression for the cross-replica reduction.

The port of ``repro.training.grad_compression``:

  * bf16 — cast, sum, upcast (half the wire bytes);
  * int8 — per-tensor symmetric quantization with error-feedback
    residuals (EF-SGD): the quantization error is carried to the next
    step.  The trainer keeps the residuals in ``state["ef"]`` when
    ``grad_compression == "int8"``, as the reference does even without a
    mesh.

:func:`compressed_psum` is the reference's all-reduce-mean over named
mesh axes (its ``psum`` inside ``shard_map``), over a bound mesh's
process group (``sharding.collectives``).  Like the reference's, the
trainer never calls it: its ``dp_mode="shard_map"`` compresses the
gradient after the data-axis mean (ROADMAP queue 3, fault 12).
"""

from __future__ import annotations

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor):
    """(int8 values, float32 scale): ``round(x / scale)`` clipped to
    [-127, 127], ties to even (as ``jnp.round``)."""
    x = x.float()
    scale = x.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    """Float32 zeros of each parameter's shape, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, mesh, axis_name, method: str = "none",
                    error_buf=None, n_replicas: int | None = None):
    """All-reduce-mean ``grads`` over the mesh axes ``axis_name`` (a name
    or a tuple), compressed by ``method``; returns ``(grads,
    new_error_buf)``.  The sum runs in rank order (bf16 in bf16, the
    others in float32) and is divided by ``n_replicas`` (the axes' size
    by default)."""
    from repro_torch.sharding import collectives

    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if n_replicas is None:
        n_replicas = mesh.axis_size(axes)

    def mean_psum(x):
        return collectives.all_reduce(x, mesh, axes) / n_replicas

    if method == "none":
        return tree_map(mean_psum, grads), error_buf
    if method == "bf16":
        return tree_map(lambda g: mean_psum(g.to(torch.bfloat16)).float(),
                        grads), error_buf
    if method == "int8":
        if error_buf is None:
            raise ValueError("int8 compression needs error feedback")

        def one(g, e):
            g = g.float() + e                       # error feedback
            deq = dequantize_int8(*quantize_int8(g))
            return mean_psum(deq), g - deq          # residual carried over

        pairs = [one(g, e) for g, e in zip(leaves(grads),
                                           leaves(error_buf))]
        return (unflatten(grads, [p[0] for p in pairs]),
                unflatten(grads, [p[1] for p in pairs]))
    raise ValueError(method)


def wire_bytes(params, method: str) -> int:
    """Bytes on the wire per all-reduce (the reference's reckoning)."""
    n = sum(int(p.numel()) for p in leaves(params))
    return n * {"none": 4, "bf16": 2, "int8": 1}[method]


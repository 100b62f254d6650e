"""Leaves laid out by partition specs, and the meshed training step.

The port's counterpart of GSPMD running the reference's jitted step on
sharded arrays.  A rank holds each leaf as its *local slice* under the
leaf's spec (:func:`local_slice`; ``sharding.partitioning.local_shape``
gives its shape).  A meshed step (:func:`meshed_grads`,
:func:`clip_local`, :func:`update_local`) is ZeRO-3 by rule:

  1. each leaf is gathered over its sharded axes (:func:`gather_leaf`),
     except the leaves a model consumes sharded (``keep``: a recsys
     table under the psum lookup);
  2. forward and backward run on this rank's shard of the batch along
     the data axes, pod-major (:func:`batch_shard`); a loss over the
     whole batch (in-batch negatives) sees every row through
     :func:`gather_rows`, a mean over it (an MoE's load-balance
     statistics) through :func:`mean_over_data`;
  3. the gradients are averaged over the data axes, in rank order
     (``collectives.all_reduce(..., "mean")``);
  4. each leaf keeps its own slice of the gradient, clipped by the global
     norm of the full gradient;
  5. the optimizer runs on the local slices: AdamW element by element;
     Adafactor, whose factored moments and update clip reduce over a
     whole leaf, on each leaf gathered in turn (its parameter, gradient
     and state), of which the rank keeps its slice.

Its numbers are the one-process step's, up to the order of the
data-axis mean.  The reference's activation layout hints (its
``transformer._constrain`` and ``recsys._maybe_full_shard``) move work
between devices, not values, and have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.sharding import collectives
from repro_torch.sharding.partitioning import (AxisRules, P, data_axes,
                                               data_parallelism,
                                               local_shape, sharded_axes,
                                               spec_axes)
from repro_torch.training.tree import flatten, tree_map, unflatten
from repro_torch.training.tree import leaves as leaves_of


def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of a full leaf under ``spec`` (a copy that owns
    its storage, so the full leaf can be freed)."""
    if not sharded_axes(spec):
        return t
    for dim, entry in enumerate(_entries(spec, t.dim())):
        axes = spec_axes(entry)
        if axes:
            n = mesh.axis_size(axes)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.shard_index(axes) * size, size)
    return t.clone()


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice under ``spec``."""
    if not sharded_axes(spec):
        return t
    for dim, entry in enumerate(_entries(spec, t.dim())):
        axes = spec_axes(entry)
        if axes:
            t = collectives.all_gather(t, mesh, axes, dim=dim)
    return t


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    return tree_map(lambda t, s: local_slice(t, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh, keep=()) -> Any:
    """Every leaf gathered, but the paths in ``keep``."""
    return unflatten(tree, [
        t if path in keep else gather_leaf(t, s, mesh)
        for (path, t), (_, s) in zip(flatten(tree), flatten(specs))])


def batch_specs(batch: Any, batch_axes: Any, mesh,
                rules: AxisRules | None = None) -> Any:
    """Each batch leaf's spec from its logical axes."""
    rules = rules or AxisRules()
    return tree_map(lambda x, axes: rules.spec_for(axes, tuple(x.shape),
                                                   mesh), batch, batch_axes)


def batch_shard(batch: Any, specs: Any, mesh) -> Any:
    """This rank's shard of a global batch (a view where possible)."""
    def one(x, spec):
        for dim, entry in enumerate(_entries(spec, x.dim())):
            axes = spec_axes(entry)
            if axes:
                n = mesh.axis_size(axes)
                size = x.shape[dim] // n
                x = x.narrow(dim, mesh.shard_index(axes) * size, size)
        return x
    return tree_map(one, batch, specs)


def data_specs(batch: Any, mesh) -> Any:
    """Dim 0 of every leaf over the data axes (the trainer's batch
    sharding, the reference's ``batch_sharding``)."""
    axes = data_axes(mesh)
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return tree_map(lambda x: P(entry), batch)


class _GatherRows(torch.autograd.Function):
    """Rows of every data rank, pod-major; the backward hands this rank
    its own rows' cotangent times the data-parallel degree, so that the
    data-axis mean of the parameter gradients is the whole batch's."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return collectives.all_gather(x.contiguous(), mesh,
                                      data_axes(mesh), dim=0)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        i = mesh.shard_index(data_axes(mesh))
        mine = g.narrow(0, i * ctx.rows, ctx.rows)
        return mine * data_parallelism(mesh), None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (this rank's batch rows) -> the whole batch's rows, on every
    rank alike (differentiable; see :class:`_GatherRows`)."""
    if mesh is None or data_parallelism(mesh) == 1:
        return x
    return _GatherRows.apply(x, mesh)


class _MeanOverData(torch.autograd.Function):
    """The data-axis mean of a per-rank statistic, in rank order; the
    backward hands this rank the cotangent unchanged: the statistic's
    gradient through this rank's rows is 1 / R of it, and the meshed
    step's data-axis mean of the ranks' gradients divides by R once
    more, so each rank's gradient carries R x its rows' share, as
    :class:`_GatherRows` arranges."""

    @staticmethod
    def forward(ctx, x, mesh):
        return collectives.all_reduce(x.contiguous(), mesh, data_axes(mesh),
                                      "mean")

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (a statistic over this rank's batch rows, the ranks' row
    counts equal) -> its mean over the whole batch, on every rank alike
    (differentiable; see :class:`_MeanOverData`)."""
    if mesh is None or data_parallelism(mesh) == 1:
        return x
    return _MeanOverData.apply(x, mesh)


def meshed_grads(loss_fn: Callable, local_params: Any, specs: Any,
                 batch: Any, mesh, keep=(), marks: Callable | None = None
                 ) -> tuple:
    """Steps 1-3: ``(loss, metrics, grads, full_params)``.  ``loss_fn(
    params, batch)`` runs on the gathered parameters (the ``keep`` paths
    as their local slices) and this rank's ``batch``; ``grads`` are the
    data-axis means, full for gathered leaves and local for kept ones;
    the loss and metrics are data-axis means too.  ``marks(phase)`` is
    called after the forward and after the synchronised backward."""
    full = leaves_of(gather_tree(local_params, specs, mesh, keep))
    leaves = [t.detach().requires_grad_(True) for t in full]
    out = loss_fn(unflatten(local_params, leaves), batch)
    loss, metrics = out if isinstance(out, tuple) else (out, {})
    if marks is not None:
        marks("forward")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    axes = data_axes(mesh)
    grads = [collectives.all_reduce(
        torch.zeros_like(p) if g is None else g, mesh, axes, "mean")
        for p, g in zip(leaves, grads)]
    loss = collectives.all_reduce(loss.detach().float(), mesh, axes, "mean")
    metrics = {k: collectives.all_reduce(
        torch.as_tensor(v).detach().float().to(loss.device), mesh, axes,
        "mean") for k, v in metrics.items()}
    if marks is not None:
        marks("backward")
    return (loss, metrics, unflatten(local_params, grads),
            unflatten(local_params, [t.detach() for t in full]))


@torch.no_grad()
def clip_local(grads: Any, specs: Any, mesh, max_norm: float,
               keep=()) -> tuple:
    """Step 4: ``(local clipped grads, global norm)``.  The norm is over
    the full gradient: a gathered leaf's squares summed here, a kept
    leaf's over the ranks it is split across; each local slice is scaled
    and cast back to its dtype, as ``optimizer.clip_by_global_norm``
    does."""
    named = flatten(grads)
    spec_leaves = [s for _, s in flatten(specs)]
    sq = []
    for (path, g), s in zip(named, spec_leaves):
        part = torch.sum(torch.square(g.float()))
        if path in keep:
            part = collectives.all_reduce(part, mesh, sharded_axes(s))
        sq.append(part)
    gn = torch.sqrt(sum(sq))
    scale = torch.minimum(torch.tensor(1.0, device=gn.device),
                          max_norm / torch.clamp_min(gn, 1e-9))
    out = []
    for (path, g), s in zip(named, spec_leaves):
        local = g if path in keep else local_slice(g, s, mesh)
        out.append(local.float().mul_(scale).to(g.dtype))
    return unflatten(grads, out), gn


@torch.no_grad()
def update_local(opt_cfg, opt_update: Callable, grads: Any, opt_state: dict,
                 params: Any, step, specs: Any, opt_specs: dict, mesh,
                 full_params: Any | None = None, keep=()) -> None:
    """Step 5, in place on the local slices.  AdamW (``"mu"`` in the
    state) updates them directly.  Adafactor gathers each leaf's
    parameter (from ``full_params`` where given), clipped gradient and
    state, updates the whole leaf and keeps this rank's slices."""
    if "mu" in opt_state:
        opt_update(grads, opt_state, params, step)
        return
    named = flatten(params)
    spec_leaves = [s for _, s in flatten(specs)]
    full_leaves = (None if full_params is None else
                   [t for _, t in flatten(full_params)])
    for i, ((path, p), g, s) in enumerate(zip(
            named, [t for _, t in flatten(grads)], spec_leaves)):
        state, sspec = opt_state["v"], opt_specs["v"]
        for key in path.split("/"):
            state, sspec = state[key], sspec[key]
        fp = (full_leaves[i] if full_leaves is not None and path not in keep
              else gather_leaf(p, s, mesh)).clone()
        fg = gather_leaf(g, s, mesh)
        fstate = {k: gather_leaf(v, sspec[k], mesh)
                  for k, v in state.items()}
        opt_update({"x": fg}, {"v": {"x": fstate}}, {"x": fp}, step)
        p.copy_(local_slice(fp, s, mesh))
        for k, v in state.items():
            v.copy_(local_slice(fstate[k], sspec[k], mesh))


def local_zeros(shapes: Any, specs: Any, mesh, device,
                dtype=torch.float32) -> Any:
    """Zeros of each leaf's local shape (global shapes in ``shapes``)."""
    return tree_map(lambda shape, s: torch.zeros(
        local_shape(tuple(shape), s, mesh), dtype=dtype, device=device),
        shapes, specs)

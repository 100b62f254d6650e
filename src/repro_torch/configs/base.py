"""Cells: an architecture's step for one input shape, and the train step.

The counterpart of ``repro.configs.base`` (``Cell``, ``make_train_cell``,
``make_infer_cell``).  A :class:`Cell` bundles the step function the
card runs; the reference's abstract arguments and ``jit_kwargs`` have no
counterpart, since torch runs eagerly.  :func:`make_train_cell` is the
full per-step training work: forward, loss, backward, global-norm clip,
optimizer update.  The update writes the parameters and the optimizer
state in place under ``no_grad``, the port's counterpart of the
reference's ``donate_argnums=(0,)``.

On a mesh (``sharding.make_mesh``, bound to a process group) a cell
carries its :class:`Layout`: the parameters' and optimizer state's specs
under the arch's rules (the reference's ``ShardCtx.shard`` and
``_opt_shardings``: Adafactor's factored ``vr`` / ``vc`` re-resolve the
parameter's logical axes without the dropped one) and the batch's
logical axes.  :func:`init_train_state` then keeps each rank's slices,
and the step is ``sharding.layout``'s meshed step over the global batch
it is given (each rank takes its rows along the data axes).  An
inference cell on a mesh gathers its parameters, runs on this rank's
rows and gathers the output rows over the data axes, so every rank
returns the whole batch's answer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.sharding import collectives
from repro_torch.sharding.layout import (batch_shard, batch_specs,
                                         clip_local, gather_tree,
                                         local_zeros, meshed_grads,
                                         shard_tree, update_local)
from repro_torch.sharding.partitioning import (AxisRules, spec_axes,
                                               tree_pspecs)
from repro_torch.training.optimizer import (OptimizerConfig,
                                            clip_by_global_norm,
                                            make_optimizer,
                                            opt_state_logical_axes)
from repro_torch.training.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class Layout:
    """A cell's sharding on a mesh: specs of the parameters
    (``param_specs``), of the optimizer state (``opt_specs``, train
    cells) and of the KV cache (``cache_specs``, serve cells), the
    batch's logical axes, the rules, and the parameter paths the model
    consumes as local slices (``keep``)."""
    mesh: Any
    rules: AxisRules
    param_specs: Any
    batch_axes: Any
    opt_specs: Any = None
    opt_shapes: Any = None
    keep: tuple = ()
    cache_specs: Any = None         # serve cells: the KV cache's specs


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                       # train | encode | serve | retrieval
    fn: Callable                    # fn(params, batch); train: (state, batch)
    optimizer: str = ""             # train cells: the optimizer's name
    layout: Layout | None = None    # on a mesh
    # a meshed serve cell: (generator, device) -> this rank's block of the
    # zeroed cache and the whole batch's tokens
    smoke_inputs: Callable | None = None

    def local_params(self, params):
        """This rank's slices of full ``params`` under the cell's layout
        (``params`` themselves without one)."""
        if self.layout is None:
            return params
        return shard_tree(params, self.layout.param_specs, self.layout.mesh)


def _opt_config(optimizer: str) -> OptimizerConfig:
    return OptimizerConfig(name=optimizer, learning_rate=1e-3)


def _meta(shapes):
    return tree_map(lambda s: torch.empty(tuple(s), device="meta"), shapes)


def make_layout(mesh, rules: AxisRules, param_shapes, param_axes,
                batch_axes, optimizer: str | None = None,
                keep=(), cache: tuple | None = None) -> Layout:
    """The specs of a cell's parameters (and, for ``optimizer``, its
    state; for ``cache = (shapes, logical axes)``, a KV cache's) on
    ``mesh``; ``param_shapes`` is a tree of shape tuples."""
    param_specs = tree_pspecs(param_shapes, param_axes, mesh, rules)
    opt_specs = opt_shapes = None
    if optimizer is not None:
        cfg = _opt_config(optimizer)
        opt_init, _ = make_optimizer(cfg)
        opt_shapes = tree_map(lambda t: tuple(t.shape),
                              opt_init(_meta(param_shapes)))
        opt_specs = tree_pspecs(opt_shapes, opt_state_logical_axes(
            cfg, param_axes, param_shapes), mesh, rules)
    cache_specs = None if cache is None else tree_pspecs(*cache, mesh, rules)
    return Layout(mesh, rules, param_specs, batch_axes, opt_specs,
                  opt_shapes, tuple(keep), cache_specs)


def make_train_cell(arch_name: str, shape_name: str, *,
                    loss_fn: Callable, optimizer: str = "adafactor",
                    layout: Layout | None = None) -> Cell:
    """fwd + bwd + optimizer update — the full per-step training work.

    ``loss_fn(params, batch)`` gives a scalar loss (or a tuple whose
    first item is one).  The cell's ``fn(state, batch)`` takes ``state =
    {"step", "params", "opt"}`` (:func:`init_train_state`), updates it in
    place and returns ``(state, {"loss", "grad_norm"})``, the grad norm
    taken before clipping to ``OptimizerConfig.grad_clip``.  With a
    ``layout`` the state holds this rank's slices and ``batch`` is the
    global batch; the loss is the data-axis mean of the ranks' losses.
    """
    opt_cfg = _opt_config(optimizer)
    _, opt_update = make_optimizer(opt_cfg)

    if layout is not None:
        lay = layout

        def meshed_step(state, batch):
            mesh = lay.mesh
            local = batch_shard(batch, batch_specs(
                batch, lay.batch_axes, mesh, lay.rules), mesh)
            loss, _, grads, full = meshed_grads(
                loss_fn, state["params"], lay.param_specs, local, mesh,
                lay.keep)
            grads, gnorm = clip_local(grads, lay.param_specs, mesh,
                                      opt_cfg.grad_clip, lay.keep)
            update_local(opt_cfg, opt_update, grads, state["opt"],
                         state["params"], state["step"], lay.param_specs,
                         lay.opt_specs, mesh, full, lay.keep)
            state["step"] = state["step"] + 1
            return state, {"loss": loss, "grad_norm": gnorm}

        return Cell(arch_name, shape_name, "train", meshed_step, optimizer,
                    layout)

    def step(state, batch):
        params = state["params"]
        named = flatten(params)
        # detached leaves that require grad (views of the same storage),
        # so the state's tensors carry no autograd history
        leaves = [p.detach().requires_grad_(True) for _, p in named]
        out = loss_fn(unflatten(params, leaves), batch)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        opt_update(grads, state["opt"], params, state["step"])
        state["step"] = state["step"] + 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return Cell(arch_name, shape_name, "train", step, optimizer)


def make_infer_cell(arch_name: str, shape_name: str, kind: str,
                    fn: Callable, layout: Layout | None = None,
                    out_axes: Any = None) -> Cell:
    """An inference cell: ``fn(params, batch)`` without gradients.  With
    a ``layout``, ``params`` are this rank's slices: the cell gathers
    them, runs ``fn`` on this rank's rows of ``batch`` and gathers the
    output's rows over the data axes where ``out_axes`` (one logical
    axis for dim 0 of each output leaf) shards them."""
    if layout is None:
        return Cell(arch_name, shape_name, kind, fn)
    lay = layout

    def meshed(params, batch):
        mesh = lay.mesh
        with torch.no_grad():
            specs = batch_specs(batch, lay.batch_axes, mesh, lay.rules)
            full = gather_tree(params, lay.param_specs, mesh, lay.keep)
            out = fn(full, batch_shard(batch, specs, mesh))
            return gather_out(out, out_axes, batch, specs, mesh)

    return Cell(arch_name, shape_name, kind, meshed, layout=layout)


def gather_out(out, out_axes, batch, specs, mesh):
    """Rows of ``out`` gathered over the axes that split dim 0 of the
    batch leaf ``out_axes`` names."""
    axes = () if out_axes is None else spec_axes(specs[out_axes][0])
    if not axes:
        return out
    return collectives.all_gather(out, mesh, axes, dim=0)


def init_train_state(cell_or_optimizer: Cell | str, params) -> dict:
    """The state a train cell steps (the reference's ``abs_state``):
    step 0 (an int32 0-d tensor on the host), ``params`` themselves (the
    cell updates them in place) and the optimizer's zero state on their
    devices.  For a cell with a layout, ``params`` are the full
    parameters and the state holds this rank's slices of them and of the
    optimizer state."""
    cell = cell_or_optimizer if isinstance(cell_or_optimizer, Cell) else None
    name = cell.optimizer if cell is not None else cell_or_optimizer
    if cell is not None and cell.layout is not None:
        lay = cell.layout
        device = next(iter(t for _, t in flatten(params))).device
        return {"step": torch.zeros((), dtype=torch.int32),
                "params": cell.local_params(params),
                "opt": local_zeros(lay.opt_shapes, lay.opt_specs, lay.mesh,
                                   device)}
    opt_init, _ = make_optimizer(_opt_config(name))
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "opt": opt_init(params)}

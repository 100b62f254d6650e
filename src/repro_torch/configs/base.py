"""Cells: an architecture's step for one input shape, and the train step.

The counterpart of ``repro.configs.base`` (``Cell``, ``make_train_cell``)
for one card.  A :class:`Cell` bundles the step function the card runs;
the reference's abstract arguments and ``jit_kwargs`` have no
counterpart, since torch runs eagerly.  :func:`make_train_cell` is the
full per-step training work: forward, loss, backward, global-norm clip,
optimizer update.  The update writes the parameters and the optimizer
state in place under ``no_grad``, the port's counterpart of the
reference's ``donate_argnums=(0,)``.  There is no mesh: a mesh (sharded
parameters, ``ShardCtx``) raises, as ``recsys.forward`` does (ROADMAP
queue 1 items 4a, 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.training.optimizer import (OptimizerConfig,
                                            clip_by_global_norm,
                                            make_optimizer)
from repro_torch.training.tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                       # train | encode | serve | retrieval
    fn: Callable                    # fn(params, batch); train: (state, batch)
    optimizer: str = ""             # train cells: the optimizer's name


def _opt_config(optimizer: str) -> OptimizerConfig:
    return OptimizerConfig(name=optimizer, learning_rate=1e-3)


def make_train_cell(arch_name: str, shape_name: str, *,
                    loss_fn: Callable, optimizer: str = "adafactor",
                    mesh=None) -> Cell:
    """fwd + bwd + optimizer update — the full per-step training work.

    ``loss_fn(params, batch)`` gives a scalar loss (or a tuple whose
    first item is one).  The cell's ``fn(state, batch)`` takes ``state =
    {"step", "params", "opt"}`` (:func:`init_train_state`), updates it in
    place and returns ``(state, {"loss", "grad_norm"})``, the grad norm
    taken before clipping to ``OptimizerConfig.grad_clip``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the port runs on one card: a mesh (sharded parameters and "
            "optimizer state) is not ported yet")
    opt_cfg = _opt_config(optimizer)
    _, opt_update = make_optimizer(opt_cfg)

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


def init_train_state(cell_or_optimizer: Cell | str, params) -> dict:
    """The state a train cell steps (the reference's ``abs_state``):
    step 0 (an int32 0-d tensor on the host), ``params`` themselves (the
    cell updates them in place) and the optimizer's zero state on their
    devices."""
    name = (cell_or_optimizer.optimizer
            if isinstance(cell_or_optimizer, Cell) else cell_or_optimizer)
    opt_init, _ = make_optimizer(_opt_config(name))
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "opt": opt_init(params)}

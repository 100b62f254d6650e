"""Optimizers in plain torch: AdamW + Adafactor (factored second moment).

The port of ``repro.training.optimizer``, with the same functional API
over nested-dict parameter trees: ``init(params) -> state`` and
``update(grads, state, params, step) -> (params, state)``.  ``update``
runs under ``torch.no_grad()`` and writes the parameters and the state
in place (the returned trees are the ones passed in).

Numerics follow the reference op for op: the schedule and the bias
corrections are float32 tensors computed from an int32 ``step`` tensor
(``(step + 1)`` as float32, ``b1 ** t``), not Python doubles; each update
is computed in float32 and cast back to the parameter's dtype; and
:func:`clip_by_global_norm` casts the clipped gradient back to the
gradient's dtype (bf16 at trove-base) before the update, as the
reference does.  The schedule and corrections are 0-d CPU tensors, which
torch applies to tensors on any device.

The clip and the updates work in place, one leaf at a time, so that at
most two float32 copies of a leaf are alive beside its state: a clipped
gradient is written back into the gradient's own tensor, and each
update's products are taken into buffers the update owns.  Every element
sees the same operations in the same order as the out-of-place form
(``a * x + b * y`` is ``x.mul_(a)`` then ``add_`` of ``y * b``, never one
fused op), so the results are the same bits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.training.tree import flatten, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 0
    total_steps: int = 0            # >0: cosine decay to 10%
    grad_clip: float = 1.0
    # adafactor
    min_dim_size_to_factor: int = 128


def _step_tensor(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32).cpu()


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (int32): linear warmup, then cosine
    decay to 10 % over ``total_steps``; a float32 0-d tensor."""
    step = _step_tensor(step)
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32)
    if cfg.warmup_steps > 0:
        lr = lr * torch.minimum(torch.tensor(1.0),
                                (step + 1) / cfg.warmup_steps)
    if cfg.total_steps > 0:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
        lr = lr * (0.55 + 0.45 * torch.cos(math.pi * frac))
    return lr


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, each cast back to its
    dtype; the float32 global norm before clipping).  The scaled leaves
    are written into ``grads``' own tensors, which are returned."""
    gs = leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.minimum(torch.tensor(1.0, device=gn.device),
                          max_norm / torch.clamp_min(gn, 1e-9))
    for g in gs:
        # a float32 leaf is scaled in place; another dtype through one
        # float32 copy, rounded back by the copy
        g.copy_(g.float().mul_(scale))
    return grads, gn


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t`` the caller may overwrite."""
    return t.to(torch.float32, copy=True)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(cfg: OptimizerConfig, params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params, step):
    step = _step_tensor(step)
    lr = schedule(cfg, step)
    t = (step + 1).float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for g, mu, nu, p in zip(leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"]), leaves(params)):
        # mu = b1 * mu + (1 - b1) * g;  nu = b2 * nu + (1 - b2) * g * g
        t = _f32_copy(g).mul_(1 - cfg.b1)
        mu.mul_(cfg.b1).add_(t)
        t.copy_(g).mul_(1 - cfg.b2).mul_(g)
        nu.mul_(cfg.b2).add_(t)
        # u = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p
        u = torch.div(mu, c1)
        torch.div(nu, c2, out=t).sqrt_().add_(cfg.eps)
        u.div_(t)
        u.add_(t.copy_(p).mul_(cfg.weight_decay))
        # p = p - lr * u, rounded to p's dtype
        p.copy_(t.copy_(p).sub_(u.mul_(lr)))
        del t, u
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) — factored second moment, no momentum:
# O(n + m) state for an (n, m) matrix.
# ---------------------------------------------------------------------------

def _factored(cfg: OptimizerConfig, shape) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def adafactor_init(cfg: OptimizerConfig, params) -> dict:
    def make(p):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(cfg, p.shape):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}

    return {"v": tree_map(make, params)}


def _state_at(tree: dict, path: str) -> dict:
    for key in path.split("/"):
        tree = tree[key]
    return tree


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state, params, step):
    step = _step_tensor(step)
    lr = schedule(cfg, step)
    b2 = 1.0 - (step + 1.0) ** -0.8          # decaying beta2 (paper)
    eps = 1e-30
    for (path, p), g in zip(flatten(params), leaves(grads)):
        v = _state_at(state["v"], path)
        u = _f32_copy(g)
        t = (u * u).add_(eps)                       # g2 = g * g + eps
        if "vr" in v:
            v["vr"].copy_(b2 * v["vr"] + (1 - b2) * t.mean(-1))
            v["vc"].copy_(b2 * v["vc"] + (1 - b2) * t.mean(-2))
            del t
            vr, vc = v["vr"], v["vc"]
            t = (vr[..., None] / vr.mean(-1, keepdim=True)[..., None]
                 * vc[..., None, :]).sqrt_()
        else:
            v["v"].mul_(b2).add_(t.mul_(1 - b2))
            t = torch.sqrt(v["v"], out=t)
        u.div_(t.clamp_min_(1e-30))                 # u = g / denom
        # update clipping (RMS(u) <= 1)
        rms_u = torch.sqrt(torch.mul(u, u, out=t).mean() + 1e-30)
        u.div_(torch.clamp_min(rms_u, 1.0))
        u.add_(t.copy_(p).mul_(cfg.weight_decay))
        p.copy_(t.copy_(p).sub_(u.mul_(lr)))
        del t, u
    return params, state


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return (lambda p: adamw_init(cfg, p),
                lambda g, s, p, t: adamw_update(cfg, g, s, p, t))
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(cfg, p),
                lambda g, s, p, t: adafactor_update(cfg, g, s, p, t))
    raise ValueError(cfg.name)


def adafactor_entries(entries, factored: bool) -> dict:
    """A parameter's Adafactor state entries from its own (logical axes or
    spec entries): a factored leaf's ``vr`` drops the last and its ``vc``
    the one before it; an unfactored leaf's ``v`` keeps them all.

    The reference applies this to logical axes and resolves them in its
    cells (``configs.base._opt_shardings``) and to resolved specs in its
    trainer (``RetrievalTrainer.state_shardings``).  The two differ where
    the dropped dimension held a mesh axis that a kept one then takes: an
    LM's ``embed`` ``vc`` (its vocabulary dimension holds "model", so its
    spec is ("model", None); ``vc`` re-resolved is ("model",), dropped
    from the spec (None,))."""
    entries = tuple(entries)
    if factored:
        return {"vr": entries[:-1], "vc": entries[:-2] + entries[-1:]}
    return {"v": entries}


def opt_state_logical_axes(cfg: OptimizerConfig, param_axes,
                           param_shapes=None):
    """Optimizer-state logical axes mirroring the parameters (ZeRO-3).

    AdamW: ``{"mu": param_axes, "nu": param_axes}``.  Adafactor: without
    ``param_shapes``, ``{"v": param_axes}`` (the reference's value: which
    leaves factor depends on their shapes); with the parameters' shapes
    (a tree of tuples or tensors), each leaf resolved against them: a
    factored leaf's ``vr`` drops the last axis and its ``vc`` the one
    before it, an unfactored leaf keeps ``v``."""
    if cfg.name == "adamw":
        return {"mu": param_axes, "nu": param_axes}
    if param_shapes is None:
        return {"v": param_axes}

    def make(axes, shape):
        shape = tuple(shape.shape) if hasattr(shape, "shape") else shape
        return adafactor_entries(axes, _factored(cfg, shape))

    return {"v": tree_map(make, param_axes, param_shapes)}


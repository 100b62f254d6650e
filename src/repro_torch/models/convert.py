"""Carry the reference package's parameters across to the port.

``params_from_jax`` (encoder) and ``recsys_params_from_jax`` (recsys
rankers) take ``repro``'s parameter pytree with numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``) and return the port's parameter
dict: same keys, same shapes, tensors of ``cfg.dtype`` on ``device``.
Both packages then compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import recsys
from repro_torch.models.transformer import LMConfig, Params, param_shapes


def _convert(expect: dict, got: dict, where: str, dtype: torch.dtype,
             dev: torch.device) -> Params:
    """Raises if a key is missing or extra, or a shape differs."""
    if set(expect) != set(got):
        raise ValueError(
            f"{where}: keys {sorted(got)} != expected {sorted(expect)}")
    out: Params = {}
    for name, shape in expect.items():
        if isinstance(shape, dict):
            out[name] = _convert(shape, got[name], f"{where}{name}.", dtype,
                                 dev)
            continue
        arr = np.asarray(got[name])
        if arr.shape != tuple(shape):
            raise ValueError(f"{where}{name}: shape {arr.shape} != "
                             f"expected {tuple(shape)}")
        # through float32: numpy has no bfloat16 that torch reads, and
        # every bf16/f16/f32 value is exact in float32
        out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=dtype)
    return out


def params_from_jax(tree: dict, cfg: LMConfig,
                    device: str | torch.device = "cuda") -> Params:
    """Reference encoder parameter pytree (numpy leaves) -> the port's
    params."""
    return _convert(param_shapes(cfg), tree, "", cfg.dtype,
                    resolve_device(device))


def recsys_params_from_jax(tree: dict, cfg: recsys.RecSysConfig,
                           device: str | torch.device = "cuda"
                           ) -> recsys.Params:
    """Reference recsys parameter dict (numpy leaves) -> the port's
    params."""
    return _convert(recsys.param_shapes(cfg), tree, "", cfg.dtype,
                    resolve_device(device))

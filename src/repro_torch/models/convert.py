"""Carry the reference package's encoder parameters across to the port.

``params_from_jax`` takes ``repro``'s parameter pytree with numpy leaves
(e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: same keys, same shapes, tensors of ``cfg.dtype`` on
``device``.  Both packages then compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import LMConfig, Params, param_shapes


def params_from_jax(tree: dict, cfg: LMConfig,
                    device: str | torch.device = "cuda") -> Params:
    """Reference parameter pytree (numpy leaves) -> the port's params.

    Raises if a key is missing or extra, or a shape differs from what
    ``cfg`` expects.
    """
    dev = resolve_device(device)

    def convert(expect: dict, got: dict, where: str) -> Params:
        if set(expect) != set(got):
            raise ValueError(
                f"{where}: keys {sorted(got)} != expected {sorted(expect)}")
        out: Params = {}
        for name, shape in expect.items():
            if isinstance(shape, dict):
                out[name] = convert(shape, got[name], f"{where}{name}.")
                continue
            arr = np.asarray(got[name])
            if arr.shape != shape:
                raise ValueError(f"{where}{name}: shape {arr.shape} != "
                                 f"expected {shape}")
            # through float32: numpy has no bfloat16 that torch reads, and
            # every bf16/f16/f32 value is exact in float32
            out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
                    device=dev, dtype=cfg.dtype)
        return out

    return convert(param_shapes(cfg), tree, "")

"""Carry the reference package's parameters across to the port.

``params_from_jax`` (encoder), ``recsys_params_from_jax`` (recsys
rankers) and ``gnn_params_from_jax`` (GraphSAGE) take ``repro``'s
parameter pytree with numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``) and return the port's parameter
dict: same keys, same shapes, tensors of ``cfg.dtype`` on ``device``.
Both packages then compute the same function.  ``cache_from_jax`` carries
a reference KV cache across in the middle of a sequence (``k`` / ``v``
of (L, B, S, K, hd) and ``len``), and ``cache_to_numpy`` gives it back,
so a decode can continue in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import gnn, recsys
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


def gnn_params_from_jax(tree: dict, cfg: gnn.SAGEConfig,
                        device: str | torch.device = "cuda") -> gnn.Params:
    """Reference GraphSAGE parameter dict (numpy leaves) -> the port's
    params."""
    return _convert(gnn.param_shapes(cfg), tree, "", cfg.dtype,
                    resolve_device(device))


def cache_from_jax(tree: dict, cfg: LMConfig,
                   device: str | torch.device = "cuda") -> Params:
    """Reference KV cache (numpy leaves: ``k`` / ``v`` (L, B, S, K, hd),
    ``len`` 0-d) -> the port's cache: ``k`` / ``v`` in ``cfg.dtype`` and
    ``len`` a 0-d int32 tensor, on ``device``."""
    dev = resolve_device(device)
    if set(tree) != {"k", "v", "len"}:
        raise ValueError(f"cache keys {sorted(tree)} != ['k', 'len', 'v']")
    out: Params = {}
    for name in ("k", "v"):
        arr = np.asarray(tree[name])
        if (arr.ndim != 5 or arr.shape[0] != cfg.n_layers
                or arr.shape[3:] != (cfg.n_kv_heads, cfg.head_dim)
                or arr.shape != np.shape(tree["k"])):
            raise ValueError(
                f"cache {name}: shape {arr.shape} is not (L={cfg.n_layers}"
                f", B, S, K={cfg.n_kv_heads}, hd={cfg.head_dim})")
        out[name] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=cfg.dtype)
    length = np.asarray(tree["len"])
    if length.shape != ():
        raise ValueError(f"cache len: shape {length.shape} != ()")
    out["len"] = torch.tensor(int(length), dtype=torch.int32, device=dev)
    return out


def cache_to_numpy(cache: Params) -> dict:
    """The port's KV cache -> numpy leaves in the reference's layout:
    ``k`` / ``v`` as float32 (exact for bf16, f16 and f32 values; numpy
    has no bfloat16) and ``len`` a 0-d int32 array."""
    return {"k": cache["k"].detach().float().cpu().numpy(),
            "v": cache["v"].detach().float().cpu().numpy(),
            "len": np.asarray(int(cache["len"]), dtype=np.int32)}

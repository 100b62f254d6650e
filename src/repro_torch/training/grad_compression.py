"""Gradient compression: the one-card part of
``repro.training.grad_compression``.

``int8`` is per-tensor symmetric quantization with error-feedback
residuals (EF-SGD): the quantization error is carried to the next step.
The trainer keeps the residuals in ``state["ef"]`` when
``grad_compression == "int8"``, as the reference does even without a
mesh.  The compressed all-reduce across cards (``compressed_psum``)
comes with the multi-card work (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.training.tree import tree_map


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

"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``:
the port runs on the card unless the caller asks for the CPU.  Where no
CUDA device is present and the caller did not pass ``device="cpu"``,
:func:`resolve_device` raises — there is no silent CPU fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable.

    A CUDA device also switches TF32 off for matrix products and
    convolutions (:func:`require_full_f32`).
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    require_full_f32()
    return dev


def require_full_f32() -> None:
    """Turn TF32 off for float32 products on the card.

    The streaming top-k must select from full-precision float32 scores:
    the fused kernel sums each dot product in float32 FMAs, and the
    ``torch`` score path is held bitwise against the kernel merge, so a
    TF32 product (about three decimal digits) would reorder near-ties
    and break both parities.  ``torch.backends.cuda.matmul`` already
    defaults to False, cuDNN does not; both are set explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

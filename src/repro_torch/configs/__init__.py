"""Architecture registry: name -> the port's Arch object.

The LM encoders (``LMArch``: trove-base, qwen2-0.5b, stablelm-3b,
gemma-7b, and the MoE stacks granite-moe-3b-a800m and
llama4-maverick-400b-a17b) and the four recsys rankers (``RecSysArch``)
of ``repro.configs``.  The reference's GNN architecture is not ported
yet: naming it raises, with its ROADMAP queue 1 item.
"""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "gemma-7b": "gemma_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen2-0.5b": "qwen2_0_5b",
    "stablelm-3b": "stablelm_3b",
    "bst": "bst",
    "autoint": "autoint",
    "deepfm": "deepfm",
    "wide-deep": "wide_deep",
    "trove-base": "trove_base",
}

# the reference's other architectures, and the item that brings each
NOT_PORTED = {
    "graphsage-reddit": ("8d", "the GNN family"),
}


def get_arch(name: str):
    if name in NOT_PORTED:
        item, what = NOT_PORTED[name]
        raise NotImplementedError(
            f"arch {name!r} needs {what}, which the port does not have yet "
            f"(ROADMAP queue 1 item 8, {item})")
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.get_arch()

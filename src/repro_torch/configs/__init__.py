"""Architecture registry: name -> the port's Arch object.

Every architecture of ``repro.configs``: the LM encoders (``LMArch``:
trove-base, qwen2-0.5b, stablelm-3b, gemma-7b, and the MoE stacks
granite-moe-3b-a800m and llama4-maverick-400b-a17b), the four recsys
rankers (``RecSysArch``) and the GNN, graphsage-reddit (``GNNArch``).
"""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "gemma-7b": "gemma_7b",
    "graphsage-reddit": "graphsage_reddit",
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


# the reference's dry-run architectures, in its order (trove-base is not
# one of its cells)
ARCH_NAMES = ["gemma-7b", "qwen2-0.5b", "stablelm-3b",
              "granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
              "graphsage-reddit", "bst", "autoint", "deepfm", "wide-deep"]


def get_arch(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.get_arch()


def all_cells() -> list[tuple[str, str]]:
    """The 40 (arch x shape) cells of the reference's dry run, in its
    order."""
    return [(name, shape) for name in ARCH_NAMES
            for shape in get_arch(name).shape_names()]

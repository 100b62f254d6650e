"""Architecture registry: name -> the port's Arch object.

The four recsys architectures of ``repro.configs`` (the retrieval
encoder's config is ``repro_torch.configs.trove_base.get_config()``).
"""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "bst": "bst",
    "autoint": "autoint",
    "deepfm": "deepfm",
    "wide-deep": "wide_deep",
}


def get_arch(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.get_arch()

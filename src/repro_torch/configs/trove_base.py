"""trove-base: the paper's default retrieval encoder (mean pooling), the
default architecture of the reference's serve and eval launchers.

12 layers, d_model 768, 12 heads x 64, d_ff 3072, vocab 50304, a
non-gated GELU FFN, LayerNorm with biases, bfloat16, each layer
checkpointed in training (``remat``): about 124 M parameters.  The same
fields as ``repro.configs.trove_base``.  :func:`reduced` is the
smoke-test size of the reference's ``LMArch.reduced()``.
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="trove-base", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=50304,
        activation="gelu", norm="layernorm", pooling="mean",
        dtype=torch.bfloat16, remat=True)


def reduced() -> LMConfig:
    """trove-base cut to 2 layers of width 64 (4 heads x 16, 4 KV heads,
    d_ff 128, vocab 512) in float32, as the reference's
    ``get_arch("trove-base").reduced()`` with its dtype set to
    float32 (``launch.serve --smoke``)."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

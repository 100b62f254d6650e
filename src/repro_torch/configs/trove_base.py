"""trove-base: the paper's default retrieval encoder (mean pooling), the
default architecture of the reference's serve and eval launchers.

12 layers, d_model 768, 12 heads x 64, d_ff 3072, vocab 50304, a
non-gated GELU FFN, LayerNorm with biases, bfloat16: about 124 M
parameters.  The same fields as ``repro.configs.trove_base``.
"""

import torch

from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="trove-base", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=50304,
        activation="gelu", norm="layernorm", pooling="mean",
        dtype=torch.bfloat16)

"""gemma-7b: 28 layers, d_model 3072, 16 heads x 256 (16 KV heads; h x hd =
4096 is not d_model), d_ff 24,576, vocab 256,000, GeGLU, RMSNorm, the
embedding scaled by sqrt(d_model) in bfloat16, last-token pooling,
attention in query chunks of 4096, each layer checkpointed in training
(``remat``): about 8.54 B parameters.  The same fields as
``repro.configs.gemma_7b`` (arXiv:2403.08295; the reference's mesh and
compile knobs have no counterpart, see ``models.transformer``).
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
        n_kv_heads=16, head_dim=256, d_ff=24576, vocab_size=256000,
        activation="geglu", norm="rmsnorm", rope_theta=10000.0,
        pooling="last", dtype=torch.bfloat16, attn_chunk=4096, remat=True)


def reduced() -> LMConfig:
    """The reference's ``get_arch("gemma-7b").reduced().cfg``: 2 x 64, 4
    heads x 16 (4 KV heads), float32."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

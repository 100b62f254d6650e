"""stablelm-3b: 32 layers, d_model 2560, 32 heads x 80 (32 KV heads), d_ff
6912, vocab 50,304, SwiGLU, LayerNorm with biases, last-token pooling,
bfloat16, attention in query chunks of 4096, each layer checkpointed in
training (``remat``): about 2.67 B parameters.  The same fields as
``repro.configs.stablelm_3b`` (the reference's mesh and compile knobs
have no counterpart, see ``models.transformer``).
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, head_dim=80, d_ff=6912, vocab_size=50304,
        activation="swiglu", norm="layernorm", rope_theta=10000.0,
        pooling="last", dtype=torch.bfloat16, attn_chunk=4096, remat=True)


def reduced() -> LMConfig:
    """The reference's ``get_arch("stablelm-3b").reduced().cfg``: 2 x 64,
    4 heads x 16 (4 KV heads), float32."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

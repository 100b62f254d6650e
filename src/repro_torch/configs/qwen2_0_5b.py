"""qwen2-0.5b: 24 layers, d_model 896, 14 heads x 64 over 2 KV heads (GQA,
groups of 7), d_ff 4864, vocab 151,936, SwiGLU, RMSNorm, QKV biases,
RoPE theta 1e6, last-token pooling, bfloat16, attention in query chunks
of 4096, each layer checkpointed in training (``remat``): about 494 M
parameters.  The same fields as ``repro.configs.qwen2_0_5b``
(arXiv:2407.10671; the reference's mesh and compile knobs have no
counterpart, see ``models.transformer``).
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151936,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1000000.0, pooling="last", dtype=torch.bfloat16,
        attn_chunk=4096, remat=True)


def reduced() -> LMConfig:
    """The reference's ``get_arch("qwen2-0.5b").reduced().cfg``: 2 x 64,
    4 heads x 16 over 2 KV heads, float32."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

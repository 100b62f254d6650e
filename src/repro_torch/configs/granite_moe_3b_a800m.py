"""granite-moe-3b-a800m: 32 layers, d_model 1536, 24 heads x 64 over 8 KV
heads (GQA, groups of 3), every layer MoE: 40 experts of width 512, top-8
routing at capacity factor 1.25, vocab 49,155, SwiGLU, RMSNorm,
last-token pooling, bfloat16, attention in query chunks of 4096, each
layer checkpointed in training (``remat``): 3,298,793,472 parameters,
882,874,368 of them active a token.  The same fields as
``repro.configs.granite_moe_3b_a800m`` (the reference's mesh and compile
knobs have no counterpart, see ``models.transformer``).
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
        activation="swiglu", norm="rmsnorm", moe=True, n_experts=40,
        top_k=8, moe_every=1, moe_d_ff=512, capacity_factor=1.25,
        pooling="last", dtype=torch.bfloat16, attn_chunk=4096, remat=True)


def reduced() -> LMConfig:
    """The reference's ``get_arch("granite-moe-3b-a800m").reduced().cfg``:
    2 x 64, 4 heads x 16 over 2 KV heads, 8 experts of width 32, top-2,
    float32."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

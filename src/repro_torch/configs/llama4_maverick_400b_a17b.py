"""llama4-maverick-400b-a17b: 48 layers, d_model 5120, 40 heads x 128 over
8 KV heads (GQA, groups of 5), dense and MoE layers interleaved (dense
first): the dense FFN of width 8192, the MoE 128 experts of width 8192,
top-1 routing at capacity factor 1.25 plus one shared expert; vocab
202,048, SwiGLU, RMSNorm, last-token pooling, bfloat16, attention in
query chunks of 1024, each layer checkpointed in training (``remat``):
396,657,464,320 parameters, 13,130,306,560 of them active a token.  The
same fields as ``repro.configs.llama4_maverick_400b_a17b`` (the
reference's mesh and compile knobs have no counterpart, see
``models.transformer``).

Its bf16 weights are 739 GiB, past one card: at full width it needs a
device mesh across cards (ROADMAP queue 1 item 10), and the launchers
refuse it before anything is allocated.  One card holds its published
width at a cut depth, or its ``reduced()`` form.
"""

import torch

from repro_torch.configs.lm_arch import LMArch, reduced_config
from repro_torch.models.transformer import LMConfig


def get_config() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=202048, activation="swiglu", norm="rmsnorm", moe=True,
        n_experts=128, top_k=1, moe_every=2, n_shared_experts=1,
        moe_d_ff=8192, capacity_factor=1.25, pooling="last",
        dtype=torch.bfloat16, attn_chunk=1024, remat=True)


def reduced() -> LMConfig:
    """The reference's
    ``get_arch("llama4-maverick-400b-a17b").reduced().cfg``: one dense
    and one MoE layer of width 64, 4 heads x 16 over 2 KV heads, 8
    experts of width 32, top-1, a shared expert, float32."""
    return reduced_config(get_config())


def get_arch() -> LMArch:
    return LMArch(get_config())

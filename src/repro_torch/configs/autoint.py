"""autoint: 39 sparse fields, embed_dim=16, 3 self-attention layers,
2 heads, d_attn=32 [arXiv:1810.11921].  The same fields as
``repro.configs.autoint``."""
from repro_torch.configs.recsys_arch import RecSysArch
from repro_torch.models.recsys import RecSysConfig

# criteo-like 39-field layout, ~34.3M total rows
_VOCABS = ((2**24, 2**23, 2**22, 2**22) + (2**16,) * 10 + (2**12,) * 25)


def get_arch() -> RecSysArch:
    return RecSysArch(RecSysConfig(
        name="autoint", kind="autoint", vocab_sizes=_VOCABS, embed_dim=16,
        n_attn_layers=3, n_heads=2, d_attn=32))

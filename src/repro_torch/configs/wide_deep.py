"""wide-deep: 40 sparse fields, embed_dim=32, MLP 1024-512-256, wide
linear + deep concat interaction [arXiv:1606.07792].  34,377,728 table
rows.  The same fields as ``repro.configs.wide_deep``."""
from repro_torch.configs.recsys_arch import RecSysArch
from repro_torch.models.recsys import RecSysConfig

_VOCABS = ((2**24, 2**23, 2**22, 2**22) + (2**16,) * 11 + (2**12,) * 25)


def get_arch() -> RecSysArch:
    return RecSysArch(RecSysConfig(
        name="wide-deep", kind="wide_deep", vocab_sizes=_VOCABS,
        embed_dim=32, mlp_dims=(1024, 512, 256)))

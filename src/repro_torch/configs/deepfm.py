"""deepfm: 39 sparse fields, embed_dim=10, MLP 400-400-400, FM
interaction [arXiv:1703.04247].  34,312,192 table rows.  The same fields
as ``repro.configs.deepfm``."""
from repro_torch.configs.recsys_arch import RecSysArch
from repro_torch.models.recsys import RecSysConfig

_VOCABS = ((2**24, 2**23, 2**22, 2**22) + (2**16,) * 10 + (2**12,) * 25)


def get_arch() -> RecSysArch:
    return RecSysArch(RecSysConfig(
        name="deepfm", kind="deepfm", vocab_sizes=_VOCABS, embed_dim=10,
        mlp_dims=(400, 400, 400)))

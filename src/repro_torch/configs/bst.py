"""bst: Behavior Sequence Transformer (Alibaba), embed_dim=32,
seq_len=20, 1 block, 8 heads, MLP 1024-512-256 [arXiv:1905.06874].  The
same fields as ``repro.configs.bst``."""
from repro_torch.configs.recsys_arch import RecSysArch
from repro_torch.models.recsys import RecSysConfig

# item table 4.2M rows + 8 profile fields
_VOCABS = (4_194_304,) + (1024,) * 8


def get_arch() -> RecSysArch:
    return RecSysArch(RecSysConfig(
        name="bst", kind="bst", vocab_sizes=_VOCABS, embed_dim=32,
        mlp_dims=(1024, 512, 256), seq_len=20, n_profile_fields=8,
        bst_d_ff=64))

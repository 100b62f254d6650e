"""graphsage-reddit: 2 layers, d_hidden=128, mean aggregator,
fanouts 25-10 [arXiv:1706.02216; paper]."""
from repro_torch.configs.gnn_arch import GNNArch
from repro_torch.models.gnn import SAGEConfig


def get_arch() -> GNNArch:
    return GNNArch(SAGEConfig(
        name="graphsage-reddit", n_layers=2, d_feat=602, d_hidden=128,
        aggregator="mean", fanouts=(25, 10)))

"""GNN cells: GraphSAGE (architecture x input shape) -> a train step.

The counterpart of ``repro.configs.base.GNNArch``: the unsupervised
GraphSAGE objective (InfoNCE over anchor · positive scores ÷ 0.07, in-batch
negatives, labels ``arange``) in its three modes — ``full`` (one graph,
the anchor and positive rows of ``pairs`` gathered from its node
embeddings), ``minibatch`` (sampled fixed-fanout blocks) and ``batched``
(small graphs, anchor and positive views) — through
``configs.base.make_train_cell`` with AdamW.  A full graph's batch may
carry its neighbour table under ``"table"`` (``gnn.neighbor_table`` of
its edges, built once by the caller), so K4ᵀ sorts the graph's ids once,
not once a step; without one the step builds it.  The batched graphs
come new every step, so each step builds its views' tables.  The
``pairs`` rows come through K4 too (``gnn.gather_rows``), so their
gradient adds repeated rows in a fixed order.

:meth:`GNNArch.smoke_inputs` draws, from a numpy generator, the same
values in the same order as the reference's; from a ``torch.Generator``
it draws inputs of the same shapes and ranges on the generator's device
(a full-size ogb_products batch is 0.98 GB of features).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import Cell, make_train_cell
from repro_torch.device import resolve_device
from repro_torch.models import gnn
from repro_torch.models.losses import InfoNCELoss
from repro_torch.sharding.partitioning import AxisRules

# the score temperature of the reference's loss
TEMPERATURE = 0.07

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", mode="full", n_nodes=2708,
                          n_edges=10556, d_feat=1433, n_pairs=1024),
    "minibatch_lg": dict(kind="train", mode="minibatch", batch_nodes=1024,
                         fanouts=(15, 10), d_feat=602),
    "ogb_products": dict(kind="train", mode="full", n_nodes=2449029,
                         n_edges=61859140, d_feat=100, n_pairs=8192),
    "molecule": dict(kind="train", mode="batched", n_graphs=128,
                     n_nodes=30, n_edges=64, d_feat=64),
}


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class GNNArch:
    family = "gnn"

    def __init__(self, cfg: gnn.SAGEConfig, shapes: dict | None = None,
                 pad: int = 512):
        self.cfg = cfg
        self.name = cfg.name
        self.shapes = shapes or GNN_SHAPES
        self.pad = pad

    def shape_names(self) -> list[str]:
        return list(self.shapes)

    def param_shapes(self, shape_name: str | None = None
                     ) -> dict[str, tuple[int, ...]]:
        cfg = self.cfg if shape_name is None else self.shape_cfg(shape_name)
        return gnn.param_shapes(cfg)

    def shape_cfg(self, shape_name: str) -> gnn.SAGEConfig:
        """Per-shape config: the input feature width is dataset-specific."""
        return dataclasses.replace(
            self.cfg, d_feat=self.shapes[shape_name]["d_feat"])

    def _batch_shapes(self, shape_name: str) -> dict[str, tuple]:
        """Name -> (shape, int32?) of each input, in the reference's order
        (``smoke_inputs`` draws in this order).  A full graph's nodes and
        edges are padded to a multiple of ``pad`` (the padding nodes are
        isolated)."""
        spec = self.shapes[shape_name]
        if spec["mode"] == "full":
            n = round_up(spec["n_nodes"], self.pad)
            e = round_up(spec["n_edges"], self.pad)
            return {"x": ((n, spec["d_feat"]), False),
                    "edge_src": ((e,), True), "edge_dst": ((e,), True),
                    "pairs": ((spec["n_pairs"], 2), True)}
        if spec["mode"] == "minibatch":
            b, d = spec["batch_nodes"], spec["d_feat"]
            f1, f2 = spec["fanouts"]
            return {f"{side}{k}": (shape, False) for side in "ap"
                    for k, shape in (("0", (b, d)), ("1", (b, f1, d)),
                                     ("2", (b, f1, f2, d)))}
        g, n, e, d = (spec["n_graphs"], spec["n_nodes"], spec["n_edges"],
                      spec["d_feat"])
        return {f"{p}{k}": v for p in "ap" for k, v in (
            ("x", ((g, n, d), False)), ("edges", ((g, e, 2), True)),
            ("emask", ((g, e), True)), ("nmask", ((g, n), True)))}

    def axis_rules(self) -> AxisRules:
        return AxisRules()

    def param_logical_axes(self):
        return gnn.param_logical_axes(self.cfg)

    def _loss(self, mode: str, cfg: gnn.SAGEConfig):
        loss = InfoNCELoss()

        def contrast(za, zp):
            scores = za @ zp.T / TEMPERATURE
            return loss(scores, torch.arange(za.shape[0], device=za.device))

        if mode == "full":
            def full(params, batch):
                z = gnn.forward_full(cfg, params, batch["x"],
                                     batch["edge_src"], batch["edge_dst"],
                                     batch.get("table"))
                pairs = batch["pairs"]
                rows = gnn.gather_rows(z, pairs.T.reshape(-1))
                return contrast(rows[:pairs.shape[0]], rows[pairs.shape[0]:])

            return full

        if mode == "minibatch":
            def minibatch(params, batch):
                za, zp = (gnn.forward_minibatch(
                    cfg, params, batch[f"{s}0"], batch[f"{s}1"],
                    batch[f"{s}2"]) for s in "ap")
                return contrast(za, zp)

            return minibatch

        def batched(params, batch):
            def view(s):
                return gnn.forward_batched_graphs(
                    cfg, params, batch[f"{s}x"], batch[f"{s}edges"],
                    batch[f"{s}emask"], batch[f"{s}nmask"])

            return contrast(view("a"), view("p"))

        return batched

    def build_cell(self, shape_name: str, device: str | torch.device = "cuda",
                   mesh=None) -> Cell:
        """The train step of one shape: ``fn(state, batch)``, the state from
        ``configs.base.init_train_state`` over ``gnn.init_params`` of
        :meth:`shape_cfg` (``device`` is checked here and must hold a card
        unless it is ``"cpu"``).  A mesh raises: node-sharded neighbour
        sums are not ported yet (ROADMAP queue 1 item 10)."""
        if mesh is not None:
            raise NotImplementedError(
                "a mesh (node-sharded GNN inputs and neighbour sums) needs "
                "ROADMAP queue 1 item 10, which the port does not have yet")
        resolve_device(device)
        spec = self.shapes[shape_name]
        return make_train_cell(
            self.name, shape_name,
            loss_fn=self._loss(spec["mode"], self.shape_cfg(shape_name)),
            optimizer="adamw")

    def reduced(self) -> "GNNArch":
        """A small config of the same family, for CPU tests (the
        reference's ``reduced``)."""
        small = dataclasses.replace(self.cfg, d_hidden=16, d_feat=12)
        shapes = {
            "full_graph_sm": dict(kind="train", mode="full", n_nodes=64,
                                  n_edges=256, d_feat=12, n_pairs=16),
            "minibatch_lg": dict(kind="train", mode="minibatch",
                                 batch_nodes=8, fanouts=(3, 2), d_feat=12),
            "ogb_products": dict(kind="train", mode="full", n_nodes=128,
                                 n_edges=512, d_feat=12, n_pairs=32),
            "molecule": dict(kind="train", mode="batched", n_graphs=4,
                             n_nodes=6, n_edges=10, d_feat=12),
        }
        return GNNArch(small, shapes=shapes, pad=8)

    def smoke_inputs(self, shape_name: str,
                     rng: np.random.Generator | torch.Generator,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
        """Random inputs of one shape: node features N(0, 1), edge and pair
        ids uniform over the shape's ``n_nodes``, masks all ones.  From a
        numpy ``rng`` exactly the reference's values, drawn on the host;
        from a ``torch.Generator``, drawn on its device (the card's, for
        full-size inputs) and moved to ``device``."""
        dev = resolve_device(device)
        spec = self.shapes[shape_name]
        on_card = isinstance(rng, torch.Generator)
        out = {}
        for k, (shape, is_int) in self._batch_shapes(shape_name).items():
            if is_int and k.endswith("mask"):
                out[k] = torch.ones(shape, dtype=torch.int32, device=dev)
            elif is_int and on_card:
                out[k] = torch.randint(0, spec["n_nodes"], shape,
                                       generator=rng, device=rng.device,
                                       dtype=torch.int32).to(dev)
            elif is_int:
                out[k] = torch.from_numpy(rng.integers(
                    0, spec["n_nodes"], shape).astype(np.int32)).to(dev)
            elif on_card:
                out[k] = torch.randn(shape, generator=rng,
                                     device=rng.device).to(dev)
            else:
                out[k] = torch.from_numpy(rng.normal(size=shape).astype(
                    np.float32)).to(dev)
        return out

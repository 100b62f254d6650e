"""RecSys cells: (architecture x input shape) -> a step the card runs.

The counterpart of ``repro.configs.base.RecSysArch`` for its three
kinds: ``train`` (the CTR step on ``train_batch``: BCE of ``forward``,
backward — K4's bag sums through K4T — clip and AdamW, from
``configs.base.make_train_cell``), ``serve`` (``sigmoid(forward)`` over a
batch) and ``retrieval`` (one user against N candidates, top-k).  On a
mesh (``build_cell(shape, device, mesh)``) every cell runs under its
``configs.base.Layout``: the tables' rows over "model" (the psum lookup
consumes them as row shards when ``embedding_impl="psum"``), the rest
replicated, the batch or the candidates over the data axes.
:meth:`RecSysArch.smoke_inputs` draws the same numpy values in the same
order as the reference's, so one seed gives both packages identical
inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import (Cell, make_infer_cell, make_layout,
                                      make_train_cell)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import recsys
from repro_torch.models.losses import BCELoss
from repro_torch.sharding.partitioning import AxisRules

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000, topk=100),
}


class RecSysArch:
    family = "recsys"

    def __init__(self, cfg: recsys.RecSysConfig, shapes: dict | None = None):
        self.cfg = cfg
        self.name = cfg.name
        self.shapes = shapes or RECSYS_SHAPES

    def shape_names(self) -> list[str]:
        return list(self.shapes)

    def axis_rules(self) -> AxisRules:
        return AxisRules()

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return recsys.param_shapes(self.cfg)

    def param_logical_axes(self) -> dict[str, tuple]:
        return recsys.param_logical_axes(self.cfg)

    def batch_axes(self, shape_name: str) -> dict[str, tuple]:
        """Each input's logical axes (the reference's ``_batch_specs``)."""
        spec = self.shapes[shape_name]
        names = self._batch_shapes(spec)
        if spec["kind"] == "retrieval":
            return {k: ("candidates",) if k == "cand_idx" else (None, None)
                    for k in names}
        return {k: ("batch",) + (None,) * (len(shape) - 1)
                for k, shape in names.items()}

    def _layout(self, shape_name: str, mesh, optimizer=None):
        rules = self.axis_rules()
        keep = recsys.mesh_kept_leaves(self.cfg, mesh)
        lay = make_layout(mesh, rules, self.param_shapes(),
                          self.param_logical_axes(),
                          self.batch_axes(shape_name), optimizer, keep)
        for name in keep:
            if (lay.param_specs[name][0] != "model"
                    and mesh.shape["model"] > 1):
                raise ValueError(
                    f"the psum lookup needs {name}'s rows split over "
                    f"'model': {self.param_shapes()[name][0]} rows do not "
                    f"divide by {mesh.shape['model']}")
        return lay

    def _batch_shapes(self, spec: dict) -> dict[str, tuple[int, ...]]:
        """Name -> shape of each input, in the reference's order
        (``smoke_inputs`` draws in this order); all int32 but the float32
        ``labels``."""
        cfg = self.cfg
        b = spec["batch"]
        if spec["kind"] == "retrieval":
            n = spec["n_candidates"]
            if cfg.kind == "bst":
                return {"hist": (1, cfg.seq_len),
                        "profile": (1, cfg.n_profile_fields),
                        "cand_idx": (n,)}
            return {"user_idx": (1, cfg.n_fields - 1), "cand_idx": (n,)}
        if cfg.kind == "bst":
            batch = {"hist": (b, cfg.seq_len), "target": (b,),
                     "profile": (b, cfg.n_profile_fields)}
        else:
            batch = {"sparse_idx": (b, cfg.n_fields)}
        if spec["kind"] == "train":
            batch["labels"] = (b,)
        return batch

    def build_cell(self, shape_name: str,
                   device: str | torch.device = "cuda", mesh=None) -> Cell:
        """The step of one shape; ``fn(params, batch)`` (``fn(state,
        batch)`` for ``train``, the state from
        ``configs.base.init_train_state``) runs on the device of its
        inputs (``device`` is checked here, and must hold a card unless it
        is ``"cpu"``).  On a bound ``mesh`` the cell carries its layout:
        ``params`` are this rank's slices (``cell.local_params``), the
        batch is the global one, and every rank returns the whole
        answer."""
        resolve_device(device)
        spec = self.shapes[shape_name]
        cfg = self.cfg
        if spec["kind"] == "train":
            bce = BCELoss()

            def loss_fn(params, b):
                return bce(recsys.forward(cfg, params, b, mesh), b["labels"])

            return make_train_cell(
                self.name, shape_name, loss_fn=loss_fn, optimizer="adamw",
                layout=(None if mesh is None else
                        self._layout(shape_name, mesh, "adamw")))
        layout = None if mesh is None else self._layout(shape_name, mesh)
        if spec["kind"] == "serve":
            def serve_fn(params, b):
                return torch.sigmoid(recsys.forward(cfg, params, b, mesh))
            return make_infer_cell(self.name, shape_name, "serve", serve_fn,
                                   layout, out_axes=next(iter(
                                       self._batch_shapes(spec))))

        topk = spec["topk"]
        scores = make_infer_cell(
            self.name, shape_name, "retrieval",
            lambda params, b: recsys.retrieval_scores(cfg, params, b, mesh),
            layout, out_axes="cand_idx")

        def retrieval_fn(params, b):
            s = scores.fn(params, b)
            n = s.shape[0]
            if n < topk:
                raise ValueError(f"{n} candidates < top-{topk}")
            # K2 on an empty (1, k) state: the lower position wins a tie,
            # as with lax.top_k
            vals, pos = ops.empty_state(1, topk, s.device)
            ops.topk_update(vals, pos, s[None, :],
                            torch.arange(n, dtype=torch.int32,
                                         device=s.device))
            return vals[0], b["cand_idx"][pos[0]]

        return Cell(self.name, shape_name, "retrieval", retrieval_fn,
                    layout=layout)

    def reduced(self) -> "RecSysArch":
        """A small config of the same family, for CPU tests (the
        reference's ``reduced``)."""
        cfg = self.cfg
        n_small = max(4, min(cfg.n_fields, 6))
        small = dataclasses.replace(
            cfg, vocab_sizes=(64,) * n_small, embed_dim=8,
            mlp_dims=(32, 16), seq_len=min(cfg.seq_len, 6),
            n_profile_fields=min(cfg.n_profile_fields, 3),
            n_attn_layers=min(cfg.n_attn_layers, 2), d_attn=8)
        shapes = {
            "train_batch": dict(kind="train", batch=32),
            "serve_p99": dict(kind="serve", batch=8),
            "serve_bulk": dict(kind="serve", batch=64),
            "retrieval_cand": dict(kind="retrieval", batch=1,
                                   n_candidates=256, topk=8),
        }
        return RecSysArch(small, shapes=shapes)

    def smoke_inputs(self, shape_name: str, rng: np.random.Generator,
                     device: str | torch.device = "cuda"
                     ) -> dict[str, torch.Tensor]:
        """Random in-range inputs of one shape, drawn from ``rng`` exactly
        as the reference draws them."""
        dev = resolve_device(device)
        cfg = self.cfg
        offs = recsys.field_offsets(cfg.vocab_sizes)
        sizes = np.asarray(cfg.vocab_sizes)

        def field_ids(n_rows, fields):
            return np.stack([offs[f] + rng.integers(0, sizes[f], n_rows)
                             for f in fields], 1)

        out = {}
        for k, shape in self._batch_shapes(self.shapes[shape_name]).items():
            if k == "labels":
                arr = rng.integers(0, 2, shape).astype(np.float32)
            elif k == "sparse_idx":
                arr = field_ids(shape[0], range(cfg.n_fields))
            elif k == "user_idx":
                arr = field_ids(1, range(1, cfg.n_fields))
            elif k in ("cand_idx", "target", "hist"):
                arr = offs[0] + rng.integers(0, sizes[0], shape)
            elif k == "profile":
                arr = field_ids(shape[0], range(1, 1 + shape[1]))
            else:
                raise KeyError(k)
            if k != "labels":
                arr = arr.astype(np.int32)
            out[k] = torch.from_numpy(arr).to(dev)
        return out

"""GraphSAGE encoder (arXiv:1706.02216) for graph retrieval.

The port of ``repro.models.gnn``, in its three execution modes:

  * full graph     — the whole (N, F) feature matrix and an edge list.
    The mean over a node's in-neighbours is K4's bag sum over the
    graph's :class:`NeighborTable` (each node's in-edges laid out as one
    row of ids, in stable destination order) divided by the in-degree
    clipped at 1; its gradient with respect to the features is K4ᵀ
    (``kernels/embedding_bag.py``).  Both add every sum in one fixed
    order, so a step gives the same bits run after run, where torch's
    segment sums (``index_add_``, ``scatter_add_``, ``index_select``'s
    backward) add with atomics; and neither holds the (E, d) message
    tensor.  The max aggregator (no configuration uses it on the card)
    is plain torch (``scatter_reduce`` with ``amax``);
  * minibatch      — fixed-fanout dense blocks from the neighbour sampler
    (``repro_torch.data.graph``): means and products, no segment;
  * batched graphs — (G, n, F) small graphs flattened to G·n rows, each
    graph's ids offset by its first row, the edge mask as each slot's
    weight; the graph embedding is a masked mean pool.

Parameters are a plain dict of tensors; :func:`init_params` draws them
from a ``torch.Generator`` with the reference's rule (carry reference
weights across with ``models.convert.gnn_params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import ops

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_feat: int = 64
    d_hidden: int = 128
    aggregator: str = "mean"          # mean | max
    fanouts: tuple[int, ...] = (25, 10)
    dtype: torch.dtype = torch.float32
    normalize: bool = True


def param_shapes(cfg: SAGEConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter (the reference's
    ``abstract_params`` without the dtype)."""
    shapes: dict[str, tuple[int, ...]] = {}
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        shapes[f"w_self_{i}"] = (d_in, cfg.d_hidden)
        shapes[f"w_neigh_{i}"] = (d_in, cfg.d_hidden)
        shapes[f"b_{i}"] = (cfg.d_hidden,)
        d_in = cfg.d_hidden
    return shapes


def init_params(cfg: SAGEConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's rule: biases 0, weights
    N(0, 1) / sqrt(fan_in).  ``generator`` lives on ``device``; names are
    drawn in sorted order."""
    dev = resolve_device(device)
    out: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.startswith("b_"):
            out[name] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            continue
        x = torch.randn(shape, generator=generator, device=dev)
        out[name] = x.div_(math.sqrt(shape[0])).to(cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# The neighbour table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeighborTable:
    """A graph's in-edges as K4's bags: row ``v`` of ``idx`` holds the
    sources of the edges into ``v`` in stable destination order (the
    reference's ``segment_sum`` order), then padding.

    Padding slots hold ``n_nodes``, the id of a zero row that
    :func:`neighbor_sum` appends to the features for K4; in K4ᵀ, whose
    gradient has ``n_nodes`` rows, an id past the last row adds nothing.
    So padding reads zeros however the features look (K4's own padding,
    id < 0, reads row 0 times 0, which a non-finite row 0 would turn into
    NaN), and the backward never piles every padded slot onto one row.
    ``weights`` are the slots' weights (the batched graphs' edge mask; 0
    on padding) or None; ``counts`` each node's in-degree (the sum of
    its weights); ``keys`` one :class:`~repro_torch.kernels.ops.BagKeys`
    on ``idx``, so every backward over the graph shares one sort.  The
    width ``L`` is the largest in-degree (at least 1): a graph with a
    few hubs makes a wide, mostly padded table.
    """

    n_nodes: int
    idx: torch.Tensor                 # (N, L) int32
    weights: torch.Tensor | None      # (N, L) float32
    counts: torch.Tensor              # (N,) float32
    keys: ops.BagKeys
    n_edges: int

    @property
    def slots(self) -> int:
        return self.idx.numel()


def neighbor_table(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   n_nodes: int,
                   edge_weight: torch.Tensor | None = None) -> NeighborTable:
    """Build a graph's :class:`NeighborTable` on the edges' device: the
    edges (E,) src -> dst, ids in [0, ``n_nodes``), sorted stably by
    destination, each edge's rank among its destination's in-edges its
    slot.  Deterministic: a sort, a search and one write a slot."""
    dev = edge_dst.device
    src = edge_src.reshape(-1).long()
    dst = edge_dst.reshape(-1).long()
    e = dst.numel()
    if src.numel() != e:
        raise ValueError(f"{src.numel()} sources for {e} destinations")
    if e and (int(torch.minimum(src.min(), dst.min())) < 0 or
              int(torch.maximum(src.max(), dst.max())) >= n_nodes):
        raise ValueError(f"edge ids must lie in [0, {n_nodes})")
    dst_sorted, order = torch.sort(dst, stable=True)
    indptr = torch.searchsorted(
        dst_sorted, torch.arange(n_nodes + 1, device=dev))
    degree = indptr[1:] - indptr[:-1]
    width = max(1, int(degree.max()) if e else 0)
    rank = torch.arange(e, device=dev) - indptr[dst_sorted]
    idx = torch.full((n_nodes, width), n_nodes, dtype=torch.int32,
                     device=dev)
    idx[dst_sorted, rank] = src[order].to(torch.int32)
    if edge_weight is None:
        weights, counts = None, degree.float()
    else:
        weights = torch.zeros((n_nodes, width), dtype=torch.float32,
                              device=dev)
        weights[dst_sorted, rank] = edge_weight.reshape(-1)[order].float()
        counts = weights.sum(1)
    return NeighborTable(n_nodes, idx, weights, counts, ops.BagKeys(idx), e)


class _NeighborSum(torch.autograd.Function):
    """K4 over the features with a zero row appended; K4ᵀ (the
    features' gradient, ``n_nodes`` rows) in the backward, sharing the
    table's sort.  On CPU tensors both wrappers run their plain
    versions."""

    @staticmethod
    def forward(ctx, h, table):
        ext = torch.cat([h, h.new_zeros((1, h.shape[1]))])
        out = torch.empty((table.n_nodes, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        _bag.embedding_bag_(out, ext, table.idx, table.weights)
        ctx.table = table
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        t = ctx.table
        d_h = torch.empty((t.n_nodes, grad_out.shape[1]),
                          dtype=grad_out.dtype, device=grad_out.device)
        _bag.embedding_bag_backward_(d_h, grad_out.contiguous(), t.idx,
                                     t.weights, keys=t.keys)
        return d_h, None


def neighbor_sum(h: torch.Tensor, table: NeighborTable) -> torch.Tensor:
    """(N, d) -> (N, d): each node's in-neighbours' rows, times their
    slot weights, summed in slot order (K4; K4ᵀ backward)."""
    if h.shape[0] != table.n_nodes:
        raise ValueError(f"{h.shape[0]} rows for a table of "
                         f"{table.n_nodes} nodes")
    return _NeighborSum.apply(h, table)


def gather_rows(z: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``z[ids]`` as K4 bags of one slot each, so the backward adds the
    rows of repeated ids in a fixed order (K4ᵀ) where ``index_select``'s
    adds with atomics."""
    return ops.embedding_bag(z, ids.reshape(-1, 1))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _segment_max(msgs: torch.Tensor, dst: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: -inf where a segment is empty."""
    out = torch.full((n, msgs.shape[1]), float("-inf"), dtype=msgs.dtype,
                     device=msgs.device)
    index = dst.reshape(-1, 1).long().expand(-1, msgs.shape[1])
    return out.scatter_reduce(0, index, msgs, "amax", include_self=True)


def _agg(cfg: SAGEConfig, h: torch.Tensor, table: NeighborTable | None,
         src: torch.Tensor, dst: torch.Tensor,
         edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    if cfg.aggregator == "max":
        msgs = h[src.reshape(-1).long()]
        if edge_weight is not None:
            msgs = msgs * edge_weight.reshape(-1, 1).to(h.dtype)
        return _segment_max(msgs, dst, h.shape[0])
    s = neighbor_sum(h, table)
    return s / table.counts.to(h.dtype).clamp(min=1.0)[:, None]


def _maybe_norm(cfg: SAGEConfig, h: torch.Tensor) -> torch.Tensor:
    if not cfg.normalize:
        return h
    hf = h.float()
    norm = torch.linalg.vector_norm(hf, dim=-1, keepdim=True)
    return (hf / norm.clamp(min=1e-9)).to(h.dtype)


def _layer(params: Params, i: int, h: torch.Tensor,
           neigh: torch.Tensor) -> torch.Tensor:
    return torch.relu(h @ params[f"w_self_{i}"]
                      + neigh @ params[f"w_neigh_{i}"] + params[f"b_{i}"])


def _check_aggregator(cfg: SAGEConfig) -> None:
    if cfg.aggregator not in ("mean", "max"):
        raise ValueError(f"unknown aggregator {cfg.aggregator!r}; "
                         f"expected mean or max")


def _message_passing(cfg: SAGEConfig, params: Params, h: torch.Tensor,
                     table: NeighborTable | None, src, dst,
                     edge_weight=None) -> torch.Tensor:
    """The layers over one graph: the mean through ``table``, the max
    through the edges (src, dst)."""
    for i in range(cfg.n_layers):
        h = _layer(params, i, h, _agg(cfg, h, table, src, dst, edge_weight))
    return h


def forward_full(cfg: SAGEConfig, params: Params, x: torch.Tensor,
                 edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 table: NeighborTable | None = None) -> torch.Tensor:
    """Full-batch message passing.  x (N, F); edges (E,) src -> dst;
    ``table`` the edges' :func:`neighbor_table` (built here if None, for
    the mean).  -> (N, d_hidden), rows unit-norm if ``cfg.normalize``."""
    _check_aggregator(cfg)
    if cfg.aggregator == "mean" and table is None:
        table = neighbor_table(edge_src, edge_dst, x.shape[0])
    h = _message_passing(cfg, params, x.to(cfg.dtype), table, edge_src,
                         edge_dst)
    return _maybe_norm(cfg, h)


def forward_minibatch(cfg: SAGEConfig, params: Params, feats0: torch.Tensor,
                      feats1: torch.Tensor,
                      feats2: torch.Tensor) -> torch.Tensor:
    """Fixed-fanout 2-layer SAGE.

    feats0 (B, F) targets; feats1 (B, f1, F) 1-hop; feats2 (B, f1, f2, F)
    2-hop.
    """
    _check_aggregator(cfg)
    if cfg.n_layers != 2:
        raise ValueError(f"the minibatch forward has 2 layers, the config "
                         f"{cfg.n_layers}")

    def reduce(t, dim):
        return t.amax(dim) if cfg.aggregator == "max" else t.mean(dim)

    h1 = _layer(params, 0, feats1, reduce(feats2, 2))        # (B, f1, d)
    h0 = _layer(params, 0, feats0, reduce(feats1, 1))        # (B, d)
    z = _layer(params, 1, h0, reduce(h1, 1))                 # (B, d)
    return _maybe_norm(cfg, z)


def batched_edges(edges: torch.Tensor,
                  n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, m, 2) per-graph edges over n nodes each -> flat (G·m,) src and
    dst over G·n rows, graph g's ids offset by g·n."""
    if edges.numel() and (int(edges.min()) < 0 or int(edges.max()) >= n):
        raise ValueError(f"edge ids must lie in [0, {n})")
    off = torch.arange(edges.shape[0], device=edges.device)[:, None] * n
    return ((edges[..., 0].long() + off).reshape(-1),
            (edges[..., 1].long() + off).reshape(-1))


def batched_table(edges: torch.Tensor, edge_mask: torch.Tensor,
                  n: int) -> NeighborTable:
    """The neighbour table of G small graphs flattened to G·n rows, each
    slot weighted by its edge's mask."""
    src, dst = batched_edges(edges, n)
    return neighbor_table(src, dst, edges.shape[0] * n, edge_mask)


def forward_batched_graphs(cfg: SAGEConfig, params: Params, x: torch.Tensor,
                           edges: torch.Tensor, edge_mask: torch.Tensor,
                           node_mask: torch.Tensor,
                           table: NeighborTable | None = None
                           ) -> torch.Tensor:
    """Batched small graphs.  x (G, n, F), edges (G, m, 2), masks ->
    (G, d_hidden); ``table`` is :func:`batched_table` of the edges
    (built here if None, for the mean)."""
    _check_aggregator(cfg)
    g, n, f = x.shape
    src = dst = None
    if cfg.aggregator == "max":
        src, dst = batched_edges(edges, n)
    elif table is None:
        table = batched_table(edges, edge_mask, n)
    h = _message_passing(cfg, params, x.to(cfg.dtype).reshape(g * n, f),
                         table, src, dst, edge_mask)
    h = h.reshape(g, n, -1)
    w = node_mask.to(h.dtype)[..., None]
    pooled = (h * w).sum(1) / w.sum(1).clamp(min=1.0)
    return _maybe_norm(cfg, pooled)


def param_logical_axes(cfg: SAGEConfig) -> dict[str, tuple]:
    """Every weight replicated (the reference's: they are under 1 MB)."""
    return {k: (None,) * len(v) for k, v in param_shapes(cfg).items()}

"""Graph substrate: CSR adjacency and the real neighbour sampler
(GraphSAGE's minibatch training), on the host in numpy.

The port's own copy of ``repro.data.graph`` (which imports only numpy;
the port keeps its own all the same).  For one seed every function draws
exactly the reference's values in the reference's order, so both
packages sample the same ids.  Sampling gives fixed-fanout dense index
arrays — (B,), (B, f1), (B, f1, f2) — with no ragged shapes: nodes of
low degree sample with replacement, isolated nodes loop to themselves.
``NeighborSampler._sample_level`` is vectorised (the reference loops
over nodes in Python); its one ``offs`` draw comes first, as there, so
the ids stay bitwise the reference's.  ``sample_block`` gathers the
features of a numpy array on the host, or of a tensor on its device.
"""

from __future__ import annotations

import numpy as np


class CSRGraph:
    """In-edges by destination: ``indices[indptr[v]:indptr[v + 1]]`` are
    the sources of the edges into ``v``, in their input order."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 n_nodes: int):
        self.indptr = indptr
        self.indices = indices
        self.n_nodes = n_nodes

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        dst_sorted = dst[order]
        src_sorted = src[order]
        counts = np.bincount(dst_sorted, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr, src_sorted.astype(np.int32), n_nodes)

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        return self.indptr[nodes + 1] - self.indptr[nodes]

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node]: self.indptr[node + 1]]


class NeighborSampler:
    """Uniform fixed-fanout sampler (GraphSAGE §3.1)."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 seed: int = 0):
        self.graph = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def _sample_level(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """nodes (N,) -> neighbour ids (N, fanout): in-neighbour
        ``offs % degree`` of each node, the node itself where it has
        none."""
        g = self.graph
        deg = g.degree(nodes)
        offs = self.rng.integers(0, 1 << 31, size=(len(nodes), fanout))
        out = np.repeat(np.asarray(nodes, np.int32)[:, None], fanout, 1)
        has = deg > 0
        if has.any():
            lo = g.indptr[nodes[has]][:, None]
            out[has] = g.indices[lo + offs[has] % deg[has][:, None]]
        return out

    def sample(self, batch_nodes: np.ndarray):
        """-> (level0 (B,), level1 (B,f1), level2 (B,f1,f2), ...)."""
        levels = [np.asarray(batch_nodes, np.int32)]
        frontier = levels[0]
        for fanout in self.fanouts:
            nxt = self._sample_level(frontier.reshape(-1), fanout)
            levels.append(nxt.reshape(frontier.shape + (fanout,)))
            frontier = levels[-1]
        return levels

    def sample_block(self, x, batch_nodes: np.ndarray):
        """Gathered features for a 2-hop block: (feats0, feats1, feats2).
        ``x`` is a numpy array, or a tensor gathered on its own device."""
        levels = self.sample(batch_nodes)
        if isinstance(x, np.ndarray):
            return tuple(x[lv] for lv in levels)
        import torch
        return tuple(x[torch.from_numpy(lv.astype(np.int64)).to(x.device)]
                     for lv in levels)

    def positive_pairs(self, batch_nodes: np.ndarray) -> np.ndarray:
        """Co-occurrence positives: one random neighbour per node (the
        unsupervised GraphSAGE objective's positive sample)."""
        return self._sample_level(np.asarray(batch_nodes, np.int32), 1)[:, 0]


def make_random_graph(n_nodes: int, avg_degree: int, seed: int = 0,
                      n_communities: int = 8):
    """Community-structured random graph: nodes in the same community
    connect preferentially, so GraphSAGE embeddings carry a learnable
    retrieval signal.  -> (src, dst, community), self-loops dropped."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, n_nodes)
    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # 80% of edges stay within the community
    same = rng.random(n_edges) < 0.8
    candidates = rng.integers(0, n_nodes, (n_edges, 8))
    match = comm[candidates] == comm[src][:, None]
    pick = np.argmax(match, axis=1)
    intra = candidates[np.arange(n_edges), pick].astype(np.int32)
    dst = np.where(same & match.any(1), intra,
                   rng.integers(0, n_nodes, n_edges)).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], comm

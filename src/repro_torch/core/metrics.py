"""IR metrics: nDCG@k, MRR@k, Recall@k, MAP (+ training-time IRMetrics).

A copy of ``repro.core.metrics`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _parse(name: str) -> tuple[str, int]:
    if "@" in name:
        base, k = name.split("@")
        return base.lower(), int(k)
    return name.lower(), 10


def dcg(rels: np.ndarray) -> np.ndarray:
    discounts = 1.0 / np.log2(np.arange(rels.shape[-1]) + 2.0)
    return ((2.0 ** rels - 1.0) * discounts).sum(-1)


def ranked_relevances(run_ids: np.ndarray, qid_hashes: np.ndarray,
                      qrels: dict[int, dict[int, float]]) -> np.ndarray:
    """(Q, k) relevance grades for ranked doc-id matrix."""
    out = np.zeros(run_ids.shape, np.float32)
    for qi, qid in enumerate(qid_hashes):
        grades = qrels.get(int(qid), {})
        for ri, did in enumerate(run_ids[qi]):
            out[qi, ri] = grades.get(int(did), 0.0)
    return out


def compute_metrics(metric_names, run_ids, qid_hashes, qrels) -> dict:
    """run_ids (Q, depth) ranked doc hashes; qrels {qid: {did: grade}}."""
    rels = ranked_relevances(run_ids, qid_hashes, qrels)
    n_rel = np.asarray(
        [sum(1 for g in qrels.get(int(q), {}).values() if g > 0)
         for q in qid_hashes], np.float32)
    ideal = [np.sort([g for g in qrels.get(int(q), {}).values() if g > 0]
                     )[::-1] for q in qid_hashes]
    out = {}
    for name in metric_names:
        base, k = _parse(name)
        rk = rels[:, :k]
        if base == "ndcg":
            idcg = np.asarray([dcg(i[:k][None])[0] if len(i) else 0.0
                               for i in ideal])
            val = np.where(idcg > 0, dcg(rk) / np.maximum(idcg, 1e-9), 0.0)
        elif base == "mrr":
            hit = rk > 0
            first = np.argmax(hit, axis=1)
            any_hit = hit.any(axis=1)
            val = np.where(any_hit, 1.0 / (first + 1.0), 0.0)
        elif base == "recall":
            # a query with zero relevant qrels contributes recall 0,
            # never a 0/0 division
            val = np.where(n_rel > 0, (rk > 0).sum(1) / np.maximum(n_rel, 1),
                           0.0)
        elif base == "map":
            hit = (rk > 0).astype(np.float32)
            prec = np.cumsum(hit, 1) / (np.arange(rk.shape[1]) + 1.0)
            val = np.where(n_rel > 0,
                           (prec * hit).sum(1) / np.maximum(n_rel, 1), 0.0)
        else:
            raise ValueError(name)
        out[name] = float(val.mean())
    return out


class IRMetrics:
    """Training-time approximate IR metrics (paper §3.4).

    Ranks each dev query's own annotated group (a reranking task) — cheap
    enough to run inside the train loop as ``compute_metrics``.
    Call with (scores (Q, G), labels (Q, G); label -1 == padding).
    """

    def __init__(self, metric_names=("ndcg@10", "mrr@10")):
        self.metric_names = metric_names

    def __call__(self, scores: np.ndarray, labels: np.ndarray) -> dict:
        scores = np.asarray(scores, np.float32)
        labels = np.asarray(labels, np.float32)
        mask = labels >= 0
        scores = np.where(mask, scores, -np.inf)
        order = np.argsort(-scores, axis=1)
        ranked = np.take_along_axis(np.where(mask, labels, 0.0), order, 1)
        out = {}
        for name in self.metric_names:
            base, k = _parse(name)
            rk = ranked[:, :k]
            if base == "ndcg":
                ideal = -np.sort(-np.where(mask, labels, 0.0), axis=1)[:, :k]
                idcg = dcg(ideal)
                val = np.where(idcg > 0, dcg(rk) / np.maximum(idcg, 1e-9), 0.0)
            elif base == "mrr":
                hit = rk > 0
                first = np.argmax(hit, 1)
                val = np.where(hit.any(1), 1.0 / (first + 1.0), 0.0)
            else:
                raise ValueError(f"IRMetrics supports ndcg/mrr, got {name}")
            out[name] = float(val.mean())
        return out

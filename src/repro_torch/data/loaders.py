"""File loaders + registry (paper §3.2.3: ``@register_loader``).

The port's own copy of the reference's ``data/loaders.py``: jsonl / tsv
record and qrel readers that give the same records and id hashes.
"""

from __future__ import annotations

import json
from typing import Callable, Iterator

import numpy as np

from repro_torch.data.table import stable_id_hash

LOADER_REGISTRY: dict[str, Callable] = {}


def register_loader(name: str):
    def deco(fn):
        LOADER_REGISTRY[name] = fn
        return fn
    return deco


def _sniff(path: str) -> str:
    if path.endswith((".jsonl", ".json")):
        return "jsonl"
    return "tsv"


# -- record loaders (queries / corpus) ---------------------------------------

@register_loader("records_jsonl")
def load_records_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


@register_loader("records_tsv")
def load_records_tsv(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            rec = {"_id": parts[0], "text": parts[1] if len(parts) > 1 else ""}
            if len(parts) > 2:
                rec["title"] = parts[2]
            yield rec


def load_records(path: str, loader: str | None = None) -> Iterator[dict]:
    name = loader or ("records_" + _sniff(path))
    return LOADER_REGISTRY[name](path)


# -- qrel loaders -------------------------------------------------------------

@register_loader("qrels_tsv")
def load_qrels_tsv(path: str):
    """TSV: ``qid\tdid\tscore`` or TREC ``qid\t0\tdid\tscore``."""
    qids, dids, scores = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or parts[0] in ("query-id", "qid"):
                continue
            if len(parts) >= 4:
                q, d, s = parts[0], parts[2], parts[3]
            elif len(parts) == 3:
                q, d, s = parts
            else:
                q, d, s = parts[0], parts[1], 1
            qids.append(stable_id_hash(q))
            dids.append(stable_id_hash(d))
            scores.append(float(s))
    return (np.asarray(qids, np.int64), np.asarray(dids, np.int64),
            np.asarray(scores, np.float32))


@register_loader("qrels_jsonl")
def load_qrels_jsonl(path: str):
    qids, dids, scores = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            qids.append(stable_id_hash(rec["query_id"]))
            dids.append(stable_id_hash(rec["doc_id"]))
            scores.append(float(rec.get("score", 1)))
    return (np.asarray(qids, np.int64), np.asarray(dids, np.int64),
            np.asarray(scores, np.float32))


def load_qrels(path: str, loader: str | None = None):
    name = loader or ("qrels_" + _sniff(path))
    return LOADER_REGISTRY[name](path)

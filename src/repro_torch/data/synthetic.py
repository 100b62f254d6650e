"""Synthetic retrieval data (offline stand-in for MS MARCO).

Topic-structured corpora where each query shares a rare "topic token"
with its relevant documents.  A copy of the reference generator: the
same seed writes the same files and returns the same dicts.
"""

from __future__ import annotations

import json
import os

import numpy as np

_WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
    "oscar", "papa", "quebec", "romeo", "sierra", "tango", "uniform",
    "victor", "whiskey", "xray", "yankee", "zulu",
]


def _text(rng: np.random.Generator, topic: int, n_words: int) -> str:
    topic_tok = f"topic{topic}"
    fillers = rng.choice(_WORDS, size=n_words)
    pos = rng.integers(0, n_words, size=max(1, n_words // 6))
    words = list(fillers)
    for p in pos:
        words[p] = topic_tok
    return " ".join(words)


def make_retrieval_dataset(out_dir: str, n_queries: int = 64,
                           n_docs: int = 512, n_topics: int = 32,
                           doc_len: int = 30, query_len: int = 6,
                           graded: bool = False, seed: int = 0,
                           id_prefix: str = ""):
    """Writes corpus.jsonl, queries.jsonl, qrels/train.tsv.

    ``id_prefix`` namespaces every query/doc id.
    Returns (queries dict, corpus dict, qrels dict).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "qrels"), exist_ok=True)

    doc_topics = rng.integers(0, n_topics, size=n_docs)
    corpus = {}
    with open(os.path.join(out_dir, "corpus.jsonl"), "w") as f:
        for i in range(n_docs):
            did = f"{id_prefix}doc{i}"
            text = _text(rng, int(doc_topics[i]), doc_len)
            corpus[did] = text
            f.write(json.dumps({"_id": did, "text": text}) + "\n")

    queries, qrels = {}, {}
    q_topics = rng.integers(0, n_topics, size=n_queries)
    with open(os.path.join(out_dir, "queries.jsonl"), "w") as f, \
            open(os.path.join(out_dir, "qrels", "train.tsv"), "w") as qf:
        for i in range(n_queries):
            qid = f"{id_prefix}q{i}"
            topic = int(q_topics[i])
            text = _text(rng, topic, query_len)
            queries[qid] = text
            f.write(json.dumps({"_id": qid, "text": text}) + "\n")
            rel_docs = np.nonzero(doc_topics == topic)[0]
            qrels[qid] = {}
            for j, d in enumerate(rel_docs[:4]):
                grade = (3 - min(j, 2)) if graded else 1
                qrels[qid][f"{id_prefix}doc{d}"] = float(grade)
                qf.write(f"{qid}\t{id_prefix}doc{d}\t{grade}\n")
    return queries, corpus, qrels


def make_synthetic_multilevel(out_dir: str, queries: dict, corpus_size: int,
                              n_topics: int = 32, seed: int = 1):
    """Extra synthetic passages with graded labels (SyCL-style source):
    per query four passages of levels 3..0 carrying its topic token
    level + 1 times.  Writes ``synthetic.jsonl`` and
    ``qrels/synthetic.tsv``; returns their paths."""
    rng = np.random.default_rng(seed)
    path = os.path.join(out_dir, "synthetic.jsonl")
    qrel_path = os.path.join(out_dir, "qrels", "synthetic.tsv")
    with open(path, "w") as f, open(qrel_path, "w") as qf:
        for qi, (qid, qtext) in enumerate(queries.items()):
            topic = next((t for t in qtext.split() if t.startswith("topic")),
                         "topic0")
            for level in (3, 2, 1, 0):
                did = f"syn_{qid}_{level}"
                words = [topic] * (level + 1) + list(
                    rng.choice(_WORDS, size=20 - level))
                rng.shuffle(words)
                f.write(json.dumps(
                    {"_id": did, "text": " ".join(words)}) + "\n")
                qf.write(f"{qid}\t{did}\t{level}\n")
    return path, qrel_path

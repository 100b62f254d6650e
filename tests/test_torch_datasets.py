"""The port's training datasets against the reference's.

``BinaryDataset`` and ``MultiLevelDataset`` of both packages over the
same files and configs (each package in a cache root of its own) give
equal items — the same query, passages and labels for every index —
since both draw from ``np.random.default_rng((seed, qid, i))``.  Then
the four dataset cases of ``tests/test_materialized_qrel.py`` on the
port, and ``make_synthetic_multilevel`` against the reference's.
"""

import filecmp

import numpy as np
import pytest

from repro.core import datasets as ref_datasets
from repro.core.config import DataArguments as RefDataArguments
from repro.core.config import MaterializedQRelConfig as RefConfig
from repro.data import synthetic as ref_synthetic
from repro_torch.core.config import DataArguments, MaterializedQRelConfig
from repro_torch.core.datasets import BinaryDataset, MultiLevelDataset
from repro_torch.core.materialized_qrel import MaterializedQRel
from repro_torch.data import synthetic


def _cfg(data, cls=MaterializedQRelConfig, qrels="qrels/train.tsv",
         corpus="corpus.jsonl", **kw):
    d = data["dir"]
    return cls(qrel_path=f"{d}/{qrels}", query_path=f"{d}/queries.jsonl",
               corpus_path=f"{d}/{corpus}", **kw)


def _items_equal(port, ref):
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port.qids, ref.qids)
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        assert a["query_id"] == b["query_id"]
        assert a["query"] == b["query"]
        assert a["passages"] == b["passages"]
        if "labels" in b:
            assert a["labels"].dtype == b["labels"].dtype
            np.testing.assert_array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("group_size", (1, 3, 6))
@pytest.mark.parametrize("seed", (0, 5))
def test_binary_dataset_matches_reference(retrieval_data, tmp_path,
                                          group_size, seed):
    pos = dict(min_score=1)
    neg = dict(group_random_k=2, seed=3)
    port = BinaryDataset(DataArguments(group_size=group_size), str.upper,
                         lambda t: "p: " + t, _cfg(retrieval_data, **pos),
                         _cfg(retrieval_data, **neg),
                         str(tmp_path / "port"), seed=seed)
    ref = ref_datasets.BinaryDataset(
        RefDataArguments(group_size=group_size), str.upper,
        lambda t: "p: " + t, _cfg(retrieval_data, RefConfig, **pos),
        _cfg(retrieval_data, RefConfig, **neg), str(tmp_path / "ref"),
        seed=seed)
    _items_equal(port, ref)


@pytest.mark.parametrize("group_size", (2, 8))
def test_multilevel_dataset_matches_reference(retrieval_data, tmp_path,
                                              group_size):
    synthetic.make_synthetic_multilevel(retrieval_data["dir"],
                                        retrieval_data["queries"], 96)
    sources = [dict(), dict(min_score=1, new_label=3),
               dict(qrels="qrels/synthetic.tsv", corpus="synthetic.jsonl")]
    port = MultiLevelDataset(
        DataArguments(group_size=group_size), lambda t: t, lambda t: t,
        [_cfg(retrieval_data, **s) for s in sources], str(tmp_path / "port"))
    ref = ref_datasets.MultiLevelDataset(
        RefDataArguments(group_size=group_size), lambda t: t, lambda t: t,
        [_cfg(retrieval_data, RefConfig, **s) for s in sources],
        str(tmp_path / "ref"))
    _items_equal(port, ref)
    assert [g["query_id"] for g in port.dev_groups(5)] == [
        g["query_id"] for g in ref.dev_groups(5)]


def test_make_synthetic_multilevel_matches_reference(retrieval_data,
                                                     tmp_path):
    for mod, name in ((synthetic, "port"), (ref_synthetic, "ref")):
        d = tmp_path / name
        (d / "qrels").mkdir(parents=True)
        paths = mod.make_synthetic_multilevel(str(d),
                                              retrieval_data["queries"], 96)
        assert [p.replace(str(d), "") for p in paths] == [
            "/synthetic.jsonl", "/qrels/synthetic.tsv"]
    for rel in ("synthetic.jsonl", "qrels/synthetic.tsv"):
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "ref" / rel,
                           shallow=False), rel


# -- the dataset cases of tests/test_materialized_qrel.py ---------------------

def test_binary_dataset_structure(retrieval_data, tmp_path):
    pos = _cfg(retrieval_data, min_score=1)
    neg = _cfg(retrieval_data, group_random_k=1)
    ds = BinaryDataset(DataArguments(group_size=3), str.upper, lambda t: t,
                       pos, neg, str(tmp_path))
    item = ds[0]
    assert item["query"].isupper()
    assert len(item["passages"]) == 3
    # the first passage is a positive of this query
    qrels = retrieval_data["qrels"]
    corpus = retrieval_data["corpus"]
    qid = next(q for q in qrels if retrieval_data["queries"][q].upper()
               == item["query"])
    assert item["passages"][0] in {corpus[d] for d in qrels[qid]}


def test_multilevel_dedup_and_padding(retrieval_data, tmp_path):
    src = _cfg(retrieval_data)
    relabeled = _cfg(retrieval_data, min_score=1, new_label=3)
    ds = MultiLevelDataset(DataArguments(group_size=8), lambda t: t,
                           lambda t: t, [src, relabeled], str(tmp_path))
    labels = ds[0]["labels"]
    assert len(ds[0]["passages"]) == 8 and labels.shape == (8,)
    assert labels[0] == 3                 # dedup keeps the max label
    assert (labels >= -1).all() and (labels == -1).any()
    valid = labels[labels >= 0]
    assert (np.diff(valid) <= 0).all()    # descending before padding


def test_combined_sources_union(retrieval_data, tmp_path):
    a = _cfg(retrieval_data, max_score=1)
    b = _cfg(retrieval_data, min_score=2)
    m_all = MaterializedQRel(_cfg(retrieval_data), str(tmp_path))
    ds = MultiLevelDataset(DataArguments(group_size=4), lambda t: t,
                           lambda t: t, [a, b], str(tmp_path))
    assert len(ds) == len(m_all)


def test_binary_dataset_drops_empty_positive_queries(retrieval_data,
                                                     tmp_path):
    """A query whose positive groups are all empty at access time
    (``group_random_k=0``) is dropped up front, not an IndexError
    mid-epoch."""
    half_qrels = str(tmp_path / "half.tsv")
    qids = list(retrieval_data["qrels"])
    with open(half_qrels, "w") as f:
        for q in qids[: len(qids) // 2]:
            for d, s in retrieval_data["qrels"][q].items():
                f.write(f"{q}\t{d}\t{int(s)}\n")
    d = retrieval_data["dir"]
    pos_half = MaterializedQRelConfig(
        qrel_path=half_qrels, query_path=f"{d}/queries.jsonl",
        corpus_path=f"{d}/corpus.jsonl")
    pos_empty = _cfg(retrieval_data, group_random_k=0)
    neg = _cfg(retrieval_data, group_random_k=2)
    ds = BinaryDataset(DataArguments(group_size=2), lambda t: t,
                       lambda t: t, [pos_half, pos_empty], neg,
                       str(tmp_path))
    assert len(ds) == len(qids) // 2
    for i in range(len(ds)):
        assert ds[i]["passages"]
    all_empty = BinaryDataset(DataArguments(group_size=2), lambda t: t,
                              lambda t: t, [pos_empty], neg, str(tmp_path))
    assert len(all_empty) == 0

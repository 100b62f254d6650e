"""The port's MaterializedQRel, loaders and evaluation datasets, against
the reference.

The evaluation cases of ``tests/test_materialized_qrel.py`` run on
``repro_torch.core.materialized_qrel``: grouping against a naive dict
grouping, ``min_score`` / ``max_score``, relabeling, ``transform_fn``,
``filter_fn``, the seeded ``group_random_k`` draw, lazy text and the
callback digests.  Each is also built by the reference's
``MaterializedQRel`` from the same files and config, each package in a
cache root of its own: the grouped arrays are equal and the table and
group-cache directories have the same names.  Then one package opens
what the other built without a rebuild.  The three training-dataset
cases (``BinaryDataset`` / ``MultiLevelDataset``) are in
``tests/test_torch_datasets.py``.
"""

import json
import os

import numpy as np
import pytest

from repro.core import materialized_qrel as ref_mq
from repro.core.config import MaterializedQRelConfig as RefConfig
from repro.core.datasets import EncodingDataset as RefEncodingDataset
from repro.core.datasets import _sources_view as ref_sources_view
from repro.data import loaders as ref_loaders
from repro_torch.core import materialized_qrel as port_mq
from repro_torch.core.config import MaterializedQRelConfig
from repro_torch.core.datasets import (EncodingDataset, _as_mqrels,
                                       _sources_view)
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.materialized_qrel import MaterializedQRel, _config_key
from repro_torch.data import loaders
from repro_torch.data.table import MMapTable, stable_id_hash
from repro_torch.data.views import ConcatView, TableView


def _cfg(data, cls=MaterializedQRelConfig, **kw):
    d = data["dir"]
    return cls(qrel_path=f"{d}/qrels/train.tsv",
               query_path=f"{d}/queries.jsonl",
               corpus_path=f"{d}/corpus.jsonl", **kw)


def _naive_groups(data, min_score=None, max_score=None, new_label=None):
    """Reference implementation: load everything, group in dicts."""
    groups = {}
    for line in open(f"{data['dir']}/qrels/train.tsv"):
        q, doc, s = line.split("\t")
        s = float(s)
        if min_score is not None and s < min_score:
            continue
        if max_score is not None and s > max_score:
            continue
        if new_label is not None:
            s = new_label
        groups.setdefault(q, {})[doc] = s
    return groups


def _dir_name(arr) -> str:
    return os.path.basename(os.path.dirname(arr.filename))


def _both(data, tmp_path, **kw) -> MaterializedQRel:
    """The port's MaterializedQRel of this config, after checking it
    against the reference's built from the same files in its own cache
    root: equal grouped arrays, tables and cache directory names."""
    m = MaterializedQRel(_cfg(data, **kw), str(tmp_path / "port"))
    r = ref_mq.MaterializedQRel(_cfg(data, RefConfig, **kw),
                                str(tmp_path / "ref"))
    for name in ("group_qids", "group_offsets", "group_dids",
                 "group_scores"):
        got, want = getattr(m, name), getattr(r, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert _dir_name(m.group_qids) == _dir_name(r.group_qids)
    for which in ("queries", "corpus"):
        assert os.path.basename(getattr(m, which).path) == \
            os.path.basename(getattr(r, which).path)
    assert _config_key(m.cfg) == ref_mq._config_key(r.cfg)
    assert m.qrels_dict() == r.qrels_dict()
    for q in m.query_id_hashes[:6]:
        for a, b in zip(m.group(int(q)), r.group(int(q))):
            np.testing.assert_array_equal(a, b)
    return m


def test_groups_match_naive(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path)
    naive = _naive_groups(retrieval_data)
    assert len(m) == len(naive)
    for q, docs in naive.items():
        dids, scores = m.group(stable_id_hash(q))
        assert {int(d) for d in dids} == {stable_id_hash(d) for d in docs}
        assert sorted(scores.tolist()) == sorted(docs.values())
    dids, scores = m.group(stable_id_hash("no-such-query"))
    assert dids.shape == scores.shape == (0,)


def test_min_score_filter(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path, min_score=2)
    naive = _naive_groups(retrieval_data, min_score=2)
    qids = {q for q, docs in naive.items() if docs}
    assert len(m) == len(qids)
    for q in qids:
        _, scores = m.group(stable_id_hash(q))
        assert (scores >= 2).all()


def test_max_score_filter(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path, max_score=1)
    naive = _naive_groups(retrieval_data, max_score=1)
    assert len(m) == len([q for q, d in naive.items() if d])


def test_relabel(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path, min_score=1, new_label=3)
    for q in list(retrieval_data["qrels"])[:5]:
        _, scores = m.group(stable_id_hash(q))
        assert (scores == 3).all()


def test_transform_fn(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path, transform_fn=lambda s: s * 10)
    q = list(retrieval_data["qrels"])[0]
    _, scores = m.group(stable_id_hash(q))
    assert set(np.unique(scores)).issubset({10.0, 20.0, 30.0})


def test_filter_fn(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path, filter_fn=lambda q, d, s: s >= 1)
    naive = _naive_groups(retrieval_data, min_score=1)
    assert len(m) == len([q for q, d in naive.items() if d])


def test_query_subset_from(retrieval_data, tmp_path):
    sub = tmp_path / "sub.tsv"
    qids = list(retrieval_data["qrels"])[:5]
    with open(sub, "w") as f:
        for q in qids:
            d = next(iter(retrieval_data["qrels"][q]))
            f.write(f"{q}\t{d}\t1\n")
    m = _both(retrieval_data, tmp_path, query_subset_from=str(sub))
    assert sorted(m.query_id_hashes.tolist()) == sorted(
        stable_id_hash(q) for q in qids)


@pytest.mark.parametrize("seed", (0, 7))
def test_group_random_k_deterministic(retrieval_data, tmp_path, seed):
    """The seeded per-query draw: stable across calls, and the same
    draw as the reference's for every query."""
    m = _both(retrieval_data, tmp_path, group_random_k=2, seed=seed)
    r = ref_mq.MaterializedQRel(
        _cfg(retrieval_data, RefConfig, group_random_k=2, seed=seed),
        str(tmp_path / "ref"))
    for q in m.query_id_hashes:
        d1, s1 = m.group(int(q))
        d2, _ = m.group(int(q))
        assert len(d1) <= 2
        np.testing.assert_array_equal(d1, d2)   # seeded => stable
        rd, rs = r.group(int(q))
        np.testing.assert_array_equal(d1, rd)
        np.testing.assert_array_equal(s1, rs)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    q = int(m.query_id_hashes[0])
    np.testing.assert_array_equal(m.group(q, rng_a)[0],
                                  r.group(q, rng_b)[0])


def test_lazy_text_access(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path)
    q = list(retrieval_data["queries"])[0]
    assert m.query_text(stable_id_hash(q)) == retrieval_data["queries"][q]
    d = list(retrieval_data["corpus"])[0]
    assert retrieval_data["corpus"][d] in m.doc_text(stable_id_hash(d))
    assert m.doc(stable_id_hash(d))["_id"] == d
    with pytest.raises(KeyError):
        m.doc_text(stable_id_hash("no-such-doc"))


def test_views_match_reference(retrieval_data, tmp_path):
    m = _both(retrieval_data, tmp_path)
    r = ref_mq.MaterializedQRel(_cfg(retrieval_data, RefConfig),
                                str(tmp_path / "ref"))
    for got, want in ((m.queries_view(), r.queries_view()),
                      (m.corpus_view(), r.corpus_view())):
        assert isinstance(got, TableView)
        np.testing.assert_array_equal(got.id_hashes, want.id_hashes)
        assert got.raw_ids() == want.raw_ids()
        assert list(got.texts()) == list(want.texts())


def test_distinct_lambdas_get_distinct_group_caches(retrieval_data,
                                                    tmp_path):
    """Two different lambdas (both ``"<lambda>"``) key two different
    grouped-qrel directories."""
    keep_all = _both(retrieval_data, tmp_path,
                     filter_fn=lambda q, d, s: True)
    keep_none = _both(retrieval_data, tmp_path,
                      filter_fn=lambda q, d, s: False)
    assert len(keep_all) == len(_naive_groups(retrieval_data))
    assert len(keep_none) == 0
    assert _dir_name(keep_all.group_qids) != _dir_name(keep_none.group_qids)


def test_closure_parameterized_lambdas_not_conflated(retrieval_data,
                                                     tmp_path):
    """Same bytecode, different closure cells -> different caches."""
    def at_least(t):
        return lambda q, d, s: s >= t

    m1 = _both(retrieval_data, tmp_path, filter_fn=at_least(1))
    m2 = _both(retrieval_data, tmp_path, filter_fn=at_least(99))
    assert len(m1) == len(_naive_groups(retrieval_data, min_score=1))
    assert len(m2) == 0
    # identical lambda re-definition still hits the same cache dir
    assert _config_key(_cfg(retrieval_data, filter_fn=at_least(1))) == \
        _config_key(_cfg(retrieval_data, filter_fn=at_least(1)))
    for fn in (None, len, at_least(2)):
        assert port_mq._fn_digest(fn) == ref_mq._fn_digest(fn)


@pytest.mark.parametrize("first", ("reference", "port"))
def test_cache_built_by_one_package_is_reused_by_the_other(
        retrieval_data, tmp_path, monkeypatch, first):
    """One cache root: the second package opens the first's tables and
    groups and builds nothing."""
    root = str(tmp_path / "shared")
    kw = dict(min_score=1, group_random_k=3)
    if first == "reference":
        built = ref_mq.MaterializedQRel(
            _cfg(retrieval_data, RefConfig, **kw), root)

        def refuse(*a, **k):
            raise AssertionError("rebuilt what the reference built")
        monkeypatch.setattr(MMapTable, "build", refuse)
        monkeypatch.setattr(MaterializedQRel, "_build_groups", refuse)
        opened = MaterializedQRel(_cfg(retrieval_data, **kw), root)
    else:
        built = MaterializedQRel(_cfg(retrieval_data, **kw), root)

        def refuse(*a, **k):
            raise AssertionError("rebuilt what the port built")
        monkeypatch.setattr(ref_mq.MMapTable, "build", refuse)
        monkeypatch.setattr(ref_mq.MaterializedQRel, "_build_groups",
                            refuse)
        opened = ref_mq.MaterializedQRel(
            _cfg(retrieval_data, RefConfig, **kw), root)
    assert opened.group_qids.filename == built.group_qids.filename
    assert opened.qrels_dict() == built.qrels_dict()
    assert [len(os.listdir(os.path.join(root, d)))
            for d in ("tables", "groups")] == [2, 1]


# -- loaders ------------------------------------------------------------------


def test_loaders_match_reference(tmp_path):
    tsv = tmp_path / "q.tsv"
    tsv.write_text("query-id\tcorpus-id\tscore\n"       # BEIR header
                   "q1\td1\t2\n"
                   "q1\t0\td2\t1\n"                     # TREC
                   "q2\td3\n"                           # no score
                   "\n")
    jl = tmp_path / "q.jsonl"
    jl.write_text(json.dumps({"query_id": "q1", "doc_id": "d1",
                              "score": 3}) + "\n\n"
                  + json.dumps({"query_id": 5, "doc_id": "d9"}) + "\n")
    for path in (str(tsv), str(jl)):
        got, want = loaders.load_qrels(path), ref_loaders.load_qrels(path)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    qids, dids, scores = loaders.load_qrels(str(tsv))
    assert scores.tolist() == [2.0, 1.0, 1.0]
    assert dids.tolist() == [stable_id_hash(d) for d in ("d1", "d2", "d3")]

    rt = tmp_path / "c.tsv"
    rt.write_text("d1\tsome text\tA title\nd2\tonly text\n\td3\nd4\n")
    rj = tmp_path / "c.jsonl"
    rj.write_text(json.dumps({"_id": "d1", "text": "t"}) + "\n\n")
    for path in (str(rt), str(rj)):
        assert list(loaders.load_records(path)) == list(
            ref_loaders.load_records(path))
    assert list(loaders.load_records(str(rt)))[0] == {
        "_id": "d1", "text": "some text", "title": "A title"}


def test_register_loader_feeds_a_config(retrieval_data, tmp_path):
    """A registered qrel loader is picked by ``cfg.loader``."""
    name = "qrels_half_scores"

    @loaders.register_loader(name)
    def half(path):
        q, d, s = loaders.load_qrels_tsv(path)
        return q, d, s / 2

    try:
        assert loaders.LOADER_REGISTRY[name] is half
        m = MaterializedQRel(_cfg(retrieval_data, loader=name),
                             str(tmp_path))
        q = list(retrieval_data["qrels"])[0]
        _, scores = m.group(stable_id_hash(q))
        assert set(scores.tolist()) <= {0.5}
    finally:
        loaders.LOADER_REGISTRY.pop(name)


# -- the evaluation datasets --------------------------------------------------


def test_sources_view_dedups_tables(retrieval_data, tmp_path):
    a = MaterializedQRel(_cfg(retrieval_data, min_score=1), str(tmp_path))
    b = MaterializedQRel(_cfg(retrieval_data, max_score=1), str(tmp_path))
    assert _as_mqrels(a, None) == [a]
    assert [m.cfg for m in _as_mqrels([a.cfg], str(tmp_path))] == [a.cfg]
    one = _sources_view([a, b], "corpus")       # one file -> one table
    assert isinstance(one, TableView)
    ref_one = ref_sources_view(
        [ref_mq.MaterializedQRel(_cfg(retrieval_data, RefConfig),
                                 str(tmp_path / "ref"))], "corpus")
    np.testing.assert_array_equal(one.id_hashes, ref_one.id_hashes)

    other = tmp_path / "other"
    other.mkdir()
    (other / "corpus.jsonl").write_text(
        json.dumps({"_id": "x1", "text": "extra"}) + "\n")
    c = MaterializedQRel(MaterializedQRelConfig(
        qrel_path=a.cfg.qrel_path, query_path=a.cfg.query_path,
        corpus_path=str(other / "corpus.jsonl")), str(tmp_path))
    both = _sources_view([a, c, b], "corpus")
    assert isinstance(both, ConcatView)
    assert len(both) == len(retrieval_data["corpus"]) + 1
    assert both.row(len(both) - 1)["_id"] == "x1"
    assert isinstance(_sources_view([a, c], "queries"), TableView)


def test_encoding_dataset(retrieval_data, tmp_path):
    m = MaterializedQRel(_cfg(retrieval_data), str(tmp_path))
    ids = list(retrieval_data["corpus"])[:6]
    cache = EmbeddingCache(str(tmp_path / "emb"), dim=4)
    vec = np.arange(8, dtype=np.float32).reshape(2, 4) / 8
    cache.cache_records(ids[:2], vec)
    ds = EncodingDataset(ids, table=m.corpus, cache=cache,
                         format_fn=str.upper)
    ref = RefEncodingDataset(ids, table=m.corpus, format_fn=str.upper)
    assert len(ds) == 6
    np.testing.assert_array_equal(ds[1]["embedding"],
                                  vec[1].astype(np.float16))
    for i in range(2, 6):
        assert ds[i] == ref[i]
        assert ds[i]["text"] == retrieval_data["corpus"][ids[i]].upper()
    texts = EncodingDataset(ids, texts=[f"t{i}" for i in range(6)])
    assert texts[3] == {"id": ids[3], "text": "t3"}

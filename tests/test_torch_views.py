"""The port's lazy dataset-view algebra, against an eager oracle and
against the reference.

The cases of ``tests/test_views.py`` run on ``repro_torch.data.views``:
every combinator (filter / map / select / concat / interleave) and
nested compositions agree with the obvious eager implementation on
rows, ids and texts, while materializing only touched rows; the
streaming contract (``open_slice`` / ``evict``) holds through every
combinator.  Then the two packages meet: the same composition built in
both gives equal rows, ``id_hashes`` and ``raw_ids``.  Search through
views is bitwise equal to the port's own dict-corpus search for every
score_impl x heap_impl pair at W = 1 and W = 2, and matches the
reference's search (JAX on the CPU, the same encoder weights through
``params_from_jax``): scores within ``TOL = 1e-5`` and ids equal where
neighbouring scores are more than ``TOL`` apart.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.data import views as ref_views
from repro.data.table import MMapTable as RefTable
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.core import fair_sharding
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import (DataArguments, EvaluationArguments,
                                     MaterializedQRelConfig)
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.core.materialized_qrel import MaterializedQRel
from repro_torch.data import views as port_views
from repro_torch.data.table import MMapTable, stable_id_hash
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.views import (ConcatView, DatasetView, DictView,
                                    FilterView, InterleaveView, MapView,
                                    RecordsView, SelectView, TableView,
                                    ViewTexts, as_view, row_text)
from repro_torch.launch.distributed import InMemoryAllGather, SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

from tests._hypothesis_shim import given, settings, st

torch.set_num_threads(1)

TOL = 1e-5
METRICS = ("ndcg@10", "recall@10")
PAIRS = [(s, h) for s in ("numpy", "torch", "fused")
         for h in ("python", "torch", "kernel")]
WAIT_S = 5.0


def recs(n, prefix="r", start=0):
    return [{"_id": f"{prefix}{start + i}", "text": f"text {prefix} {i} "
             + "x" * (i % 7)} for i in range(n)]


def eager(view: DatasetView) -> list[dict]:
    """The oracle: materialize everything."""
    return [view.row(i) for i in range(len(view))]


def assert_matches(view, expected_rows):
    """View == eager reference on every access surface.  An id that
    ``expected_rows`` holds more than once (a select that repeats a
    position) is looked up to any one of its positions."""
    assert len(view) == len(expected_rows)
    assert eager(view) == expected_rows
    assert view.rows(0, len(view)) == expected_rows
    want_ids = [r.get("_id") for r in expected_rows]
    np.testing.assert_array_equal(
        view.id_hashes, [stable_id_hash(i) for i in want_ids])
    assert view.raw_ids() == want_ids
    assert list(view.texts()) == [row_text(r) for r in expected_rows]
    for i in (0, len(expected_rows) - 1):
        if expected_rows:
            holders = [j for j, w in enumerate(want_ids)
                       if w == want_ids[i]]
            assert view.index_of(want_ids[i]) in holders
            assert view.get(want_ids[i]) == expected_rows[i]
            assert want_ids[i] in view
    assert "no-such-id" not in view


# -- single combinators vs oracle ---------------------------------------------


def test_records_leaf_roundtrip():
    r = recs(13)
    assert_matches(RecordsView(r), r)


def test_dict_leaf_matches_mapping():
    d = {f"k{i}": f"v{i}" for i in range(9)}
    v = as_view(d)
    assert_matches(v, [{"_id": k, "text": t} for k, t in d.items()])
    assert v.raw_ids() == list(d)


def test_filter_matches_eager():
    r = recs(31)
    pred = lambda rec: len(rec["text"]) % 3 == 0          # noqa: E731
    v = RecordsView(r).filter(pred)
    assert isinstance(v, FilterView)
    assert_matches(v, [x for x in r if pred(x)])


def test_filter_is_lazy_until_first_access():
    calls = []

    def pred(rec):
        calls.append(rec["_id"])
        return True

    v = RecordsView(recs(8)).filter(pred)
    w = ConcatView(v, RecordsView(recs(3, "o")))   # composing stays free
    assert calls == []
    assert len(w) == 11                            # first access scans once
    assert len(calls) == 8
    len(w)
    assert len(calls) == 8                         # index is cached


def test_map_matches_eager():
    r = recs(17)
    fn = lambda rec: {**rec, "text": rec["text"].upper()}  # noqa: E731
    v = RecordsView(r).map(fn)
    assert isinstance(v, MapView)
    assert_matches(v, [fn(x) for x in r])


def test_map_rekey_recomputes_hashes():
    r = recs(6)
    fn = lambda rec: {**rec, "_id": "ns-" + rec["_id"]}    # noqa: E731
    v = RecordsView(r).map(fn, rekey=True)
    assert_matches(v, [fn(x) for x in r])
    assert v.index_of("ns-r3") == 3
    # without rekey, ids are answered from the parent
    np.testing.assert_array_equal(
        RecordsView(r).map(fn).id_hashes, RecordsView(r).id_hashes)


def test_select_positions_ids_mask_negative():
    r = recs(10)
    base = RecordsView(r)
    assert isinstance(base.select([1]), SelectView)
    assert_matches(base.select([7, 2, 2, 0]),
                   [r[7], r[2], r[2], r[0]])
    assert_matches(base.select(["r4", "r9"]), [r[4], r[9]])
    mask = np.zeros(10, bool)
    mask[[1, 5]] = True
    assert_matches(base.select(mask), [r[1], r[5]])
    assert_matches(base.select([-1, -10]), [r[9], r[0]])
    assert_matches(base.select(np.asarray([3, 8], np.uint32)), [r[3], r[8]])
    with pytest.raises(IndexError):
        base.select([10])
    with pytest.raises(IndexError):
        base.select([-11])
    with pytest.raises(IndexError):
        base.select(np.zeros(4, bool))
    with pytest.raises(KeyError):
        base.select(["nope"])


@pytest.mark.parametrize("positions", ([0, 0], [3, 1, 3, 3], [5, 0, 5]))
def test_select_repeated_positions(positions):
    """A select that repeats a position (ROADMAP §3 fault 2): rows and
    id_hashes follow the positions, repeats included.  ``index_of`` and
    ``get`` of a repeated id are held only to *one of* the positions
    that hold it: the reference's code answers the first, its property
    oracle (``tests/test_views.py``) expects the last, and neither is
    fixed here."""
    r = recs(6)
    parts = ConcatView(RecordsView(r[:3]), RecordsView(r[3:]))
    v = parts.select(positions)
    want = [r[p] for p in positions]
    assert eager(v) == want
    assert v.rows(0, len(v)) == want
    np.testing.assert_array_equal(
        v.id_hashes, [stable_id_hash(x["_id"]) for x in want])
    for p in set(positions):
        holders = [j for j, q in enumerate(positions) if q == p]
        assert v.index_of(r[p]["_id"]) in holders
        assert v.get(r[p]["_id"]) == r[p]


def test_concat_matches_eager():
    a, b, c = recs(5, "a"), recs(0, "b"), recs(7, "c")
    v = ConcatView(RecordsView(a), RecordsView(b), RecordsView(c))
    assert_matches(v, a + b + c)
    assert_matches(RecordsView(a) + RecordsView(c), a + c)
    assert_matches(RecordsView(a).concat(RecordsView(b), RecordsView(c)),
                   a + b + c)
    assert v.row(-1) == c[-1]
    # spans crossing child boundaries
    assert v.rows(3, 9) == (a + c)[3:9]
    with pytest.raises(ValueError):
        ConcatView()


def test_interleave_round_robin_order():
    a, b = recs(4, "a"), recs(2, "b")
    v = InterleaveView(RecordsView(a), RecordsView(b))
    want = [a[0], b[0], a[1], b[1], a[2], a[3]]   # b drops out after 2
    assert_matches(v, want)
    assert_matches(RecordsView(a).interleave(RecordsView(b)), want)


def test_nested_composition_matches_eager():
    r = recs(40)
    pred = lambda rec: int(rec["_id"][1:]) % 2 == 0        # noqa: E731
    fn = lambda rec: {**rec, "text": rec["text"][::-1]}    # noqa: E731
    other = recs(11, "z")
    v = (RecordsView(r).filter(pred).map(fn)
         + RecordsView(other)).select(list(range(0, 25, 2))[::-1])
    ref = [fn(x) for x in r if pred(x)] + other
    ref = [ref[i] for i in list(range(0, 25, 2))[::-1]]
    assert_matches(v, ref)
    deep = v.interleave(RecordsView(recs(3, "w"))).filter(
        lambda rec: not rec["_id"].startswith("w"))
    assert_matches(deep, ref)


# -- streaming contract -------------------------------------------------------


@pytest.mark.parametrize("lo,hi,chunk", [(0, 23, 5), (3, 17, 4),
                                         (0, 23, 64), (7, 7, 3)])
def test_open_slice_ordered_chunks(lo, hi, chunk):
    r = recs(23)
    v = RecordsView(r)
    got, offs = [], []
    for off, rows in v.open_slice(lo, hi, chunk):
        offs.append(off)
        assert len(rows) <= chunk
        got.extend(rows)
    assert got == r[lo:hi]
    assert offs == list(range(lo, hi, chunk))


def test_open_slice_clamps_hi_and_evicts():
    evicted = []

    class Spy(RecordsView):
        def evict(self, lo, hi):
            evicted.append((lo, hi))

    v = Spy(recs(10))
    rows = [r for _, chunk in v.open_slice(0, 999, 4) for r in chunk]
    assert len(rows) == 10
    assert evicted == [(0, 4), (4, 8), (8, 10)]
    assert [r["_id"] for r in v.iter_rows()] == [x["_id"] for x in rows]


def test_combinators_propagate_evict():
    evicted = []

    class Spy(RecordsView):
        def evict(self, lo, hi):
            evicted.append((lo, hi))

    v = (Spy(recs(12)).filter(lambda r: True)
         + Spy(recs(4, "b"))).select(list(range(14)))
    list(v.open_slice(0, len(v), 6))
    assert evicted                                 # reached the leaves
    assert all(0 <= lo < hi <= 12 for lo, hi in evicted)
    evicted.clear()
    inter = InterleaveView(Spy(recs(3)), Spy(recs(2, "b"))).map(
        lambda r: r)
    list(inter.open_slice(0, len(inter), 2))
    assert sorted(evicted) == [(0, 1), (0, 1), (1, 2), (1, 2), (2, 3)]


def test_viewtexts_lazy_sequence():
    r = recs(9)
    t = ViewTexts(RecordsView(r))
    want = [row_text(x) for x in r]
    assert len(t) == 9
    assert t[4] == want[4]
    assert t[2:7] == want[2:7]
    assert t[1:8:3] == want[1:8:3]
    assert list(t) == want
    assert t[-2:] == want[-2:]


def test_table_view_over_mmap(retrieval_data, tmp_path):
    d = retrieval_data["dir"]
    m = MaterializedQRel(MaterializedQRelConfig(
        qrel_path=f"{d}/qrels/train.tsv", query_path=f"{d}/queries.jsonl",
        corpus_path=f"{d}/corpus.jsonl"), str(tmp_path))
    v = m.corpus_view()
    assert isinstance(v, TableView)
    assert len(v) == len(retrieval_data["corpus"])
    for did, text in list(retrieval_data["corpus"].items())[:5]:
        assert v.get(did)["text"] == text
        assert v.text(v.index_of(did)) == m.doc_text(stable_id_hash(did))
    # a full streaming scan (with page eviction) sees every row once
    seen = [r["_id"] for _, rows in v.open_slice(0, len(v), 7)
            for r in rows]
    assert seen == list(retrieval_data["corpus"])


def test_as_view_coercions(tmp_path):
    v = RecordsView(recs(3))
    assert as_view(v) is v
    assert isinstance(as_view({"a": "t"}), DictView)
    assert isinstance(as_view(recs(2)), RecordsView)
    assert isinstance(as_view(tuple(recs(2))), RecordsView)
    assert len(as_view([])) == 0
    table = MMapTable.build(recs(4), str(tmp_path / "t"))
    tv = as_view(table)
    assert isinstance(tv, TableView)
    assert_matches(tv, recs(4))
    with pytest.raises(TypeError):
        as_view(42)
    with pytest.raises(TypeError):
        as_view(["not", "records"])


# -- the same composition in both packages ------------------------------------


def _compositions(pkg, table_dir):
    """Named constructors of one composition each, over ``pkg``'s classes
    (``pkg`` is ``repro.data.views`` or ``repro_torch.data.views``)."""
    r, o = recs(30), recs(9, "o")
    table = (RefTable if pkg is ref_views else MMapTable)(table_dir)
    pred = lambda rec: len(rec["text"]) % 3 != 1           # noqa: E731
    up = lambda rec: {**rec, "text": rec["text"].upper()}  # noqa: E731
    ns = lambda rec: {**rec, "_id": "ns-" + rec["_id"]}    # noqa: E731
    return {
        "filter_map_concat": lambda: pkg.ConcatView(
            pkg.RecordsView(r).filter(pred).map(up), pkg.TableView(table)),
        "rekey_interleave": lambda: pkg.InterleaveView(
            pkg.RecordsView(r).map(ns, rekey=True), pkg.as_view(
                {x["_id"]: x["text"] for x in o})),
        "select_of_concat": lambda: (pkg.TableView(table)
                                     + pkg.RecordsView(r)).select(
            [38, 0, -1, 12, 11, 27]),
        "select_ids_mask": lambda: pkg.RecordsView(r).select(
            np.arange(30) % 4 == 1).select(["r5", "r29", "r1"]),
    }


@pytest.mark.parametrize("name", ("filter_map_concat", "rekey_interleave",
                                  "select_of_concat", "select_ids_mask"))
def test_same_composition_in_both_packages(tmp_path, name):
    MMapTable.build(recs(11, "t"), str(tmp_path / "t"))
    want = _compositions(ref_views, str(tmp_path / "t"))[name]()
    got = _compositions(port_views, str(tmp_path / "t"))[name]()
    assert len(got) == len(want)
    assert eager(got) == eager(want)
    np.testing.assert_array_equal(got.id_hashes, want.id_hashes)
    assert got.raw_ids() == want.raw_ids()
    assert list(got.texts()) == list(want.texts())
    assert [(o, rows) for o, rows in got.open_slice(0, len(got), 4)] == [
        (o, rows) for o, rows in want.open_slice(0, len(want), 4)]


# -- end-to-end: rankings through views == rankings through dicts -------------


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a W = 2 test within seconds."""
    monkeypatch.setattr(fair_sharding.FairSharder, "ACQUIRE_TIMEOUT_S",
                        WAIT_S)
    monkeypatch.setattr(InMemoryAllGather, "BARRIER_TIMEOUT_S", WAIT_S)


@pytest.fixture(scope="module")
def port(tiny_lm_cfg, tiny_params):
    fields = {f: getattr(tiny_lm_cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "activation", "norm", "qkv_bias",
        "rope_theta", "pooling")}
    cfg = tf.LMConfig(**fields, dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, tiny_params), cfg,
                             device="cpu")
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    collator = RetrievalCollator(DataArguments(vocab_size=257),
                                 HashTokenizer(257))

    def make(score_impl="fused", heap_impl="kernel", **workers):
        args = EvaluationArguments(topk=10, score_impl=score_impl,
                                   heap_impl=heap_impl, metrics=METRICS)
        return RetrievalEvaluator(args, retriever, collator, params,
                                  device="cpu", **workers)
    return make


@pytest.fixture(scope="module")
def reference_search(tiny_retriever, tiny_params, retrieval_data):
    """The reference's search of the same composed corpus through its
    own views (its ``jax`` backends)."""
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ev = JaxEvaluator(JaxEvalArgs(topk=10, metrics=METRICS),
                      tiny_retriever, coll, tiny_params)
    items = list(retrieval_data["corpus"].items())
    half = len(items) // 2
    view = ref_views.ConcatView(
        ref_views.RecordsView([{"_id": k, "text": t}
                               for k, t in items[:half]]),
        ref_views.as_view(dict(items[half:])))
    return ev.search(ref_views.as_view(retrieval_data["queries"]), view)


def _split_view(corpus):
    items = list(corpus.items())
    half = len(items) // 2
    return ConcatView(
        RecordsView([{"_id": k, "text": t} for k, t in items[:half]]),
        as_view(dict(items[half:])))


def _separated(vals):
    inf = np.full_like(vals[:, :1], np.inf)
    up = np.concatenate([inf, vals[:, :-1]], 1) - vals
    down = vals - np.concatenate([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def _assert_close_ranking(got, want):
    """scores within TOL, ids equal where the ranking is unambiguous."""
    (gi, gv), (wi, wv) = got, want
    np.testing.assert_allclose(gv, wv, atol=TOL, rtol=0)
    sep = _separated(wv)
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(gi[sep], wi[sep])


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("score_impl,heap_impl", PAIRS)
def test_search_views_bitwise_equals_dicts(port, retrieval_data,
                                           reference_search, score_impl,
                                           heap_impl):
    """Composed lazy corpus == eager dict corpus, identical rankings;
    within TOL of the reference's search of the same composition."""
    ev = port(score_impl, heap_impl)
    want = ev.search(retrieval_data["queries"], retrieval_data["corpus"])
    got = ev.search(as_view(retrieval_data["queries"]),
                    _split_view(retrieval_data["corpus"]))
    _assert_bitwise(got, want)
    np.testing.assert_array_equal(got[0], reference_search[0])
    _assert_close_ranking(got[1:], reference_search[1:])


def test_search_filtered_view_equals_filtered_dict(port, retrieval_data):
    ev = port("torch", "kernel")
    corpus = retrieval_data["corpus"]
    keep = {k: t for k, t in corpus.items() if "topic1" not in t}
    assert 0 < len(keep) < len(corpus)
    _, ids_ref, s_ref = ev.search(retrieval_data["queries"], keep)
    view = as_view(corpus).filter(lambda r: "topic1" not in r["text"])
    _, ids, s = ev.search(retrieval_data["queries"], view)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_array_equal(s, s_ref)


@pytest.mark.distributed
@pytest.mark.parametrize("score_impl,heap_impl", PAIRS)
def test_search_views_sharded_equals_single(port, retrieval_data,
                                            reference_search, score_impl,
                                            heap_impl):
    """W = 2 simulated workers over a ConcatView == the W = 1 dict-corpus
    search on every rank, bitwise; within TOL of the reference."""
    want = port(score_impl, heap_impl).search(retrieval_data["queries"],
                                              retrieval_data["corpus"])
    cluster = SimulatedCluster(2)
    evs = [port(score_impl, heap_impl, process_index=rank, process_count=2,
                gather=cluster.gather, sharder=cluster.sharder)
           for rank in range(2)]
    outs = cluster.run(lambda rank: evs[rank].search(
        retrieval_data["queries"], _split_view(retrieval_data["corpus"])))
    for got in outs:
        _assert_bitwise(got, want)
        _assert_close_ranking(got[1:], reference_search[1:])


# -- property tests (skip individually when hypothesis is absent) -------------


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 60), st.integers(1, 17), st.integers(0, 7))
def test_property_open_slice_partitions(n, chunk, mod):
    r = recs(n)
    v = RecordsView(r).filter(lambda rec: len(rec["text"]) % 7 != mod)
    want = [x for x in r if len(x["text"]) % 7 != mod]
    got = [x for _, rows in v.open_slice(0, len(v), chunk) for x in rows]
    assert got == want


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 25), max_size=30), st.integers(1, 4))
def test_property_compositions_match_eager(positions, k):
    """Repeated positions are drawn too; ``assert_matches`` then holds
    ``index_of`` to any position of the repeated id (fault 2)."""
    parts = [recs(9, f"p{j}") for j in range(k)]
    flat = [x for p in parts for x in p]
    v = ConcatView(*[RecordsView(p) for p in parts])
    sel = [p % len(flat) for p in positions]
    assert_matches(v.select(sel), [flat[i] for i in sel])
    inter = InterleaveView(*[RecordsView(p) for p in parts])
    ref = [p[i] for i in range(9) for p in parts]
    assert_matches(inter, ref)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 40), st.integers(0, 40), st.integers(1, 9))
def test_property_concat_rows_spans(a_n, b_n, chunk):
    a, b = recs(a_n, "a"), recs(b_n, "b")
    v = RecordsView(a) + RecordsView(b)
    ref = a + b
    for lo in range(0, len(ref) + 1, chunk):
        hi = min(lo + chunk * 2, len(ref))
        assert v.rows(lo, hi) == ref[lo:hi]

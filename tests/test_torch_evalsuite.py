"""The port's multi-dataset eval suite, against the eager union and
against the reference.

The cases of ``tests/test_evalsuite.py`` run on the port (``device=
"cpu"``, the reference's encoder weights through ``params_from_jax``):
per-dataset rows equal solo evaluations, the combined pass over a
``ConcatView`` is bitwise equal to a search of the eagerly merged dict
union, duplicate ids across datasets raise, rank 0 writes the tables,
``MaterializedQRel``-backed views give the tables plain dicts give, W = 2
equals W = 1, and the launcher runs end to end.  The combined pass over
a ``ConcatView`` of ``TableView``s is held bitwise to the dict union for
every score_impl x heap_impl pair at W = 1 and W = 2, and through every
path of ``prepare_corpus``.  The port's tables are held to the
reference's ``evaluate_suite`` on the same data: rankings within
``TOL = 1e-5`` (ids equal where neighbours are separated), metrics
within 1e-6.  Waits are bounded, so a lost worker fails in seconds.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.launch.evalsuite import build_scenarios as ref_build_scenarios
from repro_torch.core import fair_sharding
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import RetrievalEvaluator, format_metrics_table
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.views import ConcatView, TableView, as_view
from repro_torch.launch import evalsuite
from repro_torch.launch.distributed import InMemoryAllGather, SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

torch.set_num_threads(1)

TOL = 1e-5
METRICS = ("ndcg@10", "mrr@10")
PAIRS = [(s, h) for s in ("numpy", "torch", "fused")
         for h in ("python", "torch", "kernel")]
WAIT_S = 5.0


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a W = 2 test within seconds."""
    monkeypatch.setattr(fair_sharding.FairSharder, "ACQUIRE_TIMEOUT_S",
                        WAIT_S)
    monkeypatch.setattr(InMemoryAllGather, "BARRIER_TIMEOUT_S", WAIT_S)


@pytest.fixture(scope="module")
def suite_data(tmp_path_factory):
    """Two synthetic datasets with disjoint (prefixed) id spaces, as
    dicts and as the directories they were written to."""
    root = tmp_path_factory.mktemp("suite")
    out, dirs = {}, []
    for i in range(2):
        d = str(root / f"d{i}")
        q, c, r = make_retrieval_dataset(
            d, n_queries=12, n_docs=48, n_topics=6, seed=20 + i,
            id_prefix=f"d{i}-")
        out[f"d{i}"] = {"queries": q, "corpus": c, "qrels": r}
        dirs.append(d)
    return {"dicts": out, "dirs": dirs,
            "cache_root": str(root / "tables")}


def _union(scenarios):
    union = {k: {} for k in ("queries", "corpus", "qrels")}
    for sc in scenarios.values():
        for k in union:
            union[k].update(sc[k])
    return union


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


@pytest.fixture()
def evaluator(port):
    return port()


def _table_scenarios(suite_data):
    return evalsuite.build_scenarios(suite_data["dirs"],
                                     suite_data["cache_root"])


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _separated(vals):
    inf = np.full_like(vals[:, :1], np.inf)
    up = np.concatenate([inf, vals[:, :-1]], 1) - vals
    down = vals - np.concatenate([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def _cluster_evaluators(port, score_impl, heap_impl, world=2):
    cluster = SimulatedCluster(world)
    return cluster, [port(score_impl, heap_impl, process_index=rank,
                          process_count=world, gather=cluster.gather,
                          sharder=cluster.sharder)
                     for rank in range(world)]


# -- the reference's cases, on the port ---------------------------------------


def test_suite_per_dataset_rows_match_individual_eval(evaluator,
                                                      suite_data):
    scenarios = suite_data["dicts"]
    results = evaluator.evaluate_suite(scenarios)
    assert set(results) == {"d0", "d1", "combined"}
    for name, sc in scenarios.items():
        solo = evaluator.evaluate(sc["queries"], sc["corpus"], sc["qrels"])
        assert results[name] == solo


def test_suite_combined_equals_eager_union_oracle(evaluator, suite_data):
    """The ConcatView combined pass == evaluating eagerly merged dicts."""
    results = evaluator.evaluate_suite(suite_data["dicts"])
    union = _union(suite_data["dicts"])
    oracle = evaluator.evaluate(union["queries"], union["corpus"],
                                union["qrels"])
    assert results["combined"] == oracle


@pytest.mark.parametrize("score_impl,heap_impl", PAIRS)
def test_suite_combined_rankings_bitwise(port, suite_data, score_impl,
                                         heap_impl):
    """The combined search over a ConcatView of TableViews is bitwise
    equal to searching the eagerly merged dict union, and the combined
    row of the suite equals the union's evaluation."""
    ev = port(score_impl, heap_impl)
    union = _union(suite_data["dicts"])
    want = ev.search(union["queries"], union["corpus"])
    scenarios = _table_scenarios(suite_data)
    q_view = ConcatView(*[sc["queries"] for sc in scenarios.values()])
    c_view = ConcatView(*[sc["corpus"] for sc in scenarios.values()])
    assert all(isinstance(v, TableView) for v in c_view.parents)
    _assert_bitwise(ev.search(q_view, c_view), want)
    results = ev.evaluate_suite(scenarios)
    assert results["combined"] == ev.evaluate(
        union["queries"], union["corpus"], union["qrels"])


def test_suite_rejects_duplicate_ids(evaluator, tmp_path):
    q, c, r = make_retrieval_dataset(str(tmp_path / "dup"), n_queries=6,
                                     n_docs=24, n_topics=4)
    scenarios = {"a": {"queries": q, "corpus": c, "qrels": r},
                 "b": {"queries": dict(q), "corpus": dict(c),
                       "qrels": dict(r)}}
    with pytest.raises(ValueError, match="duplicate query ids"):
        evaluator.evaluate_suite(scenarios)
    # doc ids alone colliding raise too
    renamed = {"x-" + k: v for k, v in q.items()}
    scenarios["b"] = {"queries": renamed, "corpus": dict(c),
                      "qrels": {"x-" + k: v for k, v in r.items()}}
    with pytest.raises(ValueError, match="duplicate doc ids"):
        evaluator.evaluate_suite(scenarios)
    # per-dataset still fine when the combined pass is off
    results = evaluator.evaluate_suite(scenarios, combined=False)
    assert set(results) == {"a", "b"}


def test_suite_writes_tables(evaluator, suite_data, tmp_path):
    out = str(tmp_path / "results")
    results = evaluator.evaluate_suite(suite_data["dicts"], out_dir=out,
                                       suite_name="mysuite")
    payload = json.load(open(os.path.join(out, "mysuite.json")))
    assert payload["suite"] == "mysuite"
    assert payload["datasets"] == ["d0", "d1"]
    assert payload["metrics"] == list(METRICS)
    assert payload["results"] == results
    md = open(os.path.join(out, "mysuite.md")).read()
    assert md == format_metrics_table(results)
    for name in ("d0", "d1", "combined"):
        assert f"| {name}" in md
    for m, val in results["combined"].items():
        assert m in md
        assert f"{val:.4f}" in md


def test_suite_with_materialized_views(evaluator, suite_data):
    """The launcher path: MaterializedQRel-backed views and hash-keyed
    qrels give the same tables as plain dicts."""
    scenarios = _table_scenarios(suite_data)
    for sc in scenarios.values():
        assert isinstance(sc["queries"], TableView)
        assert isinstance(sc["corpus"], TableView)
        assert all(isinstance(q, int) for q in sc["qrels"])
    assert evaluator.evaluate_suite(scenarios) == \
        evaluator.evaluate_suite(suite_data["dicts"])


@pytest.mark.distributed
@pytest.mark.parametrize("score_impl,heap_impl", PAIRS)
def test_suite_sharded_equals_single(port, suite_data, tmp_path,
                                     score_impl, heap_impl):
    """W = 2 simulated workers over TableViews: each rank's tables equal
    W = 1's, the combined search is bitwise equal to the W = 1 dict
    union's on every rank, and only worker 0 writes."""
    ref = port(score_impl, heap_impl).evaluate_suite(suite_data["dicts"])
    union = _union(suite_data["dicts"])
    want = port(score_impl, heap_impl).search(union["queries"],
                                              union["corpus"])
    scenarios = _table_scenarios(suite_data)
    out = str(tmp_path / "w2")
    cluster, evs = _cluster_evaluators(port, score_impl, heap_impl)
    outs = cluster.run(lambda rank: evs[rank].evaluate_suite(
        scenarios, out_dir=out if rank == 1 else None, suite_name="w2"))
    for res in outs:
        assert res == ref
    assert not os.path.exists(out)          # rank 1 asked, did not write
    outs = cluster.run(lambda rank: evs[rank].evaluate_suite(
        scenarios, out_dir=out, suite_name="w2"))
    assert json.load(open(os.path.join(out, "w2.json")))["results"] == ref
    q_view = ConcatView(*[sc["queries"] for sc in scenarios.values()])
    c_view = ConcatView(*[sc["corpus"] for sc in scenarios.values()])
    for got in cluster.run(lambda rank: evs[rank].search(q_view, c_view)):
        _assert_bitwise(got, want)


def test_evalsuite_cli_smoke(tmp_path, capsys):
    """The launcher end to end on a tiny synthetic suite, on the CPU."""
    results = evalsuite.main([
        "--smoke", "--device", "cpu", "--data-root", str(tmp_path / "data"),
        "--out-dir", str(tmp_path / "results"),
        "--n-queries", "6", "--n-docs", "24", "--topk", "5"])
    assert set(results) == {"d0", "d1", "combined"}
    payload = json.load(open(tmp_path / "results" / "evalsuite.json"))
    assert payload["results"] == results
    assert "2 datasets (d0: 6q/24d, d1: 6q/24d) on 1 process(es) (cpu)" in \
        capsys.readouterr().out
    # the shared cache, the encoder's own, holds both corpora after the run
    cache = EmbeddingCache(str(tmp_path / "data" / "emb_cache"
                               / "trove-base-smoke"), dim=64)
    assert cache.n_live == 48


def test_evalsuite_cli_lm_arch(tmp_path):
    """``--arch qwen2-0.5b --smoke``: the launcher's tables equal an
    in-process ``evaluate_suite`` over the same files with the same seeded
    params and a cold cache of its own, and its shared cache is the
    encoder's own directory."""
    from repro_torch.configs import qwen2_0_5b

    root = tmp_path / "data"
    results = evalsuite.main([
        "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
        "--data-root", str(root), "--out-dir", str(tmp_path / "results"),
        "--n-queries", "6", "--n-docs", "24", "--topk", "5"])
    cfg = qwen2_0_5b.reduced()
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    ev = RetrievalEvaluator(
        EvaluationArguments(topk=5), retriever,
        RetrievalCollator(DataArguments(vocab_size=cfg.vocab_size),
                          HashTokenizer(cfg.vocab_size)),
        retriever.init_params(torch.Generator().manual_seed(0), "cpu"),
        device="cpu")
    scenarios = evalsuite.build_scenarios(
        [str(root / "d0"), str(root / "d1")], str(tmp_path / "tables"))
    want = ev.evaluate_suite(scenarios, cache=EmbeddingCache(
        str(tmp_path / "check"), dim=cfg.d_model))
    assert results == want
    assert os.listdir(root / "emb_cache") == ["qwen2-0.5b-smoke"]


@pytest.mark.distributed
def test_evalsuite_cli_workers_and_no_cache(tmp_path):
    """``--workers 2`` and ``--no-cache`` give W = 1's tables."""
    base = ["--smoke", "--device", "cpu", "--data-root",
            str(tmp_path / "data"), "--n-queries", "6", "--n-docs", "24",
            "--topk", "5", "--score-impl", "torch"]
    one = evalsuite.main(base + ["--no-cache", "--out-dir",
                                 str(tmp_path / "r1")])
    two = evalsuite.main(base + ["--no-cache", "--workers", "2",
                                 "--out-dir", str(tmp_path / "r2")])
    assert one == two
    assert not os.path.exists(tmp_path / "data" / "emb_cache")
    assert json.load(open(tmp_path / "r2" / "evalsuite.json"))[
        "results"] == one


def test_evalsuite_cli_refusals(tmp_path):
    """An arch of another family than the LM encoders (the GNN, a recsys
    ranker) raises a ValueError before any work, as the reference's
    launchers drive LM encoders only (qwen2-0.5b is one:
    test_evalsuite_cli_lm_arch); no card and no ``--device cpu`` raises
    instead of moving to the CPU."""
    for arch in ("graphsage-reddit", "deepfm"):
        with pytest.raises(ValueError, match="LM encoders only"):
            evalsuite.main(["--arch", arch, "--device", "cpu",
                            "--data-root", str(tmp_path / "data")])
    assert not os.path.exists(tmp_path / "data")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evalsuite.main(["--smoke", "--data-root",
                            str(tmp_path / "data"), "--out-dir",
                            str(tmp_path / "results")])
        assert not os.path.exists(tmp_path / "results")


# -- every prepare_corpus path over a ConcatView of TableViews ----------------


@pytest.mark.parametrize("path", ("online", "covering_cache",
                                  "uncovering_cache", "device_resident"))
def test_prepare_corpus_takes_a_concat_of_tables(port, suite_data,
                                                 tmp_path, path):
    """prepare_corpus + search_prepared over a ConcatView of TableViews
    == the same over the dict union, bitwise, on each of its paths."""
    ev = port("torch", "kernel")
    union = _union(suite_data["dicts"])
    scenarios = _table_scenarios(suite_data)
    c_view = ConcatView(*[sc["corpus"] for sc in scenarios.values()])
    caches = {}
    if path in ("covering_cache", "uncovering_cache"):
        for name in ("view", "dict"):
            caches[name] = EmbeddingCache(str(tmp_path / name), dim=32)
            if path == "covering_cache":
                ev.search(union["queries"], union["corpus"],
                          cache=caches[name])
            else:       # the cache holds the first dataset's docs only
                ev.search(union["queries"], suite_data["dicts"]["d0"][
                    "corpus"], cache=caches[name])
    outs = {}
    for name, corpus in (("view", c_view), ("dict", union["corpus"])):
        prepared = ev.prepare_corpus(
            corpus, caches.get(name),
            device_resident=path == "device_resident")
        try:
            outs[name] = ev.search_prepared(union["queries"], prepared)
            if path == "covering_cache":
                assert prepared.generation is not None
        finally:
            prepared.close()
    _assert_bitwise(outs["view"], outs["dict"])
    if path == "uncovering_cache":
        assert caches["view"].n_live == len(union["corpus"])


def test_suite_shared_cache_combined_pass_encodes_nothing(port, suite_data,
                                                          tmp_path):
    """One cache across the passes: the per-dataset passes fill it, the
    combined pass encodes no corpus row, and its rankings are bitwise
    equal to the same warm pass over the dict union."""
    ev = port("fused", "kernel")
    cache = EmbeddingCache(str(tmp_path / "c"), dim=32)
    seen = []
    encode = ev._encode_texts

    def counting(texts, is_query, *a, **kw):
        if not is_query:
            seen.append(len(texts))
        return encode(texts, is_query, *a, **kw)

    ev._encode_texts = counting
    scenarios = _table_scenarios(suite_data)
    for sc in scenarios.values():
        ev.evaluate(sc["queries"], sc["corpus"], sc["qrels"], cache=cache)
    assert sum(seen) == 96
    seen.clear()
    results = ev.evaluate_suite(scenarios, cache=cache)
    assert seen == []
    union = _union(suite_data["dicts"])
    assert results["combined"] == ev.evaluate(
        union["queries"], union["corpus"], union["qrels"], cache=cache)
    q_view = ConcatView(*[sc["queries"] for sc in scenarios.values()])
    c_view = ConcatView(*[sc["corpus"] for sc in scenarios.values()])
    _assert_bitwise(ev.search(q_view, c_view, cache=cache),
                    ev.search(union["queries"], union["corpus"],
                              cache=cache))
    assert seen == []


# -- against the reference ----------------------------------------------------


def test_suite_tables_match_reference(port, suite_data, tiny_retriever,
                                      tiny_params):
    """The port's suite (over its own tables) against the reference's
    ``evaluate_suite`` (over the reference's tables from the same
    files): combined rankings within TOL, ids equal where separated, and
    every metric within 1e-6."""
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ref = JaxEvaluator(JaxEvalArgs(topk=10, metrics=METRICS),
                       tiny_retriever, coll, tiny_params)
    ref_scenarios = ref_build_scenarios(suite_data["dirs"],
                                        suite_data["cache_root"])
    ev = port("fused", "kernel")
    scenarios = _table_scenarios(suite_data)
    want = ref.evaluate_suite(ref_scenarios)
    got = ev.evaluate_suite(scenarios)
    assert set(got) == set(want) == {"d0", "d1", "combined"}
    from repro.data.views import ConcatView as RefConcat
    _, rids, rvals = ref.search(
        RefConcat(*[sc["queries"] for sc in ref_scenarios.values()]),
        RefConcat(*[sc["corpus"] for sc in ref_scenarios.values()]))
    _, ids, vals = ev.search(
        ConcatView(*[sc["queries"] for sc in scenarios.values()]),
        ConcatView(*[sc["corpus"] for sc in scenarios.values()]))
    np.testing.assert_allclose(vals, rvals, atol=TOL, rtol=0)
    sep = _separated(rvals)
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(ids[sep], rids[sep])
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name


def test_as_view_of_a_dict_suite_is_unchanged(evaluator, suite_data):
    """Views over the dicts (``as_view``) give the dicts' tables."""
    wrapped = {n: {"queries": as_view(sc["queries"]),
                   "corpus": as_view(sc["corpus"]), "qrels": sc["qrels"]}
               for n, sc in suite_data["dicts"].items()}
    assert evaluator.evaluate_suite(wrapped) == \
        evaluator.evaluate_suite(suite_data["dicts"])

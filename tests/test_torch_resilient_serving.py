"""Fault tolerance through the evaluator, the serve frontend and the
launcher, the port against the reference.

The evaluator's ``fault_injector`` and recovery settings
(``round_deadline_s`` / ``shard_retries`` / ``shard_retry_backoff_s``,
forwarded by ``make_driver``), ``deadline_s`` on ``search_prepared`` /
``search_texts`` with the outcome's coverage carried to the caller (and
into ``evaluate``'s report), the serve backends' ``deadline_s`` (the
frontend passes the micro-batch's tightest budget), a resilient
``ServeFrontend.from_cluster`` through a crash, and ``repro_torch.launch.
serve.main --workers 2 --resilient --chaos crash | stall | drop`` at the
reduced width.  On the tiny encoder (the reference's weights through
``params_from_jax``) a recovered search is bitwise equal to the port's
W = 1 search and within ``TOL = 1e-5`` of the reference's W = 1 search
(ids equal where neighbouring scores are more than ``TOL`` apart).  Every
wait is bounded (round deadlines and stalls of a few hundred ms, acquire
waits lowered to seconds).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.core import fair_sharding, serving
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.core.faults import Fault, FaultInjector
from repro_torch.core.serving import EvaluatorServeBackend, ServeFrontend
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.launch import distributed, serve
from repro_torch.launch.distributed import SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

pytestmark = [pytest.mark.faults, pytest.mark.serving]

torch.set_num_threads(1)

TOL = 1e-5
K = 5
WAIT_S = 5.0
RESULT_S = 60
ROUND_DEADLINE_S, STALL_S = 0.15, 0.4
SMOKE = ["--smoke", "--device", "cpu", "--n-requests", "6", "--batch", "5",
         "--max-batch", "8", "--max-wait-ms", "2", "--topk", "7",
         "--round-deadline-s", "0.2"]


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    monkeypatch.setattr(fair_sharding.FairSharder, "ACQUIRE_TIMEOUT_S",
                        WAIT_S)


@pytest.fixture(scope="module")
def port(tiny_lm_cfg, tiny_params):
    """``make(rank, world, cluster, injector, **args)`` -> a port
    evaluator (fused scores, the kernel heap's plain version on the
    CPU) with the tiny encoder."""
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

    def make(rank=0, world=1, cluster=None, injector=None, **kw):
        fields = dict(topk=K, encode_batch_size=16, superchunk_size=2,
                      score_impl="fused", heap_impl="kernel",
                      serve_max_batch=8, serve_max_wait_ms=2.0,
                      round_deadline_s=ROUND_DEADLINE_S,
                      shard_retry_backoff_s=0.01)
        fields.update(kw)
        workers = {}
        if cluster is not None:
            workers = dict(gather=cluster.gather, sharder=cluster.sharder)
        return RetrievalEvaluator(EvaluationArguments(**fields), retriever,
                                  collator, params, device="cpu",
                                  process_index=rank, process_count=world,
                                  fault_injector=injector, **workers)
    return make


@pytest.fixture(scope="module")
def env(port, tiny_retriever, tiny_params, retrieval_data):
    """The corpus device-resident for the port, and the W = 1 searches
    of both packages over it."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ref_ev = JaxEvaluator(JaxEvalArgs(topk=K, encode_batch_size=16,
                                      score_impl="numpy"),
                          tiny_retriever, coll, tiny_params,
                          process_index=0, process_count=1)
    ev = port()
    prepared = ev.prepare_corpus(corpus, device_resident=True)
    texts = list(queries.values())
    return {"queries": queries, "corpus": corpus, "texts": texts,
            "prepared": prepared,
            "reference": ref_ev.search(queries, corpus),
            "w1": ev.search_prepared(queries, prepared),
            "w1_texts": ev.search_texts(texts[:4], prepared)}


def _cluster(port, w, injector, **kw):
    cluster = SimulatedCluster(w, resilient=True)
    evs = [port(r, w, cluster, injector, **kw) for r in range(w)]
    return cluster, evs


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _separated(vals):
    inf = np.full_like(vals[:, :1], np.inf)
    up = np.concatenate([inf, vals[:, :-1]], 1) - vals
    down = vals - np.concatenate([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def _close_to_reference(out, ref):
    (_, ids, vals), (_, rids, rvals) = out, ref
    np.testing.assert_allclose(vals, rvals, atol=TOL, rtol=0)
    sep = _separated(rvals)
    np.testing.assert_array_equal(ids[sep], rids[sep])
    return sep.mean()


# -- settings -----------------------------------------------------------------


@pytest.mark.parametrize("kwargs,name", (
    ({"round_deadline_s": 0}, "round_deadline_s"),
    ({"shard_retries": -1}, "shard_retries"),
    ({"shard_retry_backoff_s": -0.1}, "shard_retry_backoff_s"),
))
def test_recovery_settings_are_validated(kwargs, name):
    with pytest.raises(ValueError, match=name):
        EvaluationArguments(**kwargs)
    with pytest.raises(ValueError, match=name):
        JaxEvalArgs(**kwargs)


def test_recovery_defaults_match_reference():
    ref, got = JaxEvalArgs(), EvaluationArguments()
    for name in ("round_deadline_s", "shard_retries",
                 "shard_retry_backoff_s"):
        assert getattr(got, name) == getattr(ref, name), name


def test_make_driver_forwards_injector_and_recovery_settings(port):
    inj = FaultInjector()
    drv = port(injector=inj, round_deadline_s=0.7, shard_retries=5,
               shard_retry_backoff_s=0.3).make_driver()
    assert drv.fault_injector is inj
    assert (drv.round_deadline_s, drv.max_shard_retries,
            drv.retry_backoff_s) == (0.7, 5, 0.3)


# -- evaluator-level chaos ----------------------------------------------------


def _fault_for(kind):
    if kind == "drop":
        return Fault(kind="drop", worker=1, round=0, phase="gather")
    return Fault(kind=kind, worker=1, round=0, stall_s=STALL_S)


@pytest.mark.parametrize("w", (2, 4))
@pytest.mark.parametrize("kind", ("crash", "stall", "drop"))
def test_evaluator_recovery_matches_w1_and_reference(port, env, kind, w):
    """A resilient cluster of evaluators through one fault: every rank's
    ``search_prepared`` is the port's W = 1 result bitwise, within TOL of
    the reference's W = 1 search, with full coverage."""
    inj = FaultInjector([_fault_for(kind)])
    cluster, evs = _cluster(port, w, inj)
    outs = cluster.run(lambda r: evs[r].search_prepared(env["queries"],
                                                        env["prepared"]))
    assert inj.fired
    for out in outs:
        _bitwise(out, env["w1"])
        assert not out.degraded
        np.testing.assert_array_equal(out.coverage, 1.0)
    assert _close_to_reference(outs[0], env["reference"]) > 0.9


def test_search_texts_deadline_degrades_and_carries_coverage(port, env):
    """A crash whose rescuer stalls: a request deadline resolves the
    round partial, and ``search_texts`` hands its coverage (3 of 4
    shards) to the caller on every rank."""
    inj = FaultInjector([
        Fault(kind="crash", worker=1, round=0),
        Fault(kind="stall", round=0, phase="retry", stall_s=STALL_S,
              repeat=True)])
    cluster, evs = _cluster(port, 4, inj)
    outs = cluster.run(lambda r: evs[r].search_texts(
        env["texts"][:4], env["prepared"], deadline_s=0.1))
    for out in outs:
        assert out.degraded
        np.testing.assert_allclose(out.coverage, 0.75)
        _bitwise(out, outs[0])


def test_evaluate_reports_coverage_of_a_degraded_search(port, env,
                                                        retrieval_data):
    """The retry budget runs out: ``evaluate`` still returns metrics, with
    the coverage and the ``degraded`` flag beside them."""
    inj = FaultInjector([
        Fault(kind="crash", worker=1, round=0),
        Fault(kind="crash", round=0, phase="retry", repeat=True)])
    cluster, evs = _cluster(port, 2, inj, shard_retries=0)
    reports = cluster.run(lambda r: evs[r].evaluate(
        env["queries"], env["corpus"], retrieval_data["qrels"]))
    for rep in reports:
        assert rep["degraded"] is True
        assert rep["coverage"] == pytest.approx(0.5)
    clean = port().evaluate(env["queries"], env["corpus"],
                            retrieval_data["qrels"])
    assert "coverage" not in clean and "degraded" not in clean


# -- the serve frontend -------------------------------------------------------


def test_evaluator_backend_hands_the_budget_to_its_driver(port, env,
                                                          monkeypatch):
    backend = EvaluatorServeBackend(port(), env["corpus"])
    seen = []
    search_async = backend.driver.search_async

    def recording(*args, deadline_s=None, **kw):
        seen.append(deadline_s)
        return search_async(*args, deadline_s=deadline_s, **kw)

    monkeypatch.setattr(backend.driver, "search_async", recording)
    with ServeFrontend(backend, topk=K, max_batch=4, max_wait_ms=1) as fe:
        fe.submit(env["texts"][0]).result(timeout=RESULT_S)
        out = fe.submit(env["texts"][1],
                        deadline_ms=60_000).result(timeout=RESULT_S)
    assert seen[0] is None and 0 < seen[1] <= 60.0
    assert not out.degraded


def test_frontend_deadline_degrades_a_cluster_round(port, env):
    """``deadline_ms`` reaches a resilient cluster's round as
    ``deadline_s``: the request resolves degraded once its budget is
    spent, instead of waiting out the stalled recovery, and counts in
    ``stats["degraded"]``."""
    inj = FaultInjector([
        Fault(kind="crash", worker=1, round=1),
        Fault(kind="stall", round=1, phase="retry", stall_s=0.8,
              repeat=True)])
    cluster, evs = _cluster(port, 4, inj)
    fe = ServeFrontend.from_cluster(evs, cluster, env["corpus"])
    try:
        first = fe.search(env["texts"][0], timeout=RESULT_S)    # round 0
        late = fe.submit(env["texts"][1], deadline_ms=300.0)
        out = late.result(timeout=RESULT_S)
        after = fe.search(env["texts"][2], timeout=RESULT_S)   # rank 1 dead
    finally:
        fe.close()
    assert not first.degraded and not after.degraded
    # rank 1's shard of round 1 (the EMA's share after round 0) is missing
    assert out.degraded
    assert 0.5 < float(out.coverage[0]) < 1.0
    np.testing.assert_array_equal(out.coverage, out.coverage[0])
    assert fe.stats["degraded"] == 1 and fe.stats["failed"] == 0


def test_resilient_frontend_resolves_every_request_through_a_crash(port,
                                                                   env):
    """``from_cluster`` on a resilient W = 2 cluster, rank 1 crashing in a
    steady-state round: every request resolves, each bitwise equal to
    its solo W = 1 ``search_texts``."""
    inj = FaultInjector([Fault(kind="crash", worker=1, round=2)])
    cluster, evs = _cluster(port, 2, inj)
    fe = ServeFrontend.from_cluster(evs, cluster, env["corpus"])
    solo_ev = port()
    try:
        outs = [fe.search(env["texts"][i: i + 2], timeout=RESULT_S)
                for i in range(0, 10, 2)]
    finally:
        fe.close()
    assert inj.fired == [("crash", 1, 2, "load")]
    assert cluster.health.dead == {1}
    for i, out in zip(range(0, 10, 2), outs):
        assert not out.degraded
        want = solo_ev.search_texts(env["texts"][i: i + 2],
                                    env["prepared"], min_batch_dim=1)
        _bitwise(out, want)
    assert fe.stats["completed"] == 5 and fe.stats["degraded"] == 0


# -- the launcher -------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One data directory (and embedding cache) for the launcher runs."""
    path = str(tmp_path_factory.mktemp("serve_chaos"))
    serve.main(SMOKE + ["--data-dir", path, "--workers", "1"])
    return path


@pytest.mark.parametrize("kind", ("crash", "stall", "drop"))
def test_serve_main_chaos_resolves_every_request(data_dir, capsys, kind):
    stats = serve.main(SMOKE + ["--data-dir", data_dir, "--workers", "2",
                                "--resilient", "--chaos", kind])
    out = capsys.readouterr().out
    chaos = [line for line in out.splitlines() if line.startswith("chaos:")]
    assert chaos == [f"chaos: injected [{kind}@r4] -> 1 fired, 6/6 "
                     f"requests resolved, 0 degraded, 0 expired"]
    fs = stats["frontend"]
    assert fs["completed"] == 6 + 4 and fs["failed"] == 0
    assert stats["label"] == "2 simulated workers (resilient)"


def test_serve_main_chaos_needs_a_resilient_cluster(data_dir):
    for extra in (["--workers", "2"], ["--resilient", "--workers", "1"]):
        with pytest.raises(SystemExit):
            serve.main(SMOKE + ["--data-dir", data_dir, "--chaos", "crash",
                                *extra])


def test_serve_main_resilient_without_chaos_matches_barrier(data_dir,
                                                           monkeypatch):
    """``--resilient`` alone changes no result: the same requests as the
    barrier cluster, bitwise, with no rank marked dead and no shard
    rescored in any round."""
    runs = {}
    submit = serving.ServeFrontend.submit
    search = ShardedSearchDriver.search
    for name, extra in (("barrier", []), ("resilient", ["--resilient"])):
        futs, clusters, rounds = [], [], []

        def recording(self, request, deadline_ms=None, futs=futs):
            futs.append(submit(self, request, deadline_ms))
            return futs[-1]

        def logged_search(driver, *args, rounds=rounds, **kw):
            out = search(driver, *args, **kw)
            rounds.append(driver.stats)
            return out

        class Recorded(SimulatedCluster):
            def __init__(self, *args, clusters=clusters, **kw):
                super().__init__(*args, **kw)
                clusters.append(self)

        with monkeypatch.context() as m:
            m.setattr(serving.ServeFrontend, "submit", recording)
            m.setattr(ShardedSearchDriver, "search", logged_search)
            m.setattr(distributed, "SimulatedCluster", Recorded)
            serve.main(SMOKE + ["--data-dir", data_dir, "--workers", "2",
                                *extra])
        runs[name] = [f.result(timeout=RESULT_S) for f in futs]
        (cluster,) = clusters
        assert rounds and len(rounds) % 2 == 0     # both ranks, each round
        if name == "resilient":
            assert cluster.health.dead == set()
            assert not any(st["rescored"] for st in rounds)
    for got, want in zip(runs["resilient"], runs["barrier"]):
        _bitwise(got, want)

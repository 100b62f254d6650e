"""The continuous-batching serve frontend, the port against the reference.

``repro_torch.core.serving`` (``ServeFrontend``, ``EvaluatorServeBackend``,
``ClusterServeBackend``) and ``ShardedSearchDriver.search_async`` /
``close``, on ``device="cpu"`` at a small size.  The frontend mechanics
(demux, coalescing, flushes, admission control, drain on close, queue
expiry, abandonment) run on a callable backend with no model, as the
reference's ``tests/test_serving.py`` and ``tests/test_faults.py`` do.
With the encoder (the reference's weights through ``params_from_jax``)
concurrent submitters get, per query and for every score_impl at
W in {1, 2}, a result bitwise equal to a solo search of that query in the
port, and within ``TOL = 1e-5`` of the reference's own frontend (ids equal
wherever neighbouring scores are more than ``TOL`` apart); both packages
read one warm cache directory, so they score the same float16 rows.
``search_async`` is bitwise equal to ``search`` at W = 1, 2 and 4.
Over an IVF corpus a full probe returns the flat solo search's scores
bitwise at W = 1 and 2, and a pruned one returns for each coalesced
request an exact top-k over the union of its micro-batch's probed
clusters, recorded by wrapping ``round_for``.
Every wait has a timeout; barrier and acquire waits are lowered to
seconds, so a deadlock fails instead of hanging the run.
"""

import inspect
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.embedding_cache import EmbeddingCache as RefCache
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.core.serving import ServeFrontend as RefFrontend
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.core import fair_sharding, sharded_search
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import (IVFPreparedCorpus, PreparedCorpus,
                                        RetrievalEvaluator)
from repro_torch.core.result_heap import FastResultHeapq
from repro_torch.core.serving import (ClusterServeBackend,
                                      EvaluatorServeBackend,
                                      ServeClosedError, ServeFrontend,
                                      ServeOverloadError, ServeTimeoutError)
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.data.table import stable_id_hash
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch.distributed import InMemoryAllGather, SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

pytestmark = pytest.mark.serving

torch.set_num_threads(1)

TOL = 1e-5
DIM = 32
SCORE_IMPLS = ("numpy", "torch", "fused")
HEAP_OF = {"numpy": "python", "torch": "torch", "fused": "kernel"}
WAIT_S = 5.0
RESULT_S = 120


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a test within seconds."""
    monkeypatch.setattr(fair_sharding.FairSharder, "ACQUIRE_TIMEOUT_S",
                        WAIT_S)
    monkeypatch.setattr(InMemoryAllGather, "BARRIER_TIMEOUT_S", WAIT_S)


# -- frontend mechanics (a callable backend, no encoder) ----------------------


def _echo_backend(delay=0.0):
    """Backend whose ids encode (query index within batch) — demux order
    is checkable without a model.  Texts are 'q<i>' strings."""

    def run(texts, topk):
        if delay:
            time.sleep(delay)
        qnum = np.asarray([int(t[1:]) for t in texts])
        ids = qnum[:, None] * 100 + np.arange(topk)[None, :]
        return ids, ids.astype(np.float32)

    return run


def _gated(release):
    """An echo backend that blocks until ``release`` is set."""
    def run(texts, topk):
        release.wait(WAIT_S)
        return _echo_backend()(texts, topk)
    return run


def test_demux_routes_rows_to_the_right_request():
    with ServeFrontend(_echo_backend(), topk=3, max_batch=8,
                       max_wait_ms=20) as fe:
        futs = {i: fe.submit(f"q{i}") for i in range(20)}
        for i, f in futs.items():
            ids, vals = f.result(timeout=10)
            assert ids.shape == (1, 3)
            np.testing.assert_array_equal(ids[0], i * 100 + np.arange(3))
    assert fe.stats["completed"] == 20
    assert fe.stats["queries"] == 20            # pad rows not counted


def test_small_batch_requests_coalesce_and_demux():
    with ServeFrontend(_echo_backend(), topk=2, max_batch=8,
                       max_wait_ms=20) as fe:
        f1 = fe.submit(["q3", "q5", "q7"])
        f2 = fe.submit("q9")
        f3 = fe.submit({"a": "q1", "b": "q2"})
        ids1, _ = f1.result(10)
        assert ids1.shape == (3, 2)
        np.testing.assert_array_equal(ids1[:, 0], [300, 500, 700])
        np.testing.assert_array_equal(f2.result(10)[0][:, 0], [900])
        np.testing.assert_array_equal(f3.result(10)[0][:, 0], [100, 200])


def test_micro_batches_pad_to_power_of_two_rungs():
    """The backend sees every micro-batch padded to its rung with copies
    of the first text; only the real rows are counted and demuxed."""
    seen = []

    def run(texts, topk):
        seen.append(list(texts))
        return _echo_backend()(texts, topk)

    with ServeFrontend(run, topk=2, max_batch=8, max_wait_ms=50) as fe:
        fut = fe.submit(["q1", "q2", "q3"])
        np.testing.assert_array_equal(fut.result(10)[0][:, 0],
                                      [100, 200, 300])
    assert seen == [["q1", "q2", "q3", "q1"]]
    assert fe.stats["queries"] == 3 and fe.stats["max_batch_seen"] == 3


def test_deadline_flush_fires_for_a_single_queued_query():
    """A lone query must not wait for max_batch company: the flush
    deadline sends it after max_wait_ms."""
    with ServeFrontend(_echo_backend(), topk=2, max_batch=64,
                       max_wait_ms=30) as fe:
        t0 = time.monotonic()
        ids, _ = fe.submit("q4").result(timeout=10)
        dt = time.monotonic() - t0
        np.testing.assert_array_equal(ids[0], [400, 401])
    assert fe.stats["flush_deadline"] == 1
    assert fe.stats["batches"] == 1
    assert dt < 5.0


def test_full_flush_does_not_wait_for_deadline():
    with ServeFrontend(_echo_backend(), topk=2, max_batch=4,
                       max_wait_ms=10_000) as fe:
        futs = [fe.submit(f"q{i}") for i in range(4)]
        t0 = time.monotonic()
        for f in futs:
            f.result(timeout=10)
        assert time.monotonic() - t0 < 5.0
    assert fe.stats["flush_full"] >= 1


def test_oversized_batch_splits_on_request_boundary():
    """A request that would overflow the forming micro-batch is carried
    whole into the next one — requests are never split."""
    with ServeFrontend(_echo_backend(), topk=2, max_batch=4,
                       max_wait_ms=10) as fe:
        futs = [fe.submit(["q1", "q2", "q3"]),
                fe.submit(["q4", "q5", "q6"]),
                fe.submit(["q7", "q8"])]
        for f in futs:
            f.result(timeout=10)
        assert fe.stats["queries"] == 8
        assert fe.stats["max_batch_seen"] <= 4


def test_overload_rejects_fast_but_never_drops_accepted():
    accepted, rejected = [], []
    lock = threading.Lock()
    fe = ServeFrontend(_echo_backend(delay=0.02), topk=2, max_batch=1,
                       max_wait_ms=0, max_queue=2)

    def client(i):
        try:
            f = fe.submit(f"q{i}")
        except ServeOverloadError:
            with lock:
                rejected.append(i)
            return
        with lock:
            accepted.append((i, f))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(client, range(24)))
    fe.close()
    assert rejected, "overload never triggered — queue bound not enforced"
    assert accepted, "every request rejected"
    for i, f in accepted:
        ids, _ = f.result(timeout=0)     # must already be done post-close
        np.testing.assert_array_equal(ids[0], [i * 100, i * 100 + 1])
    assert fe.stats["accepted"] == len(accepted) == fe.stats["completed"]
    assert fe.stats["rejected"] == len(rejected)


def test_close_drains_queue_then_refuses_new_requests():
    fe = ServeFrontend(_echo_backend(delay=0.01), topk=2, max_batch=2,
                       max_wait_ms=0, max_queue=64)
    futs = [fe.submit(f"q{i}") for i in range(10)]
    fe.close()                           # must drain all 10, then stop
    for i, f in enumerate(futs):
        ids, _ = f.result(timeout=0)
        assert ids[0][0] == i * 100
    assert fe.stats["completed"] == 10
    with pytest.raises(ServeClosedError):
        fe.submit("q0")
    fe.close()                           # idempotent


def test_backend_error_propagates_to_every_request_future():
    def boom(texts, topk):
        raise RuntimeError("backend down")

    with ServeFrontend(boom, topk=2, max_batch=4, max_wait_ms=5) as fe:
        futs = [fe.submit(f"q{i}") for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="backend down"):
                f.result(timeout=10)
    assert fe.stats["failed"] == 3


def test_backend_taking_deadline_s_gets_the_tightest_budget():
    """A backend whose entry point takes ``deadline_s`` gets the
    micro-batch's tightest remaining request budget, and the port's own
    backends take it (it bounds a resilient round's recovery)."""
    budgets = []

    def run(texts, topk, deadline_s=None):
        budgets.append(deadline_s)
        return _echo_backend()(texts, topk)

    with ServeFrontend(run, topk=2, max_batch=4, max_wait_ms=1) as fe:
        fe.submit("q1").result(10)
        fe.submit("q2", deadline_ms=60_000).result(10)
    assert budgets[0] is None
    assert 0 < budgets[1] <= 60.0
    for entry in (EvaluatorServeBackend.begin, ClusterServeBackend.run):
        assert "deadline_s" in inspect.signature(entry).parameters


# -- deadlines, abandonment, never-dropped (tests/test_faults.py) -------------


def test_search_timeout_abandons_request():
    """A timed-out blocking search resolves its Future with
    ServeTimeoutError and coalescing skips the abandoned request."""
    release = threading.Event()
    with ServeFrontend(_gated(release), topk=2, max_batch=8,
                       max_wait_ms=1) as fe:
        blocker = fe.submit("q1")           # occupies the dispatcher
        time.sleep(0.05)
        with pytest.raises(ServeTimeoutError):
            fe.search("q2", timeout=0.05)
        assert fe.stats["abandoned"] == 1
        release.set()
        blocker.result(timeout=10)
        after = fe.submit("q3").result(timeout=10)
        np.testing.assert_array_equal(after[0][:, 0], [300])
    assert fe.stats["completed"] == 2       # q1 + q3, never q2


def test_deadline_ms_expires_queued_request_degraded_empty():
    release = threading.Event()
    with ServeFrontend(_gated(release), topk=3, max_batch=8,
                       max_wait_ms=1) as fe:
        fe.submit("q1")                     # occupies the dispatcher
        time.sleep(0.05)
        doomed = fe.submit(["q2", "q4"], deadline_ms=10.0)
        time.sleep(0.1)                     # the deadline lapses queued
        release.set()
        out = doomed.result(timeout=10)
        ids, scores = out
        assert out.degraded
        np.testing.assert_array_equal(out.coverage, [0.0, 0.0])
        np.testing.assert_array_equal(ids, -np.ones((2, 3)))
        assert np.all(np.isneginf(scores))
    assert fe.stats["expired"] == 1


def test_no_accepted_request_left_unresolved_under_mixed_deadlines():
    with ServeFrontend(_echo_backend(delay=0.02), topk=2, max_batch=4,
                       max_wait_ms=1) as fe:
        futs = []
        for i in range(12):
            ddl = 1.0 if i % 3 == 0 else None   # some effectively instant
            futs.append(fe.submit(f"q{i}", deadline_ms=ddl))
        resolved = 0
        for f in futs:
            try:
                f.result(timeout=10)
                resolved += 1
            except ServeTimeoutError:
                resolved += 1
        assert resolved == len(futs)
    st = fe.stats
    assert st["completed"] + st["expired"] == st["accepted"]


def test_deadline_ms_validation():
    with ServeFrontend(_echo_backend(), topk=2, max_batch=4,
                       max_wait_ms=1) as fe:
        with pytest.raises(ValueError):
            fe.submit("q1", deadline_ms=0)
        with pytest.raises(ValueError):
            fe.submit("q1", deadline_ms=-5)


# -- construction-time validation ---------------------------------------------


@pytest.mark.parametrize("kwargs", (
    {"topk": 0}, {"topk": -3}, {"max_batch": 0}, {"max_wait_ms": -1.0},
    {"max_queue": 0},
))
def test_frontend_rejects_bad_knobs(kwargs):
    """Refused by ``EvaluationArguments``, naming its field."""
    (knob,) = kwargs
    field = knob if knob == "topk" else f"serve_{knob}"
    with pytest.raises(ValueError, match=field):
        ServeFrontend(_echo_backend(), **kwargs)


def test_frontend_defaults_come_from_evaluation_arguments():
    """Unset knobs take ``EvaluationArguments``' defaults (topk 10, as in
    the reference's frontend)."""
    defaults = EvaluationArguments()
    with ServeFrontend(_echo_backend()) as fe:
        assert fe.topk == 10
        assert fe.max_batch == defaults.serve_max_batch
        assert fe.max_wait_s == pytest.approx(
            defaults.serve_max_wait_ms / 1e3)
        assert fe._queue.maxsize == defaults.serve_max_queue


def test_frontend_rejects_backend_without_entry_point():
    with pytest.raises(ValueError, match="backend"):
        ServeFrontend(object())


@pytest.mark.parametrize("kwargs,name", (
    ({"topk": 0}, "topk"), ({"topk": -1}, "topk"),
    ({"serve_max_batch": 0}, "serve_max_batch"),
    ({"serve_max_wait_ms": -0.5}, "serve_max_wait_ms"),
    ({"serve_max_queue": 0}, "serve_max_queue"),
    ({"score_impl": "jax"}, "score_impl"),
    ({"heap_impl": "cuda"}, "heap_impl"),
    ({"encode_batch_size": 0}, "encode_batch_size"),
    ({"superchunk_max_mb": 0}, "superchunk_max_mb"),
))
def test_evaluation_arguments_reject_bad_knobs(kwargs, name):
    """The port's names are validated, and the error names the field."""
    with pytest.raises(ValueError, match=name):
        EvaluationArguments(**kwargs)


def test_serve_knob_defaults_match_reference():
    ref, port = JaxEvalArgs(), EvaluationArguments()
    for name in ("serve_max_batch", "serve_max_wait_ms", "serve_max_queue"):
        assert getattr(port, name) == getattr(ref, name), name
    assert EvaluationArguments(serve_max_wait_ms=0).serve_max_wait_ms == 0


def test_result_heap_rejects_unknown_impl_and_bad_k():
    with pytest.raises(ValueError, match="impl"):
        FastResultHeapq(4, 3, impl="jax", device="cpu")
    with pytest.raises(ValueError, match="k must"):
        FastResultHeapq(4, 0, device="cpu")


def test_empty_and_oversized_requests_rejected_at_submit():
    with ServeFrontend(_echo_backend(), topk=2, max_batch=4,
                       max_wait_ms=0) as fe:
        with pytest.raises(ValueError, match="empty"):
            fe.submit([])
        with pytest.raises(ValueError, match="exceeds max_batch"):
            fe.submit([f"q{i}" for i in range(5)])


# -- the driver's search_async -------------------------------------------------


@pytest.fixture()
def synth():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    docs = rng.normal(size=(150, 16)).astype(np.float32)
    return q, docs


def _driver(score, w=1, rank=0, cluster=None, **kw):
    kw.setdefault("chunk_size", 32)
    kw.setdefault("superchunk_size", 2)
    if cluster is not None:
        kw.update(sharder=cluster.sharder, gather=cluster.gather)
    return ShardedSearchDriver(n_workers=w, worker_index=rank,
                               score_impl=score, heap_impl=HEAP_OF[score],
                               device="cpu", **kw)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("w", (1, 2, 4))
@pytest.mark.parametrize("score", SCORE_IMPLS)
def test_search_async_bitwise_equals_search(synth, score, w):
    """W drivers each running three pipelined rounds: round r's reduce
    (gather, merge, finalize on the reduce thread) overlaps round r + 1's
    scoring, and every round on every rank is bitwise the W = 1
    ``search``.  Each round's stats are its own: rounds 0, 1, 2, with the
    gather time written into that round's dict."""
    q, docs = synth
    load = lambda lo, hi: docs[lo:hi]
    want = _driver(score).search(q, len(docs), load, 7)
    cluster = SimulatedCluster(w) if w > 1 else None
    drivers = [_driver(score, w, rank, cluster) for rank in range(w)]

    def worker(rank):
        futs, stats = [], []
        for _ in range(3):
            futs.append(drivers[rank].search_async(q, len(docs), load, 7))
            stats.append(drivers[rank].stats)
        return [f.result(timeout=RESULT_S) for f in futs], stats

    try:
        outs = cluster.run(worker) if cluster else [worker(0)]
    finally:
        for d in drivers:
            d.close()
            d.close()                    # idempotent
    for results, stats in outs:
        assert [st["round"] for st in stats] == [0, 1, 2]
        assert all(("gather_seconds" in st) == (w > 1) for st in stats)
        for out in results:
            _bitwise(out, want)
            np.testing.assert_array_equal(out.coverage, np.ones(len(q)))
    for d in drivers:
        assert d._reduce_pool is None


@pytest.mark.parametrize("w", (1, 2))
def test_scoring_phase_synchronises_only_at_w_above_1(synth, monkeypatch,
                                                      w):
    """At W = 1 the scoring phase queues its work and returns, as the
    reference's does: the round's ``seconds`` and its untagged report
    come after the finalize, on the reduce thread.  At W > 1 it
    synchronises the device once a round, before its tagged report."""
    q, docs = synth
    load = lambda lo, hi: docs[lo:hi]
    synced = []
    monkeypatch.setattr(sharded_search, "_sync",
                        lambda device: synced.append(device))
    cluster = SimulatedCluster(w) if w > 1 else None
    drivers = [_driver("fused", w, rank, cluster) for rank in range(w)]

    def worker(rank):
        fut = drivers[rank].search_async(q, len(docs), load, 7)
        stats = drivers[rank].stats
        fut.result(timeout=RESULT_S)
        return stats

    try:
        stats = cluster.run(worker) if cluster else [worker(0)]
    finally:
        for d in drivers:
            d.close()
    assert len(synced) == (0 if w == 1 else w)
    for st in stats:
        assert isinstance(st["seconds"], float) and st["seconds"] >= 0


def test_search_async_matches_reference_driver(synth):
    """The port's pipelined rounds against the reference's synchronous
    host baseline on the same embeddings: the same positions, scores
    within TOL."""
    q, docs = synth
    load = lambda lo, hi: docs[lo:hi]
    ref_vals, ref_pos = RefDriver(score_impl="numpy", chunk_size=40).search(
        q, len(docs), load, 7)
    drv = _driver("fused")
    try:
        futs = [drv.search_async(q, len(docs), load, 7) for _ in range(3)]
        for f in futs:
            vals, pos = f.result(timeout=RESULT_S)
            np.testing.assert_array_equal(pos, ref_pos)
            np.testing.assert_allclose(vals, ref_vals, atol=TOL, rtol=0)
    finally:
        drv.close()


def test_search_async_reduce_error_reaches_the_future(synth):
    """A reduce that raises (an injected gather drop on rank 1) fails
    that round's Future; rank 1 raising aborts the gather, so rank 0's
    reduce fails at the barrier instead of hanging, and both drivers
    close cleanly."""
    from repro_torch.core.faults import (Fault, FaultInjector,
                                         InjectedTransportDrop)
    q, docs = synth
    load = lambda lo, hi: docs[lo:hi]
    cluster = SimulatedCluster(2)
    inj = FaultInjector([Fault(kind="drop", worker=1, round=0,
                               phase="gather")])
    drivers = [_driver("numpy", 2, rank, cluster, fault_injector=inj)
               for rank in range(2)]
    errs = {}

    def worker(rank):
        fut = drivers[rank].search_async(q, len(docs), load, 5)
        errs[rank] = fut.exception(timeout=RESULT_S)
        if errs[rank] is not None:
            raise errs[rank]

    try:
        with pytest.raises(InjectedTransportDrop):
            cluster.run(worker)
    finally:
        for d in drivers:
            d.close()
    assert isinstance(errs[1], InjectedTransportDrop)
    assert isinstance(errs[0], threading.BrokenBarrierError)
    assert inj.fired == [("drop", 1, 0, "gather")]


# -- evaluator-backed frontends ------------------------------------------------


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

    def make(score_impl="numpy", rank=0, world=1, cluster=None, **kw):
        fields = dict(topk=5, encode_batch_size=20, serve_max_batch=8,
                      serve_max_wait_ms=4.0)
        fields.update(kw)
        args = EvaluationArguments(score_impl=score_impl,
                                   heap_impl=HEAP_OF[score_impl], **fields)
        workers = {}
        if cluster is not None:
            workers = dict(gather=cluster.gather, sharder=cluster.sharder)
        return RetrievalEvaluator(args, retriever, collator, params,
                                  device="cpu", process_index=rank,
                                  process_count=world, **workers)
    return make


@pytest.fixture(scope="module")
def serve_env(port, tiny_retriever, tiny_params, retrieval_data,
              tmp_path_factory):
    """One warm cache directory shared by both packages (the reference
    fills it), the port's solo per-query searches over it, and the
    reference's frontend results for every query."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    path = str(tmp_path_factory.mktemp("svcache") / "c")
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ref_ev = JaxEvaluator(JaxEvalArgs(topk=5, encode_batch_size=20,
                                      score_impl="numpy", serve_max_batch=8,
                                      serve_max_wait_ms=4.0),
                          tiny_retriever, coll, tiny_params,
                          process_index=0, process_count=1)
    ref_cache = RefCache(path, dim=DIM)
    ref_ev.search(queries, corpus, cache=ref_cache)       # warm it
    fe = RefFrontend.from_evaluator(ref_ev, corpus, ref_cache)
    try:
        futs = {qid: fe.submit(text) for qid, text in queries.items()}
        reference = {qid: tuple(r[0] for r in f.result(timeout=RESULT_S))
                     for qid, f in futs.items()}
    finally:
        fe.close()
    cache = EmbeddingCache(path, dim=DIM)
    ev = port("numpy")
    solo = {}
    for qid, text in queries.items():
        qh, ids, vals = ev.search({qid: text}, corpus, cache=cache)
        assert qh[0] == stable_id_hash(qid)
        solo[qid] = (ids[0], vals[0])
    return {"cache": cache, "solo": solo, "reference": reference,
            "queries": queries, "corpus": corpus}


def _make_frontend(port, env, score_impl, world):
    if world == 1:
        return ServeFrontend.from_evaluator(port(score_impl), env["corpus"],
                                            env["cache"])
    cluster = SimulatedCluster(world)
    evs = [port(score_impl, rank, world, cluster) for rank in range(world)]
    return ServeFrontend.from_cluster(evs, cluster, env["corpus"],
                                      [env["cache"]] * world)


def _separated(vals):
    inf = np.full_like(vals[:1], np.inf)
    up = np.concatenate([inf, vals[:-1]]) - vals
    down = vals - np.concatenate([vals[1:], -inf])
    return (up > TOL) & (down > TOL)


def _assert_close_row(got, want, name):
    (gi, gv), (wi, wv) = got, want
    np.testing.assert_allclose(gv, wv, atol=TOL, rtol=0, err_msg=name)
    sep = _separated(wv)
    np.testing.assert_array_equal(gi[sep], wi[sep], err_msg=name)


@pytest.mark.parametrize("world", (1, 2))
@pytest.mark.parametrize("score_impl", SCORE_IMPLS)
def test_concurrent_submitters_match_solo_search(port, serve_env,
                                                 score_impl, world):
    """6 submitter threads racing through the frontend get, per query,
    the port's solo search bitwise, and the reference frontend's result
    within TOL (ids equal where separated)."""
    fe = _make_frontend(port, serve_env, score_impl, world)
    out, lock = {}, threading.Lock()

    def client(item):
        qid, text = item
        ids, vals = fe.submit(text).result(timeout=RESULT_S)
        with lock:
            out[qid] = (ids[0], vals[0])

    try:
        with ThreadPoolExecutor(6) as pool:
            list(pool.map(client, list(serve_env["queries"].items())))
    finally:
        fe.close()
    assert fe.stats["completed"] == len(serve_env["queries"])
    n_sep = 0
    for qid, want in serve_env["solo"].items():
        _bitwise(out[qid], want)
        _assert_close_row(out[qid], serve_env["reference"][qid], qid)
        n_sep += _separated(serve_env["reference"][qid][1]).sum()
    assert n_sep > 0.9 * 5 * len(serve_env["solo"])


def test_mixed_size_requests_match_solo_search(port, serve_env):
    """Single-query and small-batch requests coalesced into the same
    micro-batches all demux to their solo-search rows."""
    fe = _make_frontend(port, serve_env, "fused", 1)
    qids = list(serve_env["queries"])
    texts = serve_env["queries"]
    try:
        f_batch = fe.submit([texts[q] for q in qids[:3]])
        f_single = [fe.submit(texts[q]) for q in qids[3:8]]
        ids3, vals3 = f_batch.result(timeout=RESULT_S)
        for j, qid in enumerate(qids[:3]):
            _bitwise((ids3[j], vals3[j]), serve_env["solo"][qid])
        for qid, f in zip(qids[3:8], f_single):
            ids, vals = f.result(timeout=RESULT_S)
            _bitwise((ids[0], vals[0]), serve_env["solo"][qid])
    finally:
        fe.close()


def test_from_evaluator_defaults_come_from_args(port, serve_env):
    ev = port("numpy")
    fe = ServeFrontend.from_evaluator(ev, serve_env["corpus"],
                                      serve_env["cache"])
    try:
        assert fe.topk == ev.args.topk == 5
        assert fe.max_batch == ev.args.serve_max_batch == 8
        assert fe.max_wait_s == pytest.approx(
            ev.args.serve_max_wait_ms / 1e3)
        assert fe._queue.maxsize == ev.args.serve_max_queue
    finally:
        fe.close()


def test_backend_classes_validate_world_size(port, serve_env):
    cluster = SimulatedCluster(2)
    with pytest.raises(ValueError, match="world"):
        ClusterServeBackend([port("numpy")], cluster, serve_env["corpus"])


def test_evaluator_backend_closes_driver(port, serve_env):
    backend = EvaluatorServeBackend(port("numpy"), serve_env["corpus"],
                                    serve_env["cache"])
    fut = backend.begin([next(iter(serve_env["queries"].values()))], 5)
    ids, vals = fut.result(timeout=RESULT_S)
    assert ids.shape == (1, 5)
    assert backend.driver._reduce_pool is not None
    backend.close()
    assert backend.driver._reduce_pool is None
    backend.close()                      # idempotent


def test_evaluator_backend_builds_its_driver_through_make_driver(
        port, serve_env):
    ev = port("torch")
    made = []
    make = ev.make_driver
    ev.make_driver = lambda: made.append(make()) or made[-1]
    backend = EvaluatorServeBackend(ev, serve_env["corpus"],
                                    serve_env["cache"])
    try:
        assert made == [backend.driver]
        assert backend.driver.score_impl == "torch"
    finally:
        backend.close()


# -- an IVF corpus behind the frontend ------------------------------------------


IVF6 = dict(index_impl="ivf", ivf_nclusters=6, ivf_train_steps=8)


def _ivf_frontend(port, env, nprobe, world, score_impl="numpy"):
    if world == 1:
        return ServeFrontend.from_evaluator(
            port(score_impl, ivf_nprobe=nprobe, **IVF6), env["corpus"],
            env["cache"])
    cluster = SimulatedCluster(world)
    evs = [port(score_impl, rank, world, cluster, ivf_nprobe=nprobe, **IVF6)
           for rank in range(world)]
    return ServeFrontend.from_cluster(evs, cluster, env["corpus"],
                                      [env["cache"]] * world)


def _same_ranking(got, want, name):
    """Scores bitwise; ids equal outside runs of exactly equal scores
    (a full probe scans the rows in cluster order, so a tie may resolve
    to another member of its run)."""
    (gi, gv), (wi, wv) = got, want
    np.testing.assert_array_equal(gv, wv, err_msg=name)
    ties = np.zeros(len(wv), bool)
    ties[1:] |= wv[1:] == wv[:-1]
    ties[:-1] |= wv[:-1] == wv[1:]
    np.testing.assert_array_equal(gi[~ties], wi[~ties], err_msg=name)


class _MicroBatchLog:
    """Records, per micro-batch, its texts and the store rows its IVF
    round selected (``begin`` and ``round_for`` both run on the
    dispatcher thread)."""

    def __init__(self, monkeypatch):
        self.batches = []
        self._texts = None
        begin = EvaluatorServeBackend.begin
        round_for = IVFPreparedCorpus.round_for

        def logged_begin(backend, texts, *a, **kw):
            self._texts = list(texts)
            return begin(backend, texts, *a, **kw)

        def logged_round_for(prepared, q_emb):
            out = round_for(prepared, q_emb)
            if self._texts is not None:      # a frontend round, not a solo
                sel = prepared.index.gather_rows(
                    prepared.index.select(q_emb, prepared.nprobe))
                self.batches.append((self._texts, sel))
                self._texts = None
            return out

        monkeypatch.setattr(EvaluatorServeBackend, "begin", logged_begin)
        monkeypatch.setattr(IVFPreparedCorpus, "round_for",
                            logged_round_for)

    def rows_of(self, text):
        return [sel for texts, sel in self.batches if text in texts]


@pytest.mark.parametrize("world", (1, 2))
def test_ivf_full_probe_frontend_matches_flat_solo(port, serve_env, world):
    """nprobe == nclusters: 6 racing submitters get, per query, the flat
    solo search's scores bitwise (ids outside exact ties)."""
    fe = _ivf_frontend(port, serve_env, 6, world)
    out, lock = {}, threading.Lock()

    def client(item):
        qid, text = item
        ids, vals = fe.submit(text).result(timeout=RESULT_S)
        with lock:
            out[qid] = (ids[0], vals[0])

    try:
        with ThreadPoolExecutor(6) as pool:
            list(pool.map(client, list(serve_env["queries"].items())))
    finally:
        fe.close()
    for qid, want in serve_env["solo"].items():
        _same_ranking(out[qid], want, qid)


def test_ivf_pruned_frontend_is_exact_over_its_micro_batch(
        port, serve_env, monkeypatch):
    """nprobe 1: a request coalesced into a micro-batch scans the union
    of the batch's probed clusters, so its result is an exact float64
    top-k over those rows (not its solo search), and its sorted scores
    are at least its solo pruned search's (the union is a superset)."""
    log = _MicroBatchLog(monkeypatch)
    ev = port("fused", ivf_nprobe=1, **IVF6)
    fe = ServeFrontend.from_evaluator(ev, serve_env["corpus"],
                                      serve_env["cache"])
    prepared = fe.backend.prepared
    texts = list(serve_env["queries"].values())
    out = {}
    try:
        batch = fe.submit(texts[:3])
        with ThreadPoolExecutor(6) as pool:
            futs = {t: pool.submit(
                lambda t=t: fe.submit(t).result(timeout=RESULT_S))
                for t in texts[3:]}
            for t, f in futs.items():
                ids, vals = f.result(timeout=RESULT_S)
                out[t] = (ids[0], vals[0])
        ids, vals = batch.result(timeout=RESULT_S)
        for j, t in enumerate(texts[:3]):
            out[t] = (ids[j], vals[j])
    finally:
        fe.close()
    assert len(log.batches) < len(texts)          # requests coalesced
    coalesced = 0
    for t, (ids, vals) in out.items():
        q = ev._encode_texts([t], True).astype(np.float64)
        (sel,) = log.rows_of(t)
        rows = torch.as_tensor(prepared.fetch_rows(sel)).double().numpy()
        exact = (q @ rows.T)[0]
        order = np.argsort(-exact, kind="stable")[:5]
        _assert_close_row((ids, vals), (prepared.hashes[sel][order],
                                        exact[order]), t)
        solo_ids, solo_vals = ev.search_texts([t], prepared, 5,
                                              min_batch_dim=1)
        assert (vals >= solo_vals[0] - TOL).all(), t
        own = prepared.index.gather_rows(prepared.index.select(
            ev._encode_texts([t], True), 1))
        assert set(own) <= set(sel)
        coalesced += len(sel) > len(own)
    assert coalesced > 0


# -- a live corpus (tests/test_mutation.py) ------------------------------------


_ORACLE_DIM = DIM


class _Writer:
    """Background mutator: adds, re-embeds, deletes, and one online
    compaction (the reference's ``tests/test_mutation.py`` writer)."""

    def __init__(self, cache, ev, corpus):
        self.cache = cache
        self.ev = ev
        self.texts = list(corpus.values())
        self.stop = threading.Event()
        self.error = None
        self.ops = 0
        self.thread = threading.Thread(target=self._run,
                                       name="mutation-writer")

    def _run(self):
        try:
            i = 0
            while not self.stop.is_set():
                emb = self.ev._encode_texts([f"breaking news item {i}"],
                                            False)
                self.cache.cache_records([f"live{i}"], emb)
                emb = self.ev._encode_texts(
                    [self.texts[i % len(self.texts)] + f" v{i}"], False)
                self.cache.cache_records([f"doc{i % len(self.texts)}"],
                                         emb)
                if i % 2 == 1:
                    self.cache.delete_records([f"live{i - 1}"])
                if i == 2:
                    self.cache.compact()
                self.ops += 1
                i += 1
                time.sleep(0.002)
        except BaseException as exc:      # noqa: BLE001 — re-raised below
            self.error = exc

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        if self.error is not None:
            raise self.error


@pytest.mark.parametrize("score_impl", SCORE_IMPLS)
def test_search_under_concurrent_mutation_matches_frozen_oracle(
        port, retrieval_data, tmp_path, score_impl):
    """W = 2 through ``ClusterServeBackend`` on a live cache: while a
    writer mutates it, every round equals, bitwise, a W = 1 search over
    a frozen copy of the generation it pinned (flat index)."""
    corpus = dict(list(retrieval_data["corpus"].items())[:48])
    texts = list(retrieval_data["queries"].values())[:6]
    cache = EmbeddingCache(str(tmp_path / "c"), dim=_ORACLE_DIM)
    ref_ev = port(score_impl, encode_batch_size=16)
    writer_ev = port("numpy", encode_batch_size=16)
    cv = writer_ev._corpus_view(corpus)
    writer_ev.encode_corpus(np.asarray(cv.id_hashes), cv.texts(), cache)
    cluster = SimulatedCluster(2)
    evs = [port(score_impl, rank, 2, cluster, encode_batch_size=16)
           for rank in range(2)]
    backend = ClusterServeBackend(evs, cluster, {}, live_cache=cache)

    def one_search():
        out = backend.run(texts, 5)
        snap = backend.prepared[0].snapshot
        assert backend.prepared[1].generation == snap.key
        return out, (snap.ids.copy(), snap.get_range(0, snap.n_live).copy())

    results = []
    try:
        with _Writer(cache, writer_ev, corpus) as writer:
            deadline = time.monotonic() + 30.0
            while len(results) < 4 and time.monotonic() < deadline:
                results.append(one_search())
                while (writer.ops < 2 * len(results)
                       and time.monotonic() < deadline
                       and writer.error is None):
                    time.sleep(0.002)
    finally:
        backend.close()
    assert len(results) >= 2
    generations = set()
    for out, (snap_ids, snap_vecs) in results:
        generations.add((len(snap_ids), hash(snap_ids.tobytes())))
        frozen = PreparedCorpus(
            snap_ids, len(snap_ids),
            lambda lo, hi, v=snap_vecs: v[lo:hi].astype(np.float32))
        want = ref_ev.search_texts(texts, frozen, 5, min_batch_dim=1)
        _bitwise(out, want)
    assert len(generations) >= 2, generations
    assert cache._pins == {}


@pytest.mark.parametrize("world", (1, 2))
def test_live_frontend_swaps_generations_between_microbatches(
        port, retrieval_data, tmp_path, world):
    """``live=True``: requests keep resolving while the cache mutates
    and compacts; a new document becomes searchable, a deleted one
    disappears, and every pin is released on close."""
    corpus = dict(list(retrieval_data["corpus"].items())[:48])
    q = list(retrieval_data["queries"].values())[0]
    cache = EmbeddingCache(str(tmp_path / "c"), dim=_ORACLE_DIM)
    if world == 1:
        ev = port("numpy", encode_batch_size=16)
        fe = ServeFrontend.from_evaluator(ev, corpus, cache, live=True,
                                          max_wait_ms=1.0)
    else:
        cluster = SimulatedCluster(world)
        evs = [port("fused", rank, world, cluster, encode_batch_size=16)
               for rank in range(world)]
        ev = evs[0]
        fe = ServeFrontend.from_cluster(evs, cluster, corpus,
                                        [cache] * world, live=True,
                                        max_wait_ms=1.0)
    try:
        assert cache.n_live == len(corpus)      # the seed corpus warmed it
        ids0, _ = fe.search(q, timeout=RESULT_S)
        assert ids0.shape == (1, 5)
        emb = ev._encode_texts(["zzz unique marker text"], False)
        cache.cache_records(["fresh-doc"], emb)
        cache.compact()
        ids1, _ = fe.search("zzz unique marker text", timeout=RESULT_S)
        assert stable_id_hash("fresh-doc") in ids1[0]
        cache.delete_records(["fresh-doc"])
        ids2, _ = fe.search("zzz unique marker text", timeout=RESULT_S)
        assert stable_id_hash("fresh-doc") not in ids2[0]
    finally:
        fe.close()
    assert cache._pins == {}


def test_live_requires_cache():
    with pytest.raises(ValueError, match="cache"):
        ServeFrontend.from_evaluator(object(), {}, None, live=True)
    with pytest.raises(ValueError, match="cache"):
        ServeFrontend.from_cluster([object()], SimulatedCluster(1), {},
                                   None, live=True)

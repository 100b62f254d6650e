"""The port's first slice end to end on the CPU, against the reference.

``RetrievalEvaluator.search / evaluate / mine_hard_negatives`` on
``make_retrieval_dataset`` (24 queries, 96 docs): the reference (JAX on
the CPU) and the port (``device="cpu"``) run the same encoder weights,
carried across by ``params_from_jax``.  Across frameworks the float32
sums differ in order, so scores agree within ``TOL = 1e-5`` and ids
wherever neighbouring scores are more than ``TOL`` apart.  Inside the
port every ``score_impl`` x ``heap_impl`` pair is bitwise identical.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.core.evaluator import format_metrics_table as jax_format_table
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.encode_pipeline import EncodePipeline
from repro_torch.core.evaluator import (RetrievalEvaluator,
                                        format_metrics_table)
from repro_torch.core.result_heap import FastResultHeapq
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

torch.set_num_threads(1)

TOL = 1e-5
METRICS = ("ndcg@10", "mrr@10", "recall@10")
SCORE_IMPLS = ("numpy", "torch", "fused")
HEAP_IMPLS = ("python", "torch", "kernel")


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

    def make(score_impl="fused", heap_impl="kernel", **kw):
        # encode_batch_size=20 leaves a ragged last chunk (96 % 20 != 0)
        args = EvaluationArguments(topk=10, encode_batch_size=20,
                                   score_impl=score_impl,
                                   heap_impl=heap_impl, metrics=METRICS,
                                   **kw)
        return RetrievalEvaluator(args, retriever, collator, params,
                                  device="cpu")
    return make


@pytest.fixture(scope="module")
def reference(tiny_retriever, tiny_params):
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    return JaxEvaluator(JaxEvalArgs(topk=10, encode_batch_size=20,
                                    metrics=METRICS),
                        tiny_retriever, coll, tiny_params)


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


def test_search_matches_reference(port, reference, retrieval_data):
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    qh, ids, vals = port().search(q, c)
    rqh, rids, rvals = reference.search(q, c)
    np.testing.assert_array_equal(qh, rqh)
    assert ids.shape == (24, 10) and vals.dtype == np.float32
    _assert_close_ranking((ids, vals), (rids, rvals))


def test_evaluate_matches_reference(port, reference, retrieval_data):
    args = (retrieval_data["queries"], retrieval_data["corpus"],
            retrieval_data["qrels"])
    got, want = port().evaluate(*args), reference.evaluate(*args)
    assert got == pytest.approx(want, abs=1e-9)
    assert format_metrics_table({"synthetic": got}) \
        == jax_format_table({"synthetic": want})


def test_mine_hard_negatives_matches_reference(port, reference,
                                               retrieval_data, tmp_path):
    args = (retrieval_data["queries"], retrieval_data["corpus"],
            retrieval_data["qrels"])
    out = tmp_path / "negs.tsv"
    got = port().mine_hard_negatives(*args, depth=8, output_path=str(out))
    want = reference.mine_hard_negatives(*args, depth=8)
    assert len(out.read_text().splitlines()) == len(got)
    assert {(q, d) for q, d, _ in got} == {(q, d) for q, d, _ in want}
    np.testing.assert_allclose(sorted(s for _, _, s in got),
                               sorted(s for _, _, s in want), atol=TOL)


@pytest.mark.parametrize("heap_impl", HEAP_IMPLS)
@pytest.mark.parametrize("score_impl", SCORE_IMPLS)
def test_backend_matrix_bitwise(port, retrieval_data, score_impl,
                                heap_impl):
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    want = port("numpy", "python").search(q, c)
    for superchunk_size in (0, 1, 3):
        ev = port(score_impl, heap_impl, superchunk_size=superchunk_size)
        got = ev.search(q, c)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        host = score_impl == "numpy" or heap_impl == "python"
        expect = ("per_chunk" if host or superchunk_size == 1
                  else "superchunk")
        assert ev.last_search_stats["executor"] == expect
        assert ev.last_search_stats["chunk_devices"] == ["cpu"]


def test_serving_prepared_corpus(port, retrieval_data):
    """prepare_corpus(device_resident=True) + search_texts (the serve
    backends' calls) == search on the same queries."""
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    ev = port()
    _, ids, vals = ev.search(q, c)
    prepared = ev.prepare_corpus(c, device_resident=True)
    texts = list(q.values())
    for lo in range(0, len(texts), 8):
        got = ev.search_texts(texts[lo: lo + 8], prepared,
                              min_batch_dim=1)
        _assert_close_ranking(got, (ids[lo: lo + 8], vals[lo: lo + 8]))
        assert got.coverage.tolist() == [1.0] * 8 and not got.degraded
    empty = ev.search_texts([], prepared)
    assert empty[0].shape == (0, 10)


def test_encode_pipeline_shapes_match_reference(port, reference,
                                                retrieval_data):
    """Bucketing: the port encodes the same (B, L) shapes the reference
    compiles, and the same real / padded token counts."""
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    ev = port()
    ev.search(q, c)
    ev.search(q, c)
    reference.encode_pipeline.stats.update(
        {key: 0 for key in reference.encode_pipeline.stats})
    reference.search(q, c)
    reference.search(q, c)
    got, want = ev.encode_pipeline.stats, reference.encode_pipeline.stats
    assert got["compiles"] <= 2 * len(ev.encode_pipeline.ladder(128))
    for key in ("batches", "tokens_real", "tokens_padded", "windows"):
        assert got[key] == want[key], key


def test_driver_streams_numpy_and_device_chunks(retrieval_data):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    docs = rng.normal(size=(230, 16)).astype(np.float32)
    full = q.astype(np.float64) @ docs.astype(np.float64).T
    want = np.argsort(-full.astype(np.float32), axis=1, kind="stable")[:, :7]
    for loader in (lambda lo, hi: docs[lo:hi],
                   lambda lo, hi: torch.from_numpy(docs[lo:hi])):
        for s in (1, 4):
            drv = ShardedSearchDriver(chunk_size=37, superchunk_size=s,
                                      device="cpu")
            vals, pos = drv.search(q, 230, loader, 7)
            np.testing.assert_array_equal(pos, want)
            assert drv.stats["dispatch_rounds"] == (7 if s == 1 else 2)
    assert drv.sharder.throughput[0] != 1.0        # the round was reported
    # an evaluator's sharder outlives its per-search drivers: every
    # search's round is folded in
    shared = ShardedSearchDriver(chunk_size=50, device="cpu").sharder
    for _ in range(3):
        ShardedSearchDriver(sharder=shared, chunk_size=50,
                            device="cpu").search(q, 230, loader, 7)
    assert shared._committed == 3


def test_superchunk_scores_resident_rows_as_views(monkeypatch):
    """A float32 corpus already on the driver's device is scored in
    place: a full superchunk's tile is a view of it, only the ragged
    tail is padded, and the per-step offsets / valid counts follow."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    docs = torch.from_numpy(rng.normal(size=(230, 16)).astype(np.float32))
    seen = []
    real = kops.superchunk_update

    def spy(vals, ids, queries, tile, offsets, n_valids, **kw):
        seen.append((tile.data_ptr(), tuple(tile.shape), offsets.tolist(),
                     n_valids.tolist()))
        real(vals, ids, queries, tile, offsets, n_valids, **kw)

    monkeypatch.setattr(kops, "superchunk_update", spy)
    drv = ShardedSearchDriver(chunk_size=37, superchunk_size=4,
                              device="cpu")
    drv.search(q, 230, lambda lo, hi: docs[lo:hi], 7)
    assert seen[0] == (docs.data_ptr(), (4, 37, 16), [0, 37, 74, 111],
                       [37] * 4)
    assert seen[1][1:] == ((3, 37, 16), [148, 185, 222], [37, 37, 8])


def test_no_hidden_device(tiny_params):
    """Without device="cpu" every entry point asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    cfg = tf.LMConfig(dtype=torch.float32)
    collator = RetrievalCollator(DataArguments(), HashTokenizer())
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    for build in (
            lambda: RetrievalEvaluator(EvaluationArguments(), retriever,
                                       collator, {}),
            lambda: ShardedSearchDriver(),
            lambda: FastResultHeapq(2, 4),
            lambda: EncodePipeline(retriever.encoder.encode,
                                   collator.tokenizer),
            lambda: retriever.init_params(torch.Generator()),
            lambda: resolve_device()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    # meta computes nothing (the dry run's device): not a CPU fallback
    assert resolve_device("meta") == torch.device("meta")

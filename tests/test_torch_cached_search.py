"""The evaluator's cached paths, the port against the reference.

``search / evaluate / mine_hard_negatives`` with ``cache=``, a cold pass
(fresh float32 encodings, written to the cache as float16) and then warm
passes (the float16 rows, no corpus encoding); ``encode_corpus``;
``prepare_corpus`` with a cache (its row plan, ``device_resident``);
``prepare_cache_corpus`` over a live cache while a writer mutates it.
The reference runs JAX on the CPU and the port ``device="cpu"`` with the
same encoder weights (``params_from_jax``).  A cold pass and a warm pass
score different rows by design, so like is compared with like: the two
packages' warm passes read the same cache directory.  Across packages
scores agree within ``TOL = 1e-5`` and ids where neighbouring scores are
more than ``TOL`` apart; inside the port every score_impl x heap_impl
pair is bitwise identical on a warm cache.
"""

import shutil
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.embedding_cache import EmbeddingCache as RefCache
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.core import sharded_search
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import PreparedCorpus, RetrievalEvaluator
from repro_torch.core.result_heap import to_tensor
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

torch.set_num_threads(1)

TOL = 1e-5
DIM = 32
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
        fields = dict(topk=10, encode_batch_size=20, metrics=METRICS)
        fields.update(kw)
        args = EvaluationArguments(score_impl=score_impl,
                                   heap_impl=heap_impl, **fields)
        return RetrievalEvaluator(args, retriever, collator, params,
                                  device="cpu")
    return make


@pytest.fixture(scope="module")
def reference(tiny_retriever, tiny_params):
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))

    def make(**kw):
        fields = dict(topk=10, encode_batch_size=20, metrics=METRICS)
        fields.update(kw)
        return JaxEvaluator(JaxEvalArgs(**fields), tiny_retriever, coll,
                            tiny_params)
    return make


@pytest.fixture(scope="module")
def warm_cache(port, retrieval_data, tmp_path_factory):
    """A cache that covers the corpus in corpus order, warmed by one
    cold pass of the port's host baseline."""
    cache = EmbeddingCache(str(tmp_path_factory.mktemp("warm") / "c"),
                           dim=DIM)
    port("numpy", "python").search(retrieval_data["queries"],
                                   retrieval_data["corpus"], cache=cache)
    assert cache.n_live == len(retrieval_data["corpus"])
    return cache


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


def _count_corpus_encodes(ev):
    """Wrap ``ev._encode_texts``; returns the list of corpus encode
    sizes it records."""
    seen = []
    orig = ev._encode_texts

    def counting(texts, is_query, *a, **kw):
        if not is_query:
            seen.append(len(texts))
        return orig(texts, is_query, *a, **kw)

    ev._encode_texts = counting
    return seen


# -- cold then warm, against the reference -----------------------------------


def test_cold_then_warm_matches_reference(port, reference, retrieval_data,
                                          tmp_path):
    q, c, qrels = (retrieval_data["queries"], retrieval_data["corpus"],
                   retrieval_data["qrels"])
    ev, ref = port(), reference()
    ref_cache = RefCache(str(tmp_path / "ref"), dim=DIM)
    port_cache = EmbeddingCache(str(tmp_path / "port"), dim=DIM)
    # cold: both encode fresh float32 rows and write them
    got = ev.evaluate(q, c, qrels, cache=port_cache)
    want = ref.evaluate(q, c, qrels, cache=ref_cache)
    assert got == pytest.approx(want, abs=1e-9)
    np.testing.assert_array_equal(port_cache.live_ids(),
                                  ref_cache.live_ids())
    p_rows = port_cache.get_range(0, len(port_cache)).astype(np.float32)
    r_rows = ref_cache.get_range(0, len(ref_cache)).astype(np.float32)
    np.testing.assert_allclose(p_rows, r_rows, rtol=2.0 ** -10, atol=1e-7)

    # warm: the port reads the reference's cache, so both score the same
    # float16 rows
    shared = EmbeddingCache(str(tmp_path / "ref"), dim=DIM)
    assert shared.generation_key == ref_cache.generation_key
    seen = _count_corpus_encodes(ev)
    _, ids, vals = ev.search(q, c, cache=shared)
    _, rids, rvals = ref.search(q, c, cache=ref_cache)
    _assert_close_ranking((ids, vals), (rids, rvals))
    assert ev.evaluate(q, c, qrels, cache=shared) == pytest.approx(
        ref.evaluate(q, c, qrels, cache=ref_cache), abs=1e-9)
    negs = ev.mine_hard_negatives(q, c, qrels, depth=8, cache=shared)
    rnegs = ref.mine_hard_negatives(q, c, qrels, depth=8, cache=ref_cache)
    assert {(a, b) for a, b, _ in negs} == {(a, b) for a, b, _ in rnegs}
    np.testing.assert_allclose(sorted(s for _, _, s in negs),
                               sorted(s for _, _, s in rnegs), atol=TOL)
    assert seen == []
    assert shared._pins == {}                  # every search unpinned
    # a warm pass scores the float16 rows, not the cold pass's float32
    _, cold_ids, cold_vals = port().search(q, c)
    assert not np.array_equal(vals, cold_vals)
    np.testing.assert_allclose(vals, cold_vals, atol=1e-2)


@pytest.mark.parametrize("superchunk_size", (1, 3, 0))
def test_cold_pass_generations_match_reference(port, reference,
                                               retrieval_data, tmp_path,
                                               superchunk_size):
    """The cold pass appends one generation per chunk in both packages,
    whether the port streams it per chunk (S = 1) or asks its loader for
    whole superchunks (S = 3, and the autotuned S)."""
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    ref_cache = RefCache(str(tmp_path / "ref"), dim=DIM)
    port_cache = EmbeddingCache(str(tmp_path / "port"), dim=DIM)
    ev = port("torch", "kernel", superchunk_size=superchunk_size)
    ev.search(q, c, cache=port_cache)
    assert ev.last_search_stats["executor"] == (
        "per_chunk" if superchunk_size == 1 else "superchunk")
    reference().search(q, c, cache=ref_cache)
    assert port_cache.generation_key == ref_cache.generation_key == (5, 0)
    np.testing.assert_array_equal(port_cache.ids_array(),
                                  ref_cache.ids_array())


@pytest.mark.parametrize("heap_impl", HEAP_IMPLS)
@pytest.mark.parametrize("score_impl", SCORE_IMPLS)
def test_warm_backend_matrix_bitwise(port, retrieval_data, warm_cache,
                                     score_impl, heap_impl):
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    want = port("numpy", "python").search(q, c, cache=warm_cache)
    for superchunk_size in (0, 1, 3):
        ev = port(score_impl, heap_impl, superchunk_size=superchunk_size)
        _assert_bitwise(ev.search(q, c, cache=warm_cache), want)
        st = ev.last_search_stats
        host = score_impl == "numpy" or heap_impl == "python"
        assert st["executor"] == ("per_chunk" if host or superchunk_size == 1
                                  else "superchunk")
        assert st["generation"] == warm_cache.generation_key
        assert st["chunk_devices"] == ["cpu"]
    assert warm_cache._pins == {}


def test_warm_mining_encodes_no_corpus_chunk(port, retrieval_data,
                                             tmp_path):
    q, c, qrels = (retrieval_data["queries"], retrieval_data["corpus"],
                   retrieval_data["qrels"])
    cache = EmbeddingCache(str(tmp_path / "c"), dim=DIM)
    ev = port()
    seen = _count_corpus_encodes(ev)
    ev.evaluate(q, c, qrels, cache=cache)
    assert sum(seen) == len(c) == len(cache)
    seen.clear()
    batches = ev.encode_pipeline.stats["batches"]
    negs = ev.mine_hard_negatives(q, c, qrels, depth=8, cache=cache)
    assert negs
    assert seen == []       # every corpus chunk came from the cache
    # the only encoder batch was the queries'
    assert ev.encode_pipeline.stats["batches"] == batches + 1
    want = port().mine_hard_negatives(q, c, qrels, depth=8)
    assert {(a, b) for a, b, _ in negs} == {(a, b) for a, b, _ in want}


# -- encode_corpus and prepare_corpus with a cache ---------------------------


def test_encode_corpus_reads_hits_and_writes_misses(port, reference,
                                                    retrieval_data,
                                                    tmp_path):
    c = retrieval_data["corpus"]
    ids, texts = list(c)[:30], list(c.values())[:30]
    ev = port()
    cache = EmbeddingCache(str(tmp_path / "c"), dim=DIM)
    first = ev.encode_corpus(ids[:12], texts[:12], cache)
    assert isinstance(first, np.ndarray) and len(cache) == 12
    seen = _count_corpus_encodes(ev)
    embs = ev.encode_corpus(ids, texts, cache)
    assert seen == [18] and embs.dtype == np.float32
    np.testing.assert_array_equal(embs[:12],
                                  first.astype(np.float16).astype(
                                      np.float32))
    want = reference().encode_corpus(ids, texts)
    np.testing.assert_allclose(embs[12:], want[12:], atol=TOL)
    np.testing.assert_array_equal(cache.live_ids(), cache.ids_array())
    on_device = ev.encode_corpus(ids, texts, device=True)
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_allclose(on_device.numpy(), want, atol=TOL)
    assert ev.encode_corpus([], [], cache).shape == (0, 0)


@pytest.mark.parametrize("covering", (True, False))
def test_row_plan_range_and_rows(port, reference, retrieval_data,
                                 warm_cache, tmp_path, covering):
    """A cache that covers the corpus: corpus order gives the ``range``
    plan, a shuffled corpus the ``rows`` plan (as the reference's cache
    plans them); both search the same rows with no corpus encoding.  A
    cache that lacks one document: no plan and no pin; each chunk is
    looked up as it streams, the missing document is encoded and
    cached, and the search agrees with the reference's over a copy of
    the same cache."""
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    keys = list(c)
    shuffled = {k: c[k] for k in np.random.default_rng(0).permutation(
        keys)}
    ev = port("torch", "kernel", superchunk_size=3)
    caches = {}
    for pkg in ("port", "ref") if not covering else ():
        shutil.copytree(warm_cache.path, tmp_path / pkg)
        caches[pkg] = (EmbeddingCache if pkg == "port" else RefCache)(
            str(tmp_path / pkg), dim=DIM)
    cache = caches.get("port", warm_cache)
    ref_cache = RefCache(warm_cache.path, dim=DIM)
    seen = _count_corpus_encodes(ev)
    runs = {}
    for name, corpus in (("range", c), ("rows", shuffled)):
        if not covering:
            cache.delete_records([keys[7]])
        prepared = ev.prepare_corpus(corpus, cache)
        plan = cache.row_plan(prepared.hashes)
        if covering:
            want = ref_cache.row_plan(prepared.hashes)
            assert plan[0] == want[0] == name
            if name == "rows":
                np.testing.assert_array_equal(plan[1], want[1])
            assert prepared.generation == cache.generation_key
            np.testing.assert_array_equal(prepared.snapshot.ids,
                                          cache.live_ids())
        else:
            assert plan is None
            assert prepared.generation is None and prepared.snapshot is None
        prepared.close()
        runs[name] = ev.search(q, corpus, cache=cache)
        assert seen == ([] if covering else [1])
        seen.clear()
    _assert_bitwise(runs["rows"], runs["range"])
    if covering:
        _assert_bitwise(runs["range"], port("numpy", "python").search(
            q, c, cache=cache))
    else:
        ref = caches["ref"]
        ref.delete_records([keys[7]])
        _, ids, vals = runs["range"]
        _, rids, rvals = reference().search(q, c, cache=ref)
        _assert_close_ranking((ids, vals), (rids, rvals))
        assert cache.has([keys[7]]).all() and ref.has([keys[7]]).all()
        assert cache.n_live == ref.n_live == len(c)
    assert cache._pins == {}
    # an uncovered corpus (one id the cache lacks) takes no plan
    extra = dict(c, fresh="a document the cache has never seen")
    prepared = ev.prepare_corpus(extra, warm_cache)
    assert prepared.generation is None and prepared.snapshot is None


def test_device_resident_with_cache_warms_it(port, retrieval_data,
                                             tmp_path):
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    texts = list(q.values())
    ev = port()
    cache = EmbeddingCache(str(tmp_path / "c"), dim=DIM)
    cold = ev.prepare_corpus(c, cache, device_resident=True)
    assert cache.n_live == len(c) and cold.generation is None
    fresh = ev.prepare_corpus(c, device_resident=True)
    _assert_bitwise(ev.search_texts(texts, cold),
                    ev.search_texts(texts, fresh))
    seen = _count_corpus_encodes(ev)
    warm = ev.prepare_corpus(c, cache, device_resident=True)
    assert seen == [] and len(cache) == len(c)
    _, ids, vals = ev.search(q, c, cache=cache)
    _assert_bitwise(ev.search_texts(texts, warm), (ids, vals))


# -- prepare_cache_corpus: a live corpus -------------------------------------


def test_prepare_cache_corpus_matches_reference(port, reference,
                                                retrieval_data, tmp_path):
    """The cache's own live set after deletes, a re-embed and an add, in
    both packages over one directory; the pin holds across later writes
    and is released on close."""
    q, c = retrieval_data["queries"], retrieval_data["corpus"]
    texts = list(q.values())
    ev = port()
    cache = EmbeddingCache(str(tmp_path / "c"), dim=DIM)
    ev.encode_corpus(list(c), list(c.values()), cache)
    keys = list(c)
    cache.delete_records(keys[:10])
    cache.cache_records(keys[20:25], ev.encode_corpus(
        keys[20:25], [t + " revised" for t in list(c.values())[20:25]]))
    cache.cache_records(["new0", "new1"], ev.encode_corpus(
        ["new0", "new1"], ["fresh text one", "fresh text two"]))
    prepared = ev.prepare_cache_corpus(cache)
    assert prepared.generation == cache.generation_key == (4, 0)
    assert len(prepared) == cache.n_live == len(c) - 10 + 2
    ids, vals = ev.search_texts(texts, prepared)
    deleted = RefCache(cache.path, dim=DIM)
    ref_ev = reference()
    ref_prepared = ref_ev.prepare_cache_corpus(deleted)
    rids, rvals = ref_ev.search_texts(texts, ref_prepared)
    ref_prepared.close()
    _assert_close_ranking((ids, vals), (rids, rvals))
    gone = cache.snapshot((1, 0))
    assert not np.isin(ids, gone.ids[:10]).any()
    gone.close()
    # later writes do not show through the pinned corpus
    cache.delete_records(keys[30:60])
    cache.compact()
    _assert_bitwise(ev.search_texts(texts, prepared), (ids, vals))
    assert cache._pins == {0: 1} and cache._retired
    prepared.close()
    assert cache._pins == {} and not cache._retired
    again = ev.prepare_cache_corpus(cache, generation=cache.generation_key)
    assert again.generation == (5, 1) and len(again) == len(c) - 8 - 30
    again.close()


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
    """While a writer thread mutates the cache, every
    ``prepare_cache_corpus`` search equals, bitwise, a search over a
    frozen copy of the generation it pinned (W = 1, flat index)."""
    corpus = dict(list(retrieval_data["corpus"].items())[:48])
    texts = list(retrieval_data["queries"].values())[:6]
    cache = EmbeddingCache(str(tmp_path / "c"), dim=_ORACLE_DIM)
    ev = port(score_impl, "kernel" if score_impl != "numpy" else "python",
              topk=5, encode_batch_size=16)
    writer_ev = port("numpy", "python", topk=5, encode_batch_size=16)
    writer_ev.encode_corpus(list(corpus), list(corpus.values()), cache)

    def one_search():
        prepared = ev.prepare_cache_corpus(cache)
        try:
            out = ev.search_texts(texts, prepared, 5, min_batch_dim=1)
            snap = prepared.snapshot
            frozen = (snap.ids.copy(), snap.get_range(0, snap.n_live).copy())
        finally:
            prepared.close()
        return out, frozen

    results = []
    with _Writer(cache, writer_ev, corpus) as writer:
        deadline = time.monotonic() + 20.0
        while len(results) < 4 and time.monotonic() < deadline:
            results.append(one_search())
            while (writer.ops < 2 * len(results)
                   and time.monotonic() < deadline
                   and writer.error is None):
                time.sleep(0.002)
    assert len(results) >= 2
    assert cache.epoch == 1              # the compaction ran
    generations = set()
    for (ids, vals), (snap_ids, snap_vecs) in results:
        generations.add((len(snap_ids), hash(snap_ids.tobytes())))
        frozen = PreparedCorpus(
            snap_ids, len(snap_ids),
            lambda lo, hi, v=snap_vecs: v[lo:hi].astype(np.float32))
        ref_ids, ref_vals = ev.search_texts(texts, frozen, 5,
                                            min_batch_dim=1)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(vals, ref_vals)
        assert np.isin(ids[ids >= 0], snap_ids).all()
    assert len(generations) >= 2, generations
    assert cache._pins == {}


# -- the upload --------------------------------------------------------------


def test_to_tensor_copies_only_read_only_or_strided(tmp_path):
    """A read-only memmap slice (a cache read) is copied, with no
    warning, and converts correctly; a writable C-contiguous array (a
    chunk the loader has just cast) is not copied on the host."""
    path = str(tmp_path / "m.bin")
    data = np.arange(64, dtype=np.float32).reshape(8, 8) / 7
    data.astype(np.float16).tofile(path)
    mm = np.memmap(path, dtype=np.float16, mode="r", shape=(8, 8))
    for host in (np.asarray(mm[2:6]), np.asarray(mm[2:6]).view()):
        assert not host.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = to_tensor(host, torch.device("cpu"), torch.float32)
        np.testing.assert_array_equal(t.numpy(), host.astype(np.float32))
        t.add_(1)                               # a copy: the file is intact
        np.testing.assert_array_equal(mm[2:6], data[2:6].astype(np.float16))
    f32 = np.asarray(mm[1:5]).astype(np.float32)
    assert f32.flags.writeable and f32.flags.c_contiguous
    t = to_tensor(f32, torch.device("cpu"), torch.float32)
    assert t.data_ptr() == f32.ctypes.data      # no host copy
    np.testing.assert_array_equal(t.numpy(), f32)
    strided = f32[:, ::2]
    t = to_tensor(strided, torch.device("cpu"), torch.float32)
    assert t.is_contiguous() and t.data_ptr() != f32.ctypes.data
    np.testing.assert_array_equal(t.numpy(), strided)
    np.testing.assert_array_equal(
        to_tensor([[1, 2]], torch.device("cpu"), torch.float32).numpy(),
        [[1.0, 2.0]])


def test_cached_superchunk_goes_up_in_one_copy(port, retrieval_data,
                                               warm_cache, monkeypatch):
    """A cache-fed superchunk reaches the executor as one float32 host
    array: one conversion per superchunk call, the ragged tail padded on
    the device."""
    seen = []
    real = sharded_search._as_device

    def spy(x, device):
        if isinstance(x, np.ndarray):
            seen.append((x.shape, x.dtype, x.flags.writeable))
        return real(x, device)

    monkeypatch.setattr(sharded_search, "_as_device", spy)
    ev = port("torch", "kernel", superchunk_size=2)
    ev.search(retrieval_data["queries"], retrieval_data["corpus"],
              cache=warm_cache)
    st = ev.last_search_stats
    assert st["executor"] == "superchunk" and st["dispatch_rounds"] == 3
    assert seen == [((40, DIM), np.float32, True)] * 2 + [
        ((16, DIM), np.float32, True)]

"""The IVF index, the port against the reference.

``repro_torch.index`` (the k-means quantizer, ``IVFIndex``), the
sharder's cluster-edge snapping, and the evaluator's IVF preparation
(``PreparedCorpus.round_for``, ``IVFSearchSpace``, ``IVFPreparedCorpus``),
on ``device="cpu"`` at a small size, the same seeded numpy inputs fed to
both packages:

  * k-means: centroids within ``KMEANS_TOL = 1e-5`` of
    ``repro.index.kmeans`` on well-separated data with the same seed
    (the two packages sum each cluster in another order), assignments
    equal, two port builds bitwise equal, and no float scatter anywhere
    in a build;
  * the layout: ``select`` / ``gather_rows`` / ``slice_boundaries``
    bitwise equal to the reference's on one shared index; persistence
    byte-compatible both ways, torn and stale reloads returning ``None``;
  * search: inside the port a full probe (``nprobe == nclusters``)
    returns the flat search's scores bitwise for every score x heap pair
    at W in {1, 2, 4}, with ids equal outside runs of exactly equal
    scores (where the id sets match); across packages, given the same
    index and queries, the pruned search returns the reference's ids,
    scores within ``TOL = 1e-5``;
  * the sharder snaps exactly as the reference's on the same calls, and
    a frozen round refuses other boundaries without being consumed;
  * the evaluator: IVF full probe equal to flat (cached, device-resident,
    W > 1), the reference's persisted index reused, a stale digest that
    rebuilds, a live corpus whose new generation rebuilds.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import fair_sharding as ref_sharding
from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.embedding_cache import EmbeddingCache as RefCache
from repro.core.evaluator import IVFPreparedCorpus as RefIVFPrepared
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.index import ivf as ref_ivf
from repro.index import kmeans as ref_kmeans
from repro_torch.core import fair_sharding
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import (IVFPreparedCorpus, IVFSearchSpace,
                                        PreparedCorpus, RetrievalEvaluator)
from repro_torch.core.fair_sharding import FairSharder
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.index import IVFIndex, assign_rows, ivf, train_kmeans
from repro_torch.launch.distributed import InMemoryAllGather, SimulatedCluster
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

torch.set_num_threads(1)

TOL = 1e-5
KMEANS_TOL = 1e-5
DIM = 32
SCORE_IMPLS = ("numpy", "torch", "fused")
HEAP_IMPLS = ("python", "torch", "kernel")
PAIRS = [(s, h) for s in SCORE_IMPLS for h in HEAP_IMPLS]
WAIT_S = 5.0


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """A lost worker fails a test within seconds."""
    monkeypatch.setattr(fair_sharding.FairSharder, "ACQUIRE_TIMEOUT_S",
                        WAIT_S)
    monkeypatch.setattr(InMemoryAllGather, "BARRIER_TIMEOUT_S", WAIT_S)


def _clustered(n_docs, dim, n_topics, n_queries, seed=0, noise=0.12):
    """Unit-norm docs around unit-norm topic centres, and nearby
    queries: the reference's recipe (``tests/test_ivf.py``)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_topics, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    topic = rng.integers(0, n_topics, size=n_docs)
    docs = centers[topic] + noise * rng.normal(
        size=(n_docs, dim)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[rng.choice(n_docs, n_queries, replace=False)] + \
        0.04 * rng.normal(size=(n_queries, dim)).astype(np.float32)
    return docs, (q / np.linalg.norm(q, axis=1, keepdims=True)
                  ).astype(np.float32)


def _get(docs):
    return lambda lo, hi: docs[lo:hi]


def _build(docs, k, **kw):
    kw.setdefault("train_steps", 20)
    return IVFIndex.build(_get(docs), len(docs), k, device="cpu", **kw)


@pytest.fixture(scope="module")
def synth():
    """800 clustered docs of d = 16 around 10 topics, 12 queries, and the
    reference's index over them (shared by both packages' searches)."""
    docs, q = _clustered(800, 16, 10, 12)
    ref_index = ref_ivf.IVFIndex.build(_get(docs), len(docs), 10,
                                       train_steps=20)
    return {"docs": docs, "q": q, "ref_index": ref_index,
            "index": IVFIndex(ref_index.centroids, ref_index.perm,
                              ref_index.offsets)}


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def assert_same_ranking(ids, vals, want_ids, want_vals):
    """Scores bitwise equal; ids equal except inside runs of exactly
    equal scores, where the id sets match.  A run cut by the end of the
    row may hold other members of its tie group, so only its scores are
    held."""
    np.testing.assert_array_equal(vals, want_vals)
    for row, (gi, wi, wv) in enumerate(zip(ids, want_ids, want_vals)):
        start = 0
        while start < len(wv):
            end = start + 1
            while end < len(wv) and wv[end] == wv[start]:
                end += 1
            if end - start == 1:
                assert gi[start] == wi[start], (row, start)
            elif end < len(wv):
                assert set(gi[start:end]) == set(wi[start:end]), (row, start)
            start = end


def _separated(vals):
    inf = np.full_like(vals[:, :1], np.inf)
    up = np.concatenate([inf, vals[:, :-1]], 1) - vals
    down = vals - np.concatenate([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def _assert_close(ids, vals, want_ids, want_vals):
    """Scores within TOL, ids equal where neighbours are separated."""
    np.testing.assert_allclose(vals, want_vals, atol=TOL, rtol=0)
    sep = _separated(np.where(np.isfinite(want_vals), want_vals, -1e30))
    np.testing.assert_array_equal(ids[sep], want_ids[sep])


# -- k-means --------------------------------------------------------------


def test_kmeans_matches_reference_on_separated_clusters():
    """Same seed, same rows: centroids within KMEANS_TOL of the
    reference's, and the same assignment of every row."""
    docs, _ = _clustered(800, 16, 10, 12)
    kw = dict(train_steps=20, batch_size=128, seed=3)
    want = ref_kmeans.train_kmeans(_get(docs), 800, 10, **kw)
    got = train_kmeans(_get(docs), 800, 10, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=KMEANS_TOL, rtol=0)
    np.testing.assert_array_equal(
        assign_rows(got, _get(docs), 800, device="cpu"),
        ref_kmeans.assign_rows(want, _get(docs), 800))


def test_kmeans_port_builds_are_bitwise_equal():
    docs, _ = _clustered(300, 16, 5, 1)
    kw = dict(train_steps=10, batch_size=64, device="cpu")
    c1 = train_kmeans(_get(docs), 300, 5, seed=3, **kw)
    c2 = train_kmeans(_get(docs), 300, 5, seed=3, **kw)
    np.testing.assert_array_equal(c1, c2)
    assert not np.array_equal(c1, train_kmeans(_get(docs), 300, 5, seed=4,
                                               **kw))
    a, b = _build(docs, 5), _build(docs, 5)
    for name in ("centroids", "perm", "offsets"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_kmeans_uses_no_float_scatter(monkeypatch):
    """The per-cluster sums are a matrix product: a build never calls a
    scatter-add or a weighted bincount (atomics on CUDA)."""
    def refuse(*args, **kwargs):
        raise AssertionError("scatter-add in the k-means build")

    for name in ("index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_", "index_put_"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for name in ("index_add", "scatter_add", "scatter_reduce",
                 "segment_reduce", "bincount"):
        monkeypatch.setattr(torch, name, refuse)
    docs, _ = _clustered(300, 16, 5, 1)
    index = _build(docs, 5)
    assert index.n_rows == 300


def test_kmeans_recovers_separated_clusters():
    docs, _ = _clustered(600, 24, 4, 1, noise=0.08)
    cents = train_kmeans(_get(docs), 600, 4, train_steps=30,
                         batch_size=128, device="cpu")
    assign = assign_rows(cents, _get(docs), 600, device="cpu")
    assert assign.shape == (600,) and assign.dtype == np.int32
    assert (np.bincount(assign, minlength=4) > 0).all()
    d2 = ((docs[:, None] - cents[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(assign, np.argmin(d2, axis=1))


@pytest.mark.parametrize("batch_size", (1, 7, 64, 600, 4096))
def test_assign_rows_padding_changes_no_assignment(batch_size):
    """The ragged tail is padded with zero rows, as the reference's is;
    every batch size gives the one-batch assignment."""
    docs, _ = _clustered(600, 24, 4, 1)
    cents = train_kmeans(_get(docs), 600, 4, train_steps=5, device="cpu")
    want = assign_rows(cents, _get(docs), 600, batch_size=600,
                       device="cpu")
    np.testing.assert_array_equal(
        assign_rows(cents, _get(docs), 600, batch_size=batch_size,
                    device="cpu"), want)


def test_kmeans_reads_tensors_too():
    """``get_range`` may serve tensors (a device-resident corpus): the
    same centroids as from the numpy rows."""
    docs, _ = _clustered(300, 16, 5, 1)
    t = torch.from_numpy(docs)
    kw = dict(train_steps=6, batch_size=64, device="cpu")
    np.testing.assert_array_equal(
        train_kmeans(lambda lo, hi: t[lo:hi], 300, 5, **kw),
        train_kmeans(_get(docs), 300, 5, **kw))


@pytest.mark.parametrize("pkg", ("reference", "port"))
def test_kmeans_edge_cases(pkg):
    """More clusters than rows clamp to the row count; no rows and no
    steps raise, with the same messages in both packages."""
    docs = np.eye(3, 8, dtype=np.float32)
    if pkg == "reference":
        train = ref_kmeans.train_kmeans
    else:
        def train(*a, **kw):
            return train_kmeans(*a, device="cpu", **kw)
    assert train(_get(docs), 3, 10, train_steps=2, batch_size=2).shape \
        == (3, 8)
    with pytest.raises(ValueError, match="n_rows must be >= 1"):
        train(_get(docs), 0, 2)
    with pytest.raises(ValueError, match="train_steps must be >= 1"):
        train(_get(docs), 3, 2, train_steps=0)


def test_kmeans_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_kmeans(_get(np.eye(3, 8, dtype=np.float32)), 3, 2)


# -- layout ---------------------------------------------------------------


def test_build_layout_invariants():
    docs, _ = _clustered(500, 16, 6, 1)
    idx = _build(docs, 6, train_steps=10)
    assert np.array_equal(np.sort(idx.perm), np.arange(500))
    assign = assign_rows(idx.centroids, _get(docs), 500, device="cpu")
    np.testing.assert_array_equal(idx.cluster_sizes(),
                                  np.bincount(assign, minlength=6))
    for c in range(idx.n_clusters):
        rows = idx.perm[idx.offsets[c]:idx.offsets[c + 1]]
        assert (assign[rows] == c).all()
        assert (np.diff(rows) > 0).all()


def test_build_matches_reference_layout():
    """Given the rows and knobs, the port's layout is the reference's:
    the same permutation and offsets, centroids within KMEANS_TOL."""
    docs, _ = _clustered(800, 16, 10, 1)
    want = ref_ivf.IVFIndex.build(_get(docs), 800, 10, train_steps=20)
    got = _build(docs, 10)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_allclose(got.centroids, want.centroids,
                               atol=KMEANS_TOL, rtol=0)


@pytest.mark.parametrize("nprobe", (1, 2, 3, 9, 10, 999))
@pytest.mark.parametrize("n_q", (1, 4, 12))
def test_select_gather_boundaries_match_reference(synth, nprobe, n_q):
    """On one shared index the selection, its rows and its cluster edges
    are the reference's, bitwise (a query batch given as a tensor
    too)."""
    q = synth["q"][:n_q]
    ref, port = synth["ref_index"], synth["index"]
    want = ref.select(q, nprobe)
    got = port.select(q, nprobe)
    _bitwise([got], [want])
    _bitwise([port.select(torch.from_numpy(q), nprobe)], [want])
    _bitwise([port.gather_rows(got)], [ref.gather_rows(want)])
    _bitwise([port.slice_boundaries(got)], [ref.slice_boundaries(want)])


def test_select_and_gather_edges(synth):
    idx, q = synth["index"], synth["q"][:3]
    full = idx.select(q, idx.n_clusters)
    assert np.array_equal(np.sort(full), full)
    assert len(idx.gather_rows(full)) == 800
    few = idx.select(q, 2)
    assert 1 <= len(few) <= min(2 * len(q), idx.n_clusters)
    assert np.array_equal(idx.select(q[0], 999), full)
    assert len(idx.gather_rows(np.empty(0, np.int64))) == 0
    b = idx.slice_boundaries(few)
    assert b[0] == 0 and b[-1] == len(idx.gather_rows(few))
    assert (np.diff(b) > 0).all()


def test_index_validates_offsets():
    with pytest.raises(ValueError, match="offsets"):
        IVFIndex(np.zeros((2, 4), np.float32), np.arange(5),
                 np.array([0, 5], np.int64))
    with pytest.raises(ValueError, match="offsets"):
        IVFIndex(np.zeros((2, 4), np.float32), np.arange(5),
                 np.array([0, 2, 4], np.int64))


# -- persistence ----------------------------------------------------------


_FILES = ("centroids.bin", "perm.bin", "offsets.bin", "meta.json")


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_save_load_cross_package(synth, tmp_path, writer):
    """An index either package saves loads in the other, and both write
    the same bytes."""
    ref, port = synth["ref_index"], synth["index"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    (ref if writer == "reference" else port).save(a, digest="dig")
    (port if writer == "reference" else ref).save(b, digest="dig")
    for fname in _FILES:
        with open(os.path.join(a, fname), "rb") as fa, \
                open(os.path.join(b, fname), "rb") as fb:
            assert fa.read() == fb.read(), fname
    reader = IVFIndex if writer == "reference" else ref_ivf.IVFIndex
    back = reader.load(a, expect_n=800, expect_dim=16, expect_clusters=10,
                       expect_digest="dig")
    assert back is not None
    for name in ("centroids", "perm", "offsets"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(ref, name))


def test_persist_roundtrip_and_staleness(tmp_path):
    docs, _ = _clustered(200, 8, 4, 1)
    idx = _build(docs, 4, train_steps=5)
    d = str(tmp_path / "ivf")
    idx.save(d, digest="dig-1")
    back = IVFIndex.load(d, expect_n=200, expect_dim=8, expect_clusters=4,
                         expect_digest="dig-1")
    for name in ("centroids", "perm", "offsets"):
        np.testing.assert_array_equal(getattr(back, name), getattr(idx, name))
    assert json.load(open(os.path.join(d, "meta.json")))["version"] == 1
    assert IVFIndex.load(d, expect_digest="dig-2") is None
    assert IVFIndex.load(d, expect_n=201) is None
    assert IVFIndex.load(d, expect_dim=16) is None
    assert IVFIndex.load(d, expect_clusters=8) is None
    assert IVFIndex.load(str(tmp_path / "nowhere")) is None


def _tear(d, case):
    if case == "short_perm":
        with open(os.path.join(d, "perm.bin"), "r+b") as f:
            f.truncate(8 * 149)
    elif case == "short_offsets":
        with open(os.path.join(d, "offsets.bin"), "r+b") as f:
            f.truncate(8)
    elif case == "short_centroids":
        with open(os.path.join(d, "centroids.bin"), "r+b") as f:
            f.truncate(4)
    elif case == "not_a_permutation":
        with open(os.path.join(d, "perm.bin"), "wb") as f:
            f.write(np.zeros(150, np.int64).tobytes())
    elif case == "out_of_range":
        with open(os.path.join(d, "perm.bin"), "wb") as f:
            f.write(np.arange(1, 151, dtype=np.int64).tobytes())
    elif case == "torn_meta":
        with open(os.path.join(d, "meta.json"), "w") as f:
            f.write('{"n": 150, "dim"')


@pytest.mark.parametrize("case", ("short_perm", "short_offsets",
                                  "short_centroids", "not_a_permutation",
                                  "out_of_range", "torn_meta"))
def test_persist_torn_write_reopens_as_rebuild(tmp_path, case):
    """A torn payload reads as "rebuild" (``None``) in both packages,
    never as a wrong permutation."""
    docs, _ = _clustered(150, 8, 3, 1)
    d = str(tmp_path / "ivf")
    _build(docs, 3, train_steps=5).save(d, digest="x")
    _tear(d, case)
    assert IVFIndex.load(d, expect_digest="x") is None
    assert ref_ivf.IVFIndex.load(d, expect_digest="x") is None


def test_persist_ignores_trailing_bytes(tmp_path):
    docs, _ = _clustered(150, 8, 3, 1)
    idx = _build(docs, 3, train_steps=5)
    d = str(tmp_path / "ivf")
    idx.save(d, digest="x")
    for fname in _FILES[:3]:
        with open(os.path.join(d, fname), "ab") as f:
            f.write(b"\x07" * 13)
    back = IVFIndex.load(d, expect_digest="x")
    np.testing.assert_array_equal(back.perm, idx.perm)


@pytest.mark.parametrize("generation", (None, 3, (4, 1)))
def test_corpus_digest_matches_reference(generation):
    hashes = np.random.default_rng(0).integers(0, 2 ** 62, 50)
    kw = dict(seed=2, train_steps=7, train_batch=64, generation=generation)
    assert ivf.corpus_digest(hashes, **kw) == \
        ref_ivf.corpus_digest(hashes, **kw)


def test_cluster_order_matches_reference(synth):
    docs = synth["docs"]
    kw = dict(seed=1, train_steps=8, train_batch=64)
    np.testing.assert_array_equal(
        ivf.cluster_order(_get(docs), 800, 10, device="cpu", **kw),
        ref_ivf.cluster_order(_get(docs), 800, 10, **kw))


# -- search: full probe against flat, pruned against the reference ----------


def _driver(score, heap, w=1, rank=0, cluster=None, **kw):
    kw.setdefault("chunk_size", 64)
    kw.setdefault("superchunk_size", 4)
    if cluster is not None:
        kw.update(sharder=cluster.sharder, gather=cluster.gather)
    return ShardedSearchDriver(n_workers=w, worker_index=rank,
                               score_impl=score, heap_impl=heap,
                               device="cpu", **kw)


def _ivf_search(q, docs, index, nprobe, topk, score, heap, world=1):
    """Every rank's (ids, vals, stats) of one IVF round."""
    prepared = IVFPreparedCorpus(np.arange(len(docs), dtype=np.int64),
                                 len(docs), lambda rows: docs[rows], index,
                                 nprobe)
    sized, load_chunk, to_ids = prepared.round_for(q)
    if world == 1:
        d = _driver(score, heap)
        vals, pos = d.search(q, sized, load_chunk, topk)
        return [(to_ids(pos), vals, d.stats)]
    cluster = SimulatedCluster(world)
    drivers = [_driver(score, heap, world, r, cluster)
               for r in range(world)]
    outs = cluster.run(lambda r: drivers[r].search(q, sized, load_chunk,
                                                   topk))
    return [(to_ids(pos), vals, d.stats)
            for (vals, pos), d in zip(outs, drivers)]


@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("score,heap", PAIRS)
def test_full_probe_equals_flat(synth, score, heap, world):
    """nprobe == nclusters scans every row in cluster order: the flat
    scores bitwise, ids equal outside exact ties, on every rank; each
    rank's shard a run of whole clusters."""
    docs, q, index = synth["docs"], synth["q"], synth["index"]
    vals, pos = _driver(score, heap).search(q, len(docs), _get(docs), 10)
    outs = _ivf_search(q, docs, index, index.n_clusters, 10, score, heap,
                       world)
    edges = set(index.offsets.tolist())
    for ids, got_vals, st in outs:
        assert_same_ranking(ids, got_vals, pos.astype(np.int64), vals)
        assert st["lo"] in edges and st["hi"] in edges


@pytest.mark.parametrize("world", (1, 2))
@pytest.mark.parametrize("score,heap", (("numpy", "python"),
                                        ("torch", "kernel"),
                                        ("fused", "kernel")))
@pytest.mark.parametrize("nprobe", (1, 2))
def test_pruned_search_matches_reference(synth, nprobe, score, heap, world):
    """Given the same index and queries (a batch of 4) the port scans the
    reference's rows: its ids, scores within TOL; the space is pruned."""
    docs, q = synth["docs"], synth["q"][:4]
    ref_prep = RefIVFPrepared(np.arange(800, dtype=np.int64), 800,
                              lambda rows: docs[rows], synth["ref_index"],
                              nprobe)
    sized, load_chunk, to_ids = ref_prep.round_for(q)
    assert 0 < len(sized) < 800
    r_vals, r_pos = RefDriver(score_impl="numpy", chunk_size=64).search(
        q, sized, load_chunk, 10)
    want_ids = to_ids(r_pos)
    for ids, vals, _ in _ivf_search(q, docs, synth["index"], nprobe, 10,
                                    score, heap, world):
        _assert_close(ids, vals, want_ids, r_vals)


@pytest.mark.parametrize("score,heap", (("numpy", "python"),
                                        ("torch", "kernel"),
                                        ("fused", "kernel")))
def test_topk_exceeds_selected_rows(synth, score, heap):
    """k larger than the probed clusters' rows: the tail is (-inf, -1),
    the head an exact top-k over those rows."""
    docs, q, index = synth["docs"], synth["q"][:1], synth["index"]
    sel = index.gather_rows(index.select(q, 1))
    big_k = len(sel) + 7
    (ids, vals, _), = _ivf_search(q, docs, index, 1, big_k, score, heap)
    assert (ids[0, :len(sel)] >= 0).all()
    assert (ids[0, len(sel):] == -1).all()
    assert (vals[0, len(sel):] == -np.inf).all()
    exact = q.astype(np.float64) @ docs[sel].astype(np.float64).T
    order = np.argsort(-exact[0], kind="stable")
    _assert_close(ids[:, :len(sel)], vals[:, :len(sel)],
                  sel[order][None], exact[0][order][None])


@pytest.mark.parametrize("world", (1, 2))
def test_empty_selection_returns_empty(world):
    """Every probed cluster empty: the round scans nothing and every
    slot is (-inf, -1), at W = 1 and W = 2."""
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(20, 8)).astype(np.float32)
    centroids = np.stack([np.full(8, 10.0, np.float32), docs.mean(0)])
    index = IVFIndex(centroids, np.arange(20, dtype=np.int64),
                     np.array([0, 0, 20], np.int64))
    q = np.full((1, 8), 10.0, np.float32)
    assert len(index.select(q, 1)) == 0
    for ids, vals, st in _ivf_search(q, docs, index, 1, 5, "fused",
                                     "kernel", world):
        assert (ids == -1).all() and (vals == -np.inf).all()
        assert st["items"] == 0 and st["dispatch_rounds"] == 0


def test_flat_round_for_returns_its_members():
    p = PreparedCorpus(np.arange(4), 4, lambda lo, hi: None)
    assert p.round_for(None) == (p.sized, p.load_chunk, p.positions_to_ids)


def test_ivf_space_rows_on_a_device_index_once(synth):
    """With ``rows_device`` the round's rows go to that device once and
    each chunk gathers there; the result equals the host-indexed one."""
    docs, q, index = synth["docs"], synth["q"], synth["index"]
    t = torch.from_numpy(docs)
    seen = []

    def fetch(rows):
        seen.append(type(rows))
        return t[rows]

    prep = IVFPreparedCorpus(np.arange(800, dtype=np.int64), 800, fetch,
                             index, 3, rows_device=torch.device("cpu"))
    sized, load_chunk, to_ids = prep.round_for(q)
    vals, pos = _driver("fused", "kernel").search(q, sized, load_chunk, 10)
    (want_ids, want_vals, _), = _ivf_search(q, docs, index, 3, 10, "fused",
                                            "kernel")
    _bitwise((to_ids(pos), vals), (want_ids, want_vals))
    assert seen and set(seen) == {torch.Tensor}


# -- the sharder's cluster-edge snapping ------------------------------------


_SNAP_CASES = {
    "three": (3, 100, [0, 10, 35, 60, 80, 100], [], []),
    "coarse": (4, 100, [0, 90, 100], [], []),
    "ties": (2, 100, [0, 40, 60, 100], [], []),
    "one_cluster": (3, 50, [0, 50], [], []),
    "fine": (4, 997, list(range(0, 997, 7)) + [997], [], []),
    "skewed": (3, 400, [0, 5, 100, 150, 390, 400],
               [(0, 300, 1.0), (1, 50, 1.0), (2, 50, 1.0)], []),
    "dead": (4, 200, [0, 40, 80, 120, 160, 200], [], [1]),
    "dead_skewed": (4, 300, [0, 12, 130, 131, 250, 300],
                    [(0, 10, 1.0), (1, 90, 1.0), (2, 50, 1.0),
                     (3, 70, 1.0)], [2]),
}


@pytest.mark.parametrize("case", sorted(_SNAP_CASES))
def test_sharder_snaps_like_the_reference(case):
    """The same updates, deaths and bounds calls on both packages give
    the same snapped bounds; every interior cut is on an edge, the
    shards partition the space, and dead workers' shards are empty."""
    n, total, edges, updates, dead = _SNAP_CASES[case]
    port, ref = FairSharder(n), ref_sharding.FairSharder(n)
    for s in (port, ref):
        for w, items, secs in updates:
            s.update(w, items, secs, round_no=0)
        for w in dead:
            s.mark_dead(w)
    bnd = np.asarray(edges, np.int64)
    got = port.bounds(total, bnd)
    assert got == ref.bounds(total, bnd)
    assert got[0][0] == 0 and got[-1][1] == total
    assert all(b == c for (_, b), (c, _) in zip(got, got[1:]))
    assert all(hi in edges for _, hi in got)
    for w in dead:
        assert got[w][0] == got[w][1]
    assert port.bounds(total) == ref.bounds(total)
    assert port.acquire(0, total, bnd)[1] == got


def test_frozen_round_refuses_other_boundaries():
    """A round frozen with one set of edges refuses another (or none)
    with ValueError and is not consumed: the acquirer can re-acquire it
    with the round's edges."""
    s = FairSharder(2)
    edges = np.array([0, 30, 70, 100], np.int64)
    r, bounds = s.acquire(0, 100, edges, generation=(1, 0))
    assert r == 0 and bounds == [(0, 30), (30, 100)]
    with pytest.raises(ValueError, match="other cut boundaries"):
        s.acquire(1, 100, np.array([0, 50, 100], np.int64),
                  generation=(1, 0))
    with pytest.raises(ValueError, match="other cut boundaries"):
        s.acquire(1, 100, generation=(1, 0))
    with pytest.raises(ValueError, match="partitioned over 100"):
        s.acquire(1, 90, edges, generation=(1, 0))
    assert s.acquire(1, 100, list(edges), generation=(1, 0)) == (0, bounds)


def test_driver_partition_snaps_to_the_space_edges(synth):
    index, q = synth["index"], synth["q"]
    prep = IVFPreparedCorpus(np.arange(800, dtype=np.int64), 800,
                             lambda rows: synth["docs"][rows], index, 3)
    sized, _, _ = prep.round_for(q)
    assert isinstance(sized, IVFSearchSpace)
    assert sized.partition_boundaries[-1] == len(sized)
    for w in (2, 3, 4):
        got = _driver("numpy", "python", w).partition(sized)
        want = RefDriver(n_workers=w, worker_index=0, score_impl="numpy"
                         ).partition(sized)
        assert got == want
        assert all(hi in sized.partition_boundaries for _, hi in got)


# -- the evaluator ----------------------------------------------------------


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

    def make(score_impl="fused", heap_impl="kernel", rank=0, world=1,
             cluster=None, **kw):
        fields = dict(topk=10, encode_batch_size=20, score_impl=score_impl,
                      heap_impl=heap_impl, metrics=("ndcg@10",))
        fields.update(kw)
        workers = {}
        if cluster is not None:
            workers = dict(gather=cluster.gather, sharder=cluster.sharder)
        return RetrievalEvaluator(EvaluationArguments(**fields), retriever,
                                  collator, params, device="cpu",
                                  process_index=rank, process_count=world,
                                  **workers)
    return make


IVF6 = dict(index_impl="ivf", ivf_nclusters=6, ivf_nprobe=6,
            ivf_train_steps=8)


@pytest.fixture(scope="module")
def ivf_env(tiny_retriever, tiny_params, retrieval_data, tmp_path_factory):
    """One warm cache directory the reference fills and indexes
    (``ivf_k6``), and the reference's pruned search of 3 queries over it
    (nprobe 1)."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    few = dict(list(queries.items())[:3])
    path = str(tmp_path_factory.mktemp("ivfcache") / "c")
    coll = JaxCollator(JaxDataArguments(vocab_size=257), JaxTokenizer(257))
    ref = JaxEvaluator(JaxEvalArgs(topk=10, encode_batch_size=20,
                                   score_impl="numpy", metrics=("ndcg@10",),
                                   **dict(IVF6, ivf_nprobe=1)),
                       tiny_retriever, coll, tiny_params,
                       process_index=0, process_count=1)
    ref_cache = RefCache(path, dim=DIM)
    ref.search(queries, corpus, cache=ref_cache)           # warm the cache
    ref_pruned = ref.search(few, corpus, cache=ref_cache)
    return {"path": path, "queries": queries, "corpus": corpus,
            "few": few, "ref_pruned": ref_pruned}


@pytest.fixture()
def builds(monkeypatch):
    """Counts ``IVFIndex.build`` calls."""
    calls = []
    build = IVFIndex.build.__func__

    def counted(cls, *a, **kw):
        calls.append(a[1])
        return build(cls, *a, **kw)

    monkeypatch.setattr(IVFIndex, "build", classmethod(counted))
    return calls


def test_evaluator_reuses_the_reference_index(port, ivf_env, builds):
    """The port opens the reference's cache and its persisted ``ivf_k6``
    (the digest holds the same hashes, knobs and generation): no build,
    and the pruned ranking within TOL of the reference's."""
    cache = EmbeddingCache(ivf_env["path"], dim=DIM)
    ev = port("numpy", "python", **dict(IVF6, ivf_nprobe=1))
    prepared = ev.prepare_corpus(ivf_env["corpus"], cache)
    try:
        assert isinstance(prepared, IVFPreparedCorpus)
        assert builds == []
        q_emb = ev._encode_texts(list(ivf_env["few"].values()), True)
        n_sel = len(prepared.round_for(q_emb)[0])
        assert 0 < n_sel < len(ivf_env["corpus"])
    finally:
        prepared.close()
    qh, ids, vals = ev.search(ivf_env["few"], ivf_env["corpus"],
                              cache=cache)
    assert builds == []
    rqh, rids, rvals = ivf_env["ref_pruned"]
    np.testing.assert_array_equal(qh, rqh)
    _assert_close(ids, vals, rids, rvals)


@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("score,heap", (("numpy", "python"),
                                        ("torch", "kernel"),
                                        ("fused", "kernel")))
def test_evaluator_full_probe_equals_flat(port, ivf_env, score, heap, world):
    """index_impl="ivf" at nprobe == nclusters over the warm cache: the
    flat warm search's scores bitwise, ids outside exact ties, on every
    rank."""
    cache = EmbeddingCache(ivf_env["path"], dim=DIM)
    queries, corpus = ivf_env["queries"], ivf_env["corpus"]
    flat = port(score, heap).search(queries, corpus, cache=cache)
    if world == 1:
        outs = [port(score, heap, **IVF6).search(queries, corpus,
                                                 cache=cache)]
    else:
        cluster = SimulatedCluster(world)
        evs = [port(score, heap, r, world, cluster, **IVF6)
               for r in range(world)]
        outs = cluster.run(lambda r: evs[r].search(queries, corpus,
                                                   cache=cache))
    for qh, ids, vals in outs:
        np.testing.assert_array_equal(qh, flat[0])
        assert_same_ranking(ids, vals, flat[1], flat[2])


@pytest.mark.parametrize("score,heap", (("torch", "kernel"),
                                        ("fused", "kernel")))
def test_evaluator_device_resident_full_probe_equals_flat(
        port, retrieval_data, score, heap, builds):
    """Online encoding, rows kept where scoring happens: the IVF
    preparation scores the flat device-resident rows' bits; no cache, so
    nothing persists and every preparation builds."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    flat_ev = port(score, heap)
    ev = port(score, heap, **IVF6)
    flat = flat_ev.prepare_corpus(corpus, device_resident=True)
    prepared = ev.prepare_corpus(corpus, device_resident=True)
    assert prepared.rows_device == torch.device("cpu")
    assert len(builds) == 1
    texts = list(queries.values())
    want = flat_ev.search_texts(texts, flat)
    got = ev.search_texts(texts, prepared)
    assert_same_ranking(got[0], got[1], want[0], want[1])
    qh, ids, vals = ev.search_prepared(queries, prepared)
    assert_same_ranking(ids, vals, want[0], want[1])


def test_evaluator_pruned_equals_exact_topk_over_selected_rows(
        port, retrieval_data):
    """nprobe 1, 3 queries: each result is an exact float64 top-k over
    the rows of the clusters the round selected; evaluate and mine run
    through the same rounds."""
    queries, corpus, qrels = (retrieval_data["queries"],
                              retrieval_data["corpus"],
                              retrieval_data["qrels"])
    ev = port("fused", "kernel", **dict(IVF6, ivf_nprobe=1))
    prepared = ev.prepare_corpus(corpus, device_resident=True)
    texts = list(queries.values())[:3]
    q_emb = ev._encode_texts(texts, True)
    sel = prepared.index.gather_rows(prepared.index.select(q_emb, 1))
    assert 0 < len(sel) < len(corpus)
    ids, vals = ev.search_texts(texts, prepared)
    rows = prepared.fetch_rows(sel).numpy().astype(np.float64)
    exact = q_emb.astype(np.float64) @ rows.T
    order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    _assert_close(ids, vals, prepared.hashes[sel][order],
                  np.take_along_axis(exact, order, 1))
    metrics = ev.evaluate(queries, corpus, qrels)
    assert 0.0 <= metrics["ndcg@10"] <= 1.0
    negs = ev.mine_hard_negatives(queries, corpus, qrels, depth=5)
    assert negs and all(np.isfinite(s) for _, _, s in negs)


def test_evaluator_stale_digest_rebuilds(port, retrieval_data, tmp_path,
                                         builds):
    """Over a warm cache the first IVF pass builds and saves ``ivf_k6``,
    the next loads it (the file untouched), and other knobs change the
    digest and rebuild; every pass ranks as the flat search does."""
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    cache = EmbeddingCache(str(tmp_path / "c"), dim=DIM)
    port().search(queries, corpus, cache=cache)             # warm it
    flat = port().search(queries, corpus, cache=cache)
    first = port(**IVF6).search(queries, corpus, cache=cache)
    assert len(builds) == 1
    d = os.path.join(cache.path, "ivf_k6")
    st = os.stat(os.path.join(d, "meta.json")).st_mtime_ns
    again = port(**IVF6).search(queries, corpus, cache=cache)
    assert len(builds) == 1
    assert os.stat(os.path.join(d, "meta.json")).st_mtime_ns == st
    other = port(**dict(IVF6, ivf_train_steps=9)).search(
        queries, corpus, cache=cache)
    assert len(builds) == 2
    assert os.stat(os.path.join(d, "meta.json")).st_mtime_ns != st
    assert json.load(open(os.path.join(d, "meta.json")))["digest"].split(
        "-")[2] == "t9"
    for out in (first, again, other):
        assert_same_ranking(out[1], out[2], flat[1], flat[2])


def test_live_corpus_new_generation_rebuilds(port, retrieval_data,
                                             tmp_path, builds):
    """``prepare_cache_corpus`` under IVF: the snapshot's index is built
    once per generation (the digest holds it); a mutation's generation
    rebuilds, and each search is an exact top-k over its snapshot's
    selected rows."""
    corpus = retrieval_data["corpus"]
    texts = list(retrieval_data["queries"].values())
    cache = EmbeddingCache(str(tmp_path / "live"), dim=DIM)
    ev = port("torch", "kernel", **dict(IVF6, ivf_nprobe=3))
    ids = list(corpus)
    cache.cache_records(ids, ev._encode_texts([corpus[i] for i in ids],
                                              False))
    q_emb = ev._encode_texts(texts, True)
    for step in range(3):
        prepared = ev.prepare_cache_corpus(cache)
        try:
            assert len(builds) == step + 1
            again = ev.prepare_cache_corpus(cache)
            again.close()
            assert len(builds) == step + 1          # loaded, not rebuilt
            got_ids, got_vals = ev.search_texts(texts, prepared)
            sel = prepared.index.gather_rows(prepared.index.select(q_emb, 3))
            rows = prepared.snapshot.get_rows(sel).astype(np.float64)
            exact = q_emb.astype(np.float64) @ rows.T
            order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
            _assert_close(got_ids, got_vals, prepared.hashes[sel][order],
                          np.take_along_axis(exact, order, 1))
        finally:
            prepared.close()
        cache.delete_records(ids[step * 5: step * 5 + 5])
        cache.cache_records([f"new{step}"],
                            ev._encode_texts([f"fresh doc {step}"], False))


def test_ivf_w2_ranks_refuse_other_selections(port, ivf_env):
    """Two ranks whose query batches select different clusters size
    different spaces: the later acquirer of the round is refused
    (ValueError), and the round is not consumed."""
    cache = EmbeddingCache(ivf_env["path"], dim=DIM)
    cluster = SimulatedCluster(2)
    evs = [port("numpy", "python", r, 2, cluster, **dict(IVF6, ivf_nprobe=1))
           for r in range(2)]
    texts = list(ivf_env["queries"].values())
    preps = [ev.prepare_corpus(ivf_env["corpus"], cache) for ev in evs]
    try:
        q = evs[0]._encode_texts(texts, True)
        sizes = {i: len(preps[0].round_for(q[i:i + 1])[0])
                 for i in range(len(texts))}
        a = min(sizes, key=sizes.get)
        b = max(sizes, key=sizes.get)
        assert sizes[a] != sizes[b]
        d0, d1 = evs[0].make_driver(), evs[1].make_driver()
        s0 = preps[0].round_for(q[a:a + 1])
        s1 = preps[1].round_for(q[b:b + 1])
        d0._score_local(q[a:a + 1], s0[0], s0[1], 10)
        with pytest.raises(ValueError, match="partitioned over"):
            d1._score_local(q[b:b + 1], s1[0], s1[1], 10)
        s1 = preps[1].round_for(q[a:a + 1])
        assert d1._score_local(q[a:a + 1], s1[0], s1[1], 10)[1]["round"] \
            == 0
    finally:
        for p in preps:
            p.close()


# -- config -----------------------------------------------------------------


@pytest.mark.parametrize("kwargs,name", (
    ({"index_impl": "annoy"}, "index_impl"),
    ({"ivf_nclusters": 0}, "ivf_nclusters"),
    ({"ivf_nprobe": 0}, "ivf_nprobe"),
    ({"ivf_train_steps": 0}, "ivf_train_steps"),
    ({"ivf_train_batch": 0}, "ivf_train_batch"),
))
def test_config_validates_ivf_knobs(kwargs, name):
    with pytest.raises(ValueError, match=name):
        EvaluationArguments(**kwargs)
    with pytest.raises(ValueError, match=name):
        JaxEvalArgs(**kwargs)


def test_config_ivf_defaults_match_reference():
    names = ("index_impl", "ivf_nclusters", "ivf_nprobe", "ivf_train_steps",
             "ivf_train_batch", "ivf_seed")
    port_args, ref_args = EvaluationArguments(), JaxEvalArgs()
    assert ({n: getattr(port_args, n) for n in names}
            == {n: getattr(ref_args, n) for n in names})
    assert EvaluationArguments(index_impl="ivf", ivf_nclusters=4,
                               ivf_nprobe=4).index_impl == "ivf"

"""The port's EmbeddingCache log against the reference's.

Every case runs one operation sequence on a ``repro`` cache and a
``repro_torch`` cache side by side (the single-worker cases of
``tests/test_mutation.py`` and the torn-write / compaction chaos cases of
``tests/test_faults.py``) and holds the port to the reference: the same
``generation_key``, ``n_live``, live ids and log length, and every row
read back bitwise (both store the same float16 bytes).  Directories
written by either package open in the other.  Fault cases use each
package's own ``FaultInjector``.
"""

import os
import threading
import time

import numpy as np
import pytest

from repro.core.embedding_cache import EmbeddingCache as RefCache
from repro.core.faults import Fault as RefFault
from repro.core.faults import FaultInjector as RefInjector
from repro.core.faults import InjectedCrash as RefCrash
from repro.core.sharded_search import ShardedSearchDriver as RefDriver
from repro.index.ivf import cluster_order
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.faults import Fault, FaultInjector, InjectedCrash
from repro_torch.core.sharded_search import ShardedSearchDriver
from repro_torch.data.table import stable_id_hash
from repro_torch.index.ivf import cluster_order as port_cluster_order

DIM = 8


def _vecs(n, seed):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)


class Twin:
    """A reference cache and a port cache driven in lock step."""

    def __init__(self, root):
        self.root = root
        self.ref = RefCache(str(root / "ref"), dim=DIM)
        self.port = EmbeddingCache(str(root / "port"), dim=DIM)

    def both(self, op):
        """``op(cache)`` on each; results as (ref, port)."""
        return op(self.ref), op(self.port)

    def fill(self, n, seed=0, prefix="d"):
        ids = [f"{prefix}{i}" for i in range(n)]
        vecs = _vecs(n, seed)
        self.both(lambda c: c.cache_records(ids, vecs))
        return ids, vecs

    def reopen(self):
        self.ref = RefCache(str(self.root / "ref"), dim=DIM)
        self.port = EmbeddingCache(str(self.root / "port"), dim=DIM)

    def check(self):
        assert_same_cache(self.ref, self.port)


def _snapshot_view(cache, generation=None):
    snap = cache.snapshot(generation)
    try:
        return (snap.key, snap.ids.copy(),
                snap.get_range(0, snap.n_live).copy())
    finally:
        snap.close()


def assert_same_cache(ref, port):
    assert port.generation_key == ref.generation_key
    assert port.n_live == ref.n_live
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port.live_ids(), ref.live_ids())
    np.testing.assert_array_equal(port.ids_array(), ref.ids_array())
    (rk, rids, rrows), (pk, pids, prows) = (_snapshot_view(ref),
                                            _snapshot_view(port))
    assert pk == rk
    np.testing.assert_array_equal(pids, rids)
    assert prows.dtype == rrows.dtype == np.float16
    np.testing.assert_array_equal(prows, rrows)
    if len(ref):
        np.testing.assert_array_equal(port.get_range(0, len(port)),
                                      ref.get_range(0, len(ref)))
    if ref.n_live:
        live = ref.live_ids()
        np.testing.assert_array_equal(port.get(live), ref.get(live))


def _raises_same(twin, op, exc):
    """``op`` raises ``exc`` with the same message in both packages."""
    msgs = []
    for cache in (twin.ref, twin.port):
        with pytest.raises(exc) as info:
            op(cache)
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]
    return msgs[0]


# -- log semantics (single-worker cases of test_mutation.py) -----------------


def test_recache_is_last_write_wins(tmp_path):
    twin = Twin(tmp_path)
    ids, vecs = twin.fill(6)
    new = np.full((1, DIM), 7.0, np.float32)
    twin.both(lambda c: c.cache_records(["d2"], new))
    twin.check()
    assert len(twin.port) == 7 and twin.port.n_live == 6
    hashes = np.asarray([stable_id_hash(i) for i in ids])
    (rk, rrows), (pk, prows) = twin.both(lambda c: c.row_plan(hashes))
    assert pk == rk == "rows"
    np.testing.assert_array_equal(prows, rrows)
    got = twin.port.get_rows(prows)
    np.testing.assert_array_equal(got, twin.ref.get_rows(rrows))
    np.testing.assert_allclose(got[2], new[0])
    np.testing.assert_array_equal(twin.port.get_one("d2"),
                                  twin.ref.get_one("d2"))
    r, p = twin.both(lambda c: c.snapshot())
    np.testing.assert_array_equal(p.get(["d2"]), r.get(["d2"]))
    np.testing.assert_array_equal(p.has(["d2", "zz"]), [True, False])
    r.close()
    p.close()


def test_delete_tombstone_then_readd_resurrects(tmp_path):
    twin = Twin(tmp_path)
    twin.fill(5)
    g0 = twin.port.generation
    twin.both(lambda c: c.delete_records(["d1", "d3"]))
    twin.check()
    assert twin.port.generation == g0 + 1 and twin.port.n_live == 3
    assert "d1" not in twin.port and "d0" in twin.port
    msg = _raises_same(twin, lambda c: c.get(["d1"]), KeyError)
    assert "d1" in msg
    twin.both(lambda c: c.cache_records(["d1"],
                                        np.full((1, DIM), 3.0, np.float32)))
    twin.check()
    assert twin.port.has(["d1"])[0] and twin.port.n_live == 4
    # a never-cached id: a committed no-op tombstone
    twin.both(lambda c: c.delete_records(["ghost"]))
    twin.both(lambda c: c.delete_records([]))
    twin.check()
    assert twin.port.n_live == 4


def test_snapshot_pins_generation_across_mutations(tmp_path):
    twin = Twin(tmp_path)
    twin.fill(6)
    ref_snap, port_snap = twin.both(lambda c: c.snapshot())
    before = port_snap.get_range(0, port_snap.n_live).copy()
    twin.both(lambda c: c.delete_records(["d0"]))
    twin.both(lambda c: c.cache_records(
        ["d3"], np.full((1, DIM), 9.0, np.float32)))
    twin.both(lambda c: c.cache_records(
        ["new0"], np.full((1, DIM), 4.0, np.float32)))
    twin.check()
    for snap in (ref_snap, port_snap):
        np.testing.assert_array_equal(snap.get_range(0, snap.n_live),
                                      before)
        assert snap.has(["d0"])[0] and not snap.has(["new0"])[0]
    assert port_snap.key == ref_snap.key
    np.testing.assert_array_equal(port_snap.ids, ref_snap.ids)
    rows = np.array([4, 0, 2])
    np.testing.assert_array_equal(port_snap.get_rows(rows),
                                  ref_snap.get_rows(rows))
    np.testing.assert_array_equal(port_snap.get(["d3"]),
                                  ref_snap.get(["d3"]))
    hashes = port_snap.ids[::-1].copy()
    for snap in (ref_snap, port_snap):
        assert snap.row_plan(port_snap.ids)[0] == "range"
    np.testing.assert_array_equal(port_snap.row_plan(hashes)[1],
                                  ref_snap.row_plan(hashes)[1])
    assert port_snap.row_plan(np.array([12345])) is None
    ref_snap.close()
    port_snap.close()


def test_snapshot_resolves_past_generations(tmp_path):
    twin = Twin(tmp_path)
    twin.fill(4)
    g1 = twin.port.generation
    twin.both(lambda c: c.delete_records(["d2"]))
    twin.both(lambda c: c.cache_records(["d9"], np.ones((1, DIM))))
    for gen in (g1, (g1, 0), g1 + 1):
        (rk, rids, rrows), (pk, pids, prows) = twin.both(
            lambda c: _snapshot_view(c, gen))
        assert pk == rk
        np.testing.assert_array_equal(pids, rids)
        np.testing.assert_array_equal(prows, rrows)
    snap = twin.port.snapshot(g1)
    assert snap.has(["d2"])[0] and not snap.has(["d9"])[0]
    snap.close()
    _raises_same(twin, lambda c: c.snapshot(g1 + 1000), KeyError)
    _raises_same(twin, lambda c: c.snapshot((g1, 3)), KeyError)


def test_compaction_preserves_views_and_retires_old_epoch(tmp_path):
    twin = Twin(tmp_path)
    twin.fill(10)
    twin.both(lambda c: c.delete_records(["d4", "d7"]))
    twin.both(lambda c: c.cache_records(
        ["d1"], np.full((1, DIM), 5.0, np.float32)))
    pinned = twin.both(lambda c: c.snapshot())
    want = pinned[1].get_range(0, pinned[1].n_live).copy()
    ref_stats, port_stats = twin.both(lambda c: c.compact())
    assert port_stats == ref_stats
    assert port_stats["rows_after"] == 8 and port_stats["dropped"] == 3
    twin.check()
    assert twin.port.epoch == 1
    # the pinned epoch-0 readers keep their files until the last pin drops
    for name, snap in zip(("ref", "port"), pinned):
        np.testing.assert_array_equal(snap.get_range(0, snap.n_live), want)
        assert os.path.exists(tmp_path / name / "vectors.bin")
        snap.close()
        assert not os.path.exists(tmp_path / name / "vectors.bin")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    twin.reopen()
    twin.check()
    assert twin.port.epoch == 1 and not twin.port.has(["d4"])[0]
    # a (generation, epoch) key of the retired epoch is gone with it
    _raises_same(twin, lambda c: c.snapshot((c.generation, 0)), KeyError)


def test_compact_into_cluster_order(tmp_path):
    """The order comes from the reference's IVF ``cluster_order`` and is
    given to both caches: the compacted layouts are identical."""
    twin = Twin(tmp_path)
    twin.fill(32)
    twin.both(lambda c: c.delete_records(["d3"]))
    snap = twin.ref.snapshot()
    order = cluster_order(
        lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
        snap.n_live, 4, seed=0, train_steps=8, train_batch=16)
    want_ids = snap.ids[order].copy()
    want = snap.get_rows(order).copy()
    snap.close()
    assert not np.array_equal(order, np.arange(len(order)))
    ref_stats, port_stats = twin.both(lambda c: c.compact(order=order))
    assert port_stats == ref_stats
    twin.check()
    _, ids, rows = _snapshot_view(twin.port)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(rows, want)
    msg = _raises_same(
        twin, lambda c: c.compact(order=np.zeros(c.n_live, np.int64)),
        ValueError)
    assert "permutation" in msg


def test_compact_into_port_cluster_order(tmp_path):
    """The port's own ``cluster_order`` (k-means on the CPU) gives the
    reference's permutation on the same snapshot, and both caches
    compacted into it hold identical layouts in that order."""
    twin = Twin(tmp_path)
    twin.fill(32)
    twin.both(lambda c: c.delete_records(["d3"]))
    snap = twin.port.snapshot()
    get = lambda lo, hi: snap.get_range(lo, hi).astype(np.float32)  # noqa
    kw = dict(seed=0, train_steps=8, train_batch=16)
    order = port_cluster_order(get, snap.n_live, 4, device="cpu", **kw)
    np.testing.assert_array_equal(order,
                                  cluster_order(get, snap.n_live, 4, **kw))
    want_ids = snap.ids[order].copy()
    want = snap.get_rows(order).copy()
    snap.close()
    assert not np.array_equal(order, np.arange(len(order)))
    ref_stats, port_stats = twin.both(lambda c: c.compact(order=order))
    assert port_stats == ref_stats
    twin.check()
    _, ids, rows = _snapshot_view(twin.port)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("case", ("length", "width", "nan", "inf",
                                  "overflow"))
def test_cache_records_validation_names_positions(tmp_path, case):
    twin = Twin(tmp_path)
    good = np.ones((3, DIM), np.float32)
    ids, vecs = ["a", "b", "c"], good.copy()
    if case == "length":
        ids = ["a", "b"]
    elif case == "width":
        vecs = np.ones((3, DIM + 1), np.float32)
    elif case == "nan":
        vecs[1, 2] = np.nan
    elif case == "inf":
        vecs[0, 0], vecs[2, 3] = np.inf, -np.inf
    else:
        vecs[2] = 1e30        # the float16 cast overflows
    msg = _raises_same(twin, lambda c: c.cache_records(ids, vecs),
                       ValueError)
    assert {"length": "length mismatch", "width": f"(n, {DIM})",
            "nan": "positions [1]", "inf": "positions [0, 2]",
            "overflow": "positions [2]"}[case] in msg
    assert len(twin.port) == 0 and twin.port.generation == 0
    twin.check()


def test_empty_cache_reads(tmp_path):
    import repro_torch
    assert repro_torch.EmbeddingCache is EmbeddingCache
    twin = Twin(tmp_path)
    twin.check()
    assert twin.port.row_plan(np.array([1, 2])) is None
    assert twin.port.get_rows(np.array([], np.int64)).shape == (0, DIM)
    assert "x" not in twin.port
    np.testing.assert_array_equal(twin.port.has(["x"]), [False])
    _raises_same(twin, lambda c: c.get(["x"]), KeyError)
    _raises_same(twin, lambda c: c.get_range(0, 1), IndexError)
    twin.fill(3)
    _raises_same(twin, lambda c: c.get_rows(np.array([-1, 1])), IndexError)
    snap = twin.port.snapshot()
    assert snap.get_range(1, 1).shape == (0, DIM)
    with pytest.raises(IndexError, match="live-space"):
        snap.get_rows(np.array([3]))
    with snap:
        pass
    assert snap._closed


# -- one on-disk format ------------------------------------------------------


def _mutate(cache):
    """Appends, a re-embed, deletes and a compaction, then more writes on
    top of the compacted epoch."""
    cache.cache_records([f"d{i}" for i in range(12)], _vecs(12, 0))
    cache.cache_records(["d5"], _vecs(1, 1))
    cache.delete_records(["d2", "d9"])
    cache.compact()
    cache.cache_records(["n0", "d2"], _vecs(2, 2))
    cache.delete_records(["d0"])


@pytest.mark.parametrize("writer", ("repro", "repro_torch"))
def test_cross_opening(tmp_path, writer):
    """A directory written by one package opens in the other with the
    same generation, epoch, live ids and rows, and takes writes."""
    path = str(tmp_path / "c")
    make_w, make_r = ((RefCache, EmbeddingCache) if writer == "repro"
                      else (EmbeddingCache, RefCache))
    _mutate(make_w(path, dim=DIM))
    written = make_w(path, dim=DIM)
    opened = make_r(path, dim=DIM)
    ref, port = ((written, opened) if writer == "repro"
                 else (opened, written))
    assert opened.epoch == 1
    assert_same_cache(ref, port)
    # the reader appends; the writer's package reopens and agrees
    opened.cache_records(["z"], _vecs(1, 3))
    opened.delete_records(["d1"])
    reread = make_w(path, dim=DIM)
    ref, port = ((reread, opened) if writer == "repro"
                 else (opened, reread))
    assert_same_cache(ref, port)


def test_legacy_ids_npy_migrates(tmp_path):
    """A pre-generation directory (``ids.npy``, a meta with no
    generation keys) opens to the same single generation in both."""
    vecs = _vecs(5, 0).astype(np.float16)
    hashes = np.array([stable_id_hash(f"d{i}") for i in range(5)],
                      np.int64)
    for name in ("ref", "port"):
        d = tmp_path / name
        d.mkdir()
        vecs.tofile(d / "vectors.bin")
        np.save(d / "ids.npy", hashes)
        (d / "meta.json").write_text(
            '{"dim": %d, "dtype": "float16", "n": 5}' % DIM)
    twin = Twin(tmp_path)
    twin.check()
    assert twin.port.generation_key == (1, 0)
    assert os.path.exists(tmp_path / "port" / "ids.bin")
    np.testing.assert_array_equal(twin.port.get([f"d{i}" for i in range(5)]),
                                  vecs)


# -- torn writes and compaction chaos (test_faults.py) -----------------------


def _inject(twin, kind, point, **kw):
    twin.ref.fault_injector = RefInjector(
        [RefFault(kind=kind, phase="cache", point=point, **kw)])
    twin.port.fault_injector = FaultInjector(
        [Fault(kind=kind, point=point, **kw)])


def _crash_both(twin, op):
    for cache, exc in ((twin.ref, RefCrash), (twin.port, InjectedCrash)):
        with pytest.raises(exc):
            op(cache)
    assert twin.port.fault_injector.fired == twin.ref.fault_injector.fired


def _files(root):
    return sorted(os.listdir(root))


@pytest.mark.parametrize("point", ("payload", "meta", "tombstone"))
def test_torn_write_reopens_to_committed_generation(tmp_path, point):
    """A crash inside an append (``payload``: between the vector and the
    id payload; ``meta``: both payloads written, meta never replaced) or
    a delete (``tombstone``): both packages reopen to the last committed
    generation, truncate the torn tail and append in alignment."""
    twin = Twin(tmp_path)
    ids, vecs = twin.fill(10)
    gen0 = twin.port.generation_key
    _inject(twin, "torn_write", point)
    if point == "tombstone":
        _crash_both(twin, lambda c: c.delete_records(["d1", "d4"]))
    else:
        _crash_both(twin, lambda c: c.cache_records(
            [f"x{i}" for i in range(4)], _vecs(4, 1)))
    assert twin.port.fault_injector.fired == [
        ("torn_write", None, None, f"cache:{point}")]
    assert {f: os.path.getsize(tmp_path / "port" / f)
            for f in _files(tmp_path / "port")} == {
        f: os.path.getsize(tmp_path / "ref" / f)
        for f in _files(tmp_path / "ref")}
    if point == "payload":        # vectors grew, the id index did not
        assert os.path.getsize(tmp_path / "port" / "vectors.bin") == \
            14 * DIM * 2
        assert os.path.getsize(tmp_path / "port" / "ids.bin") == 10 * 8
    twin.reopen()
    twin.check()
    assert twin.port.generation_key == gen0 and len(twin.port) == 10
    assert twin.port.n_live == 10
    np.testing.assert_allclose(twin.port.get(ids), vecs, atol=1e-2)
    ids2, vecs2 = twin.fill(3, seed=2, prefix="y")
    twin.both(lambda c: c.delete_records(["d1"]))
    twin.check()
    np.testing.assert_allclose(twin.port.get(ids2), vecs2, atol=1e-2)
    assert twin.port.n_live == 12


def _mutated(twin, layout):
    """Superseded rows and tombstones (real work for the compactor) and,
    for ``order``, a cluster-sorted permutation to compact into."""
    twin.fill(24)
    twin.both(lambda c: c.delete_records(["d3", "d10"]))
    twin.both(lambda c: c.cache_records(
        ["d5"], np.full((1, DIM), 2.0, np.float32)))
    if layout == "flat":
        return None
    snap = twin.ref.snapshot()
    order = cluster_order(
        lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
        snap.n_live, 4, train_steps=4, train_batch=8)
    snap.close()
    return order


def _live_sorted(cache):
    snap = cache.snapshot()
    order = np.argsort(snap.ids)
    out = snap.ids[order].copy(), snap.get_rows(order).copy()
    snap.close()
    return out


@pytest.mark.parametrize("layout", ("flat", "order"))
@pytest.mark.parametrize("point", ("compact_payload", "compact_meta",
                                   "compact_swap"))
def test_compaction_crash_reopens_to_one_generation(tmp_path, point,
                                                    layout):
    """A crash at each compaction point reopens to exactly the pre- or
    post-compaction generation, in both packages alike: one epoch's
    payload files on disk, no committed record lost, and a search over
    the reopened cache equal to the flat-scan oracle."""
    twin = Twin(tmp_path)
    order = _mutated(twin, layout)
    gen0 = twin.port.generation
    want_ids, want_vecs = _live_sorted(twin.port)
    _inject(twin, "torn_write", point)
    _crash_both(twin, lambda c: c.compact(order=order))
    twin.reopen()
    twin.check()
    want_epoch = 1 if point == "compact_swap" else 0
    assert twin.port.generation_key == (gen0, want_epoch)
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "ref")
    assert [f for f in names if f.startswith("vectors")] == [
        "vectors.bin" if want_epoch == 0 else "vectors.e1.bin"]
    got_ids, got_vecs = _live_sorted(twin.port)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_vecs, want_vecs)

    snap = twin.port.snapshot()
    docs = snap.get_range(0, snap.n_live).astype(np.float32)
    snap.close()
    q = np.random.default_rng(3).normal(size=(4, DIM)).astype(np.float32)
    k = 5
    want_vals, want_pos = RefDriver(score_impl="numpy", chunk_size=16).search(
        q, len(docs), lambda lo, hi: docs[lo:hi], k)
    outs = [ShardedSearchDriver(score_impl=score, heap_impl=heap,
                                chunk_size=8, device="cpu").search(
        q, len(docs), lambda lo, hi: docs[lo:hi], k)
        for score, heap in (("numpy", "python"), ("torch", "kernel"))]
    for vals, pos in outs:
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_allclose(vals, want_vals, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(vals, outs[0][0])


@pytest.mark.parametrize("point", ("compact_payload", "compact_meta",
                                   "compact_swap"))
def test_compaction_stall_keeps_pinned_readers_serving(tmp_path, point):
    """A stalled disk mid-compaction does not block a pinned reader of
    the port's cache: it streams bit-identical rows through the stall
    and after the old epoch is retired."""
    twin = Twin(tmp_path)
    _mutated(twin, "flat")
    cache = twin.port
    cache.fault_injector = FaultInjector(
        [Fault(kind="stall", point=point, stall_s=0.3)])
    snap = cache.snapshot()
    first = snap.get_range(0, snap.n_live).copy()
    reads = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            reads.append(snap.get_range(0, snap.n_live).copy())
            time.sleep(0.01)

    t = threading.Thread(target=reader)
    t.start()
    try:
        t0 = time.monotonic()
        stats = cache.compact()
        dt = time.monotonic() - t0
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert dt >= 0.29, dt
    assert stats["epoch"] == 1
    assert cache.fault_injector.fired == [
        ("stall", None, None, f"cache:{point}")]
    assert len(reads) >= 10
    for r in reads:
        np.testing.assert_array_equal(r, first)
    np.testing.assert_array_equal(snap.get_range(0, snap.n_live), first)
    snap.close()
    twin.ref.compact()
    twin.check()


def test_fault_injector_on_cache_matches_reference():
    """``on_cache`` fires each fault once (every time with ``repeat``),
    only at its point, and records what the reference's records."""
    for make, fault, crash, cache_kw in (
            (FaultInjector, Fault, InjectedCrash, {}),
            (RefInjector, RefFault, RefCrash, {"phase": "cache"})):
        inj = make([fault(kind="torn_write", point="meta", **cache_kw),
                    fault(kind="stall", point="tombstone", stall_s=0.01,
                          repeat=True, **cache_kw)])
        inj.on_cache("payload")
        with pytest.raises(crash, match="cache point 'meta'"):
            inj.on_cache("meta")
        inj.on_cache("meta")               # fires once
        t0 = time.monotonic()
        inj.on_cache("tombstone")
        inj.on_cache("tombstone")
        assert time.monotonic() - t0 >= 0.02
        assert inj.fired == [("torn_write", None, None, "cache:meta")] + [
            ("stall", None, None, "cache:tombstone")] * 2
    with pytest.raises(ValueError, match="torn-write point"):
        Fault(kind="torn_write", point="elsewhere")
    with pytest.raises(ValueError, match="fault kind"):
        Fault(kind="meteor")

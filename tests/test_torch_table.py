"""The port's mmap record tables, on their own and against the reference.

The cases of ``tests/test_table.py`` run on ``repro_torch.data.table``.
Then the two packages meet on disk: a table either one builds opens in
the other with the same rows, id hashes, lookups and ``meta.json``; the
fingerprints agree; and ``build_cached`` in one package reuses the
other's directory without a rebuild.  The layout is compared byte for
byte (``ids.npy``, ``sortidx.npy``, ``offsets.npy``, ``payload.bin``,
``meta.json``).
"""

import json
import os

import numpy as np
import pytest

from repro.data import table as ref_table
from repro_torch.data.table import (MMapTable, atomic_write_dir,
                                    config_fingerprint, file_fingerprint,
                                    stable_id_hash, stable_id_hash_array)

LAYOUT = ("ids.npy", "sortidx.npy", "offsets.npy", "payload.bin",
          "meta.json")


def test_hash_array_matches_scalar():
    """Vectorized hashing == per-element hashing for every id flavor,
    including Python ints beyond int64."""
    cases = [
        ["doc-a", "doc-b", ""],                       # strings
        [0, 7, -5, 2**62],                            # int64-range ints
        [2**63, 2**64 + 3, -2**63],                   # beyond-int64 ints
        np.asarray([1, 2, 3], np.uint64),             # unsigned ndarray
    ]
    for ids in cases:
        got = stable_id_hash_array(ids)
        want = [stable_id_hash(int(i) if isinstance(i, np.integer) else i)
                for i in ids]
        assert got.dtype == np.int64
        assert got.tolist() == want, ids
        assert got.tolist() == ref_table.stable_id_hash_array(ids).tolist()


def _records(n):
    return [{"_id": f"doc{i}", "text": f"text {i}"} for i in range(n)]


def test_build_and_lookup(tmp_path):
    t = MMapTable.build(_records(100), str(tmp_path / "t"))
    assert len(t) == 100
    assert t.get("doc42")["text"] == "text 42"
    assert t.get(stable_id_hash("doc7"))["_id"] == "doc7"
    assert "doc99" in t and "doc100" not in t
    with pytest.raises(KeyError):
        t.get("missing")


def test_vectorized_indices(tmp_path):
    t = MMapTable.build(_records(50), str(tmp_path / "t"))
    hashes = np.asarray([stable_id_hash(f"doc{i}") for i in (3, 30, 7)])
    idx = t.indices_of(hashes)
    assert [t.row(i)["_id"] for i in idx] == ["doc3", "doc30", "doc7"]
    with pytest.raises(KeyError, match="not in table"):
        t.indices_of(np.asarray([stable_id_hash("nope")]))


def test_duplicate_ids_rejected(tmp_path):
    with pytest.raises(ValueError, match="collision|duplicate"):
        MMapTable.build(_records(5) + [{"_id": "doc3", "text": "dup"}],
                        str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t")


def test_build_cached_reuses(tmp_path):
    calls = []

    def records():
        calls.append(1)
        return _records(10)

    t1 = MMapTable.build_cached(records, str(tmp_path), "fp123")
    t2 = MMapTable.build_cached(records, str(tmp_path), "fp123")
    assert len(calls) == 1              # second call hit the cache
    assert len(t1) == len(t2) == 10


def test_build_cached_rebuilds_a_torn_meta(tmp_path):
    """A meta.json that does not parse is dropped and the table rebuilt."""
    MMapTable.build_cached(lambda: _records(4), str(tmp_path), "fp")
    with open(tmp_path / "fp" / "meta.json", "w") as f:
        f.write("{torn")
    t = MMapTable.build_cached(lambda: _records(6), str(tmp_path), "fp")
    assert len(t) == 6


def test_atomic_write_failure_leaves_nothing(tmp_path):
    target = str(tmp_path / "out")
    with pytest.raises(RuntimeError):
        with atomic_write_dir(target) as tmp:
            with open(os.path.join(tmp, "partial"), "w") as f:
                f.write("x")
            raise RuntimeError("boom")
    assert not os.path.exists(target)
    assert os.listdir(tmp_path) == []


def test_fingerprint_changes_with_content(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("a")
    fp1 = file_fingerprint(str(p))
    os.utime(p, ns=(1, 2))
    fp2 = file_fingerprint(str(p))
    assert fp1 != fp2
    assert file_fingerprint(str(p), "cfgA") != file_fingerprint(str(p), "cfgB")


def test_memory_mapped_payload(tmp_path):
    # a large-ish table's payload should not be resident after open
    t = MMapTable.build(_records(5000), str(tmp_path / "t"))
    assert isinstance(t._payload, np.memmap)
    # row decode only touches its slice
    assert t.row(4999)["_id"] == "doc4999"
    assert [r["_id"] for r in t.iter_rows()][-2:] == ["doc4998", "doc4999"]
    t.advise_dontneed(0, 5000)          # a residency hint, rows stay
    assert t.row(17) == {"_id": "doc17", "text": "text 17"}


# -- across the two packages --------------------------------------------------


def _mixed_records(n):
    """Raw ids of both kinds, titles, non-ASCII text and an id-less row
    (which takes its position as its id)."""
    out = []
    for i in range(n):
        rec = {"_id": f"doc-{i}" if i % 3 else i * 7,
               "text": f"text {i} é ü {'x' * (i % 5)}"}
        if i % 4 == 0:
            rec["title"] = f"title {i}"
        out.append(rec)
    out.append({"text": "no id here"})
    return out


def _assert_same_table(a, b):
    assert len(a) == len(b)
    assert a.meta == b.meta
    np.testing.assert_array_equal(np.asarray(a.id_hashes),
                                  np.asarray(b.id_hashes))
    assert [a.row(i) for i in range(len(a))] == [
        b.row(i) for i in range(len(b))]
    hashes = np.asarray(a.id_hashes)[::-1].copy()
    np.testing.assert_array_equal(a.indices_of(hashes), b.indices_of(hashes))
    for i in (1, 3, len(a) - 2):
        raw = a.row(i)["_id"]
        assert a.index_of(raw) == b.index_of(raw)
        assert a.get(raw) == b.get(raw)
        assert raw in a and raw in b
    assert "missing" not in a and "missing" not in b


@pytest.mark.parametrize("built_by", ("reference", "port"))
def test_table_opens_in_the_other_package(tmp_path, built_by):
    """A table built by one package opens in the other: equal rows,
    id_hashes, indices_of and meta.json."""
    recs = _mixed_records(40)
    build, other = ((ref_table.MMapTable, MMapTable) if built_by ==
                    "reference" else (MMapTable, ref_table.MMapTable))
    built = build.build(recs, str(tmp_path / "t"), fingerprint="fp-x")
    opened = other(str(tmp_path / "t"))
    _assert_same_table(built, opened)
    with open(tmp_path / "t" / "meta.json") as f:
        assert json.load(f) == {"n": 41, "fingerprint": "fp-x"}


def test_layout_is_byte_identical(tmp_path):
    recs = _mixed_records(25)
    ref_table.MMapTable.build(recs, str(tmp_path / "ref"), "fp")
    MMapTable.build(recs, str(tmp_path / "port"), "fp")
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(LAYOUT)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(LAYOUT)
    for name in LAYOUT:
        with open(tmp_path / "ref" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / name, "rb") as f:
            assert f.read() == want, name


def test_fingerprints_agree_across_packages(tmp_path):
    p = tmp_path / "src.jsonl"
    p.write_text('{"_id": "a", "text": "t"}\n')
    for extra in ("", "cfgA", "0123456789abcdef"):
        assert file_fingerprint(str(p), extra) == \
            ref_table.file_fingerprint(str(p), extra)
    for obj in ((1.0, None, 3, "x"), {"k": [1, 2]}, "plain", 42):
        assert config_fingerprint(obj) == ref_table.config_fingerprint(obj)


@pytest.mark.parametrize("first", ("reference", "port"))
def test_build_cached_reuses_the_other_packages_dir(tmp_path, first):
    """build_cached in one package finds the other's directory by its
    fingerprint and does not call its records function again."""
    p = tmp_path / "corpus.jsonl"
    p.write_text("x")
    fp = file_fingerprint(str(p))
    calls = []

    def records():
        calls.append(1)
        return _mixed_records(12)

    a, b = ((ref_table.MMapTable, MMapTable) if first == "reference"
            else (MMapTable, ref_table.MMapTable))
    t1 = a.build_cached(records, str(tmp_path / "tables"), fp)
    t2 = b.build_cached(records, str(tmp_path / "tables"), fp)
    assert calls == [1]
    assert t1.path == t2.path == str(tmp_path / "tables" / fp)
    _assert_same_table(t1, t2)

"""The port's EmbeddingBag (K4's plain path and ``ops.embedding_bag``)
against the reference.

The reference's Pallas kernel does not run on the installed JAX (ROADMAP
fault 1), so the oracle is its plain reference
``repro.kernels.ref.embedding_bag_ref``, as ``tests/test_kernels.py``
uses it.  The same numpy inputs, made from a seed, go to both.  On
integer-valued tables and weights every sum is exact: **bitwise equal**.
On random normals the two sum the L slots in different orders:
rtol 1e-5 / atol 1e-6.  bfloat16 tables are compared in float32.
"""

import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.models import recsys as jrecsys
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import embedding_bag as bag
from repro_torch.models import recsys

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(rng, v, d, b, n_slots, ints):
    if ints:
        table = rng.integers(-3, 4, size=(v, d)).astype(np.float32)
        w = rng.integers(-2, 3, size=(b, n_slots)).astype(np.float32)
    else:
        table = rng.normal(size=(v, d)).astype(np.float32)
        w = rng.normal(size=(b, n_slots)).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, n_slots)).astype(np.int32)
    return table, idx, w


def _both(table, idx, w):
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx),
        None if w is None else jnp.asarray(w)))
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            None if w is None else torch.from_numpy(w))
    return got, want


# (V, D, B, L): the reference tests' shapes, then the recsys path's D and L
# (DeepFM's linear term D = 1 and FM sum D = 10 over 39 fields; L = 1)
SHAPES = [(20, 8, 5, 3), (100, 32, 16, 10), (64, 1, 7, 39), (64, 10, 9, 39),
          (64, 10, 13, 1), (300, 1, 33, 1)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,d,b,n_slots", SHAPES)
def test_matches_reference_on_integers_bitwise(v, d, b, n_slots, weighted):
    rng = np.random.default_rng(v * d + b * n_slots)
    table, idx, w = _inputs(rng, v, d, b, n_slots, ints=True)
    got, want = _both(table, idx, w if weighted else None)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,d,b,n_slots", SHAPES)
def test_matches_reference_on_floats(v, d, b, n_slots, weighted):
    rng = np.random.default_rng(1 + v * d + b * n_slots)
    table, idx, w = _inputs(rng, v, d, b, n_slots, ints=False)
    got, want = _both(table, idx, w if weighted else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["id_past_table", "inf_row0_padded",
                                  "inf_weight_padded", "nan_row_used"])
def test_non_finite_edges_follow_reference(case):
    """A padded slot reads row 0 and multiplies by 0; an id >= V reads a
    NaN row (``jnp.take``'s fill mode).  NaN lands where the reference's
    lands, and nowhere else."""
    rng = np.random.default_rng(4)
    table, idx, w = _inputs(rng, 12, 4, 6, 5, ints=True)
    idx[:, 0] = np.arange(1, 7)                  # rows 1..6, never row 0
    idx[:, 1:] = np.maximum(idx[:, 1:], 1)
    if case == "id_past_table":
        idx[2, 3] = 12
        idx[4, 1] = 10_000
    elif case == "inf_row0_padded":
        table[0] = np.inf
        idx[1, 2] = -1
    elif case == "inf_weight_padded":
        idx[3, 4] = -1
        w[3, 4] = np.inf
    else:
        table[5, 1] = np.nan
    got, want = _both(table, idx, w)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got.numpy(), want)   # NaN == NaN here


def test_all_padded_and_no_slots_give_zeros():
    rng = np.random.default_rng(5)
    table, idx, _ = _inputs(rng, 10, 3, 4, 6, ints=False)
    got, want = _both(table, np.full_like(idx, -1), None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy().any()
    got, want = _both(table, idx[:, :0], None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (4, 3) and not got.numpy().any()


def test_no_bags_returns_empty_without_a_launch():
    out = ops.embedding_bag(torch.zeros((5, 3)),
                            torch.zeros((0, 4), dtype=torch.int32))
    assert out.shape == (0, 3)


@pytest.mark.parametrize("ints", [True, False])
def test_bfloat16_table_compared_in_float32(ints):
    """The port sums a bf16 table in float32 and rounds once; the
    reference, given the same values in float32, must agree after that
    rounding (bitwise on integers, within one bf16 step on floats)."""
    rng = np.random.default_rng(6)
    table, idx, w = _inputs(rng, 50, 10, 20, 39, ints=ints)
    t16 = torch.from_numpy(table).bfloat16()
    got = ops.embedding_bag(t16, torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(t16.float().numpy()), jnp.asarray(idx), jnp.asarray(w)))
    want16 = torch.tensor(want).bfloat16().float().numpy()
    if ints:
        np.testing.assert_array_equal(got.float().numpy(), want16)
    else:
        # one bf16 rounding (2^-8 relative) of float32 sums that differ
        # in order by up to ~1e-5 on 39 products of normals
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-4)


def test_plain_version_sums_in_slot_order():
    """The plain version adds slot by slot in float32: (1e8 + 1) - 1e8
    is 0 in that order, which the kernel reproduces bitwise."""
    table = torch.tensor([[1e8], [1.0], [-1e8]])
    idx = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    assert ref.embedding_bag_ref(table, idx).item() == 0.0
    idx = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    assert ref.embedding_bag_ref(table, idx).item() == 1.0


def test_wrapper_validates_and_counts_nothing_on_cpu():
    bag.reset_launch_counts()
    table = torch.zeros((8, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    out = torch.empty((3, 4))
    bag.embedding_bag_(out, table, idx, torch.ones((3, 2)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bag.embedding_bag_(out, table.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        bag.embedding_bag_(out, table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        bag.embedding_bag_(out, torch.zeros((4, 8)).T, idx)
    with pytest.raises(ValueError, match="out"):
        bag.embedding_bag_(torch.empty((3, 5)), table, idx)
    with pytest.raises(ValueError, match="weights"):
        bag.embedding_bag_(out, table, idx, torch.ones((3, 3)))
    with pytest.raises(ValueError, match="no rows"):
        bag.embedding_bag_(out, torch.zeros((0, 4)), idx)
    assert bag.LAUNCHES == {"embedding_bag": 0, "embedding_bag_backward": 0}
    assert ops.launch_counts()["embedding_bag"] == 0


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_csr_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(8)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    idx = rng.integers(0, 30, 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 7, 40)).astype(np.int32)   # bag 7 empty
    want = np.asarray(jrecsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 8, mode))
    got = recsys.embedding_bag(torch.from_numpy(table),
                               torch.from_numpy(idx),
                               torch.from_numpy(bags), 8, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[7].any()


def test_build_starts_one_compiler_per_source_then_links(tmp_path,
                                                         monkeypatch):
    """The kernel library is built by one ``nvcc -c`` per ``csrc/*.cu``,
    all started together, then one link; the log keeps their output.  A
    stand-in compiler records its calls (no CUDA toolkit here)."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n'
        "echo 'ptxas info    : Used 32 registers'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    out = tmp_path / "build" / "lib.so"
    _build._compile(out)
    lines = calls.read_text().splitlines()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert {"embedding_bag.cu", "topk.cu"} <= set(sources)
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    assert sorted(ln.split()[-1].rsplit("/", 1)[-1] for ln in compiles) == \
        sources
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in compiles)
    assert lines[-1].startswith("-shared")
    assert out.read_text() == "built\n"
    assert out.with_suffix(".log").read_text().count("registers") == \
        len(sources) + 1

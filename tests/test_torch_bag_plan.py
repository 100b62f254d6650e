"""K4's tiles and slot passes (``repro_torch.kernels.embedding_bag``).

On the card K4 runs one block per tile of consecutive bags: the block
loads the tile's ids (and weights) once, in 16-byte groups from the
16-byte boundary at or below the tile's first id, into shared memory with
an odd row stride; then one thread per (bag, piece of a row) walks the
slots in passes, issuing every gather of a pass before adding them in
slot order.  The kernel runs only on the card (``chip_smoke.py`` holds it
against the plain version there, and against itself under forced plans);
here the wrapper's pure-Python plan is checked, and a plain-Python model
of the tiled design is held **bitwise** against the plain version
``embedding_bag_ref`` on integer and on float inputs, under several
plans, at the padding / id >= V / non-finite edges, in both table dtypes,
and against the reference's ``embedding_bag_ref`` (JAX) on integer
inputs.  Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ref

torch.set_num_threads(1)

SMS = 132                     # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448            # shared memory a block can use on sm_90
L_DEEPFM = 39


# -- (a) the plan -------------------------------------------------------------

def test_vector_bytes_follow_the_row_alignment():
    assert bag.vector_bytes(10, 4) == 8       # DeepFM's FM rows, 40 bytes
    assert bag.vector_bytes(10, 2) == 4       # 20-byte bfloat16 rows
    assert bag.vector_bytes(1, 4) == 4        # the linear / wide terms
    assert bag.vector_bytes(32, 4) == 16
    assert bag.vector_bytes(7, 2) == 2
    assert bag.vector_bytes(7, 4) == 4
    assert bag.vector_bytes(256, 2) == 16


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("n_slots", [0, 1, 39, 40, 200, 1000])
def test_bag_plan_covers_every_bag_and_fits(n_slots, elt):
    for b in (1, 37, 512, 262_144, 1_000_000):
        for dim in (1, 7, 10, 32, 256):
            _check_plan(b, n_slots, dim, elt)


def _check_plan(b, n_slots, dim, elt):
    bags, n_pass = bag.bag_plan(b, n_slots, dim, elt, SMS)
    tiles = -(-b // bags)
    cover = [(t * bags, min((t + 1) * bags, b)) for t in range(tiles)]
    assert cover[0][0] == 0 and cover[-1][1] == b
    assert all(lo < hi for lo, hi in cover)                # none empty
    assert all(cover[t][1] == cover[t + 1][0] for t in range(tiles - 1))
    # the tile's ids and weights fit in a block's shared memory, within
    # the plan's own budget where one bag does
    smem = bag.tile_smem(bags, n_slots, True)
    assert smem <= MAX_SMEM
    assert bags == 1 or smem <= bag.TILE_SMEM
    # a block's threads: one per piece, at most MAX_THREADS
    pieces = dim * elt // bag.vector_bytes(dim, elt)
    assert bags == 1 or bags * pieces <= bag.MAX_THREADS
    assert bags <= bag.TILE_BAGS
    assert 1 <= n_pass <= max(1, min(n_slots, bag.MAX_PASS))
    # every SM gets a tile where there are bags enough
    assert tiles >= min(b, SMS)


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("dim", [1, 10])
def test_bag_plan_at_serve_p99_reaches_every_sm(dim, elt):
    """A request of 512 bags of DeepFM's 39 fields spreads over the card,
    each bag in one pass of all its slots."""
    bags, n_pass = bag.bag_plan(512, L_DEEPFM, dim, elt, SMS)
    assert -(-512 // bags) >= SMS
    assert n_pass == L_DEEPFM


def test_bag_plan_at_the_path_shapes():
    # serve_bulk and retrieval_cand: small tiles, short passes
    assert bag.bag_plan(262_144, 39, 10, 4, SMS) == (24, 8)
    assert bag.bag_plan(1_000_000, 39, 10, 4, SMS) == (24, 8)
    assert bag.bag_plan(262_144, 39, 1, 4, SMS) == (24, 8)
    # serve_p99: every SM a tile, each bag in one pass
    assert bag.bag_plan(512, 39, 10, 4, SMS) == (3, 39)
    assert bag.bag_plan(512, 40, 1, 4, SMS) == (3, 40)      # Wide&Deep
    # wide rows: a tile's pieces within MAX_THREADS; long bags: its ids
    # within TILE_SMEM
    assert bag.bag_plan(100_000, 39, 256, 4, SMS) == (4, 8)
    assert bag.bag_plan(100_000, 1000, 10, 4, SMS) == (6, 8)
    assert bag.bag_plan(4, 1000, 256, 4, SMS) == (1, 40)


# -- (b) the tiled model ------------------------------------------------------

def _load_tile(flat, lead, start, n, n_slots, stride, bags, fill):
    """load_tile: the n values from element ``start`` of ``flat`` (whose
    storage begins ``lead`` 4-byte elements past a 16-byte boundary), in
    4-value groups from the boundary at or below, each bag at a row of
    ``stride`` values."""
    dst = torch.full((bags * stride,), fill, dtype=flat.dtype)
    if n == 0:
        return dst
    at = lead + start
    first = at % 4
    store = torch.cat([torch.zeros(lead, dtype=flat.dtype), flat,
                       torch.zeros(4, dtype=flat.dtype)])
    for g in range((first + n + 3) // 4):
        group = store[at - first + 4 * g: at - first + 4 * g + 4]
        for k in range(4):
            e = 4 * g + k - first
            if 0 <= e < n:
                dst[e if stride == n_slots else e + e // n_slots] = group[k]
    return dst


def _model(table, idx, weights, bags, n_pass, lead=0):
    """csrc/embedding_bag.cu in plain Python: tiles of ``bags`` bags, each
    tile's ids and weights staged as load_tile stages them, one thread per
    (bag, piece), slot passes of ``n_pass`` that gather first and then add
    in slot order, float32 throughout."""
    b, n_slots = idx.shape
    v, d = table.shape
    cols = bag.vector_bytes(d, table.element_size()) // table.element_size()
    pieces = d // cols
    stride = n_slots | 1
    out = torch.empty((b, d), dtype=table.dtype)
    nan = torch.full((cols,), float("nan"))
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    for b0 in range(0, b, bags):
        nb = min(bags, b - b0)
        ids = _load_tile(idx.flatten(), lead, b0 * n_slots, nb * n_slots,
                         n_slots, stride, bags, -7)
        ws = None if weights is None else _load_tile(
            weights.flatten(), lead, b0 * n_slots, nb * n_slots, n_slots,
            stride, bags, float("nan"))
        for i in range(nb * pieces):
            t, col = i // pieces, (i % pieces) * cols
            acc = torch.zeros(cols)
            for l0 in range(0, n_slots, n_pass):
                slots = range(l0, min(l0 + n_pass, n_slots))
                rows = {}
                for l in slots:                  # every gather of the pass
                    r = max(int(ids[t * stride + l]), 0)
                    if r < v:
                        rows[l] = table[r, col: col + cols].float()
                for l in slots:                  # then the sum, in order
                    rid = int(ids[t * stride + l])
                    x = rows.get(l, nan)
                    w = one if ws is None else ws[t * stride + l]
                    acc = acc + (x * w) * (one if rid >= 0 else zero)
            out[b0 + t, col: col + cols] = acc.to(table.dtype)
    return out


def _inputs(seed, v, d, b, n_slots, ints, pad=0.2):
    rng = np.random.default_rng(seed)
    if ints:
        table = rng.integers(-3, 4, size=(v, d)).astype(np.float32)
        w = rng.integers(-2, 3, size=(b, n_slots)).astype(np.float32)
    else:
        table = rng.normal(size=(v, d)).astype(np.float32)
        w = rng.normal(size=(b, n_slots)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, n_slots)).astype(np.int32)
    idx[rng.random((b, n_slots)) < pad] = -1
    return (torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(w))


def _bits_equal(got, want):
    """Bitwise, NaN payloads aside: the value bits where neither is NaN
    (so -0.0 != +0.0), NaN in the same places."""
    g, w = got.float(), want.float()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    keep = ~torch.isnan(w)
    assert torch.equal(g[keep].view(torch.int32), w[keep].view(torch.int32))


# (bags, pass): one bag a tile, an odd tile, a tile larger than B; a pass
# of one slot, an odd pass, the whole bag
PLANS = [(1, 1), (1, 7), (5, 7), (5, 40), (64, 3), (3, 11)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("bags,n_pass", PLANS)
def test_model_is_bitwise_the_plain_version(bags, n_pass, ints, weighted):
    """9 bags (not a multiple of an odd tile) of 39 slots (odd: the tile's
    spans start off the 16-byte boundary) into D = 10 rows (8-byte
    pieces)."""
    table, idx, w = _inputs(bags * 10 + n_pass, 50, 10, 9, L_DEEPFM, ints)
    w = w if weighted else None
    want = ref.embedding_bag_ref(table, idx, w)
    _bits_equal(_model(table, idx, w, bags, n_pass), want)


@pytest.mark.parametrize("lead", [1, 2, 3])
@pytest.mark.parametrize("dim,n_slots", [(7, 40), (32, 6), (1, 13)])
def test_model_off_the_16_byte_boundary(dim, n_slots, lead):
    """ids whose storage starts 4, 8 or 12 bytes past a 16-byte boundary
    (a view), an even L (padded smem stride), D = 7 (4-byte pieces) and
    D = 32 (16-byte pieces)."""
    table, idx, w = _inputs(lead * 100 + dim, 30, dim, 7, n_slots, False)
    want = ref.embedding_bag_ref(table, idx, w)
    _bits_equal(_model(table, idx, w, 3, 5, lead=lead), want)


@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dim", [10, 7])
def test_model_bfloat16_rows(dim, ints):
    """bf16 tables: D = 10 (20-byte rows, 4-byte pieces) and D = 7 (2-byte
    pieces), summed in float32 and rounded once."""
    table, idx, w = _inputs(dim, 40, dim, 11, L_DEEPFM, ints)
    t16 = table.bfloat16()
    want = ref.embedding_bag_ref(t16, idx, w)
    assert want.dtype == torch.bfloat16
    _bits_equal(_model(t16, idx, w, 4, 9), want)


@pytest.mark.parametrize("case", ["id_past_table", "inf_row0_padded",
                                  "inf_weight_padded", "nan_row_used",
                                  "all_padded", "no_slots"])
def test_model_edges(case):
    """An id >= V adds a NaN row and reads nothing; a padded slot gathers
    row 0 and multiplies by 0 (a non-finite row 0 or weight there gives
    NaN); every slot padded gives zeros; L = 0 gives zeros."""
    table, idx, w = _inputs(11, 12, 4, 6, 9, True, pad=0.0)
    idx = idx.clamp(min=1)                       # row 0 only as padding
    if case == "id_past_table":
        idx[2, 3] = 12
        idx[4, 1] = 1_000_000
    elif case == "inf_row0_padded":
        table[0] = float("inf")
        idx[1, 2] = -1
    elif case == "inf_weight_padded":
        idx[3, 4] = -1
        w[3, 4] = float("inf")
    elif case == "nan_row_used":
        table[5, 1] = float("nan")
        idx[0, 0] = 5
    elif case == "all_padded":
        idx[:] = -1
    else:
        idx, w = idx[:, :0], w[:, :0]
    want = ref.embedding_bag_ref(table, idx, w)
    got = _model(table, idx, w, 4, 4)
    _bits_equal(got, want)
    if case in ("all_padded", "no_slots"):
        assert not got.any()
    else:
        assert torch.isnan(want).any()


@pytest.mark.parametrize("bags,n_pass", [(1, 39), (4, 8), (16, 1)])
def test_model_matches_the_reference_on_integers(bags, n_pass):
    """The model against the reference's ``embedding_bag_ref`` (JAX, which
    sums the slots with ``jnp.sum``): integer values make every order
    exact, so bitwise."""
    table, idx, w = _inputs(3, 64, 10, 20, L_DEEPFM, True)
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()),
        jnp.asarray(w.numpy())))
    got = _model(table, idx, w, bags, n_pass)
    np.testing.assert_array_equal(got.numpy(), want)

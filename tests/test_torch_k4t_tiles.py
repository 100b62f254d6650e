"""K4T's row tiles (``repro_torch.kernels.embedding_bag``).

On the card K4T runs persistent blocks, each a contiguous run of the
(V, D) gradient's rows, the runs cut by work (a row's bytes against
``backward_entry_work(D)`` an entry) by one search over the sorted keys
that also finds each block's first entry.  A block stages a tile of rows
as float32 sums in shared memory from +0.0, takes its entries in batches
that span tiles — every gather of a batch before any add, then one thread
per (run of equal keys, column) adding in entry order — and writes the
tile out once: single elements before the first and after the last
16-byte boundary, 16-byte pieces between, the staged sums shifted so that
each piece is an aligned run of them.  The kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version there, with its
output NaN before each launch, and against itself under forced plans);
here the wrapper's pure-Python plan is checked, and a plain-Python model
of the walk is held **bitwise** against the plain version
``embedding_bag_backward_ref`` on integer and on float inputs, under
several plans, at the padding / id >= V / non-finite edges, on hot rows
at tile and batch boundaries, in both dtypes, and against the reference's
VJP (JAX) on integer inputs.  Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ref

torch.set_num_threads(1)

SMS = 132                     # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448            # shared memory a block can use on sm_90
V_DEEPFM = 34_312_192         # DeepFM's and Wide&Deep's summed vocabularies
V_WIDE = 34_377_728


# -- (a) the plan -------------------------------------------------------------

@pytest.mark.parametrize("dim,elt,rows", [
    (10, 4, 408), (10, 2, 816), (1, 4, 4096), (1, 2, 8192),
    (7, 4, 584), (7, 2, 1168), (32, 4, 128), (32, 2, 256)])
def test_tile_rows_fill_the_tile_in_whole_16_byte_pieces(dim, elt, rows):
    """16 KB of output a tile at most, in a whole number of 16-byte pieces,
    so every tile of a block starts at its first tile's alignment."""
    assert bag.backward_tile_rows(V_DEEPFM, dim, elt) == rows
    assert rows * dim * elt <= bag.BACKWARD_TILE_BYTES
    assert rows * dim * elt % 16 == 0
    # one piece more would pass the tile
    quantum = 16 // np.gcd(dim * elt, 16)
    assert (rows + quantum) * dim * elt > bag.BACKWARD_TILE_BYTES


def test_tile_rows_at_most_v_and_at_least_a_piece():
    assert bag.backward_tile_rows(1, 10, 4) == 1
    assert bag.backward_tile_rows(5, 10, 4) == 5
    assert bag.backward_tile_rows(1000, 10, 4) == 408
    # a row wider than the tile: the fewest rows of whole pieces
    assert bag.backward_tile_rows(10, 5000, 4, tile_bytes=1024) == 1
    assert bag.backward_tile_rows(10, 5001, 4, tile_bytes=1024) == 4


def test_smem_mirrors_the_kernel_layout():
    # DeepFM's D = 10 float32 tile of 204 rows, 128 threads: the sums
    # (2044 floats), 128 x 10 products, keys, 129 run starts, 32 warp
    # counts, each rounded up to 16 bytes
    assert bag.backward_smem(204, 128, 10) == 8176 + 5120 + 512 + 528 + 128
    assert bag.backward_smem(408, 256, 10) == (
        16336 + 10240 + 1024 + 1040 + 128)
    assert bag.backward_batch(256, 10) == 256
    assert bag.backward_batch(256, 32) == 80
    assert bag.backward_batch(32, 1) == 32
    assert bag.backward_batch(1024, 1024) == 2


def test_entry_work_grows_with_the_row():
    assert bag.backward_entry_work(1) == 170
    assert bag.backward_entry_work(10) == 260
    assert all(bag.backward_entry_work(d) < bag.backward_entry_work(d + 1)
               for d in range(1, 64))


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("name,v,dim", [
    ("DeepFM FM sum", V_DEEPFM, 10), ("DeepFM linear", V_DEEPFM, 1),
    ("Wide&Deep wide", V_WIDE, 1), ("D=7", V_DEEPFM, 7),
    ("D=32", V_DEEPFM, 32)])
def test_plan_at_the_training_shapes(name, v, dim, elt):
    """The wrapper's plan at train_batch's tables: as many persistent
    blocks as fit on every SM at once (threads, 64 registers a thread,
    shared memory), twice that for the wide rows, each with a run of rows
    of many tiles."""
    rows, threads, grid = bag.backward_plan(v, dim, elt, SMS)
    assert rows == bag.backward_tile_rows(v, dim, elt)
    assert threads == bag.BACKWARD_THREADS >= dim
    smem = bag.backward_smem(rows, threads, dim)
    per_sm = min(bag.SM_THREADS // threads,
                 bag.SM_REGS // (bag.BACKWARD_REGS * threads),
                 bag.SM_SMEM // (smem + 1024))
    assert per_sm == 4
    # a second wave where a block would write a MiB or more
    waves = 2 if v * dim * elt >= SMS * per_sm * bag.BACKWARD_WAVE_BYTES else 1
    assert grid == SMS * per_sm * waves
    assert waves == (2 if dim * elt >= 16 else 1)
    assert -(-v // rows) >= 7 * grid        # every block walks many tiles


def test_plan_at_deepfm_pinned():
    assert bag.backward_plan(V_DEEPFM, 10, 4, SMS) == (408, 256, 1056)
    assert bag.backward_plan(V_DEEPFM, 1, 4, SMS) == (4096, 256, 528)
    assert bag.backward_plan(V_WIDE, 1, 4, SMS) == (4096, 256, 528)
    assert bag.backward_plan(V_DEEPFM, 10, 2, SMS) == (816, 256, 1056)
    # a row wider than the block: a thread a column
    assert bag.backward_plan(1000, 300, 4, SMS)[1] == 320


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("threads", [32, 96, 256, 1024])
def test_plan_fits_and_covers(threads, elt):
    for v in (1, 5, 409, 4099, 100_000, V_DEEPFM, 3 * 2 ** 31):
        for dim in (1, 7, 10, 32, 256):
            for tile_bytes in (64, 1000, 16384, 32768):
                rows, t, grid = bag.backward_plan(
                    v, dim, elt, SMS, tile_bytes=tile_bytes, threads=threads)
                assert t == max(threads, 32 * -(-dim // 32)) >= dim
                assert 1 <= rows <= v
                assert rows == v or rows * dim * elt % 16 == 0
                tiles = -(-v // rows)
                assert 1 <= grid <= min(tiles, SMS * 64)
                assert bag.backward_smem(rows, t, dim) <= MAX_SMEM
                assert rows * dim <= MAX_SMEM // 4   # the C entry's cap


# -- (b) the tiled model ------------------------------------------------------

def _first_not_below(lo, hi, below, threads):
    """The kernel's ``first_not_below``: the first index in [lo, hi) where
    ``below`` is false, every thread probing one index a round."""
    while lo < hi:
        step = -(-(hi - lo) // threads)
        c = sum(1 for t in range(threads)
                if lo + t * step < hi and below(lo + t * step))
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    return lo


def _rows_end(keys, n_rows, threads):
    """The kernel's ``rows_end``: where the entries whose key is not a row
    (padding, ids >= V) start."""
    return _first_not_below(0, keys.numel(),
                            lambda p: int(keys[p]) < n_rows, threads)


def _split_row(keys, n_rows, row_w, entry_w, blk, grid, threads):
    """The kernel's ``split_row``: where block ``blk`` starts, balancing a
    row's bytes (``row_w``) against its entries (``entry_w`` each), and
    its first entry, over the entries with a row's key."""
    n = _rows_end(keys, n_rows, threads)
    if blk <= 0:
        return 0, 0
    if blk >= grid:
        return n_rows, n
    total = n_rows * row_w + n * entry_w
    target = blk * (total // grid) + blk * (total % grid) // grid

    def tau(i):
        return 0 if i <= 0 else min(int(keys[i - 1]) + 1, n_rows)

    i = _first_not_below(
        0, n, lambda k: tau(k + 1) * row_w + (k + 1) * entry_w < target,
        threads)
    lo, hi = tau(i), tau(i + 1) if i < n else n_rows
    need = target - i * entry_w
    r = min(max(0 if need <= 0 else -(-need // row_w), lo), hi)
    if r < hi:
        return r, i
    return r, _first_not_below(i, n, lambda p: int(keys[p]) < r, threads)


def _model(grad, idx, weights, n_rows, tile_rows, threads, grid, lead=0,
           entry_w=None):
    """csrc/embedding_bag_backward.cu in plain Python: the first pass's
    NaN columns, then ``grid`` blocks of ``threads``, each walking its run
    of tiles of ``tile_rows`` rows (the runs balanced by work), its
    entries staged a batch at a time across tile edges, float32
    throughout, row 0 starting at NaN in the flagged columns; ``out``
    starts ``lead`` bytes past a 16-byte boundary.  Checks as it goes that the runs of tiles cover the
    table once, that each batch's and each tile's entries are a prefix,
    that the 16-byte pieces are aligned in the output and in the staged
    sums, that the staged sums are +0.0 again after every tile, and that
    every element is written and every entry below V taken exactly
    once."""
    b, n_slots = idx.shape
    d, elt = grad.shape[1], grad.element_size()
    keys, order = bag.backward_keys(idx)
    n = keys.numel()
    batch = bag.backward_batch(threads, d)
    out = torch.full((n_rows * d,), float("nan"), dtype=grad.dtype)
    writes = torch.zeros(n_rows * d, dtype=torch.int64)
    g32, flat_idx = grad.float(), idx.reshape(-1)
    w = None if weights is None else weights.reshape(-1)
    # pad_pass: the columns where a padded slot's (g * 0) * w is NaN
    padded = (flat_idx < 0).nonzero().flatten()
    x = g32[padded // n_slots] * 0.0
    if w is not None:
        x = x * w[padded][:, None]
    nan_cols = torch.isnan(x).any(0)
    assert (keys[:_rows_end(keys, n_rows, threads)] < n_rows).all()
    entry_w = entry_w or bag.backward_entry_work(d)
    firsts = [_split_row(keys, n_rows, d * elt, entry_w, k, grid, threads)
              for k in range(grid + 1)]
    splits = [r for r, _ in firsts]
    assert splits[0] == 0 and splits[-1] == n_rows
    assert all(x <= y for x, y in zip(splits, splits[1:]))
    taken = 0
    for blk in range(grid):
        row_begin, row_end = splits[blk], splits[blk + 1]
        if row_begin >= row_end:
            continue
        acc = torch.zeros(tile_rows * d + 4)
        j = firsts[blk][1]
        assert j == int(torch.searchsorted(keys, row_begin))
        st = {"keys": [], "vals": None, "q0": 0, "j": j}

        def load():
            ks = keys[st["j"]:st["j"] + batch]
            take = ks < row_end
            cnt = int(take.sum())
            assert take[:cnt].all()
            pos = order[st["j"]:st["j"] + cnt].long()
            # every gather of the batch before any add
            x = g32[pos // n_slots]
            if w is not None:
                x = x * w[pos][:, None]
            # padding on a row only when V > INT_MAX: it adds +0.0
            pad = (ks[:cnt] == bag.PAD_KEY) & (flat_idx[pos] < 0)
            x = torch.where(pad[:, None], 0.0, x)
            st.update(keys=ks[:cnt].tolist(), vals=x, q0=0,
                      j=st["j"] + cnt)

        load()
        for r0 in range(row_begin, row_end, tile_rows):
            nrow = min(tile_rows, row_end - r0)
            r1 = r0 + nrow
            mis = (lead + r0 * d * elt) % 16
            off = (mis // elt) & 3
            if r0 == 0:
                acc[off:off + d] = torch.where(nan_cols, float("nan"),
                                               acc[off:off + d])
            while st["q0"] < len(st["keys"]) or len(st["keys"]) == batch:
                if st["q0"] == len(st["keys"]):
                    load()
                    if not st["keys"]:
                        break
                ks, q0 = st["keys"], st["q0"]
                q1 = sum(1 for k in ks if k < r1)
                assert all(r0 <= k for k in ks[q0:q1])
                heads = [q for q in range(q0, q1)
                         if q == q0 or ks[q] != ks[q - 1]]
                for s, a in enumerate(heads):
                    z = heads[s + 1] if s + 1 < len(heads) else q1
                    at = off + (ks[a] - r0) * d
                    run = acc[at:at + d].clone()
                    for k in range(a, z):        # in entry order
                        run = run + st["vals"][k]
                    acc[at:at + d] = run
                taken += q1 - q0
                st["q0"] = q1
                if q1 < len(ks):
                    break
            # the write-out: single elements, 16-byte pieces, single elements
            vec, nel = 16 // elt, nrow * d
            head = min(nel, ((16 - mis) & 15) // elt)
            body = (nel - head) // vec
            for k in range(body):
                e0 = head + k * vec
                assert (lead + (r0 * d + e0) * elt) % 16 == 0
                assert 4 * (off + e0) % 16 == 0
            out[r0 * d:r0 * d + nel] = acc[off:off + nel].to(grad.dtype)
            writes[r0 * d:r0 * d + nel] += 1
            acc[off:off + nel] = 0.0
            assert not acc.any()
    assert (writes == 1).all()
    assert taken == int((keys < n_rows).sum())
    return out.reshape(n_rows, d)


def _inputs(seed, v, d, b, n_slots, ints, pad=0.2, past=0.0):
    rng = np.random.default_rng(seed)
    if ints:
        g = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
        w = rng.integers(-2, 3, size=(b, n_slots)).astype(np.float32)
    else:
        g = rng.normal(size=(b, d)).astype(np.float32)
        w = rng.normal(size=(b, n_slots)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, n_slots)).astype(np.int32)
    idx[rng.random((b, n_slots)) < pad] = -1
    idx[rng.random((b, n_slots)) < past] = v + 3
    return torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(w)


def _bits_equal(got, want):
    """Bitwise, NaN payloads aside: the value bits where neither is NaN
    (so -0.0 != +0.0), NaN in the same places."""
    g, w = got.float(), want.float()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    keep = ~torch.isnan(w)
    assert torch.equal(g[keep].view(torch.int32), w[keep].view(torch.int32))


# (tile rows, threads, grid): one-row tiles walked by one block, an odd
# tile, a tile larger than V, more blocks than rows, 32-entry batches
PLANS = [(1, 32, 1), (2, 32, 3), (7, 128, 2), (16, 96, 5), (204, 128, 7),
         (50, 1024, 100)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("tile_rows,threads,grid", PLANS)
def test_model_is_bitwise_the_plain_version(tile_rows, threads, grid, ints,
                                            weighted):
    """40 bags of DeepFM's 39 slots over 200 rows at D = 10: padding, a few
    ids >= V, runs of several equal ids."""
    g, idx, w = _inputs(tile_rows * 10 + threads + grid, 200, 10, 40, 39,
                        ints, past=0.02)
    w = w if weighted else None
    want = ref.embedding_bag_backward_ref(g, idx, 200, w)
    _bits_equal(_model(g, idx, w, 200, tile_rows, threads, grid), want)


@pytest.mark.parametrize("lead", [4, 8, 12])
@pytest.mark.parametrize("dim,tile_rows", [(10, 6), (7, 5), (32, 3),
                                           (1, 13)])
def test_model_off_the_16_byte_boundary(dim, tile_rows, lead):
    """An out whose storage starts 4, 8 or 12 bytes past a 16-byte
    boundary (a view), tiles whose bytes are not whole pieces (so each
    tile starts at its own alignment): single elements at both ends, the
    staged sums shifted under the pieces."""
    g, idx, w = _inputs(lead * 100 + dim, 60, dim, 11, 9, False)
    want = ref.embedding_bag_backward_ref(g, idx, 60, w)
    _bits_equal(_model(g, idx, w, 60, tile_rows, 64, 4, lead=lead), want)


@pytest.mark.parametrize("lead", [2, 6, 10, 14, 20])
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dim", [10, 7])
def test_model_bfloat16_rows(dim, ints, lead):
    """bf16 gradients: D = 10 (20-byte rows) and D = 7 (14-byte rows),
    summed in float32 and rounded once; ``lead`` 20 is the out 20 bytes
    into its storage that chip_smoke.py drives."""
    g, idx, w = _inputs(dim + lead, 90, dim, 23, 39, ints)
    g16 = g.bfloat16()
    want = ref.embedding_bag_backward_ref(g16, idx, 90, w)
    assert want.dtype == torch.bfloat16
    _bits_equal(_model(g16, idx, w, 90, 16, 96, 3, lead=lead), want)


@pytest.mark.parametrize("case", ["id_past_table", "inf_grad_padded",
                                  "inf_weight_padded", "nan_grad_used",
                                  "all_padded", "no_slots", "no_bags"])
def test_model_edges(case):
    """An id >= V adds nothing; a padded slot adds (g * 0) * w to row 0 (a
    non-finite gradient or weight there gives NaN); every slot padded
    gives zeros; L = 0 and B = 0 give zeros, every row still written."""
    g, idx, w = _inputs(12, 12, 4, 6, 9, True, pad=0.0)
    idx = idx.clamp(min=1)                       # row 0 only as padding
    if case == "id_past_table":
        idx[2, 3] = 12
        idx[4, 1] = 1_000_000
        g[4] = float("nan")               # its bag's rows NaN, not row 0
    elif case == "inf_grad_padded":
        idx[1, 2] = -1
        g[1, 0] = float("inf")
    elif case == "inf_weight_padded":
        idx[3, 4] = -1
        w[3, 4] = float("inf")
    elif case == "nan_grad_used":
        g[5, 1] = float("nan")
    elif case == "all_padded":
        idx[:] = -1
    elif case == "no_slots":
        idx, w = idx[:, :0], w[:, :0]
    else:
        g, idx, w = g[:0], idx[:0], w[:0]
    want = ref.embedding_bag_backward_ref(g, idx, 12, w)
    got = _model(g, idx, w, 12, 5, 32, 2)
    _bits_equal(got, want)
    if case in ("all_padded", "no_slots", "no_bags"):
        assert not got.any()
    else:
        assert torch.isnan(want).any()


@pytest.mark.parametrize("length", [31, 32, 33, 100])
@pytest.mark.parametrize("hot", ["first_of_tile", "last_of_tile", "row_0"])
def test_model_hot_row_across_batches_and_tile_edges(hot, length):
    """A run of ``length`` equal ids (crossing 32-entry batches from 33 on)
    on the first or last row of a tile, or on row 0 beside padding, next
    to ordinary ids: its sum carries from batch to batch in entry order.
    Values of mixed magnitude make the order show."""
    rng = np.random.default_rng(length)
    tile_rows, v = 8, 40
    row = {"first_of_tile": 16, "last_of_tile": 15, "row_0": 0}[hot]
    idx = rng.integers(1, v, size=(length + 20,)).astype(np.int32)
    idx[:length] = row
    idx = torch.from_numpy(rng.permutation(idx).reshape(-1, 1))
    if hot == "row_0":
        idx[::7] = -1
    g = torch.from_numpy((rng.normal(size=(idx.shape[0], 3))
                          * 10.0 ** rng.integers(-4, 5, size=(
                              idx.shape[0], 1))).astype(np.float32))
    want = ref.embedding_bag_backward_ref(g, idx, v, None)
    for threads, grid in ((32, 1), (32, 5), (128, 2)):
        _bits_equal(_model(g, idx, None, v, tile_rows, threads, grid), want)


@pytest.mark.parametrize("v", [1, 5])
def test_model_v_below_one_tile(v):
    g, idx, w = _inputs(v, v, 10, 30, 39, False)
    want = ref.embedding_bag_backward_ref(g, idx, v, w)
    for tile_rows, threads, grid in ((v, 128, 1), (2, 32, 3), (204, 96, 1)):
        rows = min(tile_rows, v)
        _bits_equal(_model(g, idx, w, v, rows, threads, grid), want)


def test_model_ids_only_in_the_first_and_last_rows():
    """Every tile between the two ends is zeros from the write-out alone."""
    rng = np.random.default_rng(5)
    v = 1000
    idx = np.where(rng.random((50, 39)) < 0.5, 0, v - 1).astype(np.int32)
    idx[rng.random((50, 39)) < 0.1] = -1
    g = torch.from_numpy(rng.normal(size=(50, 10)).astype(np.float32))
    idx = torch.from_numpy(idx)
    want = ref.embedding_bag_backward_ref(g, idx, v, None)
    got = _model(g, idx, None, v, 24, 96, 7)
    _bits_equal(got, want)
    assert not got[1:-1].any() and got[0].any() and got[-1].any()


@pytest.mark.parametrize("threads", [32, 96, 256])
def test_search_finds_every_tile_start(threads):
    rng = np.random.default_rng(threads)
    keys = torch.from_numpy(np.sort(rng.integers(0, 5000, 3000))
                            .astype(np.int32))
    for target in list(range(0, 5200, 37)) + [0, 4999, 5000, 10 ** 9]:
        assert _first_not_below(0, 3000, lambda p: int(keys[p]) < target,
                                threads) == int(torch.searchsorted(keys,
                                                                   target))
    assert _first_not_below(0, 0, lambda p: True, threads) == 0


@pytest.mark.parametrize("entry_w", [1, 512, 100_000])
@pytest.mark.parametrize("grid", [1, 7, 64, 1000])
def test_split_balances_rows_and_entries(grid, entry_w):
    """The blocks' runs of rows cover the table once, in order, and each
    holds about its share of the work: a dense stretch (most entries on
    few rows) is shared out over many blocks, never splitting a row."""
    rng = np.random.default_rng(grid)
    v, row_w = 100_000, 40
    # 90 % of the entries on the last 1 % of the rows
    dense = rng.integers(v - 1000, v, 27_000)
    sparse = rng.integers(0, v, 3_000)
    keys = torch.from_numpy(np.sort(np.concatenate([dense, sparse]))
                            .astype(np.int32))
    firsts = [_split_row(keys, v, row_w, entry_w, k, grid, 256)
              for k in range(grid + 1)]
    splits = [r for r, _ in firsts]
    assert [j for _, j in firsts] == torch.searchsorted(
        keys, torch.tensor(splits)).tolist()
    assert splits[0] == 0 and splits[-1] == v
    assert all(x <= y for x, y in zip(splits, splits[1:]))
    starts = torch.searchsorted(keys, torch.tensor(splits))
    work = [(splits[k + 1] - splits[k]) * row_w
            + int(starts[k + 1] - starts[k]) * entry_w
            for k in range(grid)]
    share = (v * row_w + keys.numel() * entry_w) / grid
    # a block's run ends within one row's work of its share
    per_row = int(keys.bincount().max()) * entry_w + row_w
    assert max(work) <= share + per_row


@pytest.mark.parametrize("tile_rows,threads,grid", [(1, 32, 3), (16, 96, 4),
                                                    (204, 128, 1)])
def test_model_matches_the_reference_vjp_on_integers(tile_rows, threads,
                                                     grid):
    """The model against ``jax.vjp`` of the reference's
    ``embedding_bag_ref`` (JAX) with respect to the table: integer values
    make every order exact, so bitwise (up to the sign of a zero)."""
    g, idx, w = _inputs(tile_rows + threads, 64, 10, 20, 39, True,
                        past=0.02)
    table = jnp.zeros((64, 10), jnp.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(
        t, jnp.asarray(idx.numpy()), jnp.asarray(w.numpy())), table)
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    got = _model(g, idx, w, 64, tile_rows, threads, grid)
    np.testing.assert_array_equal(got.numpy(), want)

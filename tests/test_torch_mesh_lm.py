"""The LM cells on a mesh against the reference's meshed cells, on the CPU.

One module fixture starts one gloo world of four port ranks (each
``python tests/_mesh_lm_ranks.py port DIR RANK``, joined through
``init_method="file://DIR/rdzv"``) and two reference processes on four
forced host devices each, one a mesh ((data 2, model 2) and (data 1,
model 4)), over the same seeded inputs, with every wait bounded.  The
reduced configs run in float32.  Each test reads the fixture's results:

  * the decode cells (``decode_32k`` B 4 x S 64, ``long_500k`` B 1 x S
    128) of qwen2-0.5b, gemma-7b, granite-moe-3b-a800m and
    llama4-maverick on both meshes, whose caches reach the four layouts
    of ``cache_logical_axes`` (batch + KV heads, batch + sequence,
    sequence + KV heads, sequence alone): three steps from ``len = S -
    4`` and from 5, every rank's logits within TOL of the reference's and
    of the port's one-process cell, each rank's cache block within 1e-6
    (relative to the block's scale) of the reference's addressable shard
    and of the one-process cache's slice, two runs bitwise, the
    collective calls and bytes of a step those the layout implies, the
    cell's ``smoke_inputs`` a zeroed block, a full cache refused;
  * ``prefill_32k`` of qwen2-0.5b and granite on (2, 2);
  * one ``train_4k`` AdamW step of granite and llama4 on (2, 2) (the MoE
    aux over the split batch): loss, grad norm, aux, every leaf and
    moment against the reference's meshed step;
  * one ``RetrievalTrainer`` step of a granite encoder with
    ``aux_loss_weight`` 0.01 on (2, 2) against the reference's;
  * every LM cell built and stepped on (2, 2), and, in this process,
    every LM cell's specs on shape-only meshes equal to the reference's.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import repro.configs.base as ref_base
from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.models import convert, transformer
from repro_torch.sharding import make_mesh
from repro_torch.sharding.partitioning import local_shape, spec_axes
from repro_torch.training.tree import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _mesh_lm_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 240
# float32 in other summation orders (logits ~0.1-1)
TOL = 1e-5
# a cache block, relative to its largest entry
CACHE_RTOL = 1e-6
# a gradient entry is clear of zero (AdamW's first step is lr * g / (|g| +
# eps), a step function of g near 0) when |its first moment| exceeds this
CLEAR = 1e-5
DECODE_CASES = [(m, n, s) for m in ranks.MESHES for n in ranks.DECODE_ARCHS
                for s in ranks.SERVE_SHAPES]
DECODE_IDS = [f"{ranks.mesh_id(m)}-{n}-{s}" for m, n, s in DECODE_CASES]


def _params(cfg, rng) -> dict:
    def leaf(path, s):
        name = path[-1].key
        if name.startswith(("ln", "final_ln")) and not name.endswith("_b"):
            return np.ones(s.shape, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, ref_tf.abstract_params(cfg))


def _toks(rng, b, s, vocab, pad=True) -> dict:
    mask = np.ones((b, s), np.int32)
    if pad:
        mask[1, s // 2:] = 0
    return {"tokens": rng.integers(3, vocab, (b, s)).astype(np.int32),
            "mask": mask}


def _inputs(rng: np.random.Generator) -> dict:
    names = sorted(set(ranks.DECODE_ARCHS + ranks.ENCODE_ARCHS
                       + ranks.MOE_ARCHS))
    cfgs = {n: ref_get_arch(n).reduced().cfg for n in names}
    inp = {"params": {n: _params(cfgs[n], rng) for n in names},
           "decode": {}, "encode": {}, "train": {}}
    for name in ranks.DECODE_ARCHS:
        arch, cfg = ref_get_arch(name).reduced(), cfgs[name]
        for shape in ranks.SERVE_SHAPES:
            b, s = (arch.shapes[shape]["global_batch"],
                    arch.shapes[shape]["seq_len"])
            kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
            inp["decode"][(name, shape)] = {
                "k": rng.standard_normal(kv).astype(np.float32),
                "v": rng.standard_normal(kv).astype(np.float32),
                "tokens": rng.integers(3, cfg.vocab_size, (
                    2, ranks.STEPS, b)).astype(np.int32)}
    for name in ranks.ENCODE_ARCHS:
        inp["encode"][name] = _toks(rng, 2, 64, cfgs[name].vocab_size)
    for name in ranks.MOE_ARCHS:
        v = cfgs[name].vocab_size
        inp["train"][name] = {"query": _toks(rng, 4, 32, v),
                              "passage": _toks(rng, 4, 32, v)}
    v = cfgs[ranks.RETRIEVER_ARCH].vocab_size
    inp["retriever"] = {"query": _toks(rng, 8, 16, v),
                        "passage": _toks(rng, 8, 16, v)}
    return inp


def _wait_all(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            return
        time.sleep(0.1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_lm")
    inputs = _inputs(np.random.default_rng(0))
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    script = os.path.join(REPO, "tests", "_mesh_lm_ranks.py")
    base = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1")
    base.pop("CUDA_VISIBLE_DEVICES", None)
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [([sys.executable, script, "port", str(work), str(r)], base,
             f"port-{r}") for r in range(4)]
    cmds += [([sys.executable, script, "reference", str(work),
               ranks.mesh_id(m)], ref_env, f"reference-{ranks.mesh_id(m)}")
             for m in ranks.MESHES]
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for cmd, env, name in cmds:
            logs.append(work / f"{name}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                              stdout=log,
                                              stderr=subprocess.STDOUT))
        _wait_all(procs, JOIN_S)
        waited = time.monotonic() - t0
        bad = [f"{cmds[i][2]} " + (
            f"still running after {waited:.1f} s (limit {JOIN_S} s), killed"
            if p.returncode is None else f"exited {p.returncode}") +
            ":\n" + logs[i].read_text()[-3000:]
            for i, p in enumerate(procs) if p.returncode != 0]
        assert not bad, "\n".join(bad)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    port = []
    for r in range(4):
        with open(work / f"port-{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    ref = {"decode": {}}
    for m in ranks.MESHES:
        with open(work / f"reference-{ranks.mesh_id(m)}.pkl", "rb") as f:
            got = pickle.load(f)
        ref["decode"].update(got.pop("decode"))
        ref.update(got)
    return {"inputs": inputs, "port": port, "ref": ref}


def _coords(rank: int, mesh_shape) -> tuple:
    return (rank // mesh_shape[1], rank % mesh_shape[1])


def _block_of(full: np.ndarray, spec, coords, mesh_shape) -> np.ndarray:
    """The piece of ``full`` the rank at ``coords`` holds under ``spec``
    (a dimension split over two axes is the first one major)."""
    sizes = dict(zip(ranks.AXES, mesh_shape))
    at = dict(zip(ranks.AXES, coords))
    index = []
    for dim, d in enumerate(full.shape):
        n, i = 1, 0
        for a in spec_axes(spec[dim] if dim < len(spec) else None):
            i, n = i * sizes[a] + at[a], n * sizes[a]
        index.append(slice(i * (d // n), (i + 1) * (d // n)))
    return full[tuple(index)]


def _one_process(runs, name, shape, start_i) -> dict:
    """The port's one-process serve cell over the same cache and tokens."""
    arch = get_arch(name).reduced()
    case = runs["inputs"]["decode"][(name, shape)]
    params = convert.params_from_jax(runs["inputs"]["params"][name],
                                     arch.cfg, "cpu")
    start = ranks.starts(arch.shapes[shape]["seq_len"])[start_i]
    cache = {"k": torch.from_numpy(case["k"].copy()),
             "v": torch.from_numpy(case["v"].copy()),
             "len": torch.tensor(start, dtype=torch.int32)}
    cell = arch.build_cell(shape, "cpu")
    logits = []
    for step in range(ranks.STEPS):
        y, cache = cell.fn(params, cache,
                           torch.from_numpy(case["tokens"][start_i][step]))
        logits.append(y.numpy())
    return {"logits": logits, "k": cache["k"].numpy(),
            "v": cache["v"].numpy()}


# -- the decode ----------------------------------------------------------------


def test_the_two_meshes_reach_the_four_cache_layouts(runs):
    """qwen2-0.5b's 2 KV heads divide "model" on (2, 2), not on (1, 4);
    every port spec is the reference's."""
    specs = {}
    for key, got in runs["port"][0]["decode"].items():
        assert got["spec"] == runs["ref"]["decode"][key]["spec"], key
        specs[key] = got["spec"]
    qwen = {(m, s): specs[(m, "qwen2-0.5b", s)] for m in ("2x2", "1x4")
            for s in ranks.SERVE_SHAPES}
    assert qwen == {
        ("2x2", "decode_32k"): (None, "data", None, "model", None),
        ("2x2", "long_500k"): (None, None, "data", "model", None),
        ("1x4", "decode_32k"): (None, None, "model", None, None),
        ("1x4", "long_500k"): (None, None, ("data", "model"), None, None)}


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_meshed_decode_matches_the_reference_and_one_process(runs, case):
    mesh_shape, name, shape = case
    key = (ranks.mesh_id(mesh_shape), name, shape)
    want = runs["ref"]["decode"][key]
    spec = want["spec"]
    arch = get_arch(name).reduced()
    for i, start in enumerate(ranks.starts(arch.shapes[shape]["seq_len"])):
        solo = _one_process(runs, name, shape, i)
        for r, out in enumerate(runs["port"]):
            got = out["decode"][key][start]
            coords = _coords(r, mesh_shape)
            assert got["len"] == want[start]["len"] == start + ranks.STEPS
            for step, y in enumerate(got["logits"]):
                at = f"{key} start {start} rank {r} step {step}"
                assert y.shape == (arch.shapes[shape]["global_batch"],
                                   arch.cfg.vocab_size), at
                np.testing.assert_allclose(y, want[start]["logits"][step],
                                           atol=TOL, rtol=0, err_msg=at)
                np.testing.assert_allclose(y, solo["logits"][step],
                                           atol=TOL, rtol=0, err_msg=at)
            for n in ("k", "v"):
                shard = want[start][n][coords]
                assert got[n].shape == shard.shape
                scale = CACHE_RTOL * np.abs(shard).max()
                np.testing.assert_allclose(got[n], shard, atol=scale,
                                           rtol=0, err_msg=f"{key} {n}")
                np.testing.assert_allclose(
                    got[n], _block_of(solo[n], spec, coords, mesh_shape),
                    atol=scale, rtol=0, err_msg=f"{key} {n} one process")


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_meshed_decode_is_bitwise_run_to_run_and_alike_on_every_rank(
        runs, case):
    mesh_shape, name, shape = case
    key = (ranks.mesh_id(mesh_shape), name, shape)
    arch = get_arch(name).reduced()
    for start in ranks.starts(arch.shapes[shape]["seq_len"]):
        first = runs["port"][0]["decode"][key][start]["logits"]
        for out in runs["port"]:
            got = out["decode"][key][start]
            assert got["bitwise"], (key, start)
            for a, b in zip(got["logits"], first):
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))


def predicted_decode_counts(arch, shape, spec, mesh_shape) -> dict:
    """Calls and bytes out of one rank in one float32 step: every sharded
    parameter gathered a dimension at a time; per layer the softmax's
    (max, sum) gather and the partials' all-reduce where the sequence is
    split, and the heads' gather where they are; the logits' gather where
    the rows are split."""
    cfg = arch.cfg
    mesh = make_mesh(mesh_shape, ranks.AXES)
    calls = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}
    wire = dict(calls)

    def count(op, numel, n):
        calls[op] += 1
        wire[op] += numel * 4 * (n - 1)

    shapes = dict(flatten(transformer.param_shapes(cfg)))
    layout = arch.build_cell(shape, "cpu", mesh).layout
    for path, pspec in flatten(layout.param_specs):
        numel = int(np.prod(local_shape(shapes[path], pspec, mesh)))
        for entry in pspec:
            n = mesh.axis_size(spec_axes(entry))
            if n > 1:
                count("all_gather", numel, n)
                numel *= n
    n_rows, n_seq, n_heads = (mesh.axis_size(spec_axes(e))
                              for e in spec[1:4])
    b = arch.shapes[shape]["global_batch"] // n_rows
    heads = cfg.n_heads // n_heads
    for _ in range(cfg.n_layers):
        if n_seq > 1:
            count("all_gather", 2 * b * heads, n_seq)
            count("all_reduce", b * heads * cfg.head_dim, n_seq)
        if n_heads > 1:
            count("all_gather", b * heads * cfg.head_dim, n_heads)
    if n_rows > 1:
        count("all_gather", b * cfg.vocab_size, n_rows)
    return {"wire_bytes": wire, "calls": calls}


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_meshed_decode_moves_what_its_layout_implies(runs, case):
    mesh_shape, name, shape = case
    key = (ranks.mesh_id(mesh_shape), name, shape)
    arch = get_arch(name).reduced()
    spec = runs["port"][0]["decode"][key]["spec"]
    want = predicted_decode_counts(arch, shape, spec, mesh_shape)
    for out in runs["port"]:
        for start in ranks.starts(arch.shapes[shape]["seq_len"]):
            for counts in out["decode"][key][start]["counts"]:
                assert counts == want, (key, start)


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_meshed_serve_cell_inputs_and_a_full_cache(runs, case):
    """``cell.smoke_inputs`` gives this rank's zeroed block with ``len = S
    - 1`` and ``smoke_inputs``' tokens; a full cache raises on every
    rank, as on one card."""
    mesh_shape, name, shape = case
    key = (ranks.mesh_id(mesh_shape), name, shape)
    arch = get_arch(name).reduced()
    cfg, spec = arch.cfg, runs["port"][0]["decode"][key]["spec"]
    b, s = arch.shapes[shape]["global_batch"], arch.shapes[shape]["seq_len"]
    full = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    mesh = make_mesh(mesh_shape, ranks.AXES)
    for out in runs["port"]:
        got = out["decode"][key]
        assert got["smoke"] == {"k": local_shape(full, spec, mesh),
                                "zeros": True, "len": s - 1,
                                "tokens": True}
        assert got["full_raises"] == f"cache len {s} outside [0, {s})"


# -- the encode cell -------------------------------------------------------------


@pytest.mark.parametrize("name", ranks.ENCODE_ARCHS)
def test_meshed_encode_matches_the_reference_and_one_process(runs, name):
    arch = get_arch(name).reduced()
    batch = runs["inputs"]["encode"][name]
    params = convert.params_from_jax(runs["inputs"]["params"][name],
                                     arch.cfg, "cpu")
    solo = arch.build_cell("prefill_32k", "cpu").fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    want = runs["ref"]["encode"][name]
    for out in runs["port"]:
        got = out["encode"][name]
        assert got.shape == (2, arch.cfg.d_model)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, solo, atol=TOL, rtol=0)


# -- the MoE aux over a split batch ---------------------------------------------


def _check_state(got: dict, want: dict, lr: float, name: str) -> None:
    """Moments within TOL of their leaf's scale; parameters within TOL
    where the gradient is clear of zero (AdamW's first step moves each
    entry by lr x the sign of its gradient there), else within 2 lr; at
    least a third of the entries are clear (the experts no token chose
    have no gradient)."""
    assert set(got) == set(want), name
    n_clear = n = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (name, path)
        if path.startswith("opt/"):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=TOL * max(1.0, float(np.abs(w).max())),
                err_msg=f"{name} {path}")
            continue
        mu = got["opt/mu/" + path[len("params/"):]]
        clear = np.abs(mu) > CLEAR
        n_clear, n = n_clear + clear.sum(), n + clear.size
        np.testing.assert_allclose(g[clear], w[clear], rtol=0, atol=TOL,
                                   err_msg=f"{name} {path}")
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr + TOL,
                                   err_msg=f"{name} {path}")
    assert n_clear > n / 3, name


@pytest.mark.parametrize("name", ranks.MOE_ARCHS)
def test_moe_train_4k_step_on_a_mesh_matches_the_references(runs, name):
    want = runs["ref"]["train"][name]
    got = runs["port"][0]["train"][name]
    for out in runs["port"][1:]:
        other = out["train"][name]
        assert (other["loss"], other["grad_norm"], other["aux"]) == (
            got["loss"], got["grad_norm"], got["aux"])
    assert got["loss"] == pytest.approx(want["loss"], rel=TOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=TOL)
    _check_state(got["state"], want["state"], 1e-3, name)


@pytest.mark.parametrize("name", ranks.MOE_ARCHS)
def test_moe_aux_over_a_split_batch_is_the_whole_batchs(runs, name):
    """Every rank's aux is the reference's meshed aux and the one-process
    aux of the whole passage batch, not its own rows' (which differs)."""
    arch = get_arch(name).reduced()
    params = convert.params_from_jax(runs["inputs"]["params"][name],
                                     arch.cfg, "cpu")
    batch = runs["inputs"]["train"][name]["passage"]
    tokens, mask = (torch.from_numpy(batch[k]) for k in ("tokens", "mask"))
    whole = float(transformer.forward_hidden(arch.cfg, params, tokens,
                                             mask)[1])
    own = float(transformer.forward_hidden(arch.cfg, params, tokens[:2],
                                           mask[:2])[1])
    assert abs(own - whole) > 1e-3
    for out in runs["port"]:
        got = out["train"][name]["aux"]
        assert got == pytest.approx(runs["ref"]["train"][name]["aux"],
                                    rel=TOL)
        assert got == pytest.approx(whole, rel=TOL)


@pytest.mark.parametrize("name", ranks.MOE_ARCHS)
def test_moe_aux_gradient_over_a_split_batch_is_the_whole_batchs(runs,
                                                                  name):
    """The data-axis mean of the ranks' aux gradients (each rank's
    statistics' cotangent handed back unchanged) is the reference's
    gradient of the whole batch's aux, every leaf within TOL of its
    scale; the aux moves the router and what feeds it."""
    want = runs["ref"]["train"][name]["aux_grads"]
    for out in runs["port"]:
        got = out["train"][name]["aux_grads"]
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(
                got[path], w, rtol=0,
                atol=TOL * max(1e-3, float(np.abs(w).max())),
                err_msg=f"{name} {path}")
        assert np.abs(got["moe_blocks/router"]).max() > 1e-4


def test_moe_aux_statistics_keep_the_one_process_bits():
    """Without a mesh (or with one whose data axes do not split the
    batch) ``forward_hidden`` sums each layer's aux as before; with one,
    the layers hand out their statistics, whose product is the same aux
    here (one rank holds the whole batch)."""
    arch = get_arch("granite-moe-3b-a800m").reduced()
    params = transformer.init_params(arch.cfg,
                                     torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(3, 512, (2, 16), generator=torch.Generator(
        ).manual_seed(4))
    mask = torch.ones_like(tokens)
    h, aux = transformer.forward_hidden(arch.cfg, params, tokens, mask)
    h1, aux1 = transformer.forward_hidden(arch.cfg, params, tokens, mask,
                                          make_mesh((1, 4), ranks.AXES))
    assert torch.equal(h, h1) and torch.equal(aux, aux1)
    lp = transformer._unstack(params["moe_blocks"])[0]
    x = torch.randn(2, 16, arch.cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    y, a = transformer._moe_ffn(arch.cfg, lp, x)
    y2, stats = transformer._moe_ffn(arch.cfg, lp, x, local_stats=True)
    assert torch.equal(y, y2) and stats.shape == (2, arch.cfg.n_experts)
    assert torch.equal(transformer._switch_aux(arch.cfg, stats), a)


def test_retriever_step_with_an_moe_aux_on_a_mesh(runs):
    want = runs["ref"]["retriever"]
    got = runs["port"][0]["retriever"]
    for out in runs["port"][1:]:
        assert out["retriever"]["metrics"] == got["metrics"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert got["metrics"]["moe_aux_loss"] > 0
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=TOL, abs=TOL), k
    _check_state(got["state"], want["state"], 1e-2, "retriever")


# -- every LM cell ------------------------------------------------------------


@pytest.mark.parametrize("name,shape", [
    (n, s) for n in ranks.LM_ARCHS for s in get_arch(n).shape_names()])
def test_every_lm_cell_builds_and_steps_on_a_bound_mesh(runs, name, shape):
    arch = get_arch(name).reduced()
    spec = arch.shapes[shape]
    want = {"train": (2,), "encode": (spec["global_batch"],
                                      arch.cfg.d_model),
            "serve": (spec["global_batch"], arch.cfg.vocab_size)}
    for out in runs["port"]:
        got = out["cells"][(name, shape)]
        assert got["kind"] == spec["kind"]
        assert got["shape"] == want[got["kind"]] and got["finite"]
        if got["gap"] is not None:
            assert got["gap"] <= TOL


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's cell constructors hand back bare specs."""
    monkeypatch.setattr(ref_base, "NamedSharding", lambda mesh, spec: spec)
    real = ref_base._sds
    monkeypatch.setattr(ref_base, "_sds", lambda shape, dtype, sharding=None:
                        real(shape, dtype) if sharding is None else sharding)


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _flat(tree) -> dict:
    return {p: tuple(s) for p, s in flatten(tree)}


def _ref_flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): tuple(s) for path, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


@pytest.mark.parametrize("mesh_def", [((16, 16), ("data", "model")),
                                      ((2, 16, 16), ("pod", "data", "model")),
                                      ((2, 2), ("data", "model")),
                                      ((1, 4), ("data", "model"))],
                         ids=["16x16", "2x16x16", "2x2", "1x4"])
@pytest.mark.parametrize("name", ranks.LM_ARCHS)
def test_shape_only_mesh_lays_out_every_lm_cell_as_the_reference(
        name, mesh_def, spec_only):
    """``build_cell(shape, "cpu", mesh)`` on a shape-only mesh (costing):
    each cell's parameter specs, and a serve cell's cache specs, are the
    reference's; stepping needs the mesh bound."""
    shape_def, axes = mesh_def
    fake, mesh = FakeMesh(shape_def, axes), make_mesh(shape_def, axes)
    arch, ref_arch = get_arch(name), ref_get_arch(name)
    for shape in arch.shape_names():
        args = ref_arch.build_cell(shape, mesh=fake).abstract_args
        lay = arch.build_cell(shape, "cpu", mesh).layout
        assert lay.mesh is mesh
        want_params = (args[0]["params"] if shape == "train_4k"
                       else args[0])
        assert _flat(lay.param_specs) == _ref_flat(want_params), shape
        if arch.shapes[shape]["kind"] == "serve":
            assert _flat(lay.cache_specs) == _ref_flat(args[1]), shape
            assert tuple(args[2]) == tuple(
                lay.rules.spec_for(("batch",), (arch.shapes[shape][
                    "global_batch"],), mesh))

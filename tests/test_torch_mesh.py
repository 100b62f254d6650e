"""The port's rank meshes against the reference's device meshes, on the CPU.

One module fixture starts one gloo world of four port ranks (each
``python tests/_mesh_ranks.py port DIR RANK``, joined through
``init_method="file://DIR/rdzv"``: no port is opened, so parallel test
workers do not collide) and one reference process on four forced host
devices (``--xla_force_host_platform_device_count=4``), all on one
(data 2, model 2) mesh over the same seeded inputs, with every wait
bounded.  Each test reads the fixture's results:

  * the collectives (orders, reductions, bytes, bf16 bits);
  * the psum lookup, bitwise against the reference's ``_lookup_psum``,
    and its table gradient;
  * ``compressed_psum`` none / bf16 / int8 against the reference's under
    ``shard_map``;
  * a tiny LM's ``RetrievalTrainer`` step (AdamW, Adafactor, and
    ``dp_mode="shard_map"`` with int8) against the reference's meshed
    step and the port's one-process step;
  * the reduced DeepFM ``train_batch`` (psum and xla_gather lookups) and
    ``serve_bulk`` cells from ``build_cell(shape, mesh)``;
  * elastic restore of a (2, 2) checkpoint onto (4, 1) and onto one
    process, bitwise.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch
from repro_torch.configs.base import init_train_state
from repro_torch.core.config import RetrievalTrainingArguments
from repro_torch.models import convert, transformer
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.trainer import RetrievalTrainer
from repro_torch.training.tree import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _mesh_ranks as ranks  # noqa: E402

pytestmark = pytest.mark.distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 240
# float32 steps in another summation order
TOL = 1e-5
# a gradient entry is clear of zero (AdamW's first step is lr * g / (|g| +
# eps), a step function of g near 0) when |g| exceeds this
CLEAR = 1e-4


def _inputs(rng: np.random.Generator) -> dict:
    cfg = ref_tf.LMConfig(**ranks.tiny_fields(), dtype=jnp.float32)

    def leaf(path, s):
        name = path[-1].key
        if name.startswith(("ln", "final_ln")) and not name.endswith("_b"):
            return np.ones(s.shape, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf,
                                              ref_tf.abstract_params(cfg))

    def toks(b, s):
        mask = np.ones((b, s), np.int32)
        mask[1, 12:] = 0
        mask[5, 9:] = 0
        return {"tokens": rng.integers(3, 512, (b, s)).astype(np.int32),
                "mask": mask}

    lm = {"params": params,
          "batch": {"query": toks(8, 16), "passage": toks(8, 16)}}
    lookup = {"table": rng.standard_normal((64, 3)).astype(np.float32),
              "idx": rng.integers(0, 64, (8, 5)).astype(np.int32),
              "w": rng.standard_normal((8, 5, 3)).astype(np.float32)}

    def tree():
        return {"a": rng.standard_normal((5, 3)).astype(np.float32),
                "b": rng.standard_normal((7,)).astype(np.float32)}

    compress = {"grads": [tree() for _ in range(4)],
                "ef": [tree() for _ in range(4)]}
    arch = ref_get_arch("deepfm").reduced()
    deepfm = {"params": {k: (0.1 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in arch.abstract_params().items()}}
    for shape in ("train_batch", "serve_bulk"):
        deepfm[shape] = {k: np.asarray(v) for k, v in
                         arch.smoke_inputs(shape, rng).items()}
    return {"lm": lm, "lookup": lookup, "compress": compress,
            "deepfm": deepfm}


def _wait_all(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            return
        time.sleep(0.1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    inputs = _inputs(np.random.default_rng(0))
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    script = os.path.join(REPO, "tests", "_mesh_ranks.py")
    base = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1")
    base.pop("CUDA_VISIBLE_DEVICES", None)
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [([sys.executable, script, "port", str(work), str(r)], base,
             f"port-{r}") for r in range(4)]
    cmds.append(([sys.executable, script, "reference", str(work)], ref_env,
                 "reference"))
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
    with open(work / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"work": work, "inputs": inputs, "port": port, "ref": ref}


# -- the mesh and the collectives ----------------------------------------------


def test_ranks_sit_row_major_and_groups_follow_the_axes(runs):
    for r, out in enumerate(runs["port"]):
        assert out["coords"] == {"data": r // 2, "model": r % 2}
        d, m = r // 2, r % 2
        assert out["members"] == {"data": [m, 2 + m],
                                  "model": [2 * d, 2 * d + 1],
                                  "both": [0, 1, 2, 3]}


def test_collectives_reduce_and_gather_in_shard_order(runs):
    x = [np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * r
         for r in range(4)]
    for r, out in enumerate(runs["port"]):
        got = out["collectives"]
        d, m = r // 2, r % 2
        np.testing.assert_array_equal(got["all_reduce data"],
                                      x[m] + x[2 + m])
        np.testing.assert_array_equal(got["all_reduce model mean"],
                                      (x[2 * d] + x[2 * d + 1]) / 2)
        np.testing.assert_array_equal(got["all_reduce both"],
                                      ((x[0] + x[1]) + x[2]) + x[3])
        np.testing.assert_array_equal(got["all_gather data 0"],
                                      np.concatenate([x[m], x[2 + m]]))
        np.testing.assert_array_equal(got["all_gather both 1"],
                                      np.concatenate(x, axis=1))
        # ("model", "data"): model major
        np.testing.assert_array_equal(
            got["all_gather model-data 0"],
            np.concatenate([x[0], x[2], x[1], x[3]]))
        full = x[2 * d] + x[2 * d + 1]
        np.testing.assert_array_equal(got["reduce_scatter model 1"],
                                      full[:, 2 * m:2 * m + 2])
        bits = [torch.from_numpy(x[i] / 7).to(torch.bfloat16).view(
            torch.int16).numpy() for i in (m, 2 + m)]
        np.testing.assert_array_equal(got["bf16 bits"],
                                      np.concatenate(bits))
        # a 48-byte piece to each of 3 others
        assert out["wire"] == {
            "wire_bytes": {"all_reduce": 0, "all_gather": 144,
                           "reduce_scatter": 0},
            "calls": {"all_reduce": 0, "all_gather": 1,
                      "reduce_scatter": 0}}


@pytest.mark.parametrize("model", ("lm", "deepfm"))
def test_local_slices_equal_the_references_addressable_shards(runs, model):
    """Weights carried across (``models.convert``) and laid out by the
    port's rules: each rank's slice of every parameter is, bitwise, the
    reference's addressable shard on the device at the same mesh
    coordinates (the tiny LM's trainer state, DeepFM's psum cell)."""
    want = runs["ref"][f"{model}_shards"]
    for r, out in enumerate(runs["port"]):
        got = out[f"{model}_slices"]
        assert set(got) == set(want)
        for path, local in got.items():
            shard = want[path][(r // 2, r % 2)]
            assert local.shape == shard.shape, path
            np.testing.assert_array_equal(local, shard, err_msg=path)


# -- the psum lookup -------------------------------------------------------------


def test_psum_lookup_is_bitwise_the_references(runs):
    want = runs["ref"]["lookup"]
    inp = runs["inputs"]["lookup"]
    bf16 = torch.from_numpy(inp["table"][inp["idx"]]).to(
        torch.bfloat16).float().numpy()
    for out in runs["port"]:
        got = out["lookup"]
        assert got["rows"].dtype == np.float32
        np.testing.assert_array_equal(got["rows"].view(np.uint32),
                                      want["rows"].view(np.uint32))
        # each row rounded to bf16 once, otherwise exact
        np.testing.assert_array_equal(got["rows"], bf16)
        # the cotangent rounded to bf16, summed per row (K4T's plain
        # version against the reference's scatter-add)
        np.testing.assert_allclose(got["grad"], want["grad"], rtol=1e-6,
                                   atol=1e-6)


# -- compressed_psum ---------------------------------------------------------------


@pytest.mark.parametrize("axes", ranks.COMPRESSION_AXES,
                         ids=lambda a: "-".join(a))
@pytest.mark.parametrize("method", ranks.COMPRESSION)
def test_compressed_psum_matches_the_references(runs, axes, method):
    ref = runs["ref"]["compress"][(axes, method)]
    for r, out in enumerate(runs["port"]):
        got = out["compress"][(axes, method)]
        for leaf in ("a", "b"):
            want = ref["grads"][leaf][r]
            assert got["grads"][leaf].dtype == np.float32
            if method == "bf16":
                # one bf16 rounding of the float32 sum on both sides
                np.testing.assert_array_equal(got["grads"][leaf], want)
            else:
                np.testing.assert_allclose(got["grads"][leaf], want,
                                           rtol=1e-6, atol=1e-6)
            if method == "int8":
                np.testing.assert_allclose(got["ef"][leaf],
                                           ref["ef"][leaf][r], rtol=1e-6,
                                           atol=1e-6)


# -- the meshed trainer step -----------------------------------------------------------


def _port_cfg():
    return transformer.LMConfig(**ranks.tiny_fields(), dtype=torch.float32)


def _one_process(runs, case, tmp_path) -> dict:
    optimizer, _, compression = case
    cfg = _port_cfg()
    trainer = RetrievalTrainer(
        BiEncoderRetriever(DefaultEncoder(cfg), "infonce"),
        ranks.train_args(str(tmp_path), optimizer, compression,
                         RetrievalTrainingArguments), device="cpu")
    lm = runs["inputs"]["lm"]
    state = trainer.init_state(convert.params_from_jax(lm["params"], cfg,
                                                       "cpu"))
    state, metrics = trainer._step(state, lm["batch"])
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {p: t.numpy() for p, t in flatten(state["params"])}}


def _check_step(got: dict, want: dict, name: str, mu=None) -> None:
    """Params within TOL where the gradient is clear of zero (AdamW's
    first moment is 0.1 g; the key bias's gradient is 0 but for rounding,
    the softmax being blind to it); everywhere for Adafactor.  Most
    entries are clear."""
    n_clear = n = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (name, path)
        clear = np.ones(w.shape, bool) if mu is None else (
            np.abs(mu[path]) > 0.1 * CLEAR)
        n_clear, n = n_clear + clear.sum(), n + clear.size
        np.testing.assert_allclose(g[clear], w[clear], rtol=0, atol=TOL,
                                   err_msg=f"{name} {path}")
    assert n_clear > 0.5 * n, name


@pytest.mark.parametrize("case", ranks.TRAINER_CASES,
                         ids=lambda c: "-".join(c))
def test_meshed_trainer_step_matches_the_reference_and_one_process(
        runs, case, tmp_path):
    got = runs["port"][0]["trainer"][case]
    want = runs["ref"]["trainer"][case]
    # every rank stepped the same loss and norm
    for out in runs["port"][1:]:
        other = out["trainer"][case]
        assert (other["loss"], other["grad_norm"]) == (got["loss"],
                                                       got["grad_norm"])
    assert got["loss"] == pytest.approx(want["loss"], rel=TOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=TOL)
    state, ref_state = got["state"], want["state"]
    assert set(state) == set(ref_state)
    params = {p[len("params/"):]: v for p, v in state.items()
              if p.startswith("params/")}
    ref_params = {p: ref_state["params/" + p] for p in params}
    mu = ({p: state["opt/mu/" + p] for p in params}
          if case[0] == "adamw" else None)
    if case[2] == "int8":
        # int8 rounding flips where g sits on a quantum's edge: the
        # residuals differ there by one quantum, and the update with them
        for p in params:
            off = np.abs(state["ef/" + p] - ref_state["ef/" + p]) > TOL
            assert off.mean() < 0.01, p
            mu[p] = np.where(off, 0, mu[p])
    else:
        for p, v in state.items():
            if p.startswith("opt/"):
                np.testing.assert_allclose(
                    v, ref_state[p], rtol=0,
                    atol=TOL * max(1.0, float(np.abs(v).max())), err_msg=p)
    _check_step(params, ref_params, "reference", mu)
    if case[2] == "int8":
        return
    solo = _one_process(runs, case, tmp_path)
    assert got["loss"] == pytest.approx(solo["loss"], rel=TOL)
    assert got["grad_norm"] == pytest.approx(solo["grad_norm"], rel=TOL)
    _check_step(params, solo["params"], "one process", mu)


def _local_shape(shape, spec) -> tuple:
    sizes = {"data": 2, "model": 2}
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            d //= sizes[a]
        out.append(d)
    return tuple(out)


@pytest.mark.parametrize("case", ranks.TRAINER_CASES,
                         ids=lambda c: "-".join(c))
def test_trainer_state_is_laid_out_by_the_references_specs(runs, case):
    """The port's state specs are the reference trainer's, leaf for leaf,
    and every rank's local shapes are the rules' slices."""
    got = runs["port"][0]["trainer"][case]["specs"]
    want = runs["ref"]["trainer"][case]["specs"]
    assert got == want
    # the tiny LM shards every weight on (2, 2)
    assert got["params/blocks/wq"] == (None, "data", "model", None)
    assert got["params/embed"] == ("model", None)
    full = runs["port"][0]["trainer"][case]["state"]
    for out in runs["port"]:
        for path, shape in out["trainer"][case]["local_shapes"].items():
            assert shape == _local_shape(full[path].shape, got[path]), path


# -- the reduced DeepFM cells ---------------------------------------------------------


@pytest.mark.parametrize("impl", ("psum", "xla_gather"))
def test_deepfm_train_cell_on_a_mesh_matches_the_references(runs, impl):
    got = runs["port"][0]["deepfm"][(impl, "train_batch")]
    want = runs["ref"]["deepfm"][(impl, "train_batch")]
    assert got["keep"] == (("table", "linear_table") if impl == "psum"
                           else ())
    for out in runs["port"][1:]:
        other = out["deepfm"][(impl, "train_batch")]
        assert other["loss"] == got["loss"]
    assert got["loss"] == pytest.approx(want["loss"], rel=TOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=TOL)
    for k, w in want["params"].items():
        mu = got["opt"]["mu"][k]
        clear = np.abs(mu) > 0.1 * CLEAR
        np.testing.assert_allclose(got["params"][k][clear], w[clear],
                                   rtol=0, atol=TOL, err_msg=k)
        np.testing.assert_allclose(mu, want["opt"]["mu"][k], rtol=0,
                                   atol=1e-7, err_msg=k)


def test_deepfm_meshed_forward_differs_from_one_card_as_the_reference(runs):
    """Under the psum lookup the loss is the reference's meshed one, which
    rounds the looked-up rows to bf16; the xla_gather cell runs the
    one-card path on gathered tables."""
    psum = runs["port"][0]["deepfm"][("psum", "train_batch")]["loss"]
    gather = runs["port"][0]["deepfm"][("xla_gather", "train_batch")]["loss"]
    assert psum != gather
    arch = get_arch("deepfm").reduced()
    rec = runs["inputs"]["deepfm"]
    params = convert.recsys_params_from_jax(rec["params"], arch.cfg, "cpu")
    cell = arch.build_cell("train_batch", "cpu")
    _, m = cell.fn(init_train_state(cell, params), {
        k: torch.from_numpy(np.array(v)) for k, v in rec["train_batch"].items()})
    assert float(m["loss"]) == pytest.approx(gather, rel=TOL)


def test_deepfm_serve_bulk_on_a_mesh_matches_the_references(runs):
    want = runs["ref"]["deepfm"][("psum", "serve_bulk")]["out"]
    for out in runs["port"]:
        got = out["deepfm"][("psum", "serve_bulk")]["out"]
        assert got.shape == want.shape == (64,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- elastic restore ----------------------------------------------------------------------


def test_elastic_restore_onto_another_mesh_is_bitwise(runs):
    for out in runs["port"]:
        res = out["restore"]
        assert res["step"] == 1
        assert res["equal"] and all(res["equal"].values()), res["equal"]
        # (4, 1): the rows split four ways where (2, 2) split them two
        specs = {p: tuple(s) for p, s in flatten(res["specs41"])}
        assert specs["params/blocks/wq"] == (None, "data", None, None)


def test_meshed_train_loop_checkpoints_and_resumes(runs):
    """``RetrievalTrainer.train`` on the mesh: two steps on the fixed
    batch (the first the meshed step held above), a checkpoint of
    gathered leaves each step (keep 2), and a second trainer on the same
    directory resumed from the last one, bitwise, with no step left."""
    step1 = runs["port"][0]["trainer"][ranks.TRAINER_CASES[0]]
    for out in runs["port"]:
        loop = out["train_loop"]
        assert loop["steps"] == (2, 2)
        assert loop["written"] == ["step_00000001", "step_00000002"]
        assert loop["losses"][0] == step1["loss"]
        assert np.isfinite(loop["losses"]).all()
        for path, want in loop["state"].items():
            np.testing.assert_array_equal(loop["resumed"][path], want,
                                          err_msg=path)
    ckpts = runs["work"] / "loop" / "checkpoints"
    # full leaves on disk: the global shapes
    restored = ckpt.restore_checkpoint(
        str(ckpts / "step_00000002"),
        {p: torch.zeros(np.shape(v)) for p, v in
         runs["port"][0]["train_loop"]["state"].items() if p != "rng"})
    for path, t in restored.items():
        np.testing.assert_array_equal(
            t.numpy(), runs["port"][0]["train_loop"]["state"][path])


def test_elastic_restore_onto_one_process_is_bitwise(runs):
    path = ckpt.latest_checkpoint(str(runs["work"] / "ckpt"))
    full = runs["port"][0]["trainer"][ranks.TRAINER_CASES[0]]["state"]
    specs = runs["port"][0]["trainer"][ranks.TRAINER_CASES[0]]["specs"]
    template = {p: v if p == "rng" else torch.from_numpy(np.array(v))
                for p, v in full.items()}
    restored = dict(flatten(ckpt.restore_checkpoint(
        path, _unflat(template))))
    assert set(restored) == set(full)
    for p, want in full.items():
        got = restored[p]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, want, err_msg=p)
    # each rank's (2, 2) slices are slices of what one process restored
    for r, out in enumerate(runs["port"]):
        coord = {"data": r // 2, "model": r % 2}
        for p, local in out["restore"]["local22"].items():
            want = np.asarray(full[p])
            for dim, e in enumerate(specs[p]):
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n = want.shape[dim] // 2
                    want = np.take(want, range(coord[a] * n,
                                               (coord[a] + 1) * n), axis=dim)
            np.testing.assert_array_equal(local, want,
                                          err_msg=f"rank {r} {p}")


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out

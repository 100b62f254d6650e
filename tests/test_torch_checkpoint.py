"""The port's checkpoints, and checkpoints crossing between the packages.

The layout is the reference's (``step_%08d/manifest.json + arrays.npz``,
leaves keyed by ``/``-joined tree paths), so: a float32 train state the
reference's ``save_checkpoint`` wrote restores into the port, and the
port's restores through the reference's ``restore_checkpoint``; after
either, the two encoders agree within 1e-5 (float32, unit-norm
embeddings, as ``tests/test_torch_encoder.py``).  bf16 leaves are raw
``|V2`` words with ``"dtype": "bfloat16"`` in the manifest in both
packages; the port decodes the reference's bit for bit (the reference
cannot restore its own: ROADMAP §3 fault 8).  Then the manager: keep-M
garbage collection, async writes, an async write's error surfacing on
the next ``wait`` / ``save``, and a torn save never picked up.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as ref_tf
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro_torch.configs import trove_base
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import flatten

torch.set_num_threads(1)

ATOL = 1e-5


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"step": torch.tensor(7, dtype=torch.int32),
            "params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8, dtype=torch.bfloat16) + 1.5},
            "opt": {"mu": {"w": torch.ones(8, 8), "b": torch.zeros(8)}},
            "rng": np.array([0, 1], np.uint32)}


def _assert_same(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


def test_roundtrip_is_bitwise(tmp_path):
    state = _state()
    path = ckpt.save_checkpoint(str(tmp_path), 7, state)
    assert os.path.basename(path) == "step_00000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    restored = ckpt.restore_checkpoint(path, _state(seed=1))
    _assert_same(restored, state)
    assert ckpt.checkpoint_step(path) == 7
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["leaves"]["params/b"] == {"shape": [8],
                                              "dtype": "bfloat16"}
    assert manifest["leaves"]["rng"]["dtype"] == "uint32"
    with pytest.raises(KeyError, match="params/x"):
        ckpt.restore_checkpoint(path, {"params": {"x": torch.zeros(1)}})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(path, {"params": {"w": torch.zeros(4)}})


def test_latest_checkpoint_ordering(tmp_path):
    for step in (5, 20, 10):
        ckpt.save_checkpoint(str(tmp_path), step, _state())
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000020")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_torn_save_is_never_picked_up(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, _state())
    # a crash mid-save leaves the tmp dir (and a partial dir without a
    # manifest from a foreign writer)
    torn = tmp_path / ".tmp_step_00000002abcd"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"partial")
    os.makedirs(tmp_path / "step_00000003")
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000001")
    mgr = ckpt.CheckpointManager(str(tmp_path))
    restored, step = mgr.restore_latest(_state(seed=2))
    assert step == 1
    _assert_same(restored, _state())


def test_manager_gc_and_async(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), save_every=1, keep=2,
                                 async_save=True)
    states = []
    for step in range(5):
        state = _state(step)
        mgr.save(step, state)
        # the host copy is taken at save: in-place updates after it do
        # not reach the checkpoint
        states.append({k: v for k, v in _state(step).items()})
        state["params"]["w"].add_(1.0)
    mgr.wait()
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000003", "step_00000004"]
    restored, step = mgr.restore_latest(_state(seed=9))
    assert step == 4
    _assert_same(restored, states[4])
    assert [mgr.should_save(s) for s in (0, 1, 2)] == [False, True, True]


def test_async_error_surfaces_on_next_wait_and_save(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    real = ckpt._write_flat

    def boom(*a):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write_flat", boom)
    mgr.save(1, _state())                    # returns: the write is async
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                               # reported once
    mgr.save(2, _state())
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, _state())                # surfaced by the next save
    monkeypatch.setattr(ckpt, "_write_flat", real)
    mgr.save(4, _state())
    mgr.wait()
    assert os.listdir(tmp_path) == ["step_00000004"]


# -- across packages -----------------------------------------------------------

@pytest.fixture(scope="module")
def cfgs():
    return ref_get_arch("trove-base").reduced().cfg, trove_base.reduced()


def _tokens():
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 512, size=(4, 10)).astype(np.int32)
    mask = (np.arange(10)[None] < np.array([10, 6, 3, 1])[:, None]).astype(
        np.int32)
    return toks, mask


def _encoders_agree(jcfg, cfg, jparams, params):
    toks, mask = _tokens()
    want = np.asarray(ref_tf.encode(jcfg, jparams, jnp.asarray(toks),
                                    jnp.asarray(mask)))
    got = tf.encode(cfg, params, torch.from_numpy(toks),
                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _ref_state(jcfg, seed=0):
    params = ref_tf.init_params(jcfg, jax.random.key(seed))
    opt_init, _ = ref_opt.make_optimizer(ref_opt.OptimizerConfig())
    return {"step": jnp.asarray(3, jnp.int32), "params": params,
            "opt": opt_init(params),
            "rng": jax.random.key_data(jax.random.key(1))}


def _port_state(cfg, seed=5):
    params = tf.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    opt_init, _ = opt.make_optimizer(opt.OptimizerConfig())
    return {"step": torch.tensor(3, dtype=torch.int32), "params": params,
            "opt": opt_init(params), "rng": np.array([0, 1], np.uint32)}


def test_reference_checkpoint_restores_into_the_port(tmp_path, cfgs):
    jcfg, cfg = cfgs
    ref = _ref_state(jcfg)
    path = ref_ckpt.save_checkpoint(str(tmp_path), 3, ref)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    state = ckpt.restore_checkpoint(path, _port_state(cfg))
    assert int(state["step"]) == 3
    np.testing.assert_array_equal(state["rng"], [0, 1])
    want = params_from_jax(jax.tree.map(np.asarray, ref["params"]), cfg,
                           device="cpu")
    _assert_same(state["params"], want)
    _encoders_agree(jcfg, cfg, ref["params"], state["params"])
    for (path_, got), (_, w) in zip(
            flatten(state["opt"]),
            flatten(jax.tree.map(np.asarray, ref["opt"]))):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=path_)


def test_port_checkpoint_restores_through_the_reference(tmp_path, cfgs):
    jcfg, cfg = cfgs
    state = _port_state(cfg)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert ref_ckpt.latest_checkpoint(str(tmp_path)) == path
    assert ref_ckpt.checkpoint_step(path) == 3
    ref = ref_ckpt.restore_checkpoint(path, _ref_state(jcfg, seed=1))
    assert int(ref["step"]) == 3
    _encoders_agree(jcfg, cfg, ref["params"], state["params"])
    got = dict((("/".join(str(k.key) for k in p)), np.asarray(v))
               for p, v in jax.tree_util.tree_flatten_with_path(ref)[0])
    for path_, leaf in flatten(state):
        want = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        np.testing.assert_array_equal(got[path_], want, err_msg=path_)


def test_reference_bf16_checkpoint_decodes_bit_exact(tmp_path, cfgs):
    """trove-base's bf16 leaves: the reference writes raw ``|V2`` words
    and cannot read them back (fault 8); the port decodes them by the
    manifest's dtype, bit for bit, and writes the same layout."""
    jcfg, cfg = cfgs
    jcfg16 = jcfg.__class__(**{**jcfg.__dict__, "dtype": jnp.bfloat16})
    ref = {"step": jnp.asarray(3, jnp.int32),
           "params": ref_tf.init_params(jcfg16, jax.random.key(4)),
           "rng": jax.random.key_data(jax.random.key(1))}
    path = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref)
    with pytest.raises(TypeError, match="V2"):
        ref_ckpt.restore_checkpoint(path, ref)
    cfg16 = cfg.__class__(**{**cfg.__dict__, "dtype": torch.bfloat16})
    template = {"step": torch.zeros((), dtype=torch.int32),
                "params": tf.init_params(cfg16, torch.Generator(), "cpu"),
                "rng": np.zeros(2, np.uint32)}
    state = ckpt.restore_checkpoint(path, template)
    flat_ref = dict(
        ("/".join(str(k.key) for k in p), np.asarray(v))
        for p, v in jax.tree_util.tree_flatten_with_path(ref["params"])[0])
    for key, leaf in flatten(state["params"]):
        assert leaf.dtype == torch.bfloat16, key
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy().view(np.uint16),
            flat_ref[key].view(np.uint16), err_msg=key)
    # the port's save of the same state: the reference's npz dtypes and
    # manifest, and its own restore bit for bit
    mine = ckpt.save_checkpoint(str(tmp_path / "port"), 3, state)
    manifests = [json.load(open(os.path.join(p, "manifest.json")))
                 for p in (path, mine)]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    with np.load(os.path.join(path, "arrays.npz")) as a, \
            np.load(os.path.join(mine, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype.str == b[key].dtype.str, key
            assert a[key].tobytes() == b[key].tobytes(), key
    _assert_same(ckpt.restore_checkpoint(mine, template), state)

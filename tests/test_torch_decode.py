"""The KV-cache decode (``init_cache``, ``decode_step``, ``lm_logits``,
``_moe_token``) and ``LMArch``'s serve cells against the reference, on
the CPU.

* ``decode_step`` over 9 steps from an empty cache against
  ``repro.models.transformer.decode_step`` on parameters carried across
  by ``params_from_jax`` (biases made non-zero), for the ``reduced()``
  config of the six LM archs (granite: two MoE layers; llama4: one dense
  and one MoE layer with a shared expert) and the four configs of the
  reference's ``test_decode_matches_forward``: every step's logits, the
  final cache and ``len`` within ATOL = 1e-5 (float32; the two packages
  sum the same products in other orders, ~1e-7 on logits of ~0.2), with
  the attention's position chunks, its runs in the product with V and
  the vocabulary blocks cut small so every loop runs several times.
* The port's decode against its own forward (``lm_logits`` of
  ``forward_hidden``) on the reference test's four configs at its
  tolerance (rtol 2e-2, atol 2e-4; capacity factor 8.0 for the MoE
  configs, so the prefill drops nothing).
* A reference cache carried across at ``len = 5`` (``cache_from_jax``),
  3 more steps in each package, and ``cache_to_numpy`` round trips.
* ``_moe_token`` against the reference's on hand-made router ties (a
  zero router, two equal columns), a random router, and the shared
  expert, within ATOL.
* The in-place write: the same storage returned, only position ``len``
  changed, ``len`` one more.
* The serve cells at the reduced shapes against the reference's cell
  ``fn``; on a shape-only mesh a serve cell builds with its cache's
  specs and refuses to step; ``device="cuda"`` without a card raises.
* granite's own capacity factor: decode differs from prefill where the
  prefill dropped token-slots, alike in both packages (a property of the
  reference: ``_moe_token`` has no capacity).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.configs.lm_arch import REDUCED_SHAPES
from repro_torch.models import transformer as tf
from repro_torch.sharding import make_mesh
from repro_torch.models.convert import (cache_from_jax, cache_to_numpy,
                                        params_from_jax)

torch.set_num_threads(1)

ATOL = 1e-5
# the reference's test_decode_matches_forward tolerance
FWD_RTOL, FWD_ATOL = 2e-2, 2e-4
STEPS, BATCH, MAX_LEN = 9, 2, 12
ARCHS = ["trove-base", "qwen2-0.5b", "stablelm-3b", "gemma-7b",
         "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
# the reference's test_decode_matches_forward configs (tests/test_models.py)
REF_KW = [
    dict(),
    dict(qkv_bias=True, norm="layernorm", activation="gelu"),
    dict(moe=True, n_experts=4, top_k=2, moe_d_ff=32, moe_every=1,
         capacity_factor=8.0),
    dict(moe=True, n_experts=4, top_k=1, moe_d_ff=32, moe_every=2,
         n_shared_experts=1, capacity_factor=8.0),
]
REF_IDS = ["dense", "bias-layernorm-gelu", "moe-every-1", "moe-every-2"]


def _ref_cfg(**kw):
    base = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=64, vocab_size=101, dtype=jnp.float32,
                remat=False)
    base.update(kw)
    return jtf.LMConfig(name="t", **base)


def _port_cfg(jcfg) -> tf.LMConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tf.LMConfig) if f.name != "dtype"}
    return tf.LMConfig(**fields, dtype=torch.float32)


def _jcfg(case: str):
    if case in ARCHS:
        return ref_get_arch(case).reduced().cfg
    return _ref_cfg(**REF_KW[REF_IDS.index(case)])


def _pair(jcfg, seed=0):
    """Reference params (numpy leaves; biases and LayerNorm shifts made
    non-zero so their paths count) and the port's copy."""
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(size=x.shape).astype(np.float32) * 0.1
                      if str(p[-1].key).startswith("b")
                      or str(p[-1].key).endswith("_b") else np.asarray(x)),
        jtf.init_params(jcfg, jax.random.key(seed)))
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _ref_step(jcfg):
    return jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t))


def _np_cache(c) -> dict:
    return {k: np.asarray(v) for k, v in c.items()}


def _same_cache(got, want, atol=ATOL):
    got = cache_to_numpy(got)
    assert int(got["len"]) == int(want["len"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   atol=atol, rtol=0)


@pytest.fixture
def small_chunks(monkeypatch):
    """Attention chunks of 3 positions at BATCH rows over 2 KV heads of
    16 (1 over 4 heads, 6 at head_dim 8), runs of 2 positions in the
    product with V (a run and a remainder, runs alone, a remainder
    alone), and vocabulary blocks of 40 rows at the reduced widths, so
    every loop runs several times."""
    monkeypatch.setattr(tf, "DECODE_CHUNK_BYTES", 3 * 4 * BATCH * 2 * 16)
    monkeypatch.setattr(tf, "PV_SPLIT", 2)
    monkeypatch.setattr(tf, "LOGIT_BLOCK_BYTES", 40 * 4 * 64)


# -- decode against the reference's --------------------------------------------


@pytest.mark.parametrize("case", ARCHS + REF_IDS)
def test_decode_matches_reference(case, small_chunks):
    jcfg = _jcfg(case)
    cfg, tree, params = _pair(jcfg)
    toks = np.random.default_rng(1).integers(
        3, cfg.vocab_size, (STEPS, BATCH)).astype(np.int32)
    step = _ref_step(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jtf.init_cache(jcfg, BATCH, MAX_LEN)
    cache = tf.init_cache(cfg, BATCH, MAX_LEN, device="cpu")
    assert cache["len"].dtype == torch.int32 and cache["len"].shape == ()
    assert cache["k"].shape == (cfg.n_layers, BATCH, MAX_LEN,
                                cfg.n_kv_heads, cfg.head_dim)
    for t in range(STEPS):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[t]))
        got, cache = tf.decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[t]))
        assert got.dtype == torch.float32
        assert got.shape == (BATCH, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"step {t}")
    assert int(cache["len"]) == STEPS
    _same_cache(cache, jcache)


def test_lm_logits_matches_reference(small_chunks):
    jcfg = _jcfg("gemma-7b")
    cfg, tree, params = _pair(jcfg)
    hidden = np.random.default_rng(2).normal(
        size=(2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jtf.lm_logits(jcfg, jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(hidden)))
    got = tf.lm_logits(cfg, params, torch.from_numpy(hidden))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# -- decode against the port's own forward -------------------------------------


@pytest.mark.parametrize("case", REF_IDS)
def test_decode_matches_forward(case):
    """The reference's test_decode_matches_forward, on the port alone."""
    cfg, _, params = _pair(_jcfg(case))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        3, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32))
    hidden, _ = tf.forward_hidden(cfg, params, toks,
                                  torch.ones_like(toks))
    full = tf.lm_logits(cfg, params, hidden).numpy()
    cache = tf.init_cache(cfg, BATCH, STEPS, device="cpu")
    outs = []
    for t in range(STEPS):
        logits, cache = tf.decode_step(cfg, params, cache, toks[:, t])
        outs.append(logits.numpy())
    np.testing.assert_allclose(np.stack(outs, 1), full, rtol=FWD_RTOL,
                               atol=FWD_ATOL)


# -- a cache carried across ----------------------------------------------------


@pytest.mark.parametrize("case", ["qwen2-0.5b", "llama4-maverick-400b-a17b",
                                  "bias-layernorm-gelu"])
def test_cache_carried_across_mid_sequence(case):
    jcfg = _jcfg(case)
    cfg, tree, params = _pair(jcfg)
    toks = np.random.default_rng(4).integers(
        3, cfg.vocab_size, (8, BATCH)).astype(np.int32)
    step = _ref_step(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jtf.init_cache(jcfg, BATCH, MAX_LEN)
    for t in range(5):
        _, jcache = step(jparams, jcache, jnp.asarray(toks[t]))
    tree_cache = _np_cache(jcache)
    cache = cache_from_jax(tree_cache, cfg, device="cpu")
    assert int(cache["len"]) == 5 and cache["len"].dtype == torch.int32
    assert cache["k"].dtype == cfg.dtype
    # the way back, and across again, both exact
    back = cache_to_numpy(cache)
    assert back["len"].dtype == np.int32 and back["len"].shape == ()
    for name in ("k", "v"):
        assert np.array_equal(back[name], tree_cache[name])
    again = cache_from_jax(back, cfg, device="cpu")
    assert all(torch.equal(again[n], cache[n]) for n in ("k", "v", "len"))
    for t in range(5, 8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[t]))
        got, cache = tf.decode_step(cfg, params, cache,
                                    torch.from_numpy(toks[t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    _same_cache(cache, jcache)


def test_cache_from_jax_refuses_a_wrong_layout():
    cfg = _port_cfg(_jcfg("qwen2-0.5b"))
    good = cache_to_numpy(tf.init_cache(cfg, 1, 4, device="cpu"))
    with pytest.raises(ValueError, match="cache k"):
        cache_from_jax(dict(good, k=good["k"][:1]), cfg, device="cpu")
    with pytest.raises(ValueError, match="cache keys"):
        cache_from_jax({"k": good["k"], "v": good["v"]}, cfg, device="cpu")
    with pytest.raises(ValueError, match="cache len"):
        cache_from_jax(dict(good, len=np.zeros(1, np.int32)), cfg,
                       device="cpu")


# -- _moe_token ----------------------------------------------------------------


def _moe_lp(case, seed=0):
    jcfg = _jcfg(case)
    cfg, tree, _ = _pair(jcfg, seed)
    return jcfg, cfg, {k: v[0] for k, v in tree["moe_blocks"].items()}


@pytest.mark.parametrize("case", ["granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b",
                                  "moe-every-1", "moe-every-2"])
@pytest.mark.parametrize("router", ["random", "zero", "equal-columns"])
def test_moe_token_matches_reference(case, router):
    """A zero router ties every expert (the top k are experts 0..k-1);
    two equal columns tie those two for every token.  llama4 and
    moe-every-2 add the shared expert."""
    jcfg, cfg, lp = _moe_lp(case)
    rng = np.random.default_rng(5)
    if router == "zero":
        lp["router"] = np.zeros_like(lp["router"])
    elif router == "equal-columns":
        lp["router"] = np.array(lp["router"])
        lp["router"][:, 2] = lp["router"][:, 1]
    # expert weights scaled up so the routed part is not lost under the
    # tolerance (the init's 0.02 gives outputs ~1e-5)
    for name in ("we_gate", "we_up", "we_down"):
        lp[name] = np.asarray(lp[name]) * 10.0
    h = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    want = np.asarray(jtf._moe_token(jcfg, jax.tree.map(jnp.asarray, lp),
                                     jnp.asarray(h), None))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    got = tf._moe_token(cfg, pt, torch.from_numpy(h))
    assert got.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 100 * ATOL
    if router == "zero":
        # every expert tied: experts 0..k-1, equal gates
        kk = cfg.top_k
        hh = torch.from_numpy(h).reshape(3, cfg.d_model)
        y = torch.zeros_like(hh)
        for e in range(kk):
            x = tf._act(hh @ pt["we_gate"][e], cfg.activation) * (
                hh @ pt["we_up"][e])
            y += (x @ pt["we_down"][e]) / kk
        if cfg.n_shared_experts:
            y += tf._glu(cfg, torch.from_numpy(h), pt["ws_gate"],
                         pt["ws_up"], pt["ws_down"])[:, 0]
        np.testing.assert_allclose(got[:, 0].numpy(), y.numpy(), atol=ATOL,
                                   rtol=0)


# -- the in-place write ----------------------------------------------------------


def test_decode_writes_the_cache_in_place():
    jcfg = _jcfg("llama4-maverick-400b-a17b")
    cfg, _, params = _pair(jcfg)
    g = torch.Generator().manual_seed(0)
    cache = tf.init_cache(cfg, 3, 10, device="cpu")
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    cache["len"].fill_(6)
    before = {n: cache[n].clone() for n in ("k", "v")}
    ptrs = {n: cache[n].data_ptr() for n in ("k", "v", "len")}
    len_tensor = cache["len"]
    logits, out = tf.decode_step(cfg, params, cache,
                                 torch.tensor([3, 4, 5], dtype=torch.int32))
    assert out is cache and out["len"] is len_tensor
    assert {n: out[n].data_ptr() for n in ptrs} == ptrs
    assert int(out["len"]) == 7
    assert logits.shape == (3, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    for n in ("k", "v"):
        changed = (out[n] != before[n]).any(dim=(0, 1, 3, 4))
        assert changed.nonzero().flatten().tolist() == [6]
    with pytest.raises(ValueError, match="outside"):
        cache["len"].fill_(10)
        tf.decode_step(cfg, params, cache, torch.tensor([3, 4, 5]))


# -- the serve cells -----------------------------------------------------------


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("name", ARCHS)
def test_serve_cells_match_reference(name, shape):
    arch, jarch = get_arch(name).reduced(), ref_get_arch(name).reduced()
    spec = REDUCED_SHAPES[shape]
    b, s = spec["global_batch"], spec["seq_len"]
    cell = arch.build_cell(shape, device="cpu")
    assert (cell.arch, cell.shape, cell.kind) == (name, shape, "serve")
    cache, tokens = arch.smoke_inputs(
        shape, torch.Generator().manual_seed(0), device="cpu")
    assert cache["k"].shape == (arch.cfg.n_layers, b, s,
                                arch.cfg.n_kv_heads, arch.cfg.head_dim)
    assert not cache["k"].any() and not cache["v"].any()
    assert int(cache["len"]) == s - 1 and cache["len"].dtype == torch.int32
    assert tokens.shape == (b,) and tokens.dtype == torch.int32
    assert 3 <= int(tokens.min()) and int(tokens.max()) < arch.cfg.vocab_size
    # the same draw again; then a non-zero cache, so no softmax is uniform
    cache2, tokens2 = arch.smoke_inputs(
        shape, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tokens, tokens2)
    rng = np.random.default_rng(6)
    for n in ("k", "v"):
        cache[n].copy_(torch.from_numpy(
            rng.normal(size=cache[n].shape).astype(np.float32)))
    jcell = jarch.build_cell(shape)
    _, tree, params = _pair(jarch.cfg)
    want, jcache = jcell.fn(jax.tree.map(jnp.asarray, tree),
                            {k: jnp.asarray(v) for k, v
                             in cache_to_numpy(cache).items()},
                            jnp.asarray(tokens.numpy()))
    got, out = cell.fn(params, cache, tokens)
    assert out is cache and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _same_cache(out, jcache)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_serve_cells_refuse_a_mesh_and_a_missing_card(shape):
    """A mesh builds the serve cell (the meshed steps are in
    ``tests/test_torch_mesh_lm.py``); a shape-only one refuses to step
    it, and a missing card raises."""
    arch = get_arch("granite-moe-3b-a800m").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    cell = arch.build_cell(shape, device="cpu", mesh=mesh)
    # 2 KV heads over "model"; the batch of 4 over "data", a batch of 1
    # keeps its sequence there
    want = ((None, "data", None, "model", None) if shape == "decode_32k"
            else (None, None, "data", "model", None))
    assert tuple(cell.layout.cache_specs["k"]) == want
    assert tuple(cell.layout.cache_specs["len"]) == ()
    params = tf.init_params(arch.cfg, torch.Generator().manual_seed(0),
                            "cpu")
    with pytest.raises(RuntimeError, match="shape-only"):
        cell.fn(params, *arch.smoke_inputs(shape, torch.Generator(),
                                           device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arch.build_cell(shape)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arch.smoke_inputs(shape, torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tf.init_cache(arch.cfg, 1, 4)


# -- MoE: decode against a prefill that drops ----------------------------------


def test_moe_decode_differs_from_prefill_where_the_prefill_drops():
    """granite's reduced config at its own capacity factor 1.25 with a zero
    router: every token ties and takes experts 0 and 1, an expert's
    capacity in a row of 9 is ceil(9 * 2 / 8 * 1.25) = 3, so the prefill
    drops both slots of positions 3..8 in every MoE layer.  The decode
    (no capacity) drops nothing: it equals the prefill at positions 0..2
    and differs after, in both packages alike."""
    jcfg = _jcfg("granite-moe-3b-a800m")
    assert jcfg.capacity_factor == 1.25
    cfg, tree, _ = _pair(jcfg)
    blocks = dict(tree["moe_blocks"])
    blocks["router"] = np.zeros_like(blocks["router"])
    for name in ("we_gate", "we_up", "we_down"):
        blocks[name] = np.asarray(blocks[name]) * 10.0
    tree = dict(tree, moe_blocks=blocks)
    params = params_from_jax(tree, cfg, device="cpu")
    assert tf.capacity(cfg, STEPS) == 3
    toks = np.random.default_rng(7).integers(
        3, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)

    jhid, _ = jtf.forward_hidden(jcfg, jparams, jnp.asarray(toks),
                                 jnp.ones_like(jnp.asarray(toks)))
    jprefill = np.asarray(jtf.lm_logits(jcfg, jparams, jhid))
    step = _ref_step(jcfg)
    jcache, jdec = jtf.init_cache(jcfg, BATCH, STEPS), []
    for t in range(STEPS):
        lg, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]))
        jdec.append(np.asarray(lg))
    jdec = np.stack(jdec, 1)

    tt = torch.from_numpy(toks)
    hid, _ = tf.forward_hidden(cfg, params, tt, torch.ones_like(tt))
    prefill = tf.lm_logits(cfg, params, hid).numpy()
    cache, dec = tf.init_cache(cfg, BATCH, STEPS, device="cpu"), []
    for t in range(STEPS):
        lg, cache = tf.decode_step(cfg, params, cache, tt[:, t])
        dec.append(lg.numpy())
    dec = np.stack(dec, 1)

    np.testing.assert_allclose(prefill, jprefill, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dec, jdec, atol=ATOL, rtol=0)
    for d, p in ((dec, prefill), (jdec, jprefill)):
        gap = np.abs(d - p).max(axis=(0, 2))
        assert (gap[:3] <= ATOL).all(), gap
        assert (gap[3:] > 100 * ATOL).all(), gap

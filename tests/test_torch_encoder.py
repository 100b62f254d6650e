"""The port's encoder stack and data leaves against the reference.

Encoders run on the same numpy tokens with the reference's parameters
carried across by ``params_from_jax``, in float32 on the CPU.  Tolerance
``ATOL = 1e-5`` on unit-norm embeddings: the two frameworks sum the same
float32 products in different orders (a few ulps per layer).  Each
numeric trap where JAX and PyTorch differ by default has its own test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.encode_pipeline import bucket_ladder as jax_bucket_ladder
from repro.data import synthetic as jsynthetic
from repro.data import table as jtable
from repro.data import tokenizer as jtokenizer
from repro.models import transformer as jtf
from repro_torch.core.encode_pipeline import bucket_ladder
from repro_torch.data import synthetic, table, tokenizer
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-5

# (name, overrides): the trove-base family (gelu + layernorm + mean) and
# the gated / rms / GQA / bias / other-pooling branches
VARIANTS = {
    "gelu-layernorm-mean": dict(activation="gelu", norm="layernorm",
                                pooling="mean"),
    "swiglu-rmsnorm-last-gqa-bias": dict(activation="swiglu",
                                         norm="rmsnorm", pooling="last",
                                         n_kv_heads=2, qkv_bias=True),
    "geglu-rmsnorm-first": dict(activation="geglu", norm="rmsnorm",
                                pooling="first"),
}


def _configs(**kw):
    base = dict(name="tiny", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=257)
    base.update(kw)
    jcfg = jtf.LMConfig(**base, dtype=jnp.float32, remat=False)
    return jcfg, tf.LMConfig(**base, dtype=torch.float32)


def _tokens(rng, b=5, s=12, vocab=257):
    toks = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    lengths = [s, 7, 1, 4, 0][:b]                     # last row all padding
    mask = (np.arange(s)[None] < np.array(lengths)[:, None]).astype(np.int32)
    return np.where(mask > 0, toks, 0), mask


def _converted(jcfg, cfg, seed=0):
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    # the reference initializes biases to zero: give them values so the
    # bias paths are exercised
    if cfg.qkv_bias or cfg.norm == "layernorm":
        rng = np.random.default_rng(seed)
        jparams = jax.tree_util.tree_map_with_path(
            lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.1,
                                      x.dtype)
                          if str(p[-1].key).startswith("b")
                          or str(p[-1].key).endswith("_b") else x),
            jparams)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encode_matches_reference(variant):
    jcfg, cfg = _configs(**VARIANTS[variant])
    jparams, params = _converted(jcfg, cfg)
    toks, mask = _tokens(np.random.default_rng(1))
    want = np.asarray(jtf.encode(jcfg, jparams, jnp.asarray(toks),
                                 jnp.asarray(mask)))
    got = tf.encode(cfg, params, torch.from_numpy(toks),
                    torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tf._act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4        # torch's default differs


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_eps_1e6_in_float32(kind):
    rng = np.random.default_rng(2)
    # a tiny spread, where eps=1e-6 and torch's default 1e-5 part ways
    x = (1e-3 * rng.normal(size=(3, 16))).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32) if kind == "layernorm" \
        else None
    want = np.asarray(jtf._norm(jnp.asarray(x), jnp.asarray(scale),
                                None if bias is None else jnp.asarray(bias),
                                kind))
    got = tf._norm(torch.from_numpy(x), torch.from_numpy(scale),
                   None if bias is None else torch.from_numpy(bias),
                   kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if kind == "layernorm":
        torch_default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (16,), torch.from_numpy(scale),
            torch.from_numpy(bias)).numpy()
        assert np.abs(torch_default - want).max() > 1e-2
    # bf16 in, bf16 out, computed in float32
    xb = torch.from_numpy(x).bfloat16()
    out = tf._norm(xb, torch.from_numpy(scale), None, kind)
    assert out.dtype == torch.bfloat16


def test_rope_is_half_split():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    want = np.asarray(jtf._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tf._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                   10000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the interleaved form rotates pairs (0,1), (2,3), ... instead
    inter = x.copy()
    inter[..., 0::2], inter[..., 1::2] = x[..., :4], x[..., 4:]
    inter_rot = tf._rope(torch.from_numpy(inter),
                         torch.from_numpy(pos.copy()), 10000.0).numpy()
    assert np.abs(inter_rot - got).max() > 1e-2


def test_attention_masks_with_minus_1e30_not_minus_inf():
    """A fully masked query row softmaxes to uniform weights (the
    reference's -1e30 mask); an -inf mask gives NaN there and SDPA
    (version-dependent) NaN or zeros, never the uniform row."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(1, 3, 2, 4)).astype(np.float32)
               for _ in range(3))
    mask = np.array([[[True, False, False], [True, True, False],
                      [False, False, False]]])
    want = np.asarray(jtf._attn_scores_softmax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = tf._attn_scores_softmax(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0, 2], v[0].mean(0), atol=1e-6)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(
            1, 2), torch.from_numpy(v).transpose(1, 2),
        attn_mask=torch.from_numpy(mask)[:, None])
    uniform = torch.from_numpy(v[0].mean(0))
    assert not torch.allclose(sdpa[0, :, 2], uniform, atol=1e-3)


@pytest.mark.parametrize("pooling", ["mean", "first", "last"])
def test_pool_clips_in_float32(pooling):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(3, 4, 6)).astype(np.float32)
    hidden[1] = 0.0                                   # zero vector: 1e-9 clip
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    jcfg, cfg = _configs(pooling=pooling)
    want = np.asarray(jtf.pool(jcfg, jnp.asarray(hidden), jnp.asarray(mask)))
    got = tf.pool(cfg, torch.from_numpy(hidden),
                  torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_params_from_jax_checks_layout():
    jcfg, cfg = _configs(activation="gelu", norm="layernorm")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.key(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    assert params["blocks"]["wq"].shape == (2, 32, 4, 8)
    assert params["blocks"]["wo"].shape == (2, 4, 8, 32)
    bad = dict(tree, blocks=dict(tree["blocks"]))
    del bad["blocks"]["wi_up"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, cfg, device="cpu")
    bad["blocks"]["wi_up"] = np.zeros((2, 32, 65), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, device="cpu")


def test_init_params_layout_and_seed():
    cfg = dataclasses.replace(_configs(norm="layernorm")[1],
                              dtype=torch.bfloat16)
    a = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = tf.param_shapes(cfg)
    assert {n: tuple(t.shape) for n, t in a["blocks"].items()} \
        == shapes["blocks"]
    assert a["embed"].dtype == torch.bfloat16
    assert (a["final_ln"] == 1).all() and (a["final_ln_b"] == 0).all()
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert 0.015 < a["embed"].float().std().item() < 0.025


def test_tokenizer_ids_identical():
    texts = ["Hello, World!  alpha-bravo 42", "", "topic7 x" * 40,
             "ÜNICODE straße", "a.b,c;d"]
    mine, ref = tokenizer.HashTokenizer(50304), jtokenizer.HashTokenizer(
        50304)
    for max_len, eos in ((None, False), (8, True), (0, True)):
        assert (mine.batch_encode_ids(texts, max_len, eos)
                == ref.batch_encode_ids(texts, max_len, eos))
        assert [mine.encode(t, max_len, eos) for t in texts] \
            == [ref.encode(t, max_len, eos) for t in texts]
    for got, want in zip(mine.batch_encode(texts, 16, True, 8),
                         ref.batch_encode(texts, 16, True, 8)):
        np.testing.assert_array_equal(got, want)


def test_stable_id_hash_identical():
    ids = ["doc1", "q0", "", "ünï", 5, 2 ** 70, np.int64(-3)]
    assert [table.stable_id_hash(i) for i in ids] \
        == [jtable.stable_id_hash(i) for i in ids]
    for arr in (["a", "b", "c"], [1, 2 ** 65], np.arange(5, dtype=np.int32)):
        np.testing.assert_array_equal(table.stable_id_hash_array(arr),
                                      jtable.stable_id_hash_array(arr))


def test_synthetic_dataset_and_ladder_identical(tmp_path):
    assert synthetic.make_retrieval_dataset(
        str(tmp_path / "a"), n_queries=9, n_docs=40, n_topics=5, seed=3) \
        == jsynthetic.make_retrieval_dataset(
            str(tmp_path / "b"), n_queries=9, n_docs=40, n_topics=5, seed=3)
    for args in ((128, 6, 8), (32, 6, 8), (7, 3, 8), (300, 1, 8),
                 (100, 4, 16)):
        assert bucket_ladder(*args) == jax_bucket_ladder(*args)

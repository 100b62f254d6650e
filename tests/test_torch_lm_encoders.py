"""The dense LM encoders (qwen2-0.5b, stablelm-3b, gemma-7b) against the
reference.

Each arch's ``reduced()`` form (2 x 64, float32) encodes the same seeded
numpy tokens within ``ATOL = 1e-5`` of the reference's ``encode`` (the
reference's parameters carried across by ``params_from_jax``, biases set
non-zero so their paths count), and ranks a synthetic corpus as the
reference's evaluator does.  At full width the parameter layout and count
equal the reference's (``jax.eval_shape``, nothing allocated); one layer
at full width (vocab cut to 4096; gemma-7b's d_ff cut to 3072) encodes
within ATOL too (the same float32 products summed in another order: a
few 1e-7 over up to 4096-term dot products).  Chunked attention is held
against the reference's ``_attention``;
gemma's embedding scale in bf16 bitwise; the tokenizer at the two large
vocabularies id for id; the ``LMArch`` cells and refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.collator import RetrievalCollator as JaxCollator
from repro.core.config import DataArguments as JaxDataArguments
from repro.core.config import EvaluationArguments as JaxEvalArgs
from repro.core.evaluator import RetrievalEvaluator as JaxEvaluator
from repro.data.synthetic import make_retrieval_dataset
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.models import transformer as jtf
from repro.models.encoder import DefaultEncoder as JaxEncoder
from repro.models.retriever import BiEncoderRetriever as JaxRetriever
from repro_torch.configs import (gemma_7b, get_arch, granite_moe_3b_a800m,
                                 llama4_maverick_400b_a17b, qwen2_0_5b,
                                 stablelm_3b, trove_base)
from repro_torch.configs.base import init_train_state
from repro_torch.configs.lm_arch import LMArch
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever
from repro_torch.sharding import make_mesh

torch.set_num_threads(1)

ATOL = 1e-5
TOL = 1e-5
MODULES = {"qwen2-0.5b": qwen2_0_5b, "stablelm-3b": stablelm_3b,
           "gemma-7b": gemma_7b, "granite-moe-3b-a800m": granite_moe_3b_a800m,
           "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b}
ARCHS = sorted(MODULES)
# the reference's LMConfig.param_count() at published widths
PARAM_COUNTS = {"qwen2-0.5b": 494_032_768, "stablelm-3b": 2_666_664_960,
                "gemma-7b": 8_537_680_896,
                "granite-moe-3b-a800m": 3_298_793_472,
                "llama4-maverick-400b-a17b": 396_657_464_320}
# the fields both LMConfigs carry; the reference's others are mesh and
# compile knobs, and logit_softcap, which no config sets
# (models/transformer.py's docstring)
FIELDS = [f.name for f in dataclasses.fields(tf.LMConfig)]


def _same_fields(cfg, jcfg):
    for name in FIELDS:
        want = getattr(jcfg, name)
        if name == "dtype":
            want = {jnp.float32: torch.float32,
                    jnp.bfloat16: torch.bfloat16}[want]
        assert getattr(cfg, name) == want, name
    # the port has no softcap: the reference's config must not set one
    assert jcfg.logit_softcap == 0.0


def _port_cfg(jcfg) -> tf.LMConfig:
    return tf.LMConfig(**{n: getattr(jcfg, n) for n in FIELDS
                          if n != "dtype"}, dtype=torch.float32)


def _biased(jparams, cfg, seed=0):
    """The reference initializes biases to zero: give them values so the
    bias paths count."""
    if not (cfg.qkv_bias or cfg.norm == "layernorm"):
        return jparams
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape) * 0.1, x.dtype)
                      if str(p[-1].key).startswith("b")
                      or str(p[-1].key).endswith("_b") else x), jparams)


def _pair(jcfg, seed=0):
    """Reference params (numpy leaves) and the port's copy."""
    cfg = _port_cfg(jcfg)
    jparams = _biased(jtf.init_params(jcfg, jax.random.key(seed)), cfg,
                      seed)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, tree, params_from_jax(tree, cfg, device="cpu")


def _tokens(rng, vocab, b=4, s=12):
    toks = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([s, 7, 1, 0][:b])             # last row all padding
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, toks, 0), mask


def _encode_both(jcfg, cfg, tree, params, toks, mask):
    jparams = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jtf.encode(jcfg, jparams, jnp.asarray(toks),
                                 jnp.asarray(mask)))
    got = tf.encode(cfg, params, torch.from_numpy(toks),
                    torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    return got, want


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference_field_for_field(name):
    jarch = ref_get_arch(name)
    mod = MODULES[name]
    _same_fields(mod.get_config(), jarch.cfg)
    _same_fields(mod.reduced(), jarch.reduced().cfg)
    arch = get_arch(name)
    assert isinstance(arch, LMArch) and arch.name == name
    assert arch.cfg == mod.get_config()
    assert arch.reduced().cfg == mod.reduced()
    assert arch.shape_names() == jarch.shape_names()
    assert arch.reduced().shapes == jarch.reduced().shapes


def test_trove_base_is_an_lm_arch_too():
    arch = get_arch("trove-base")
    _same_fields(arch.cfg, ref_get_arch("trove-base").cfg)
    assert arch.reduced().cfg == trove_base.reduced()


def test_every_reference_arch_is_ported():
    """Every architecture of ``repro.configs`` has the port's, the GNN
    included (``tests/test_torch_gnn.py`` holds it against the
    reference)."""
    from repro.configs import ARCH_MODULES as REF_MODULES
    from repro_torch.configs import ARCH_MODULES
    assert set(ARCH_MODULES) == set(REF_MODULES)
    assert get_arch("graphsage-reddit").family == "gnn"


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_layout_and_count_match_reference(name):
    """``param_shapes`` is the reference's ``abstract_params`` leaf for
    leaf (``jax.eval_shape`` of nothing: no allocation), and
    ``param_count()`` its count."""
    jcfg = ref_get_arch(name).cfg
    cfg = MODULES[name].get_config()
    abstract = jtf.abstract_params(jcfg)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert tf.param_shapes(cfg) == shapes(abstract)
    assert cfg.param_count() == jcfg.param_count() == PARAM_COUNTS[name]


# -- reduced: encode, ranking, conversion, cells ------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_encode_matches_reference(name):
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, params = _pair(jcfg)
    assert cfg == MODULES[name].reduced()
    toks, mask = _tokens(np.random.default_rng(1), cfg.vocab_size)
    got, want = _encode_both(jcfg, cfg, tree, params, toks, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_chunked_encode_matches_reference(name):
    """The reduced arch with attention in chunks of 16 over 64 tokens
    (four chunks on both sides)."""
    jcfg = dataclasses.replace(ref_get_arch(name).reduced().cfg,
                               attn_chunk=16)
    cfg, tree, params = _pair(jcfg)
    assert cfg.attn_chunk == 16
    toks, mask = _tokens(np.random.default_rng(2), cfg.vocab_size, s=64)
    got, want = _encode_both(jcfg, cfg, tree, params, toks, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_ranking_matches_reference_evaluator(name, tmp_path):
    """The port's evaluator (fused, kernel) ranks a synthetic corpus as
    the reference's (jax, jax) does: scores within TOL, ids equal where
    neighbours are separated by more than TOL."""
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, params = _pair(jcfg)
    queries, corpus, _ = make_retrieval_dataset(
        str(tmp_path), n_queries=12, n_docs=64, n_topics=6, seed=3)
    v = cfg.vocab_size
    ref = JaxEvaluator(JaxEvalArgs(topk=10),
                       JaxRetriever(JaxEncoder(jcfg), "infonce"),
                       JaxCollator(JaxDataArguments(vocab_size=v),
                                   JaxTokenizer(v)),
                       jax.tree.map(jnp.asarray, tree))
    ev = RetrievalEvaluator(
        EvaluationArguments(topk=10, score_impl="fused", heap_impl="kernel"),
        BiEncoderRetriever(DefaultEncoder(cfg)),
        RetrievalCollator(DataArguments(vocab_size=v), HashTokenizer(v)),
        params, device="cpu")
    rq, rids, rvals = ref.search(queries, corpus)
    q, ids, vals = ev.search(queries, corpus)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_allclose(vals, rvals, atol=TOL, rtol=0)
    inf = np.full_like(rvals[:, :1], np.inf)
    sep = ((np.concatenate([inf, rvals[:, :-1]], 1) - rvals > TOL)
           & (rvals - np.concatenate([rvals[:, 1:], -inf], 1) > TOL))
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(ids[sep], rids[sep])


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_on_each_reduced_layout(name):
    jcfg = ref_get_arch(name).reduced().cfg
    cfg, tree, params = _pair(jcfg)
    want = tf.param_shapes(cfg)
    assert set(params) == set(want)
    stacks = [k for k in ("blocks", "moe_blocks") if k in want]
    for stack in stacks:
        for key, shape in want[stack].items():
            got = params[stack][key]
            assert tuple(got.shape) == shape and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), tree[stack][key])
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    stack = stacks[0]
    bad = dict(tree, **{stack: dict(tree[stack])})
    bad[stack]["wq"] = tree[stack]["wq"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_encode_cell_matches_reference_cell(name):
    """``build_cell("prefill_32k")`` is the encode kind: on the reduced
    arch's shape (2 x 64 tokens) its ``fn`` gives the reference cell's
    embeddings within ATOL."""
    jarch = ref_get_arch(name).reduced()
    arch = get_arch(name).reduced()
    cfg, tree, params = _pair(jarch.cfg)
    cell = arch.build_cell("prefill_32k", device="cpu")
    assert (cell.kind, cell.shape, cell.arch) == ("encode", "prefill_32k",
                                                  name)
    batch = arch.smoke_inputs("prefill_32k", torch.Generator().manual_seed(
        0), device="cpu")
    assert batch["tokens"].shape == (2, 64)
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].min()) >= 3
    assert int(batch["tokens"].max()) < arch.cfg.vocab_size
    got = cell.fn(params, batch).numpy()
    jcell = jarch.build_cell("prefill_32k")
    want = np.asarray(jcell.fn(jax.tree.map(jnp.asarray, tree), {
        k: jnp.asarray(t.numpy()) for k, t in batch.items()}))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_unported_cells_raise_naming_their_item(shape):
    """On a mesh every cell builds with its layout: ``train_4k`` its
    parameters' and optimizer state's specs, the decode cells their
    cache's, and ``prefill_32k`` beside them (stepping them needs the mesh
    bound to a process group, ``tests/test_torch_mesh_lm.py``); on one
    device every cell builds and steps: ``train_4k`` one optimizer step,
    the decode shapes one decode step from ``smoke_inputs``' cache."""
    arch = get_arch("qwen2-0.5b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    layout = arch.build_cell(shape, device="cpu", mesh=mesh).layout
    assert tuple(layout.param_specs["embed"]) == ("model", None)
    if shape == "train_4k":
        assert set(layout.opt_specs) == {"mu", "nu"}
    else:
        assert tuple(layout.cache_specs["k"]) == (
            (None, "data", None, "model", None) if shape == "decode_32k"
            else (None, None, "data", "model", None))
    encode = arch.build_cell("prefill_32k", device="cpu", mesh=mesh)
    assert encode.kind == "encode"
    assert encode.layout.batch_axes["tokens"] == ("batch", None)
    params = tf.init_params(arch.cfg, torch.Generator().manual_seed(0),
                            "cpu")
    cell = arch.build_cell(shape, device="cpu")
    if shape != "train_4k":
        spec = arch.shapes[shape]
        cache, tokens = arch.smoke_inputs(shape, torch.Generator(),
                                          device="cpu")
        assert cell.kind == "serve"
        logits, out = cell.fn(params, cache, tokens)
        assert logits.shape == (spec["global_batch"], arch.cfg.vocab_size)
        assert torch.isfinite(logits).all()
        assert out is cache and int(out["len"]) == spec["seq_len"]
        return
    batch = arch.smoke_inputs(shape, torch.Generator(), device="cpu")
    assert batch["query"]["tokens"].shape == (4, 32)
    assert (cell.kind, cell.shape, cell.optimizer) == ("train", shape,
                                                       "adamw")
    before = params["embed"].clone()
    state, metrics = cell.fn(init_train_state(cell, params), batch)
    assert int(state["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert not torch.equal(state["params"]["embed"], before)


# -- full width, one layer ----------------------------------------------------

WIDE = {
    "qwen2-0.5b": dict(n_layers=1, vocab_size=4096),
    "stablelm-3b": dict(n_layers=1, vocab_size=4096),
    "gemma-7b": dict(n_layers=1, vocab_size=4096, d_ff=3072),
}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_full_width_one_layer_matches_reference(name):
    """Published heads, head_dim and d_model (qwen's GQA groups of 7,
    stablelm's head_dim 80, gemma's 16 x 256 = 4096 != 3072), one layer,
    float32; within ATOL."""
    jcfg = dataclasses.replace(ref_get_arch(name).cfg, dtype=jnp.float32,
                               remat=False, **WIDE[name])
    cfg, tree, params = _pair(jcfg)
    toks, mask = _tokens(np.random.default_rng(4), cfg.vocab_size, b=3,
                         s=10)
    got, want = _encode_both(jcfg, cfg, tree, params, toks, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# -- attention ----------------------------------------------------------------


def _attention_inputs(seed, sq, h=4, kv=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(2, sq, kv, hd)).astype(np.float32)
            for _ in range(2))
    causal = np.tril(np.ones((sq, sq), bool))
    valid = np.arange(sq)[None] < np.array([[sq], [sq - 5]])
    return q, k, v, causal[None] & valid[:, None, :]


@pytest.mark.parametrize("sq,chunks", [(64, 4), (60, 1), (16, 1)])
def test_attention_chunks_match_reference(sq, chunks, monkeypatch):
    """attn_chunk = 16: Sq = 64 runs four chunks, Sq = 60 (no multiple)
    and Sq = 16 (not above the chunk) one pass, as in the reference."""
    q, k, v, mask = _attention_inputs(5, sq)
    jcfg = jtf.LMConfig(attn_chunk=16, dtype=jnp.float32, remat=False)
    cfg = tf.LMConfig(attn_chunk=16, dtype=torch.float32)
    want = np.asarray(jtf._attention(jcfg, *map(jnp.asarray,
                                                (q, k, v, mask))))
    calls = []
    inner = tf._attn_scores_softmax

    def counted(*args):
        calls.append(args[0].shape[1])
        return inner(*args)

    monkeypatch.setattr(tf, "_attn_scores_softmax", counted)
    got = tf._attention(cfg, *map(torch.from_numpy, (q, k, v, mask)))
    assert calls == [sq // chunks] * chunks
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # one pass over every query gives the same function
    whole = inner(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


# -- embedding scale, tokenizer -----------------------------------------------


def test_gemma_embed_scale_is_bf16_and_bitwise(monkeypatch):
    """x * sqrt(d) in the model dtype: at d = 3072 the bf16 scalar is
    55.5, not 55.43 (bitwise the reference's first residual; a float32
    scale would differ)."""
    base = dict(name="gemma-7b", n_layers=1, d_model=3072, n_heads=1,
                n_kv_heads=1, head_dim=8, d_ff=8, vocab_size=64,
                activation="geglu", norm="rmsnorm")
    jcfg = jtf.LMConfig(**base, dtype=jnp.bfloat16, remat=False,
                        scan_layers=False)
    cfg = tf.LMConfig(**base, dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.key(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(7).integers(3, 64, (2, 5)).astype(np.int32)
    mask = np.ones_like(toks)

    class Seen(Exception):
        pass

    def first_residual(module):
        def stop(cfg, lp, x, *args):
            raise Seen(np.asarray(x.float() if isinstance(x, torch.Tensor)
                                  else x.astype(jnp.float32)))
        monkeypatch.setattr(module, "_attn_block", stop)

    first_residual(jtf)
    with pytest.raises(Seen) as want:
        jtf.forward_hidden(jcfg, jax.tree.map(jnp.asarray, tree),
                           jnp.asarray(toks), jnp.asarray(mask))
    first_residual(tf)
    with pytest.raises(Seen) as got:
        tf.forward_hidden(cfg, params, torch.from_numpy(toks),
                          torch.from_numpy(mask))
    want, got = want.value.args[0], got.value.args[0]
    np.testing.assert_array_equal(got, want)
    emb = params["embed"][torch.from_numpy(toks).long()]
    assert torch.equal(torch.from_numpy(got), (emb * 55.5).float())
    f32 = (emb.float() * float(np.sqrt(3072))).bfloat16().float()
    assert not torch.equal(torch.from_numpy(got), f32)


@pytest.mark.parametrize("vocab", [151936, 256000])
def test_tokenizer_ids_at_large_vocabularies(vocab):
    texts = ["Hello, World!  alpha-bravo 42", "", "topic7 x" * 40,
             "ÜNICODE straße", "a.b,c;d"]
    mine, ref = HashTokenizer(vocab), JaxTokenizer(vocab)
    for max_len, eos in ((None, False), (8, True)):
        got = mine.batch_encode_ids(texts, max_len, eos)
        assert got == ref.batch_encode_ids(texts, max_len, eos)
        assert max(i for row in got for i in row) < vocab
    for got, want in zip(mine.batch_encode(texts, 16, True, 8),
                         ref.batch_encode(texts, 16, True, 8)):
        np.testing.assert_array_equal(got, want)

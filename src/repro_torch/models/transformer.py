"""LM transformer backbone for retrieval encoders: the dense path.

The port's counterpart of ``repro.models.transformer`` for dense stacks:
``forward_hidden`` (embed, N × [norm, QKV, RoPE, masked softmax
attention, FFN], final norm), ``pool`` and ``encode``, plus
``init_params`` from a ``torch.Generator``.  Parameters keep the
reference's layout — a dict with ``embed`` (V, d), ``final_ln`` (d,)
and ``blocks`` stacked over layers (``wq`` (L, d, h, hd), ``wo``
(L, h, hd, d), ``wi_up`` (L, d, f), ...) — so the reference's
parameters carry across unchanged (``models.convert``).

Numerics follow the reference where frameworks differ:
  * GELU is the tanh approximation (``jax.nn.gelu``'s default; torch's
    default is the exact erf form);
  * norms compute in float32 with eps 1e-6;
  * RoPE is the half-split form, not the interleaved one;
  * attention scores are float32, masked with -1e30 (not -inf) and then
    softmaxed, so a fully masked row is uniform, not NaN; the mask is
    always causal & padding.  It is written out rather than calling
    ``scaled_dot_product_attention`` for that reason;
  * pooling is in float32 with the clips 1e-6 and 1e-9.

``attn_chunk`` is the reference's field that changes the function.
With ``attn_chunk > 0`` attention runs over query chunks of that many
rows when the query length is a larger multiple of it, else in one pass
(the reference's rule); each chunk sees every key, so a row's softmax is
the same function, and only one chunk's scores are alive at a time.
The reference's ``logit_softcap`` is left out: no config sets it.

``remat`` is the reference's activation checkpointing (its
``jax.checkpoint`` per layer).  Under autograd with ``remat`` each
layer (attention block and FFN) runs as one
``torch.utils.checkpoint``: the backward keeps only the layer's input
and recomputes the rest.  Chunked attention checkpoints each query chunk
under autograd whatever ``remat`` says, as the reference's chunk scan
does, so a backward holds one chunk's float32 scores.  The recomputed
forward runs the same ops on the same inputs, so the gradients are the
same bits with and without it.  Under ``no_grad`` (every encode, serve
and prefill path) nothing is checkpointed.

The reference's mesh and compile knobs have no counterpart here, since
torch runs eagerly on one card: ``scan_layers``, ``seq_shard_attn``,
``seq_shard_acts``, ``inline_mask``, ``dus_cache_update`` and
``moe_impl``; nor has ``max_seq_len``, which the reference declares and
never reads.  The MoE FFN and the KV-cache decode step come with later
slices (item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.training.tree import leaves

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128
    vocab_size: int = 1024
    activation: str = "swiglu"      # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pooling: str = "last"           # last | mean | first
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 0             # > 0: query-chunked attention
    remat: bool = True              # checkpoint each layer under autograd

    def param_count(self) -> int:
        """Parameters of :func:`param_shapes` (the reference's
        ``LMConfig.param_count()``)."""
        return sum(math.prod(s) for s in leaves(param_shapes(self)))


def param_shapes(cfg: LMConfig) -> dict:
    """Nested dict of parameter shapes, the reference's layout."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    block = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
             "wo": (h, hd, d), "ln1": (d,), "ln2": (d,)}
    if cfg.qkv_bias:
        block.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    if cfg.norm == "layernorm":
        block.update({"ln1_b": (d,), "ln2_b": (d,)})
    if cfg.activation in ("swiglu", "geglu"):
        block.update({"wi_gate": (d, f), "wi_up": (d, f), "wo_ffn": (f, d)})
    else:
        block.update({"wi_up": (d, f), "wo_ffn": (f, d)})
    shapes = {"embed": (cfg.vocab_size, d), "final_ln": (d,),
              "blocks": {k: (cfg.n_layers,) + s for k, s in block.items()}}
    if cfg.norm == "layernorm":
        shapes["final_ln_b"] = (d,)
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Norm scales 1, biases 0, other weights 0.02 * N(0, 1), drawn from
    ``generator`` (on the generator's device) in a fixed leaf order."""
    device = resolve_device(device)

    def leaf(name: str, shape) -> torch.Tensor:
        if name.startswith(("ln", "final_ln")) and not name.endswith("_b"):
            t = torch.ones(shape)
        elif name.startswith("b") or name.endswith("_b"):
            t = torch.zeros(shape)
        else:
            # scaled in place: one float32 copy of the leaf at a time
            t = torch.randn(shape, generator=generator,
                            device=generator.device).mul_(0.02)
        return t.to(device=device, dtype=cfg.dtype)

    out: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if isinstance(shape, dict):
            out[name] = {k: leaf(k, s) for k, s in sorted(shape.items())}
        else:
            out[name] = leaf(name, shape)
    return out


def _norm(x, scale, bias=None, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form.  x: (B, S, H, hd), positions
    (B, S)."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32) / half).to(x.device)
    ang = positions[..., :, None].float() * freqs          # (B, S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(x, kind):
    if kind in ("swiglu", "silu"):
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _attn_scores_softmax(q, k, v, mask):
    """q: (B, Sq, H, hd), k/v: (B, Skv, K, hd), mask (B, Sq, Skv) bool.

    At most two float32 score-sized tensors are alive at once: the
    scores, scaled and masked in place, and the softmax of them (the
    scores are freed before the cast to ``v``'s dtype)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    # float32 scores from (possibly bf16) inputs: the reference's
    # preferred_element_type=float32 product
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores.div_(math.sqrt(hd))
    scores.masked_fill_(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def _attention(cfg: LMConfig, q, k, v, mask):
    """Attention over query chunks of ``cfg.attn_chunk`` rows when
    ``0 < attn_chunk < Sq`` and ``attn_chunk`` divides ``Sq``, else in
    one pass (the reference's rule, ``repro/models/transformer.py``'s
    ``_attention``)."""
    sq, chunk = q.shape[1], cfg.attn_chunk
    if not chunk or sq <= chunk or sq % chunk != 0:
        return _attn_scores_softmax(q, k, v, mask)
    if torch.is_grad_enabled():
        # the reference's jax.checkpoint of the chunk body: the backward
        # recomputes one chunk's scores at a time
        def run(*args):
            return checkpoint(_attn_scores_softmax, *args,
                              use_reentrant=False, preserve_rng_state=False)
    else:
        run = _attn_scores_softmax
    return torch.cat([run(q[:, lo: lo + chunk], k, v,
                          mask[:, lo: lo + chunk])
                      for lo in range(0, sq, chunk)], dim=1)


def _attn_block(cfg: LMConfig, lp: Params, x, positions, mask):
    h = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg.norm)
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    out = _attention(cfg, q, k, v, mask)
    return x + torch.einsum("bshk,hkd->bsd", out, lp["wo"])


def _glu(cfg: LMConfig, h, w_gate, w_up, w_down):
    up = torch.einsum("bsd,df->bsf", h, w_up)
    if w_gate is not None:
        up = _act(torch.einsum("bsd,df->bsf", h, w_gate),
                  cfg.activation) * up
    else:
        up = _act(up, cfg.activation)
    return torch.einsum("bsf,fd->bsd", up, w_down)


def _dense_ffn(cfg: LMConfig, lp: Params, x):
    h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg.norm)
    return x + _glu(cfg, h, lp.get("wi_gate"), lp["wi_up"], lp["wo_ffn"])


def _layer(cfg: LMConfig, lp: Params, x, positions, mask):
    return _dense_ffn(cfg, lp, _attn_block(cfg, lp, x, positions, mask))


def forward_hidden(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   attn_mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int, attn_mask (B, S) {0,1} -> hidden (B, S, d)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=tokens.device))
    mask = causal[None] & attn_mask[:, None, :].bool()
    blocks = params["blocks"]
    # one view per layer of each stacked weight: unbind's backward stacks
    # the layers' gradients once, where indexing would write a zero-filled
    # stack per layer and sum the stacks
    layers = [dict(zip(blocks, ws)) for ws in zip(
        *(w.unbind(0) for w in blocks.values()))][: cfg.n_layers]
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = checkpoint(_layer, cfg, lp, x, positions, mask,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(cfg, lp, x, positions, mask)
    return _norm(x, params["final_ln"], params.get("final_ln_b"), cfg.norm)


def pool(cfg: LMConfig, hidden: torch.Tensor,
         attn_mask: torch.Tensor) -> torch.Tensor:
    maskf = attn_mask.float()[..., None]
    if cfg.pooling == "mean":
        emb = (hidden * maskf).sum(1) / maskf.sum(1).clamp_min(1e-6)
    elif cfg.pooling == "first":
        emb = hidden[:, 0]
    else:  # last non-pad token
        idx = (attn_mask.sum(-1).long() - 1).clamp_min(0)
        emb = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                     idx]
    emb = emb.float()
    return emb / torch.linalg.norm(emb, dim=-1,
                                   keepdim=True).clamp_min(1e-9)


def encode(cfg: LMConfig, params: Params, tokens: torch.Tensor,
           attn_mask: torch.Tensor) -> torch.Tensor:
    """Retrieval embedding: (B, S) -> (B, d) L2-normalized float32."""
    return pool(cfg, forward_hidden(cfg, params, tokens, attn_mask),
                attn_mask)

"""LM transformer backbone for retrieval encoders, dense and MoE.

The port's counterpart of ``repro.models.transformer``:
``forward_hidden`` (embed, N × [norm, QKV, RoPE, masked softmax
attention, FFN], final norm), ``pool`` and ``encode``, plus
``init_params`` from a ``torch.Generator``.  Parameters keep the
reference's layout — a dict with ``embed`` (V, d), ``final_ln`` (d,)
and ``blocks`` / ``moe_blocks`` stacked over layers (``wq`` (L, d, h,
hd), ``wo`` (L, h, hd, d), ``wi_up`` (L, d, f), ``router`` (L, d, E),
``we_up`` (L, E, d, f), ...) — so the reference's
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

The MoE FFN (``moe``) is the reference's ``_moe_ffn``: token-choice
top-k routing over ``n_experts`` with a per-row capacity, gather
dispatch and combine, and the Switch aux loss (:func:`_route`,
:func:`_moe_ffn`).  ``moe_every=1`` makes every layer MoE
(``moe_blocks``); ``moe_every=2`` interleaves dense and MoE layers,
dense first (``blocks`` and ``moe_blocks``, half the depth each);
``n_shared_experts`` adds a dense GLU of ``moe_d_ff * n_shared_experts``
beside the routed experts.  Three rules are copied exactly, because they
decide which tokens overflow:
  * ties among equal probabilities go to the lower expert index
    (``lax.top_k``'s rule; ``torch.topk`` promises no order, so the top k
    come from a stable descending sort);
  * the capacity is ``max(ceil(S * top_k / E * capacity_factor), 1)`` a
    row, with S the padded length, so a token's output depends on its
    row's padded length (padded positions route and take slots too;
    padding is on the right, so it never displaces a real token);
  * a slot's rank within its expert counts the (s, k) pairs s-major.
The forward uses no atomics: the dispatch index is a scatter whose only
duplicates land on a sentinel column that is then dropped.  The
gathers' backward adds into rows on CUDA, so two backward passes are
bitwise equal only under ``torch.use_deterministic_algorithms(True)``.

The reference's mesh and compile knobs have no counterpart here, since
torch runs eagerly: ``scan_layers``, ``seq_shard_attn``,
``seq_shard_acts``, ``inline_mask``, ``dus_cache_update`` and
``moe_impl`` (its ``shardmap`` form of the MoE); nor has
``max_seq_len``, which the reference declares and never reads.  The
reference's partitioning is here, at the end of the module: each leaf's
logical axes (``param_logical_axes``, ``cache_logical_axes``) and
``LM_RULES``, which ``sharding.partitioning`` resolves on a mesh; its
activation constraints (``_constrain``) move work between devices, not
values, and have none.

The KV-cache decode (the reference's serve step): :func:`init_cache`
gives ``{"k", "v"}`` of shape (L, B, S, K, hd) in the model dtype and
``"len"``, a 0-d int32 tensor; :func:`decode_step` embeds one token a
row, walks the layers in :func:`_stack_order`'s order, writes each
layer's new K/V in place at ``len`` before that layer's attention reads
the cache (the values of the reference's ``dus_cache_update=True`` and of
its ``where`` form alike), and returns float32 logits from the tied
``embed`` (:func:`lm_logits`) and the same cache, ``len`` advanced by
one in place (the reference donates its cache).  ``len`` is read on the
host once a step, which synchronises with the card there.  Attention
over the cache runs in chunks of positions: each chunk of K is cast to
float32 (the reference's float32 scores), so at most one chunk's float32
K or V is alive, never a layer's, and the query is grouped over the KV
heads (GQA), never the cache repeated.  An MoE layer's decode FFN is
:func:`_moe_token`: the reference's top-k with no capacity, so no token
is dropped, computed per chosen expert (each expert's weights read once
a step), not by gathering (t, k, d, f) weights.

On a mesh of rank processes (``sharding.make_mesh``) the reference's
GSPMD results are computed explicitly.  :func:`forward_hidden` with a
``mesh`` takes this rank's rows and returns the whole batch's MoE aux:
each layer's two E-vectors (:func:`_route`'s ``local_stats``) averaged
over the data axes before their product.  :func:`decode_step` on a
mesh steps this rank's block of a cache laid out by
:func:`cache_logical_axes`: its rows, its KV heads (the attention output
gathered in head order) and its range of positions (a softmax over every
rank's range, :func:`_decode_attention_split`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding import collectives
from repro_torch.sharding.layout import mean_over_data
from repro_torch.sharding.partitioning import (AxisRules, data_parallelism,
                                               spec_axes)
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
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1              # 1: every layer MoE; 2: dense / MoE
    n_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    pooling: str = "last"           # last | mean | first
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 0             # > 0: query-chunked attention
    remat: bool = True              # checkpoint each layer under autograd

    @property
    def n_dense_layers(self) -> int:
        if not self.moe:
            return self.n_layers
        return 0 if self.moe_every == 1 else self.n_layers // 2

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.moe else 0

    def param_count(self) -> int:
        """Parameters of :func:`param_shapes` (the reference's
        ``LMConfig.param_count()``)."""
        return sum(math.prod(s) for s in leaves(param_shapes(self)))

    def active_param_count(self) -> int:
        """Parameters a token touches: the MoE layers' unchosen experts
        left out (the reference's ``active_param_count()``)."""
        per_expert = 3 * self.d_model * self.moe_d_ff
        return self.param_count() - self.n_moe_layers * per_expert * (
            self.n_experts - self.top_k)


def param_shapes(cfg: LMConfig) -> dict:
    """Nested dict of parameter shapes, the reference's layout: the dense
    layers stacked in ``blocks``, the MoE layers in ``moe_blocks``."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
            "wo": (h, hd, d), "ln1": (d,), "ln2": (d,)}
    if cfg.qkv_bias:
        attn.update({"bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)})
    if cfg.norm == "layernorm":
        attn.update({"ln1_b": (d,), "ln2_b": (d,)})
    dense = dict(attn)
    if cfg.activation in ("swiglu", "geglu"):
        dense.update({"wi_gate": (d, f), "wi_up": (d, f), "wo_ffn": (f, d)})
    else:
        dense.update({"wi_up": (d, f), "wo_ffn": (f, d)})
    e, fe = cfg.n_experts, cfg.moe_d_ff
    moe = dict(attn, router=(d, e), we_gate=(e, d, fe), we_up=(e, d, fe),
               we_down=(e, fe, d))
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        moe.update({"ws_gate": (d, fs), "ws_up": (d, fs),
                    "ws_down": (fs, d)})
    shapes = {"embed": (cfg.vocab_size, d), "final_ln": (d,)}
    if cfg.norm == "layernorm":
        shapes["final_ln_b"] = (d,)
    for stack, depth, block in (("blocks", cfg.n_dense_layers, dense),
                                ("moe_blocks", cfg.n_moe_layers, moe)):
        if depth:
            shapes[stack] = {k: (depth,) + s for k, s in block.items()}
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


def capacity(cfg: LMConfig, s: int) -> int:
    """Slots each expert has in a row of ``s`` (padded) tokens."""
    return max(math.ceil(s * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor), 1)


def _route(cfg: LMConfig, h: torch.Tensor, router: torch.Tensor,
           local_stats: bool = False):
    """Token-choice top-k routing of normed rows ``h`` (B, S, d) over
    ``router`` (d, E): ``(gates, choice, slot, keep, aux)``.

    ``gates`` (B, S, k) float32 are the chosen probabilities divided by
    their sum, ``choice`` (B, S, k) the experts (equal probabilities go
    to the lower index), ``slot`` (B, S * k) each (s, k) pair's place
    ``expert * cap + rank`` in the dispatch buffer, or the sentinel
    ``E * cap`` where ``keep`` is false (the expert's ``cap`` slots were
    taken by earlier pairs, counted s-major), and ``aux`` the Switch
    load-balance loss ``E * sum_e density_e * mean_prob_e`` over every
    position, padding included.  With ``local_stats`` the last output is
    the aux's two E-vectors instead, (2, E) float32: the share of
    positions whose first choice is each expert (no gradient) and each
    expert's mean probability (:func:`_switch_aux` takes them)."""
    b, s, _ = h.shape
    e, kk = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    # the product in the model dtype, then float32, as the reference
    logits = torch.einsum("bsd,de->bse", h, router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, choice = gates[..., :kk], choice[..., :kk]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    density = F.one_hot(choice[..., 0], e).float().mean((0, 1))
    stats = torch.stack([density, probs.mean((0, 1))])
    e_flat = choice.reshape(b, s * kk)
    onehot = F.one_hot(e_flat, e)
    pos = (onehot.cumsum(1) - onehot).gather(-1, e_flat[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos,
                       torch.full_like(e_flat, e * cap))
    return gates, choice, slot, keep, (stats if local_stats
                                       else _switch_aux(cfg, stats))


def _switch_aux(cfg: LMConfig, stats: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss of :func:`_route`'s (2, E) local
    statistics: ``E * sum_e density_e * mean_prob_e``."""
    return cfg.n_experts * (stats[0] * stats[1]).sum()


def _moe_ffn(cfg: LMConfig, lp: Params, x, local_stats: bool = False):
    """The MoE FFN of one layer: ``(x + ffn(norm(x)), aux)``, or with
    ``local_stats`` ``(x + ffn(norm(x)), stats)``, the aux's two
    E-vectors over these rows (:func:`_route`), for a caller that
    averages them over a batch split across ranks first."""
    b, s, d = x.shape
    e, kk = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    h = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg.norm)
    gates, _, slot, _, aux = (_route(cfg, h, lp["router"], True)
                              if local_stats else
                              _route(cfg, h, lp["router"]))
    # dispatch: each kept slot's token index (s, a zero row, elsewhere);
    # the dropped pairs all write the sentinel column, which is cut off
    tok = torch.arange(s * kk, device=x.device).div(
        kk, rounding_mode="floor").expand(b, -1)
    dest = torch.full((b, e * cap + 1), s, dtype=torch.long,
                      device=x.device)
    dest = dest.scatter(1, slot, tok)[:, : e * cap]
    h_pad = torch.cat([h, h.new_zeros(b, 1, d)], dim=1)
    xin = h_pad.gather(1, dest[..., None].expand(-1, -1, d)).reshape(
        b, e, cap, d)
    hidden = _act(torch.einsum("becd,edf->becf", xin, lp["we_gate"]),
                  cfg.activation) * torch.einsum("becd,edf->becf", xin,
                                                 lp["we_up"])
    out = torch.einsum("becf,efd->becd", hidden, lp["we_down"])
    # combine: each (s, k) pair's expert output (a zero row if dropped),
    # weighted by its gate in the model dtype
    out_pad = torch.cat([out.reshape(b, e * cap, d),
                         out.new_zeros(b, 1, d)], dim=1)
    back = out_pad.gather(1, slot[..., None].expand(-1, -1, d)).reshape(
        b, s, kk, d)
    y = (back * gates[..., None].to(back.dtype)).sum(2)
    if cfg.n_shared_experts:
        y = y + _glu(cfg, h, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return x + y.to(x.dtype), aux


def _dense_layer(cfg: LMConfig, lp: Params, x, positions, mask):
    return _dense_ffn(cfg, lp, _attn_block(cfg, lp, x, positions, mask))


def _moe_layer(cfg: LMConfig, lp: Params, x, positions, mask,
               local_stats: bool = False):
    return _moe_ffn(cfg, lp, _attn_block(cfg, lp, x, positions, mask),
                    local_stats)


def _unstack(stack: Params) -> list[Params]:
    """One view per layer of each stacked weight: unbind's backward
    stacks the layers' gradients once, where indexing would write a
    zero-filled stack per layer and sum the stacks."""
    return [dict(zip(stack, ws)) for ws in zip(
        *(w.unbind(0) for w in stack.values()))]


def _stack_order(cfg: LMConfig, params: Params) -> list:
    """(is_moe, layer params) in the order the layers run: all dense,
    all MoE (``moe_every=1``), or dense / MoE pairs (``moe_every=2``:
    layer i is ``blocks[i // 2]`` when i is even, ``moe_blocks[i // 2]``
    when odd)."""
    dense = _unstack(params["blocks"]) if "blocks" in params else []
    moe = _unstack(params["moe_blocks"]) if "moe_blocks" in params else []
    if not cfg.moe:
        return [(False, lp) for lp in dense[: cfg.n_layers]]
    if cfg.moe_every == 1:
        return [(True, lp) for lp in moe[: cfg.n_layers]]
    return [(i % 2 == 1, (moe if i % 2 else dense)[i // 2])
            for i in range(cfg.n_layers)]


def forward_hidden(cfg: LMConfig, params: Params, tokens: torch.Tensor,
                   attn_mask: torch.Tensor, mesh=None):
    """tokens (B, S) int, attn_mask (B, S) {0,1} -> (hidden (B, S, d), the
    MoE aux loss summed over layers: a float32 scalar, 0.0 for a dense
    stack).

    On a ``mesh`` whose data axes split the batch, ``tokens`` are this
    rank's rows and the aux is the whole batch's: each MoE layer returns
    its rows' two E-vectors, which are averaged over the data axes
    outside the layer (a checkpointed layer recomputes in the backward,
    and a collective must not run twice) before their product
    (``sharding.layout.mean_over_data``, whose backward hands each rank
    the cotangent unchanged, as the meshed step's gradient mean
    expects)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=tokens.device))
    mask = causal[None] & attn_mask[:, None, :].bool()
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    split = mesh is not None and data_parallelism(mesh) > 1
    for is_moe, lp in _stack_order(cfg, params):
        layer = _moe_layer if is_moe else _dense_layer
        extra = (True,) if is_moe and split else ()
        if remat:
            # a MoE layer's aux (or statistics) is an output of its
            # checkpoint
            out = checkpoint(layer, cfg, lp, x, positions, mask, *extra,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = layer(cfg, lp, x, positions, mask, *extra)
        if is_moe:
            x, a = out
            if split:
                a = _switch_aux(cfg, mean_over_data(a, mesh))
            aux = aux + a
        else:
            x = out
    return (_norm(x, params["final_ln"], params.get("final_ln_b"),
                  cfg.norm), aux)


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
    return pool(cfg, forward_hidden(cfg, params, tokens, attn_mask)[0],
                attn_mask)


# A float32 block of the vocabulary in lm_logits, and a float32 chunk of
# one layer's K or V in the decode attention, at most this many bytes
LOGIT_BLOCK_BYTES = 256 * 2 ** 20
DECODE_CHUNK_BYTES = 256 * 2 ** 20
# positions a run of the decode attention's product with V sums in one
# product before the runs' partial sums are added
PV_SPLIT = 1024


def lm_logits(cfg: LMConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """float32 logits (..., V) of ``hidden`` (..., d) against the tied
    ``embed``: the reference's product with float32 accumulation.  The
    table is cast to float32 a block of LOGIT_BLOCK_BYTES at a time, so
    gemma-7b's 256,000-row vocabulary never has a whole float32 copy."""
    embed = params["embed"]
    v, d = embed.shape
    h = hidden.reshape(-1, d).float()
    out = torch.empty((h.shape[0], v), dtype=torch.float32,
                      device=hidden.device)
    rows = max(1, LOGIT_BLOCK_BYTES // (4 * d))
    for lo in range(0, v, rows):
        out[:, lo: lo + rows] = h @ embed[lo: lo + rows].float().T
    return out.reshape(*hidden.shape[:-1], v)



def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> Params:
    """An empty KV cache: ``k`` / ``v`` zeros of (L, B, S, K, hd) in the
    model dtype, ``len`` a 0-d int32 0."""
    dev = resolve_device(device)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def _decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      n: int) -> torch.Tensor:
    """One query position against the first ``n`` positions of a layer's
    cache: q (B, 1, H, hd), kc / vc (B, S, K, hd) -> (B, 1, H, hd).

    The reference's ``_attn_scores_softmax`` with its mask ``<= len``:
    the masked positions' -1e30 scores are exactly 0 after the softmax,
    so only the first ``n`` are read.  Scores are float32 products of the
    query and a float32 copy of a chunk of K, laid out (B, K, chunk, hd);
    the probabilities are rounded to the cache dtype (the reference's
    cast before its product with V) and summed against float32 chunks of
    V in float32, each chunk split into runs of PV_SPLIT positions whose
    partial sums are added after (a product over 524,288 positions into
    a (G, hd) output would otherwise run on a handful of blocks)."""
    b, _, h, hd = q.shape
    kh = kc.shape[2]
    qg = q.reshape(b, kh, h // kh, hd).float()
    spans = _decode_spans(qg, n)
    scores = _decode_scores(qg, kc, spans, n)
    probs = torch.softmax(scores, dim=-1)
    del scores
    return _decode_pv(probs, vc, spans, qg).to(vc.dtype).reshape(
        b, 1, h, hd)


def _decode_spans(qg: torch.Tensor, n: int) -> list:
    """The chunks of positions ``[0, n)`` whose float32 copy of K or V
    for ``qg`` (B, K, G, hd) stays within DECODE_CHUNK_BYTES."""
    b, kh, _, hd = qg.shape
    chunk = max(1, DECODE_CHUNK_BYTES // (4 * b * kh * hd))
    return [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]


def _f32_chunk(cache: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Positions ``[lo, hi)`` of a layer's cache (B, S, K, hd) as float32,
    laid out (B, K, hi - lo, hd)."""
    b, _, kh, hd = cache.shape
    out = torch.empty((b, kh, hi - lo, hd), dtype=torch.float32,
                      device=cache.device)
    return out.copy_(cache[:, lo:hi].transpose(1, 2))


def _decode_scores(qg: torch.Tensor, kc: torch.Tensor, spans: list,
                   n: int) -> torch.Tensor:
    """float32 scores (B, K, G, n) of ``qg`` against the first ``n``
    positions of ``kc``, divided by sqrt(hd)."""
    b, kh, g, hd = qg.shape
    scores = torch.empty((b, kh, g, n), dtype=torch.float32,
                         device=qg.device)
    for lo, hi in spans:
        scores[..., lo:hi] = qg @ _f32_chunk(kc, lo, hi).transpose(-1, -2)
    return scores.div_(math.sqrt(hd))


def _decode_pv(probs: torch.Tensor, vc: torch.Tensor, spans: list,
               qg: torch.Tensor) -> torch.Tensor:
    """float32 (B, K, G, hd): ``probs`` (B, K, G, n) rounded to the cache
    dtype, times the first n positions of ``vc`` in float32, a chunk's
    runs of PV_SPLIT positions summed apart, then added."""
    b, kh, g, hd = qg.shape
    out = torch.zeros_like(qg)
    for lo, hi in spans:
        p = probs[..., lo:hi].to(vc.dtype).float()
        vf = _f32_chunk(vc, lo, hi)
        runs = (hi - lo) // PV_SPLIT
        cut = runs * PV_SPLIT
        out += p[..., cut:] @ vf[:, :, cut:]
        if runs:
            pp = p[..., :cut].reshape(b, kh, g, runs, PV_SPLIT)
            vv = vf[:, :, :cut].reshape(b, kh, runs, PV_SPLIT, hd)
            out += (pp.transpose(2, 3) @ vv).sum(2)
    return out


def _moe_token(cfg: LMConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The decode step's MoE FFN of normed rows ``h`` (B, S, d): the
    reference's ``_moe_token`` (no residual; the shared expert added).

    Router product in the model dtype, float32 softmax, the top k from a
    stable descending sort (equal probabilities go to the lower index, as
    ``lax.top_k``), gates divided by their sum clipped at 1e-9.  There is
    no capacity: every (token, k) pair is computed, grouped by its expert
    so each chosen expert's three weights are read once (the reference
    gathers them per pair, (t, k, d, f) each); the pairs' outputs are
    summed over k weighted by the gates in the model dtype.  The experts'
    pair counts are read on the host, once a layer."""
    b, s, d = h.shape
    kk = cfg.top_k
    hh = h.reshape(b * s, d)
    probs = torch.softmax((hh @ lp["router"]).float(), dim=-1)
    gates, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, choice = gates[:, :kk], choice[:, :kk]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = choice.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    out = hh.new_empty((b * s * kk, d))
    lo = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        pairs = order[lo: lo + n]
        lo += n
        x = hh[pairs.div(kk, rounding_mode="floor")]
        hidden = _act(x @ lp["we_gate"][e], cfg.activation) * (
            x @ lp["we_up"][e])
        out[pairs] = hidden @ lp["we_down"][e]
    y = (out.reshape(b * s, kk, d) * gates[..., None].to(out.dtype)).sum(1)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + _glu(cfg, h, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return y


def _decode_attention_split(q: torch.Tensor, kc: torch.Tensor,
                            vc: torch.Tensor, n: int, mesh,
                            axes: tuple) -> torch.Tensor:
    """:func:`_decode_attention` over a cache whose positions are split
    over the mesh ``axes``: this rank's kc / vc hold one contiguous range,
    of which the first ``n`` (0 to all) are at or before ``len``.

    As the reference's softmax under GSPMD: local float32 scores; each
    rank's max and sum of exponentials, all-gathered and combined in rank
    order into the global ones; the probabilities normalised globally,
    then rounded to the cache dtype; the local product with V in float32;
    the (B, K, G, hd) partials summed over ``axes`` in rank order.  (A
    combine of unnormalised outputs, flash-decoding's, would round the
    probabilities before normalising them.)"""
    b, _, h, hd = q.shape
    kh = kc.shape[2]
    qg = q.reshape(b, kh, h // kh, hd).float()
    spans = _decode_spans(qg, n)
    scores = _decode_scores(qg, kc, spans, n)
    if n:
        top = scores.amax(-1)
        total = torch.exp(scores - top[..., None]).sum(-1)
    else:
        top = torch.full(qg.shape[:-1], -math.inf, device=q.device)
        total = torch.zeros_like(top)
    ranks = collectives.all_gather(torch.stack([top, total])[None], mesh,
                                   axes, dim=0)
    top = ranks[:, 0].amax(0)
    total = torch.zeros_like(top)
    for r in range(ranks.shape[0]):
        total += ranks[r, 1] * torch.exp(ranks[r, 0] - top)
    probs = scores.sub_(top[..., None]).exp_().div_(total[..., None])
    out = collectives.all_reduce(_decode_pv(probs, vc, spans, qg), mesh,
                                 axes)
    return out.to(vc.dtype).reshape(b, 1, h, hd)


def decode_step(cfg: LMConfig, params: Params, cache: Params,
                tokens: torch.Tensor, mesh=None, spec=()):
    """One decode step: tokens (B,) int -> (logits (B, V) float32, cache).

    Each row's token sits at position ``len``: per layer, its K / V are
    written into the cache at ``len`` in place, then it attends to
    positions ``0..len``.  The cache returned is the one passed in, its
    ``len`` advanced by one in place.  ``len`` is read on the host here
    (a sync with the card once a step).

    On a ``mesh``, ``cache`` is this rank's block of a cache laid out by
    ``spec`` (the k / v spec of :func:`cache_logical_axes` resolved on
    ``mesh``), with the whole parameters and the whole batch's ``tokens``;
    every rank returns the whole (B, V) logits:

      * **rows**: where the batch dim is split, the rank embeds and runs
        only its rows; the logits are gathered over those axes;
      * **KV heads**: where they are split, the rank attends only with its
        KV heads and their query groups, and the (B, 1, H, hd) output is
        gathered over those axes in head order before ``wo``;
      * **positions**: where the sequence is split, each rank holds a
        contiguous range and attends as :func:`_decode_attention_split`.

    The rank that holds position ``len`` writes the new K / V there (its
    rows and heads); ``len`` is replicated and every rank advances it.
    The projections, FFN, :func:`_moe_token` and :func:`lm_logits` run on
    the rank's rows, repeated on ranks that share them.  With no axis
    split (no mesh) the views are whole and no collective runs."""
    dims = tuple(spec) + (None,) * (5 - len(spec))
    rows, seq, heads = (spec_axes(e) for e in dims[1:4])
    b_loc, s_loc, kh_loc = cache["k"].shape[1:4]
    pos = int(cache["len"])
    max_len = s_loc * (mesh.axis_size(seq) if seq else 1)
    if not 0 <= pos < max_len:
        raise ValueError(f"cache len {pos} outside [0, {max_len})")
    r0 = mesh.shard_index(rows) * b_loc if rows else 0
    k0 = mesh.shard_index(heads) * kh_loc if heads else 0
    lo = mesh.shard_index(seq) * s_loc if seq else 0
    g = cfg.n_heads // cfg.n_kv_heads
    toks = tokens[r0: r0 + b_loc]
    x = params["embed"][toks.long()[:, None]].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    positions = torch.full((b_loc, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    for i, (is_moe, lp) in enumerate(_stack_order(cfg, params)):
        hn = _norm(x, lp["ln1"], lp.get("ln1_b"), cfg.norm)
        q = torch.einsum("bsd,dhk->bshk", hn, lp["wq"])
        k = torch.einsum("bsd,dhk->bshk", hn, lp["wk"])
        v = torch.einsum("bsd,dhk->bshk", hn, lp["wv"])
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = _rope(q, positions, cfg.rope_theta)[:, :, k0 * g:
                                                (k0 + kh_loc) * g]
        k = _rope(k, positions, cfg.rope_theta)[:, :, k0: k0 + kh_loc]
        v = v[:, :, k0: k0 + kh_loc]
        kc, vc = cache["k"][i], cache["v"][i]
        if lo <= pos < lo + s_loc:
            kc[:, pos - lo] = k[:, 0]
            vc[:, pos - lo] = v[:, 0]
        if seq:
            out = _decode_attention_split(
                q, kc, vc, min(max(pos + 1 - lo, 0), s_loc), mesh, seq)
        else:
            out = _decode_attention(q, kc, vc, pos + 1)
        if heads:
            out = collectives.all_gather(out, mesh, heads, dim=2)
        x = x + torch.einsum("bshk,hkd->bsd", out, lp["wo"])
        hn = _norm(x, lp["ln2"], lp.get("ln2_b"), cfg.norm)
        if is_moe:
            x = x + _moe_token(cfg, lp, hn)
        else:
            x = x + _glu(cfg, hn, lp.get("wi_gate"), lp["wi_up"],
                         lp["wo_ffn"])
    x = _norm(x, params["final_ln"], params.get("final_ln_b"), cfg.norm)
    cache["len"].add_(1)
    logits = lm_logits(cfg, params, x)[:, 0]
    if rows:
        logits = collectives.all_gather(logits, mesh, rows, dim=0)
    return logits, cache


# ---------------------------------------------------------------------------
# Partitioning: logical axes of the parameters and the KV cache
# ---------------------------------------------------------------------------

# Logical axes of each leaf (without the stacked layer axis): d_model rows
# FSDP-sharded, heads / ffn / experts tensor-parallel (the reference's
# ``_AXES``)
_AXES = {
    # attention
    "wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None), "wo": ("heads", None, "fsdp"),
    "bq": ("heads", None), "bk": ("kv_heads", None), "bv": ("kv_heads", None),
    "ln1": (None,), "ln2": (None,), "ln1_b": (None,), "ln2_b": (None,),
    # dense FFN
    "wi_gate": ("fsdp", "ffn"), "wi_up": ("fsdp", "ffn"),
    "wo_ffn": ("ffn", "fsdp"),
    # MoE
    "router": ("fsdp", None),
    "we_gate": ("experts", "fsdp", "expert_ffn"),
    "we_up": ("experts", "fsdp", "expert_ffn"),
    "we_down": ("experts", "expert_ffn", "fsdp"),
    "ws_gate": ("fsdp", "ffn"), "ws_up": ("fsdp", "ffn"),
    "ws_down": ("ffn", "fsdp"),
    # top level
    "embed": ("vocab", "embed"),
    "final_ln": (None,), "final_ln_b": (None,),
}

# The FSDP rule: weight rows over the data-parallel axes; seq_model: the
# cache's sequence over "model" where the KV heads do not divide it.
LM_RULES = AxisRules().with_overrides(fsdp=("pod", "data"),
                                      seq_model=("model",),
                                      kv_seq_full=("pod", "data", "model"))


def param_logical_axes(cfg: LMConfig) -> Params:
    """The logical axes of every leaf of :func:`param_shapes`, a stacked
    leaf's first axis ``"layers"``."""
    def axes(name: str, shape) -> tuple:
        base = _AXES[name]
        return ("layers",) + base if len(base) + 1 == len(shape) else base

    return {name: ({k: axes(k, s) for k, s in shape.items()}
                   if isinstance(shape, dict) else axes(name, shape))
            for name, shape in param_shapes(cfg).items()}


def cache_logical_axes(cfg: LMConfig, batch: int,
                       tp_divides_kv: bool = True) -> Params:
    """The KV cache's logical axes (the reference's): at batch 1 (long
    context) the sequence over the data axes (and "model" too when the KV
    heads do not divide it); above 1 the batch over the data axes and the
    KV heads over "model" where they divide it, else the sequence."""
    if batch == 1:
        seq_axis = "kv_seq" if tp_divides_kv else "kv_seq_full"
        kv = ("layers", None, seq_axis, "kv_heads", None)
    elif tp_divides_kv:
        kv = ("layers", "batch", None, "kv_heads", None)
    else:
        kv = ("layers", "batch", "seq_model", None, None)
    return {"k": kv, "v": kv, "len": ()}

"""Roofline terms of a step on one H100, from counted FLOPs and bytes.

The counterpart of ``repro.launch.roofline`` for one card.  Three terms
per (arch x shape), in seconds:

    compute    = sum over dtypes of that dtype's FLOPs / its peak rate
    memory     = bytes / HBM_BW
    collective = collective bytes / NVLINK_BW   (0 on one card)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()``; eager
torch has none, so :class:`CostMode` counts them over one step (on meta,
CPU or CUDA tensors alike).  The compute term is split by dtype because
the port runs its float32 products (attention scores, the recsys MLPs,
the GNN) with TF32 off (``repro_torch/device.py``): one bf16 peak would
understate their time about 15-fold.  ``model_flops`` (6 N D train, 2 N D
inference) gives the useful-compute ratio, and ``analytic_bytes`` the
reference's fusion-aware traffic model, both copied as they are, at one
card.  The HLO collective parsers (``collective_bytes``,
``collective_breakdown``) wait for a mesh (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import traceback
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# H100 80GB HBM3 (SXM) data-sheet peaks, dense, at its 700 W limit: bf16 /
# fp16 on the tensor cores, float32 outside them (TF32 is off), float64
# outside them; HBM; NVLink, one direction.
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 67e12, "float64": 34e12}
F32_FLOPS = PEAK_FLOPS["float32"]
HBM_BW = 3.35e12            # bytes/s
NVLINK_BW = 450e9           # bytes/s a direction
HBM_BYTES = 80e9            # device memory of one card

aten = torch.ops.aten
# ops that move no bytes: allocation without a write, and metadata
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.lift_fresh, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.is_same_size, aten._local_scalar_dense}
# copies, which between two devices are a transfer, not device traffic
_COPIES = {aten._to_copy, aten.copy_}
# reads of a device value on the host: on meta there is none to read
_HOST_READS = {getattr(aten, name) for name in (
    "_local_scalar_dense", "_to_copy", "copy_", "bincount", "nonzero",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "masked_select") if hasattr(aten, name)}


class HostRead(RuntimeError):
    """A step read a device value on the host (``int()``, ``.item()``,
    ``.tolist()``, a data-dependent shape) under :class:`CostMode` on meta
    tensors, which hold no value; ``where`` is the port's ``file:line``."""

    def __init__(self, where: str, op: str):
        super().__init__(f"host read of a device value at {where} ({op})")
        self.where = where


def _tensors(*items) -> list:
    """The tensors among an aten op's arguments or results: a tensor, or
    a list or tuple of them (``cat``, the ``_foreach`` ops, multiple
    outputs), at the top level of ``items`` or of a kwargs dict."""
    out = []
    for item in items:
        for x in (item.values() if isinstance(item, dict) else
                  item if isinstance(item, (list, tuple)) else (item,)):
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _caller() -> str:
    """``src/repro_torch/...:line`` of the innermost frame of the port
    below this module (the line that read the value)."""
    for frame in reversed(traceback.extract_stack()):
        path = frame.filename.replace("\\", "/")
        if "/repro_torch/" in path and not path.endswith(
                "/launch/roofline.py"):
            return "src/" + path[path.rindex("repro_torch/"):] + \
                f":{frame.lineno}"
    return "unknown"


class CostMode(TorchDispatchMode):
    """Count one step's FLOPs (by dtype) and bytes, the port's
    ``cost_analysis()``.

    Every aten op the step dispatches (forward, autograd's backward,
    which runs under the mode too, and the optimizer) is counted:

    - FLOPs by ``torch.utils.flop_counter``'s registered formulas (the
      matmul family, convolutions, attention), keyed by the dtype of the
      op's first tensor input;
    - bytes as the op's tensor inputs plus its outputs, each once; views
      and metadata ops (``func.is_view``, allocation without a write)
      count 0, and a copy between two devices (a host constant moved to
      the card) counts its output under ``transfer_bytes`` instead: it
      crosses the host link, not device memory (on the CPU there is no
      such copy, so a CPU count and a meta or card count agree).

    The kernel wrappers add their own calls through
    :meth:`kernel_report` (``kernels.topk.report_cost``): their FLOPs and
    bytes as ``PERF.md`` §6's bound counts them, under ``kernels``, and
    into the totals.  The mode runs the same way on meta, CPU and CUDA
    tensors: on meta it allocates nothing, and a read of a device value
    on the host raises :class:`HostRead` naming the line.

    How it differs from XLA's count: XLA counts every elementwise FLOP,
    this counts the matmul family only (so the compute term is a lower
    bound, as the reference's 6 N D is); XLA's bytes are those of fused
    HLO, these are those of unfused eager ops, which on the card is the
    traffic eager torch really moves (a reduction, a cast or a scale is
    one more read and write of its tensor).
    """

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.transfer_bytes = 0
        self.kernels: dict[str, dict] = {}
        self._rules: dict[int, tuple] = {}

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def kernel_report(self, name: str, flops_by_dtype: dict,
                      nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        for dt, n in flops_by_dtype.items():
            k["flops"] += int(n)
            self.flops_by_dtype[dt] += int(n)
        k["bytes"] += int(nbytes)
        self.bytes += int(nbytes)

    def _rule(self, func) -> tuple:
        """(host read?, FLOP formula or None, moves no bytes?, a copy?)
        of an op, looked up once an op."""
        rule = self._rules.get(id(func))
        if rule is None:
            packet = func._overloadpacket
            rule = self._rules[id(func)] = (
                packet in _HOST_READS, flop_registry.get(packet),
                func.is_view or packet in _FREE, packet in _COPIES)
        return rule

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        host_read, flop, free, copy = self._rule(func)
        ins = _tensors(args, kwargs)
        if host_read and any(t.is_meta for t in ins):
            try:
                out = func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                raise HostRead(_caller(), str(func)) from e
        else:
            out = func(*args, **kwargs)
        if flop is not None:
            n = flop(*args, **kwargs, out_val=out)
            self.flops_by_dtype[str(ins[0].dtype).removeprefix("torch.")] += \
                int(n)
        if free:
            return out
        outs = _tensors(out)
        if copy and len({t.device for t in ins + outs}) > 1:
            self.transfer_bytes += _nbytes(outs)
        else:
            self.bytes += _nbytes(ins) + _nbytes(outs)
        return out

    def cost(self) -> dict:
        """``{"flops", "flops_by_dtype", "bytes", "transfer_bytes"}``, the
        record's ``cost``."""
        return {"flops": self.flops,
                "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
                "bytes": self.bytes, "transfer_bytes": self.transfer_bytes}


def compute_seconds(flops_by_dtype: dict) -> float:
    """The compute term: each dtype's FLOPs over its peak rate."""
    return sum(n / PEAK_FLOPS[dt] for dt, n in flops_by_dtype.items())


def bound_ms(cost: tuple[int, int]) -> tuple[float, str]:
    """A kernel's least time on the card for ``(float32 operations,
    bytes)`` (the ``kernels.*_cost`` functions): the larger of the bytes
    over HBM_BW and the operations over the float32 rate, in ms, and which
    of the two it is (``"bytes"`` or ``"operations"``)."""
    t_ops = cost[0] / F32_FLOPS * 1e3
    t_bytes = cost[1] / HBM_BW * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def roofline_terms(cost: dict, coll_bytes: int) -> dict[str, float]:
    """The three terms of one step from its ``cost`` (:meth:`CostMode.cost`)
    and its collective bytes (0 on one card)."""
    flops = float(cost.get("flops", 0))
    bytes_acc = float(cost.get("bytes", 0))
    compute_s = compute_seconds(cost.get("flops_by_dtype", {}))
    memory_s = bytes_acc / HBM_BW
    collective_s = coll_bytes / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms.update({
        "dominant": dom,
        "step_lower_bound_s": bound,
        "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": float(coll_bytes),
    })
    return terms


# -- MODEL_FLOPS (useful compute), the reference's forms ----------------------

def lm_model_flops(arch, shape_name: str) -> float:
    """6*N_active*D for train, 2*N_active*D for inference (global)."""
    cfg = arch.cfg
    spec = arch.shapes[shape_name]
    n_active = cfg.active_param_count()
    b, s = spec["global_batch"], spec["seq_len"]
    if spec["kind"] == "train":
        tokens = 2 * b * s                     # query + passage towers
        return 6.0 * n_active * tokens
    if spec["kind"] == "encode":
        return 2.0 * n_active * b * s
    # decode: 1 token/seq; attention reads dominate but count param-flops
    kv_flops = (2.0 * b * s * cfg.n_layers
                * cfg.n_kv_heads * cfg.head_dim * 2)
    return 2.0 * n_active * b + kv_flops


def gnn_model_flops(arch, shape_name: str) -> float:
    spec = arch.shapes[shape_name]
    cfg = arch.shape_cfg(shape_name)
    d0, dh = cfg.d_feat, cfg.d_hidden
    per_node = 2 * (d0 * dh * 2 + dh * dh * 2)       # 2 layers, self+neigh
    if spec["mode"] == "full":
        n = spec["n_nodes"]
        e = spec["n_edges"]
        msgs = 2 * e * (d0 + dh)                      # gather+reduce adds
        return 3.0 * (n * per_node + msgs)            # fwd+bwd
    if spec["mode"] == "minibatch":
        b = spec["batch_nodes"]
        f1, f2 = spec["fanouts"]
        nodes = 2 * b * (1 + f1 + f1 * f2)            # anchor+positive trees
        return 3.0 * nodes * per_node
    g, n = spec["n_graphs"], spec["n_nodes"]
    return 3.0 * 2 * g * n * per_node


def recsys_model_flops(arch, shape_name: str) -> float:
    spec = arch.shapes[shape_name]
    cfg = arch.cfg
    d = cfg.embed_dim
    f = cfg.n_fields
    mlp_in = {"deepfm": f * d, "wide_deep": f * d,
              "autoint": f * cfg.n_heads * cfg.d_attn,
              "bst": (cfg.seq_len + 1 + cfg.n_profile_fields) * d}[cfg.kind]
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    inter = 0
    if cfg.kind == "autoint":
        d_in = d
        for _ in range(cfg.n_attn_layers):
            dh = cfg.n_heads * cfg.d_attn
            inter += 2 * f * d_in * dh * 4 + 2 * f * f * dh * 2
            d_in = dh
        mlp = 2 * f * d_in * 1
    if cfg.kind == "bst":
        s = cfg.seq_len + 1
        inter = 2 * s * d * d * 4 + 2 * s * s * d * 2 + \
            2 * s * d * cfg.bst_d_ff * 2
    if cfg.kind == "deepfm":
        inter = 2 * f * d * 2
    per_ex = mlp + inter + f * d                      # + embedding reads
    b = (spec["n_candidates"] if spec["kind"] == "retrieval"
         else spec["batch"])
    mult = 3.0 if spec["kind"] == "train" else 1.0
    return mult * per_ex * b


def model_flops(arch, shape_name: str) -> float:
    return {"lm": lm_model_flops, "gnn": gnn_model_flops,
            "recsys": recsys_model_flops}[arch.family](arch, shape_name)


# -- analytic HBM-traffic model, the reference's at one card ------------------
# Closed forms of a step's HBM traffic under fusion: weights stream once
# per pass, activations r/w at layer boundaries, the attention score
# matrix r/w unless a flash kernel is used.  The reference divides by its
# mesh's data (dp) and model (tp) axes; one card is dp = tp = 1, where
# its sequence-sharding branches give the same numbers as these.

def lm_analytic_bytes(arch, shape_name: str,
                      flash_attn: bool = False) -> float:
    cfg = arch.cfg
    spec = arch.shapes[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    bpe = 2
    p_total = cfg.param_count()

    if spec["kind"] == "serve":
        # decode: read the params + the cache once
        cache = float(cfg.n_layers * b * s * cfg.n_kv_heads * cfg.head_dim
                      * 2 * bpe)
        if cfg.moe:
            # only active experts' weights are read per token
            active = cfg.active_param_count()
            p_read = float(active) * bpe * max(1, b)
        else:
            p_read = float(p_total) * bpe  # weights stream once
        return p_read + cache

    passes = 3.0 if spec["kind"] == "train" else 1.0
    # weights stream through the card once per pass
    w_traffic = passes * p_total * bpe
    if spec["kind"] == "train":
        w_traffic += p_total * (4 + 4) * 2      # grads + opt r/w fp32
    # activation boundaries: ~6 r/w of (B,S,d) per layer per pass
    act = passes * cfg.n_layers * 6 * b * s * cfg.d_model * bpe
    # attention scores: r/w of (B,*,Sq,Skv) fp32 per layer unless flash
    scores = 0.0
    if not flash_attn and s > 1:
        heads = cfg.n_kv_heads * (cfg.n_heads // cfg.n_kv_heads)
        scores = passes * cfg.n_layers * 4 * b * heads * s * s * 4
    # MoE expert weights: all experts stream per pass
    moe = 0.0
    if cfg.moe:
        moe = passes * cfg.n_moe_layers * cfg.n_experts * 3 * \
            cfg.d_model * cfg.moe_d_ff * bpe
    return w_traffic + act + scores + moe


def gnn_analytic_bytes(arch, shape_name: str) -> float:
    spec = arch.shapes[shape_name]
    cfg = arch.shape_cfg(shape_name)
    if spec["mode"] == "full":
        n, e = spec["n_nodes"], spec["n_edges"]
        per = (n * (cfg.d_feat + 4 * cfg.d_hidden)
               + 2 * e * (cfg.d_feat + cfg.d_hidden)) * 4
        return 3.0 * per
    if spec["mode"] == "minibatch":
        b = spec["batch_nodes"]
        f1, f2 = spec["fanouts"]
        nodes = 2 * b * (1 + f1 + f1 * f2)
        return 3.0 * 4 * nodes * max(cfg.d_feat, cfg.d_hidden) * 4
    g, n = spec["n_graphs"], spec["n_nodes"]
    return 3.0 * 4 * 2 * g * n * max(cfg.d_feat, cfg.d_hidden) * 4


def recsys_analytic_bytes(arch, shape_name: str) -> float:
    spec = arch.shapes[shape_name]
    cfg = arch.cfg
    b = (spec["n_candidates"] if spec["kind"] == "retrieval"
         else spec["batch"])
    rows = b * cfg.n_fields * cfg.embed_dim * 4           # gathered rows
    mlp_params = sum(a * bb for a, bb in zip(
        ((cfg.n_fields * cfg.embed_dim,) + tuple(cfg.mlp_dims)),
        (tuple(cfg.mlp_dims) + (1,)))) * 4
    act = b * (cfg.n_fields * cfg.embed_dim
               + sum(cfg.mlp_dims) + 1) * 4 * 2
    passes = 3.0 if spec["kind"] == "train" else 1.0
    table_grad = 0.0
    if spec["kind"] == "train":
        # dense scatter-add gradient + adamw update over the table
        table_grad = cfg.total_vocab * cfg.embed_dim * 4 * 4
    return passes * (rows + mlp_params + act) + table_grad


def analytic_bytes(arch, shape_name: str, flash_attn: bool = False) -> float:
    if arch.family == "lm":
        return lm_analytic_bytes(arch, shape_name, flash_attn)
    if arch.family == "gnn":
        return gnn_analytic_bytes(arch, shape_name)
    return recsys_analytic_bytes(arch, shape_name)

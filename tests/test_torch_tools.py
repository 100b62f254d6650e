"""The analysis tools (``repro_torch.launch.{roofline,memmodel,dryrun,
report,hillclimb}``) against the reference's, on the CPU.

* The 40 (arch x shape) cells of ``all_cells()`` equal the reference's,
  in order.
* ``model_flops``, ``analytic_bytes`` (the reference's at mesh shape
  ``{}``), ``activation_bytes`` and ``grad_transient_bytes`` equal the
  reference's exactly on every cell, one case a cell; the bytes of the
  dry run's meta arguments equal the reference's
  ``args_bytes_per_device(cell.abstract_args)`` on every cell, and the
  memory model's state-and-args differs only where the port keeps its
  own inputs (a full graph's neighbour table, :data:`PORT_INPUTS`).
* ``roofline_terms`` on hand-made costs.
* ``CostMode``: one ``torch.mm`` (2 m k n FLOPs, 4 (mk + kn + mn)
  bytes); a reduced dense LM encode cell equal on CPU and on meta and
  equal to the closed form of its products; a train cell with remat on
  counting one forward of every layer more than with it off, less each
  layer's last product, which the checkpoint does not recompute.
* The kernel wrappers on meta: the CPU's ValueErrors, no launch counted,
  their reports' numbers.
* ``run_cell`` on every reduced cell and on the reference's four mini
  cells at full width (each under a time limit of its own), ``main()``
  writing records that ``report`` reads back, the hill-climb's variants
  and refusals, ``--multi-pod`` raising item 10.
"""

import json
import os

import pytest
import torch

import repro.configs as ref_configs
from repro.launch import memmodel as ref_memmodel
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_NAMES, all_cells, get_arch
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import ops, topk
from repro_torch.launch import dryrun, hillclimb, memmodel, report, roofline

CELLS = ref_configs.all_cells()
META = torch.device("meta")
# cells whose memory model counts inputs the reference's cell does not
# hold: a full graph's batch carries its neighbour table
PORT_INPUTS = {("graphsage-reddit", "full_graph_sm"),
               ("graphsage-reddit", "ogb_products")}
# cells whose step reads a device value on the host, and the line
HOST_READS = {"lm serve": "src/repro_torch/models/transformer.py",
              "gnn full": "src/repro_torch/models/gnn.py",
              "gnn batched": "src/repro_torch/models/gnn.py"}


class _OneDevice:
    """The reference's mesh at one device: no axis."""
    shape = {}


def _ids(cell):
    return f"{cell[0]}:{cell[1]}"


def test_all_cells_equal_the_reference():
    assert all_cells() == CELLS
    assert len(CELLS) == 40
    assert ARCH_NAMES == ref_configs.ARCH_NAMES


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_closed_forms_equal_the_reference(cell):
    name, shape = cell
    ref_arch, arch = ref_configs.get_arch(name), get_arch(name)
    assert roofline.model_flops(arch, shape) == \
        ref_roofline.model_flops(ref_arch, shape)
    for flash in (False, True):
        assert roofline.analytic_bytes(arch, shape, flash) == \
            ref_roofline.analytic_bytes(ref_arch, shape, {}, flash)
    assert memmodel.activation_bytes(arch, shape) == \
        ref_memmodel.activation_bytes(ref_arch, shape, _OneDevice)
    ref_cell = ref_arch.build_cell(shape, mesh=None)
    ref_mm = ref_memmodel.memory_model(ref_arch, shape, _OneDevice, ref_cell)
    port_cell = arch.build_cell(shape, device=META)
    args = dryrun.meta_args(arch, shape, port_cell)
    mm = memmodel.memory_model(arch, shape, port_cell, args)
    assert mm["grad_transient_bytes"] == ref_mm["grad_transient_bytes"]
    assert mm["activation_bytes"] == ref_mm["activation_bytes"]
    assert memmodel.args_bytes(args) == \
        ref_memmodel.args_bytes_per_device(ref_cell.abstract_args)
    table = mm["neighbor_table_bytes"]
    assert (table > 0) == (cell in PORT_INPUTS)
    assert mm["state_and_args_bytes"] == \
        ref_mm["state_and_args_bytes"] + table
    assert mm["fits_80GB"] == (mm["total_bytes"] < 80e9)


def test_neighbor_table_bytes_at_the_least_width():
    arch = get_arch("graphsage-reddit")
    # ogb_products padded to 2,449,408 nodes and 61,859,328 edges: at
    # least 26 slots a node
    n, width = 2_449_408, 26
    assert memmodel.neighbor_table_bytes(arch, "ogb_products") == \
        12 * n * width + 4 * n
    assert memmodel.neighbor_table_bytes(arch, "minibatch_lg") == 0


def test_roofline_terms_on_hand_made_costs():
    t = roofline.roofline_terms(
        {"flops": 989.4e12 + 67e12,
         "flops_by_dtype": {"bfloat16": 989.4e12, "float32": 67e12},
         "bytes": 3.35e12}, 0)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == 0.0
    assert t["dominant"] == "compute_s"
    assert t["step_lower_bound_s"] == pytest.approx(2.0)
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = roofline.roofline_terms(
        {"flops": 67e9, "flops_by_dtype": {"float32": 67e9},
         "bytes": 6.7e9}, 450e9)
    assert t["dominant"] == "collective_s"
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2e-3)
    assert t["roofline_fraction"] == pytest.approx(1e-3)
    assert t["flops_per_device"] == 67e9
    # a float32 FLOP costs ~15 bf16 ones: the terms keep dtypes apart
    assert roofline.compute_seconds({"float32": 1e12}) > \
        14 * roofline.compute_seconds({"bfloat16": 1e12})
    assert roofline.bound_ms((67e9, 0)) == (pytest.approx(1.0),
                                           "operations")
    assert roofline.bound_ms((0, 3.35e9)) == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("device", ("cpu", "meta"))
def test_costmode_counts_one_mm(device):
    m, k, n = 7, 5, 3
    a = torch.ones((m, k), device=device)
    b = torch.ones((k, n), device=device)
    with roofline.CostMode() as mode:
        torch.mm(a, b)
        a.t()                                # a view: no bytes
        torch.empty((100, 100), device=device)
    assert mode.flops_by_dtype == {"float32": 2 * m * k * n}
    assert mode.bytes == 4 * (m * k + k * n + m * n)
    assert mode.kernels == {}


def _encode_flops(cfg, b: int, s: int) -> int:
    """The products of ``transformer.encode`` on (B, S) tokens: per layer
    the Q / K / V / O projections, the scores and their product with V
    (every query against every key), the GLU's three products."""
    t, d, h, kv, hd, f = (b * s, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    per_layer = (2 * t * d * (h + 2 * kv) * hd + 2 * 2 * b * h * s * s * hd
                 + 2 * t * h * hd * d + 3 * 2 * t * d * f)
    return cfg.n_layers * per_layer


def _real(t, g):
    if t.dtype == torch.int32:
        return torch.randint(3, 500, t.shape, generator=g, dtype=torch.int32)
    return torch.randn(t.shape, generator=g).to(t.dtype)


def _to_cpu(tree, g):
    if isinstance(tree, dict):
        return {k: _to_cpu(v, g) for k, v in tree.items()}
    return _real(tree, g)


def test_costmode_encode_cell_cpu_equals_meta_equals_closed_form():
    arch = get_arch("qwen2-0.5b").reduced()
    shape = "prefill_32k"
    spec = arch.shapes[shape]
    cell = arch.build_cell(shape, device=META)
    params, batch = dryrun.meta_args(arch, shape, cell)
    meta = dryrun.count_cell(cell, (params, batch))
    g = torch.Generator().manual_seed(0)
    cpu_args = (_to_cpu(params, g), _to_cpu(batch, g))
    cpu_args[1]["mask"].fill_(1)
    cpu_cell = arch.build_cell(shape, device="cpu")
    cpu = dryrun.count_cell(cpu_cell, cpu_args)
    want = _encode_flops(arch.cfg, spec["global_batch"], spec["seq_len"])
    assert meta.flops_by_dtype == {"float32": want}
    assert cpu.flops_by_dtype == meta.flops_by_dtype
    assert cpu.bytes == meta.bytes > 0


def test_costmode_remat_counts_one_more_forward():
    arch = get_arch("qwen2-0.5b").reduced()
    spec = arch.shapes["train_4k"]
    counts = {}
    for remat in (False, True):
        a = arch.variant(remat=remat)
        cell = a.build_cell("train_4k", device=META)
        counts[remat] = dryrun.count_cell(
            cell, dryrun.meta_args(a, "train_4k", cell)).flops
    # the query and passage towers each recompute their layers' forward,
    # but for each layer's last product (the FFN's down projection): the
    # non-reentrant checkpoint stops recomputing once the backward has
    # the tensors it saved, and that product's output is not one of them
    cfg, b, s = arch.cfg, spec["global_batch"], spec["seq_len"]
    down = cfg.n_layers * 2 * b * s * cfg.d_ff * cfg.d_model
    assert counts[True] - counts[False] == 2 * (_encode_flops(cfg, b, s)
                                                - down)


def _bag_inputs(device, b=6, n_slots=4, v=9, d=3):
    return (torch.empty((b, d), device=device),
            torch.zeros((v, d), device=device),
            torch.zeros((b, n_slots), dtype=torch.int32, device=device),
            torch.ones((b, n_slots), device=device))


def _errors(fn, device):
    try:
        fn(device)
    except (ValueError, TypeError) as e:
        return type(e), str(e).replace(device, "DEV")
    return None


@pytest.mark.parametrize("case", ("bag_out_shape", "bag_idx_dtype",
                                  "bag_weights_shape", "bwd_out_cols",
                                  "k2_chunk_ids", "k2_k_too_big",
                                  "k1_queries"))
def test_wrappers_raise_the_same_on_meta(case):
    def call(device):
        out, table, idx, w = _bag_inputs(device)
        if case == "bag_out_shape":
            bag.embedding_bag_(out[:5], table, idx, w)
        elif case == "bag_idx_dtype":
            bag.embedding_bag_(out, table, idx.long(), w)
        elif case == "bag_weights_shape":
            bag.embedding_bag_(out, table, idx, w[:, :2].contiguous())
        elif case == "bwd_out_cols":
            bag.embedding_bag_backward_(torch.empty((9, 2), device=device),
                                        out, idx, w)
        elif case == "k2_chunk_ids":
            v, i = ops.empty_state(2, 3, device)
            topk.topk_update_(v, i, torch.zeros((2, 5), device=device),
                              torch.arange(4, dtype=torch.int32,
                                           device=device))
        elif case == "k2_k_too_big":
            v, i = ops.empty_state(2, topk.MAX_K + 1, device)
            topk.topk_update_(v, i, torch.zeros((2, 5), device=device),
                              torch.arange(5, dtype=torch.int32,
                                           device=device))
        else:
            v, i = ops.empty_state(2, 3, device)
            z = torch.zeros(1, dtype=torch.int32, device=device)
            topk.fused_score_topk_(v, i, torch.zeros((2, 4), device=device),
                                   torch.zeros((1, 8, 5), device=device),
                                   z, z)

    ops.reset_launch_counts()
    cpu = _errors(call, "cpu")
    assert cpu is not None
    assert _errors(call, "meta") == cpu
    assert set(ops.launch_counts().values()) == {0}


def test_wrappers_report_on_meta_and_launch_nothing():
    ops.reset_launch_counts()
    b, n_slots, v, d = 6, 4, 9, 3
    out, table, idx, w = _bag_inputs("meta", b, n_slots, v, d)
    with roofline.CostMode() as mode:
        bag.embedding_bag_(out, table, idx, w)
        bag.embedding_bag_backward_(torch.empty((v, d), device=META), out,
                                    idx, None)
        vals, ids = ops.empty_state(5, 10, META)
        ops.topk_update(vals, ids, torch.zeros((5, 300), device=META),
                        torch.arange(300, device=META))
        ops.fused_score_topk(torch.zeros((5, 16), device=META),
                             torch.zeros((40, 16), device=META), 10)
    assert set(ops.launch_counts().values()) == {0}
    assert mode.kernels == {
        "embedding_bag": {"calls": 1, "flops": 2 * b * n_slots * d,
                          "bytes": 4 * 2 * b * n_slots + 4 * (b * n_slots
                                                              + b) * d},
        "embedding_bag_backward": {"calls": 1, "flops": 2 * b * n_slots * d,
                                   "bytes": 4 * b * n_slots
                                   + 4 * (b + v) * d},
        "topk_update": {"calls": 1, "flops": 5 * 300,
                        "bytes": 4 * (5 * 300 + 300) + 2 * 5 * 10 * 8},
        "fused_score_topk": {"calls": 1, "flops": 2 * 5 * 40 * 16,
                             "bytes": 4 * (5 * 16 + 40 * 16 + 2)
                             + 2 * 5 * 10 * 8}}
    assert bag.bag_cost(b, n_slots, d, 4, True) == (
        mode.kernels["embedding_bag"]["flops"],
        mode.kernels["embedding_bag"]["bytes"])
    # the kernels' float32 operations are in the totals
    assert mode.flops_by_dtype["float32"] >= sum(
        k["flops"] for k in mode.kernels.values())


def test_cpu_wrappers_report_nothing():
    """On the CPU the plain versions run, counted as their own ops."""
    out, table, idx, w = _bag_inputs("cpu")
    with roofline.CostMode() as mode:
        bag.embedding_bag_(out, table, idx, w)
    assert mode.kernels == {} and mode.bytes > 0


def test_meta_backward_sorts_as_the_card_does():
    """K4T on meta sorts its ids (once a shared BagKeys), as on the card."""
    b, n_slots, v, d = 6, 4, 9, 3
    out, table, idx, _ = _bag_inputs("meta", b, n_slots, v, d)
    keys = ops.BagKeys(idx)
    with roofline.CostMode() as mode:
        for _ in range(2):
            bag.embedding_bag_backward_(torch.empty((v, d), device=META),
                                        out, idx, None, keys=keys)
    assert keys._sorted is not None
    assert mode.kernels["embedding_bag_backward"]["calls"] == 2
    assert mode.bytes > 2 * mode.kernels["embedding_bag_backward"]["bytes"]


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_run_cell_on_the_reduced_cell(cell):
    name, shape = cell
    arch = get_arch(name).reduced()
    rec = dryrun.run_cell(name, shape, arch=arch)
    spec = arch.shapes[shape]
    assert rec["arch"] == name and rec["shape"] == shape
    assert rec["n_devices"] == 1
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["memory"]["model"]["fits_80GB"]
    assert rec["collectives"]["total"] == 0
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["model_flops_global"] == roofline.model_flops(arch, shape)
    key = (f"{arch.family} {spec.get('mode', spec['kind'])}"
           if arch.family == "gnn" else f"{arch.family} {spec['kind']}")
    if key in HOST_READS:
        path, line = rec["flops_source"].removeprefix("analytic: ").split(
            ":")
        assert path == HOST_READS[key]
        text = open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), path)).read().splitlines()
        assert "int(" in text[int(line) - 1] or ".tolist()" in \
            text[int(line) - 1]
        assert rec["cost"]["bytes"] == roofline.analytic_bytes(arch, shape)
    else:
        assert rec["flops_source"] == "counted"
        assert rec["useful_compute_ratio"] == \
            rec["model_flops_global"] / rec["cost"]["flops"]
    kernels = set(rec["kernels"])
    if name in ("deepfm", "wide-deep") and rec["flops_source"] == "counted":
        assert "embedding_bag" in kernels
    if spec["kind"] == "retrieval":
        assert rec["kernels"]["topk_update"]["calls"] == 1
    if name == "deepfm" and spec["kind"] == "train":
        assert rec["kernels"]["embedding_bag_backward"]["calls"] == 2


# the reference's mini cells (tests/test_dryrun_mini.py) at full width,
# each with its time limit (seconds of counting on this container)
MINI = {("qwen2-0.5b", "train_4k"): 180, ("granite-moe-3b-a800m",
                                          "decode_32k"): 30,
        ("deepfm", "retrieval_cand"): 30,
        ("graphsage-reddit", "minibatch_lg"): 30}


@pytest.mark.parametrize("cell", list(MINI), ids=_ids)
def test_run_cell_at_full_width(cell):
    name, shape = cell
    rec = dryrun.run_cell(name, shape)
    assert rec["wall_s"] <= MINI[cell]
    assert rec["cost"]["flops"] > 0
    if cell == ("granite-moe-3b-a800m", "decode_32k"):
        assert rec["flops_source"] == \
            "analytic: src/repro_torch/models/transformer.py:613"
        assert rec["cost"]["flops"] == roofline.model_flops(
            get_arch(name), shape)
    else:
        assert rec["flops_source"] == "counted"
    if cell == ("qwen2-0.5b", "train_4k"):
        # the reference's 831 GB at its published batch: not one card
        assert not rec["memory"]["model"]["fits_80GB"]
        assert rec["cost"]["flops_by_dtype"]["bfloat16"] > \
            rec["cost"]["flops_by_dtype"]["float32"] > 0
    if cell == ("deepfm", "retrieval_cand"):
        assert rec["kernels"]["embedding_bag"]["calls"] == 2
        assert rec["kernels"]["topk_update"] == {
            "calls": 1, "flops": 10 ** 6,
            "bytes": 4 * (2 * 10 ** 6) + 2 * 100 * 8}


def test_main_writes_records_that_report_reads(tmp_path, capsys,
                                               monkeypatch):
    cells = [("deepfm", "serve_p99"), ("qwen2-0.5b", "long_500k"),
             ("graphsage-reddit", "molecule")]
    for a, s in cells:
        dryrun.main(["--arch", a, "--shape", s, "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("[ok]") == 3
    dryrun.main(["--arch", "deepfm", "--shape", "serve_p99", "--out",
                 str(tmp_path), "--skip-existing"])
    assert "[skip] deepfm serve_p99" in capsys.readouterr().out
    recs = report.load_records(str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in recs] == sorted(cells)
    recs = [report.enrich(r) for r in recs]
    text = report.table(recs)
    assert text.count("\n") == 2 + 3 - 1
    assert "analytic: src/repro_torch/models/transformer.py:613" in text
    assert "(!)" not in text.split("deepfm")[1].split("\n")[0]
    detail = report.dryrun_table(recs)
    assert "embedding_bag 2" in detail
    for r in recs:
        rm = r["roofline_model"]
        assert rm["analytic_bytes_per_device"] == roofline.analytic_bytes(
            get_arch(r["arch"]), r["shape"])
        assert rm["step_lower_bound_s"] == max(
            rm["compute_s"], rm["memory_s_model"], rm["collective_s"])
    report.main(["--dir", str(tmp_path)])
    assert "## Roofline table" in capsys.readouterr().out
    json.loads((tmp_path / "onecard__deepfm__serve_p99.json").read_text())


@pytest.mark.parametrize("flag", ("--multi-pod", "--both-meshes"))
def test_dryrun_mesh_flags_name_item_10(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.main(["--all", flag, "--out", str(tmp_path)])


def test_hillclimb_variants_and_refusals(tmp_path, capsys, monkeypatch):
    lm = get_arch("granite-moe-3b-a800m")
    for name, fields in hillclimb.LM_VARIANTS.items():
        v = hillclimb.variant_arch(lm, name)
        for k, want in fields.items():
            assert getattr(v.cfg, k) == want
        assert v.shapes is lm.shapes and v.optimizer == lm.optimizer
    for name in hillclimb.NOT_PORTED:
        with pytest.raises(ValueError, match="not ported, by decision"):
            hillclimb.variant_arch(lm, name)
    rec = get_arch("deepfm")
    assert hillclimb.variant_arch(rec, "baseline") is rec
    for name in hillclimb.RECSYS_VARIANTS:
        with pytest.raises(NotImplementedError, match="items 4a and 10"):
            hillclimb.variant_arch(rec, name)
    with pytest.raises(NotImplementedError, match="item 10"):
        hillclimb.main(["--cell", "deepfm:train_batch", "--multi-pod"])
    # the reduced qwen2-0.5b with remat on through main: no_remat counts
    # less
    monkeypatch.setattr(hillclimb, "get_arch",
                        lambda n: get_arch(n).reduced().variant(remat=True))
    rows = hillclimb.main(["--cell", "qwen2-0.5b:train_4k", "--variants",
                           "baseline,no_remat,cap1.0", "--out",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert "deltas vs baseline" in out
    (_, base), (_, off), (_, cap) = rows
    assert off["flops_per_device"] < base["flops_per_device"]
    assert cap["flops_per_device"] == base["flops_per_device"]  # dense
    assert (tmp_path / "qwen2-0.5b__train_4k__no_remat.json").exists()


def test_lm_variant_keeps_the_arch():
    arch = get_arch("qwen2-0.5b")
    v = arch.variant(attn_chunk=1024)
    assert v.cfg.attn_chunk == 1024 and arch.cfg.attn_chunk == 4096
    assert v.cfg.n_layers == arch.cfg.n_layers and v.name == arch.name

"""The port's partitioning rules against the reference's, in-process.

No process group and no forced devices: both packages resolve specs on
shape-only meshes (the port's ``make_mesh`` without a group, the
reference's ``FakeMesh`` stand-in of ``tests/test_sharding.py``), which
is all rule resolution reads.  On six meshes — (16, 16), (2, 16, 16),
(2, 2, 2), (2, 2), (4, 1), (1, 1) — the port's specs equal the
reference's leaf for leaf for:

  * the parameters of all 40 (arch x shape) cells, as the reference's
    ``build_cell(shape, mesh)`` lays them out;
  * the train cells' optimizer states, and AdamW's and Adafactor's states
    over every cell's parameters (the reference's ``make_train_cell``);
  * the serve cells' KV caches (``cache_logical_axes``).

The reference's ``NamedSharding`` and ``ShapeDtypeStruct`` wrappers in
``repro.configs.base`` are patched to hand back the bare spec, so its
own code resolves every spec on the shape-only mesh.
"""

import pytest
from jax.sharding import PartitionSpec as JP

import repro.configs.base as ref_base
from repro.configs import get_arch as ref_get_arch
from repro.sharding.partitioning import AxisRules as RefRules
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import make_layout
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import gnn, recsys, transformer
from repro_torch.sharding import Mesh, make_mesh
from repro_torch.sharding.partitioning import (DEFAULT_RULES, AxisRules, P,
                                               data_axes, data_parallelism,
                                               local_mesh, local_shape,
                                               model_parallelism,
                                               tree_pspecs)
from repro_torch.training.optimizer import (OptimizerConfig,
                                            opt_state_logical_axes)
from repro_torch.training.tree import flatten

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((4, 1), ("data", "model")),
          ((1, 1), ("data", "model")))
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


class FakeMesh:
    """Shape-only mesh stand-in (the reference's tests' own)."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's cell constructors hand back bare specs."""
    monkeypatch.setattr(ref_base, "NamedSharding", lambda mesh, spec: spec)
    real = ref_base._sds
    monkeypatch.setattr(ref_base, "_sds", lambda shape, dtype, sharding=None:
                        real(shape, dtype) if sharding is None else sharding)


def _ref_flat(tree) -> dict:
    import jax
    return {"/".join(str(k.key) for k in path): tuple(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _flat(tree) -> dict:
    return {p: tuple(s) for p, s in flatten(tree)}


def _port_params(arch, shape: str):
    """(shapes, logical axes) of a cell's parameters in the port."""
    if arch.family == "lm":
        return (transformer.param_shapes(arch.cfg),
                transformer.param_logical_axes(arch.cfg))
    if arch.family == "gnn":
        cfg = arch.shape_cfg(shape)
        return gnn.param_shapes(cfg), gnn.param_logical_axes(cfg)
    return recsys.param_shapes(arch.cfg), recsys.param_logical_axes(arch.cfg)


def _rules(arch):
    return arch.axis_rules()


# -- the rules ----------------------------------------------------------------


def test_rule_table_and_lm_rules_match_the_references():
    from repro.models.transformer import LM_RULES as REF_LM
    from repro.sharding.partitioning import DEFAULT_RULES as REF
    assert DEFAULT_RULES == REF
    assert dict(transformer.LM_RULES.rules) == dict(REF_LM.rules)


@pytest.mark.parametrize("axes,dims,shape,names,want", [
    (("batch", None), (256, 4096), (16, 16), ("data", "model"),
     ("data", None)),
    (("heads", None), (14, 64), (16, 16), ("data", "model"), (None, None)),
    (("vocab", "embed"), (49155, 1536), (16, 16), ("data", "model"),
     (None, "model")),
    (("experts", "fsdp", "expert_ffn"), (128, 5120, 8192), (16, 16),
     ("data", "model"), ("model", None, None)),
    (("experts", None, "expert_ffn"), (40, 1536, 512), (16, 16),
     ("data", "model"), (None, None, "model")),
    (("batch",), (8,), (4, 2), ("data", "model"), ("data",)),
])
def test_spec_for_guards_divisibility_and_uses_an_axis_once(
        axes, dims, shape, names, want):
    rules = AxisRules()
    mesh = make_mesh(shape, names)
    assert rules.spec_for(axes, dims, mesh) == P(*want)
    assert tuple(RefRules().spec_for(axes, dims, FakeMesh(shape, names))
                 ) == want


def test_pod_prefix_fallback():
    rules = AxisRules().with_overrides(fsdp=("pod", "data"))
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.spec_for(("fsdp",), (34,), mesh) == P("pod")
    assert rules.spec_for(("fsdp",), (64,), mesh) == P(("pod", "data"))
    assert rules.mesh_axes_for(None, mesh) == ()
    with pytest.raises(ValueError, match="logical axes"):
        rules.spec_for(("fsdp",), (4, 4), mesh)


def test_mesh_helpers():
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
    assert not mesh.bound and mesh.size == 512
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(mesh) == ("pod", "data")
    assert data_parallelism(mesh) == 32 and model_parallelism(mesh) == 16
    assert local_shape((64, 30, 32), P(("pod", "data"), None, "model"),
                       mesh) == (2, 30, 2)
    with pytest.raises(RuntimeError, match="shape-only"):
        mesh.shard_index(("data",))
    with pytest.raises(ValueError, match="pair up"):
        Mesh((2, 2), ("data",))
    with pytest.raises(ValueError, match="empty axis"):
        Mesh((0, 2), ("data", "model"))
    assert local_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("multi_pod,shape", [(False, (16, 16)),
                                             (True, (2, 16, 16))])
def test_production_mesh_is_shape_only_without_a_group(multi_pod, shape):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert tuple(mesh.shape.values()) == shape and not mesh.bound
    assert mesh.axis_names == (("pod", "data", "model") if multi_pod
                               else ("data", "model"))


# -- all 40 cells on six meshes ------------------------------------------------


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name,shape", all_cells())
def test_cell_specs_equal_the_references(name, shape, mesh_def, spec_only):
    """Parameters (every cell), optimizer state (train cells), KV cache
    (serve cells): the port's specs are the reference's."""
    shape_def, axes = mesh_def
    fake, mesh = FakeMesh(shape_def, axes), make_mesh(shape_def, axes)
    arch, ref_arch = get_arch(name), ref_get_arch(name)
    ref_cell = ref_arch.build_cell(shape, mesh=fake)
    args = ref_cell.abstract_args
    shapes, logical = _port_params(arch, shape)
    params = tree_pspecs(shapes, logical, mesh, _rules(arch))
    if ref_cell.kind == "train":
        want_state = args[0]
        assert _flat(params) == _ref_flat(want_state["params"])
        lay = make_layout(mesh, _rules(arch), shapes, logical, None,
                          arch_optimizer(arch))
        assert _flat(lay.opt_specs) == _ref_flat(want_state["opt"])
        assert tuple(want_state["step"]) == ()
        return
    assert _flat(params) == _ref_flat(args[0])
    if ref_cell.kind == "serve" and arch.family == "lm":
        spec = arch.shapes[shape]
        b, s = spec["global_batch"], spec["seq_len"]
        tp = mesh.shape.get("model", 1)
        cfg = arch.cfg
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        cache = tree_pspecs(
            {"k": kv, "v": kv, "len": ()},
            transformer.cache_logical_axes(
                cfg, b, tp_divides_kv=(cfg.n_kv_heads % tp == 0)),
            mesh, _rules(arch))
        assert _flat(cache) == _ref_flat(args[1])


def arch_optimizer(arch) -> str:
    return "adamw" if arch.family != "lm" else arch.optimizer


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
@pytest.mark.parametrize("name,shape", [
    (n, s) for n, s in all_cells()
    if get_arch(n).family == "gnn" or s == get_arch(n).shape_names()[0]])
def test_optimizer_state_specs_equal_the_references(name, shape, optimizer,
                                                    mesh_def, spec_only):
    """AdamW's and Adafactor's states over each cell's parameters (one
    parameter set per LM / recsys arch, one per GNN shape)."""
    shape_def, axes = mesh_def
    fake, mesh = FakeMesh(shape_def, axes), make_mesh(shape_def, axes)
    arch, ref_arch = get_arch(name), ref_get_arch(name)
    if arch.family == "gnn":
        import dataclasses
        from repro.models import gnn as ref_gnn
        cfg = dataclasses.replace(ref_arch.cfg,
                                  d_feat=ref_arch.shapes[shape]["d_feat"])
        ab, ax = ref_gnn.abstract_params(cfg), ref_gnn.param_logical_axes(cfg)
    else:
        ab, ax = ref_arch.abstract_params(), ref_arch.param_logical_axes()
    ref_cell = ref_base.make_train_cell(
        name, shape, loss_fn=lambda p, b, c: 0.0, abstract_params=ab,
        param_axes=ax, batch_specs={}, batch_axes={},
        rules=ref_arch.axis_rules(), mesh=fake, optimizer=optimizer)
    shapes, logical = _port_params(arch, shape)
    lay = make_layout(mesh, _rules(arch), shapes, logical, None, optimizer)
    assert _flat(lay.param_specs) == _ref_flat(
        ref_cell.abstract_args[0]["params"])
    assert _flat(lay.opt_specs) == _ref_flat(ref_cell.abstract_args[0]["opt"])


def test_opt_state_logical_axes():
    axes = {"w": ("fsdp", "ffn"), "b": ("ffn",)}
    shapes = {"w": (256, 512), "b": (512,)}
    assert opt_state_logical_axes(OptimizerConfig("adamw"), axes) == {
        "mu": axes, "nu": axes}
    ada = OptimizerConfig("adafactor")
    # without the shapes: the reference's value
    assert opt_state_logical_axes(ada, axes) == {"v": axes}
    assert opt_state_logical_axes(ada, axes, shapes) == {"v": {
        "w": {"vr": ("fsdp",), "vc": ("ffn",)}, "b": {"v": ("ffn",)}}}


def test_param_axes_cover_every_leaf():
    for name in ("qwen2-0.5b", "granite-moe-3b-a800m", "stablelm-3b"):
        cfg = get_arch(name).cfg
        shapes = dict(flatten(transformer.param_shapes(cfg)))
        axes = dict(flatten(transformer.param_logical_axes(cfg)))
        assert set(shapes) == set(axes)
        assert all(len(axes[p]) == len(s) for p, s in shapes.items())
    cfg = get_arch("deepfm").cfg
    axes = recsys.param_logical_axes(cfg)
    assert axes["table"] == ("embed_rows", None)
    assert axes["mlp_w0"] == (None, None)
    assert set(gnn.param_logical_axes(get_arch("graphsage-reddit").cfg)
               .values()) <= {(None,), (None, None)}

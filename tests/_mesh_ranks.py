"""The processes behind ``tests/test_torch_mesh.py``.

    python tests/_mesh_ranks.py port DIR RANK     # one of 4 gloo ranks
    python tests/_mesh_ranks.py reference DIR     # 4 forced host devices

Both read ``DIR/inputs.pkl`` (seeded numpy, written by the test) and run
the same cases on a (data 2, model 2) mesh: the collectives (port only),
the psum lookup and its table gradient, ``compressed_psum``, one
``RetrievalTrainer`` step of a tiny LM (AdamW, Adafactor, and
``dp_mode="shard_map"`` with int8), and the reduced DeepFM ``train_batch``
/ ``serve_bulk`` cells.  The port's ranks also save a meshed checkpoint
and restore it onto (4, 1).  Each writes ``DIR/port-RANK.pkl`` or
``DIR/reference.pkl``; every wait in the test is bounded.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (optimizer, dp_mode, grad_compression) of the trainer cases
TRAINER_CASES = (("adamw", "pjit", "none"), ("adafactor", "pjit", "none"),
                 ("adamw", "shard_map", "int8"))
RECSYS_CASES = (("psum", "train_batch"), ("xla_gather", "train_batch"),
                ("psum", "serve_bulk"))
COMPRESSION = ("none", "bf16", "int8")
COMPRESSION_AXES = (("data",), ("data", "model"))


def tiny_fields() -> dict:
    """A tiny LM whose every spec is sharded on (2, 2) and whose 2-D
    leaves are large enough for Adafactor to factor (128 x 256)."""
    return dict(name="tiny", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
                activation="swiglu", norm="rmsnorm", qkv_bias=True,
                pooling="last", attn_chunk=0, remat=False)


def train_args(out_dir: str, optimizer: str, compression: str, cls):
    return cls(output_dir=out_dir, learning_rate=1e-2, warmup_steps=0,
               max_steps=10, per_device_batch_size=2, optimizer=optimizer,
               grad_compression=compression, seed=0,
               async_checkpoint=False)


def _load(d: str) -> dict:
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _save(d: str, name: str, out: dict) -> None:
    tmp = os.path.join(d, name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(d, name))


# -- the port's ranks --------------------------------------------------------

def port_rank(d: str, rank: int) -> None:
    import numpy as np
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.configs.recsys_arch import RecSysArch
    from repro_torch.configs import get_arch
    from repro_torch.launch.distributed import init_distributed
    from repro_torch.models import convert, recsys, transformer
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.core.config import RetrievalTrainingArguments
    from repro_torch.sharding import collectives, make_mesh
    from repro_torch.sharding.layout import (gather_tree, local_slice,
                                             shard_tree)
    from repro_torch.sharding.partitioning import P
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import grad_compression as gc
    from repro_torch.training.trainer import RetrievalTrainer
    from repro_torch.training.tree import flatten, tree_map

    inp = _load(d)
    init_distributed(init_method=f"file://{d}/rdzv", world_size=4,
                     rank=rank)
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"))
    out: dict = {"coords": dict(mesh.coords), "rank": mesh.rank}

    def host(t):
        # copies: the steps update the state's tensors in place
        return tree_map(lambda x: x.detach().cpu().numpy().copy()
                        if isinstance(x, torch.Tensor) else np.array(x), t)

    def flat_host(t):
        return {p: x for p, x in flatten(host(t))}

    # collectives
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * rank
    col = {
        "all_reduce data": collectives.all_reduce(x, mesh, "data"),
        "all_reduce model mean": collectives.all_reduce(x, mesh, "model",
                                                        "mean"),
        "all_reduce both": collectives.all_reduce(
            x, mesh, ("data", "model")),
        "all_gather data 0": collectives.all_gather(x, mesh, "data", 0),
        "all_gather both 1": collectives.all_gather(
            x, mesh, ("data", "model"), 1),
        "all_gather model-data 0": collectives.all_gather(
            x, mesh, ("model", "data"), 0),
        "reduce_scatter model 1": collectives.reduce_scatter(
            x, mesh, "model", 1),
        "bf16 bits": collectives.all_gather(
            (x / 7).to(torch.bfloat16), mesh, "data", 0).view(torch.int16),
    }
    collectives.reset_counts()
    collectives.all_gather(x, mesh, ("data", "model"), 0)
    out["wire"] = collectives.counts()
    out["collectives"] = host(col)
    out["members"] = {"data": mesh.members(("data",)),
                      "model": mesh.members(("model",)),
                      "both": mesh.members(("data", "model"))}

    # the psum lookup and its gradient
    table = torch.from_numpy(inp["lookup"]["table"])
    idx = torch.from_numpy(inp["lookup"]["idx"])
    w = torch.from_numpy(inp["lookup"]["w"])
    mine = local_slice(table, P("model", None), mesh).requires_grad_(True)
    i = mesh.shard_index(("data",))
    rows = idx.shape[0] // 2
    got = recsys.embedding_lookup(mine, idx[i * rows:(i + 1) * rows],
                                  "psum", mesh)
    (got * w[i * rows:(i + 1) * rows]).sum().backward()
    grad = collectives.all_reduce(mine.grad, mesh, "data")
    out["lookup"] = host({
        "rows": collectives.all_gather(got.detach(), mesh, "data"),
        "grad": collectives.all_gather(grad, mesh, "model")})

    # compressed_psum
    comp = {}
    g, e = inp["compress"]["grads"][rank], inp["compress"]["ef"][rank]
    for axes in COMPRESSION_AXES:
        for method in COMPRESSION:
            t = tree_map(torch.from_numpy, g)
            ef = tree_map(torch.from_numpy, e) if method == "int8" else None
            res, new_ef = gc.compressed_psum(t, mesh, axes, method, ef)
            comp[(axes, method)] = host({"grads": res, "ef": new_ef})
    out["compress"] = comp

    # the tiny LM's trainer steps
    cfg = transformer.LMConfig(**tiny_fields(), dtype=torch.float32)
    lm = inp["lm"]
    trainer_out = {}
    for case in TRAINER_CASES:
        optimizer, dp_mode, compression = case
        trainer = RetrievalTrainer(
            BiEncoderRetriever(DefaultEncoder(cfg), "infonce"),
            train_args(os.path.join(d, f"run-{rank}"), optimizer,
                       compression, RetrievalTrainingArguments),
            mesh=mesh, dp_mode=dp_mode, device="cpu")
        state = trainer.init_state(
            convert.params_from_jax(lm["params"], cfg, "cpu"))
        if case == TRAINER_CASES[0]:
            out["lm_slices"] = flat_host(state["params"])
        local_shapes = {p: tuple(t.shape) for p, t in flatten(state)
                        if isinstance(t, torch.Tensor)}
        state, metrics = trainer._step(state, lm["batch"])
        full = gather_tree(state, trainer.specs, mesh)
        trainer_out[case] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "state": flat_host(full) if rank == 0 else None,
            "local_shapes": local_shapes,
            "specs": {p: tuple(s) for p, s in flatten(trainer.specs)}}
        if case == TRAINER_CASES[0]:
            out["restore"] = elastic_restore(
                d, trainer, state, full, mesh, flat_host)
            out["train_loop"] = train_loop(d, cfg, lm, mesh, flat_host)
    out["trainer"] = trainer_out

    # the reduced DeepFM cells
    base = get_arch("deepfm").reduced()
    rec = inp["deepfm"]
    cells = {}
    for impl, shape in RECSYS_CASES:
        arch = RecSysArch(dataclasses.replace(base.cfg, embedding_impl=impl),
                          shapes=base.shapes)
        params = convert.recsys_params_from_jax(rec["params"], arch.cfg,
                                                "cpu")
        batch = tree_map(torch.from_numpy, rec[shape])
        cell = arch.build_cell(shape, "cpu", mesh)
        if shape == "train_batch":
            state = init_train_state(cell, params)
            if impl == "psum":
                out["deepfm_slices"] = flat_host(state["params"])
            state, m = cell.fn(state, batch)
            full = gather_tree(state, {"step": P(), "params":
                                       cell.layout.param_specs,
                                       "opt": cell.layout.opt_specs}, mesh)
            cells[(impl, shape)] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": host(full["params"]), "opt": host(full["opt"]),
                "keep": cell.layout.keep}
        else:
            cells[(impl, shape)] = {"out": host(cell.fn(
                cell.local_params(params), batch))}
    out["deepfm"] = cells
    _save(d, f"port-{rank}.pkl", out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def elastic_restore(d, trainer, state, full, mesh, flat_host) -> dict:
    """Save the (2, 2) state, restore it onto (4, 1) in this group, and
    hold every restored leaf against the slice of the gathered state."""
    import torch

    from repro_torch.sharding import make_mesh
    from repro_torch.sharding.layout import local_slice, shard_tree
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.trainer import RetrievalTrainer
    from repro_torch.training.tree import flatten

    mgr = ckpt.CheckpointManager(os.path.join(d, "ckpt"), save_every=1,
                                 async_save=False)
    mgr.save(1, state, shardings=(mesh, trainer.specs))
    mesh41 = make_mesh((4, 1), ("data", "model"))
    other = RetrievalTrainer(trainer.retriever, trainer.args, mesh=mesh41,
                             device="cpu")
    specs41 = other.state_shardings(full)
    template = shard_tree(full, specs41, mesh41)
    restored, step = mgr.restore_latest(template, (mesh41, specs41))
    equal = {}
    for (path, got), (_, want), (_, spec) in zip(
            flatten(restored), flatten(full), flatten(specs41)):
        if isinstance(want, torch.Tensor):
            equal[path] = same_bits(got, local_slice(want, spec, mesh41))
        else:
            equal[path] = bool((got == want).all())
    return {"step": step, "equal": equal, "local22": flat_host(state),
            "specs41": {p: tuple(s) for p, s in flatten(specs41)}}


def shards_by_coords(tree, mesh) -> dict:
    """{path: {(data, model): the addressable shard on that device}} of a
    sharded reference pytree."""
    import numpy as np
    out = {}
    for path, arr in ref_flat(tree).items():
        out[path] = {}
        for shard in arr.addressable_shards:
            coords = tuple(int(c) for c in np.argwhere(
                mesh.devices == shard.device)[0])
            out[path][coords] = np.asarray(shard.data)
    return out


def ref_flat(tree, is_leaf=None) -> dict:
    """A reference pytree as {"/"-joined path: leaf} (the port's
    ``training.tree.flatten`` keys)."""
    import jax
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def train_loop(d, cfg, lm, mesh, flat_host) -> dict:
    """``RetrievalTrainer.train`` on the mesh: 2 steps over a stream whose
    every draw is the fixed batch, a checkpoint each step (rank 0 writes
    gathered leaves), then a second trainer on the same directory that
    resumes from the last one and has nothing left to do."""
    from repro_torch.core.config import RetrievalTrainingArguments
    from repro_torch.models import convert
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.sharding.layout import gather_tree
    from repro_torch.training.trainer import RetrievalTrainer

    def trainer():
        args = train_args(os.path.join(d, "loop"), "adamw", "none",
                          RetrievalTrainingArguments)
        args.max_steps, args.checkpoint_every, args.log_every = 2, 1, 1
        return RetrievalTrainer(
            BiEncoderRetriever(DefaultEncoder(cfg), "infonce"), args,
            collator=lambda feats: lm["batch"], train_dataset=list(range(8)),
            mesh=mesh, device="cpu")

    first = trainer()
    state = first.train(first.init_state(
        convert.params_from_jax(lm["params"], cfg, "cpu")))
    again = trainer()
    resumed = again.train(again.init_state(
        convert.params_from_jax(lm["params"], cfg, "cpu")))
    return {"losses": [r["loss"] for r in first.logs],
            "steps": (int(state["step"]), int(resumed["step"])),
            "state": flat_host(gather_tree(state, first.specs, mesh)),
            "resumed": flat_host(gather_tree(resumed, again.specs, mesh)),
            "written": sorted(os.listdir(os.path.join(d, "loop",
                                                      "checkpoints")))}


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bytes (NaN-safe)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


# -- the reference -----------------------------------------------------------

def reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_arch
    from repro.configs.base import RecSysArch
    from repro.core.config import RetrievalTrainingArguments
    from repro.models import recsys, transformer
    from repro.models.encoder import DefaultEncoder
    from repro.models.retriever import BiEncoderRetriever
    from repro.sharding import make_mesh
    from repro.training import grad_compression as gc
    from repro.training.trainer import RetrievalTrainer

    inp = _load(d)
    mesh = make_mesh((2, 2), ("data", "model"))
    out: dict = {}
    host = lambda t: jax.tree.map(np.asarray, t)

    # the psum lookup
    lk = inp["lookup"]
    table = jax.device_put(jnp.asarray(lk["table"]),
                           NamedSharding(mesh, P("model", None)))
    idx, w = jnp.asarray(lk["idx"]), jnp.asarray(lk["w"])
    rows = jax.jit(lambda t: recsys._lookup_psum(t, idx, mesh, "model"))(
        table)
    grad = jax.jit(jax.grad(lambda t: (recsys._lookup_psum(
        t, idx, mesh, "model") * w).sum()))(table)
    out["lookup"] = host({"rows": rows, "grad": grad})

    # compressed_psum under shard_map, device r holding rank r's tree
    comp = {}
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    grads = stack(inp["compress"]["grads"])
    efs = stack(inp["compress"]["ef"])
    spec = P(("data", "model"))
    for axes in [tuple(a) for a in (("data",), ("data", "model"))]:
        for method in ("none", "bf16", "int8"):
            def body(g, e, axes=axes, method=method):
                g = jax.tree.map(lambda x: x[0], g)
                e = jax.tree.map(lambda x: x[0], e)
                r, ne = gc.compressed_psum(
                    g, axes if len(axes) > 1 else axes[0], method,
                    e if method == "int8" else None)
                ne = e if ne is None else ne
                return (jax.tree.map(lambda x: x[None], r),
                        jax.tree.map(lambda x: x[None], ne))
            f = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec, spec), check_rep=False)
            r, ne = jax.jit(f)(grads, efs)
            comp[(axes, method)] = host({"grads": r, "ef": ne})
    out["compress"] = comp

    # the tiny LM's trainer steps
    cfg = transformer.LMConfig(**tiny_fields(), dtype=jnp.float32)
    lm = inp["lm"]
    tr_out = {}
    for optimizer, dp_mode, compression in TRAINER_CASES:
        trainer = RetrievalTrainer(
            BiEncoderRetriever(DefaultEncoder(cfg), "infonce"),
            train_args(os.path.join(d, "ref-run"), optimizer, compression,
                       RetrievalTrainingArguments),
            mesh=mesh, dp_mode=dp_mode)
        params = jax.tree.map(jnp.asarray, lm["params"])
        state = {"step": jnp.zeros((), jnp.int32), "params": params,
                 "opt": trainer.opt_init(params),
                 "rng": jax.random.key_data(jax.random.key(1))}
        if compression == "int8":
            state["ef"] = gc.init_error_feedback(params)
        shardings = trainer.state_shardings(state)
        state = jax.device_put(state, shardings)
        if (optimizer, dp_mode, compression) == TRAINER_CASES[0]:
            out["lm_shards"] = shards_by_coords(state["params"], mesh)
        state, metrics = trainer._build_step(None)(
            state, jax.tree.map(jnp.asarray, lm["batch"]))
        tr_out[(optimizer, dp_mode, compression)] = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "state": ref_flat(host(state)),
            "specs": {p: tuple(ns.spec) for p, ns in ref_flat(
                shardings, lambda x: isinstance(x, NamedSharding)).items()}}
    out["trainer"] = tr_out

    # the reduced DeepFM cells
    base = get_arch("deepfm").reduced()
    rec = inp["deepfm"]
    cells = {}
    for impl, shape in RECSYS_CASES:
        arch = RecSysArch(dataclasses.replace(base.cfg, embedding_impl=impl),
                          shapes=base.shapes)
        cell = arch.build_cell(shape, mesh=mesh)
        params = jax.tree.map(jnp.asarray, rec["params"])
        batch = jax.tree.map(jnp.asarray, rec[shape])
        abs_args = cell.abstract_args
        sh = lambda tree: jax.tree.map(lambda s: s.sharding, tree)
        batch = jax.device_put(batch, sh(abs_args[-1]))
        if shape == "train_batch":
            from repro.training.optimizer import (OptimizerConfig,
                                                  make_optimizer)
            opt_init, _ = make_optimizer(OptimizerConfig(
                name="adamw", learning_rate=1e-3))
            state = {"step": jnp.zeros((), jnp.int32), "params": params,
                     "opt": opt_init(params)}
            state = jax.device_put(state, sh(abs_args[0]))
            if impl == "psum":
                out["deepfm_shards"] = shards_by_coords(state["params"],
                                                        mesh)
            state, m = jax.jit(cell.fn, **cell.jit_kwargs)(state, batch)
            cells[(impl, shape)] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": host(state["params"]), "opt": host(state["opt"])}
        else:
            params = jax.device_put(params, sh(abs_args[0]))
            cells[(impl, shape)] = {"out": np.asarray(
                jax.jit(cell.fn)(params, batch))}
    out["deepfm"] = cells
    _save(d, "reference.pkl", out)


if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                         "src")]
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]))
    else:
        reference(sys.argv[2])

"""The processes behind ``tests/test_torch_mesh_lm.py``.

    python tests/_mesh_lm_ranks.py port DIR RANK          # one of 4 gloo ranks
    python tests/_mesh_lm_ranks.py reference DIR 2x2      # 4 forced host
    python tests/_mesh_lm_ranks.py reference DIR 1x4      # devices each

Each reads ``DIR/inputs.pkl`` (seeded numpy, written by the test) and
runs the reduced LM cells on (data, model) meshes: the port's ranks on
(2, 2) and (1, 4) in one gloo world, each reference process on the mesh
it names.  The cases:

  * the decode cells of four archs at ``decode_32k`` and ``long_500k``,
    three steps from each start in ``starts(S)``, the cache laid out by
    ``cache_logical_axes`` (each port rank stepping its block, twice);
  * (2, 2) only: ``prefill_32k`` of two archs, one ``train_4k`` AdamW
    step of the two MoE stacks with their aux over the split batch, and
    one ``RetrievalTrainer`` step of an MoE encoder with
    ``aux_loss_weight > 0``;
  * the port's ranks also step every LM cell once on (2, 2).

Each writes ``DIR/port-RANK.pkl`` or ``DIR/reference-MESH.pkl``; every
wait in the test is bounded.
"""

from __future__ import annotations

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
DECODE_ARCHS = ("qwen2-0.5b", "gemma-7b", "granite-moe-3b-a800m",
                "llama4-maverick-400b-a17b")
SERVE_SHAPES = ("decode_32k", "long_500k")
ENCODE_ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m")
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
LM_ARCHS = ("gemma-7b", "qwen2-0.5b", "stablelm-3b", "granite-moe-3b-a800m",
            "llama4-maverick-400b-a17b")
RETRIEVER_ARCH = "granite-moe-3b-a800m"
STEPS = 3


def starts(s: int) -> tuple[int, int]:
    """Where the steps begin: near the end (the last sequence shard writes)
    and at 5 (every sequence shard but the first lies past ``len``)."""
    return (s - 4, 5)


def mesh_id(shape) -> str:
    return "x".join(map(str, shape))


def train_args(out_dir: str, cls):
    return cls(output_dir=out_dir, learning_rate=1e-2, warmup_steps=0,
               max_steps=10, per_device_batch_size=2, optimizer="adamw",
               aux_loss_weight=0.01, seed=0, async_checkpoint=False)


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
    import torch

    from repro_torch.launch.distributed import init_distributed
    from repro_torch.sharding import make_mesh

    inp = _load(d)
    init_distributed(init_method=f"file://{d}/rdzv", world_size=4,
                     rank=rank)
    torch.set_num_threads(1)
    out: dict = {"rank": rank, "decode": {}}
    meshes = {shape: make_mesh(shape, AXES) for shape in MESHES}
    for shape, mesh in meshes.items():
        out["decode"].update(port_decode(inp, mesh, shape))
    mesh = meshes[(2, 2)]
    out["encode"] = port_encode(inp, mesh)
    out["train"] = port_train(inp, mesh)
    out["retriever"] = port_retriever(d, inp, mesh)
    out["cells"] = port_every_cell(mesh)
    _save(d, f"port-{rank}.pkl", out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _host(t):
    return t.detach().cpu().numpy().copy()


def port_decode(inp: dict, mesh, mesh_shape) -> dict:
    """Each decode case on this rank: every step's logits and collective
    counts, the block after the steps, a second run's bits, the cell's
    smoke inputs and the full cache's refusal."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import convert
    from repro_torch.sharding import collectives
    from repro_torch.sharding.layout import local_slice

    out = {}
    for name in DECODE_ARCHS:
        arch = get_arch(name).reduced()
        params = convert.params_from_jax(inp["params"][name], arch.cfg,
                                         "cpu")
        for shape in SERVE_SHAPES:
            case = inp["decode"][(name, shape)]
            cell = arch.build_cell(shape, "cpu", mesh)
            spec = cell.layout.cache_specs
            local = cell.local_params(params)
            full = {n: torch.from_numpy(case[n]) for n in ("k", "v")}
            got: dict = {"spec": tuple(spec["k"])}

            def run(start, tokens):
                block = {n: local_slice(full[n], spec[n], mesh)
                         for n in ("k", "v")}
                block["len"] = torch.tensor(start, dtype=torch.int32)
                logits, counts = [], []
                for step in range(STEPS):
                    collectives.reset_counts()
                    y, block = cell.fn(local, block,
                                       torch.from_numpy(tokens[step]))
                    counts.append(collectives.counts())
                    logits.append(_host(y))
                return logits, counts, block

            for i, start in enumerate(starts(arch.shapes[shape]["seq_len"])):
                logits, counts, block = run(start, case["tokens"][i])
                again = run(start, case["tokens"][i])
                got[start] = {
                    "logits": logits, "counts": counts,
                    "k": _host(block["k"]), "v": _host(block["v"]),
                    "len": int(block["len"]),
                    "bitwise": all(
                        (a.view("u4") == b.view("u4")).all()
                        for a, b in zip(logits, again[0])) and all(
                        torch.equal(block[n].view(torch.int32),
                                    again[2][n].view(torch.int32))
                        for n in ("k", "v"))}
            block, tokens = cell.smoke_inputs(
                torch.Generator().manual_seed(0), "cpu")
            _, want_tokens = arch.smoke_inputs(
                shape, torch.Generator().manual_seed(0), "cpu")
            got["smoke"] = {"k": tuple(block["k"].shape),
                            "zeros": not bool(block["k"].any()
                                              or block["v"].any()),
                            "len": int(block["len"]),
                            "tokens": torch.equal(tokens, want_tokens)}
            block["len"].fill_(arch.shapes[shape]["seq_len"])
            try:
                cell.fn(local, block, tokens)
                got["full_raises"] = None
            except ValueError as e:
                got["full_raises"] = str(e)
            out[(mesh_id(mesh_shape), name, shape)] = got
    return out


def port_encode(inp: dict, mesh) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import convert

    out = {}
    for name in ENCODE_ARCHS:
        arch = get_arch(name).reduced()
        params = convert.params_from_jax(inp["params"][name], arch.cfg,
                                         "cpu")
        cell = arch.build_cell("prefill_32k", "cpu", mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in inp["encode"][name].items()}
        out[name] = _host(cell.fn(cell.local_params(params), batch))
    return out


def port_train(inp: dict, mesh) -> dict:
    """One meshed ``train_4k`` step of each MoE stack (the gathered state
    after it), and the aux of the initial parameters over the split
    passage batch with its gradient (the data-axis mean of the ranks')."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import init_train_state
    from repro_torch.models import convert, transformer
    from repro_torch.sharding.layout import (batch_shard, batch_specs,
                                             gather_tree, meshed_grads)
    from repro_torch.training.tree import flatten, tree_map

    out = {}
    for name in MOE_ARCHS:
        arch = get_arch(name).reduced()
        params = convert.params_from_jax(inp["params"][name], arch.cfg,
                                         "cpu")
        batch = tree_map(torch.from_numpy, inp["train"][name])
        cell = arch.build_cell("train_4k", "cpu", mesh)
        lay = cell.layout
        local = batch_shard(batch, batch_specs(batch, lay.batch_axes, mesh,
                                               lay.rules), mesh)

        def aux_fn(p, b):
            return transformer.forward_hidden(arch.cfg, p, b["tokens"],
                                              b["mask"], mesh)[1]

        aux, _, grads, _ = meshed_grads(aux_fn, cell.local_params(params),
                                        lay.param_specs, local["passage"],
                                        mesh)
        state = init_train_state(cell, params)
        state, m = cell.fn(state, batch)
        full = gather_tree({"params": state["params"], "opt": state["opt"]},
                           {"params": lay.param_specs,
                            "opt": lay.opt_specs}, mesh)
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "aux": float(aux),
                     "aux_grads": {p: _host(t) for p, t in flatten(grads)},
                     "state": {p: _host(t) for p, t in flatten(full)}}
    return out


def port_retriever(d: str, inp: dict, mesh) -> dict:
    """One ``RetrievalTrainer`` step of an MoE encoder on the mesh, the
    retriever's aux weighted in."""
    from repro_torch.configs import get_arch
    from repro_torch.core.config import RetrievalTrainingArguments
    from repro_torch.models import convert
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.sharding.layout import gather_tree
    from repro_torch.training.trainer import RetrievalTrainer
    from repro_torch.training.tree import flatten

    cfg = get_arch(RETRIEVER_ARCH).reduced().cfg
    trainer = RetrievalTrainer(
        BiEncoderRetriever(DefaultEncoder(cfg), "infonce"),
        train_args(os.path.join(d, f"run-{mesh.rank}"),
                   RetrievalTrainingArguments), mesh=mesh, device="cpu")
    state = trainer.init_state(convert.params_from_jax(
        inp["params"][RETRIEVER_ARCH], cfg, "cpu"))
    state, m = trainer._step(state, inp["retriever"])
    full = gather_tree(state, trainer.specs, mesh)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {p: _host(t) for p, t in flatten(full)
                      if p.startswith(("params/", "opt/"))}}


def port_every_cell(mesh) -> dict:
    """Every LM cell on ``mesh`` stepped once from seeded parameters and
    ``smoke_inputs``: each output's shape and finiteness; an encode or
    serve cell's output beside the one-process cell's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import init_train_state
    from repro_torch.models import transformer

    out = {}
    for name in LM_ARCHS:
        arch = get_arch(name).reduced()
        for shape in arch.shape_names():
            params = transformer.init_params(
                arch.cfg, torch.Generator().manual_seed(1), "cpu")
            cell = arch.build_cell(shape, "cpu", mesh)
            one = arch.build_cell(shape, "cpu")
            kind = arch.shapes[shape]["kind"]
            if kind == "train":
                state = init_train_state(cell, params)
                _, m = cell.fn(state, arch.smoke_inputs(
                    shape, torch.Generator().manual_seed(2), "cpu"))
                got = torch.stack([m["loss"], m["grad_norm"]])
                want = None
            elif kind == "encode":
                batch = arch.smoke_inputs(
                    shape, torch.Generator().manual_seed(2), "cpu")
                got = cell.fn(cell.local_params(params), batch)
                want = one.fn(params, batch)
            else:
                block, tokens = cell.smoke_inputs(
                    torch.Generator().manual_seed(2), "cpu")
                got, _ = cell.fn(cell.local_params(params), block, tokens)
                want, _ = one.fn(params, *arch.smoke_inputs(
                    shape, torch.Generator().manual_seed(2), "cpu"))
            out[(name, shape)] = {
                "kind": kind, "shape": tuple(got.shape),
                "finite": bool(torch.isfinite(got).all()),
                "gap": None if want is None else
                float((got - want).abs().max())}
    return out


# -- the reference -----------------------------------------------------------

def shards_by_coords(arr, mesh) -> dict:
    """{(data, model): the addressable shard on that device} of a sharded
    reference array."""
    import numpy as np
    out = {}
    for shard in arr.addressable_shards:
        coords = tuple(int(c) for c in np.argwhere(
            mesh.devices == shard.device)[0])
        out[coords] = np.asarray(shard.data)
    return out


def ref_flat(tree) -> dict:
    """A reference pytree as {"/"-joined path: leaf}."""
    import jax
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference(d: str, which: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_arch
    from repro.sharding import make_mesh

    inp = _load(d)
    shape = tuple(int(n) for n in which.split("x"))
    mesh = make_mesh(shape, AXES)
    sh = lambda tree: jax.tree.map(lambda s: s.sharding, tree)
    out: dict = {"decode": {}}
    for name in DECODE_ARCHS:
        arch = get_arch(name).reduced()
        for shp in SERVE_SHAPES:
            case = inp["decode"][(name, shp)]
            cell = arch.build_cell(shp, mesh=mesh)
            ap, ac, at = cell.abstract_args
            step = jax.jit(cell.fn, **cell.jit_kwargs)
            params = jax.device_put(
                jax.tree.map(jnp.asarray, inp["params"][name]), sh(ap))
            got: dict = {"spec": tuple(ac["k"].sharding.spec)}
            for i, start in enumerate(starts(arch.shapes[shp]["seq_len"])):
                cache = jax.device_put(
                    {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"]),
                     "len": jnp.asarray(start, jnp.int32)}, sh(ac))
                logits = []
                for s in range(STEPS):
                    toks = jax.device_put(
                        jnp.asarray(case["tokens"][i][s]), at.sharding)
                    y, cache = step(params, cache, toks)
                    logits.append(np.asarray(y))
                got[start] = {"logits": logits,
                              "k": shards_by_coords(cache["k"], mesh),
                              "v": shards_by_coords(cache["v"], mesh),
                              "len": int(cache["len"])}
            out["decode"][(which, name, shp)] = got
    if shape == (2, 2):
        out["encode"] = ref_encode(inp, mesh, sh)
        out["train"] = ref_train(inp, mesh, sh)
        out["retriever"] = ref_retriever(d, inp, mesh)
    _save(d, f"reference-{which}.pkl", out)


def ref_encode(inp, mesh, sh) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_arch

    out = {}
    for name in ENCODE_ARCHS:
        cell = get_arch(name).reduced().build_cell("prefill_32k", mesh=mesh)
        ap, ab = cell.abstract_args
        params = jax.device_put(
            jax.tree.map(jnp.asarray, inp["params"][name]), sh(ap))
        batch = jax.device_put(
            jax.tree.map(jnp.asarray, inp["encode"][name]), sh(ab))
        out[name] = np.asarray(jax.jit(cell.fn)(params, batch))
    return out


def ref_train(inp, mesh, sh) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_arch
    from repro.models import transformer
    from repro.training.optimizer import OptimizerConfig, make_optimizer

    out = {}
    for name in MOE_ARCHS:
        arch = get_arch(name).reduced()
        cell = arch.build_cell("train_4k", mesh=mesh)
        astate, abatch = cell.abstract_args
        params = jax.tree.map(jnp.asarray, inp["params"][name])
        opt_init, _ = make_optimizer(OptimizerConfig(name="adamw",
                                                     learning_rate=1e-3))
        state = jax.device_put({"step": jnp.zeros((), jnp.int32),
                                "params": params,
                                "opt": opt_init(params)}, sh(astate))
        batch = jax.device_put(jax.tree.map(jnp.asarray, inp["train"][name]),
                               sh(abatch))
        ctx = (mesh, arch.axis_rules())
        aux, aux_grads = jax.jit(jax.value_and_grad(
            lambda p, b: transformer.forward_hidden(
                arch.cfg, p, b["tokens"], b["mask"], ctx)[1]))(
            state["params"], batch["passage"])
        state, m = jax.jit(cell.fn, **cell.jit_kwargs)(state, batch)
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "aux": float(aux),
                     "aux_grads": {p: np.asarray(v) for p, v in ref_flat(
                         aux_grads).items()},
                     "state": {p: np.asarray(v) for p, v in ref_flat(
                         {"params": state["params"],
                          "opt": state["opt"]}).items()}}
    return out


def ref_retriever(d, inp, mesh) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_arch
    from repro.core.config import RetrievalTrainingArguments
    from repro.models.encoder import DefaultEncoder
    from repro.models.retriever import BiEncoderRetriever
    from repro.training.trainer import RetrievalTrainer

    cfg = get_arch(RETRIEVER_ARCH).reduced().cfg
    trainer = RetrievalTrainer(
        BiEncoderRetriever(DefaultEncoder(cfg), "infonce"),
        train_args(os.path.join(d, "ref-run"), RetrievalTrainingArguments),
        mesh=mesh)
    params = jax.tree.map(jnp.asarray, inp["params"][RETRIEVER_ARCH])
    state = {"step": jnp.zeros((), jnp.int32), "params": params,
             "opt": trainer.opt_init(params),
             "rng": jax.random.key_data(jax.random.key(1))}
    state = jax.device_put(state, trainer.state_shardings(state))
    state, m = trainer._build_step(None)(
        state, jax.tree.map(jnp.asarray, inp["retriever"]))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {p: np.asarray(v) for p, v in ref_flat(
                {"params": state["params"], "opt": state["opt"]}).items()}}


if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                         "src")]
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]))
    else:
        reference(sys.argv[2], sys.argv[3])

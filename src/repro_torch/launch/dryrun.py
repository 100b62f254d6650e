"""Dry run: cost every (arch x shape) cell at its published shape on one
H100, on the meta device.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell with XLA against a 256- or 512-chip mesh and reads
``cost_analysis()`` / ``memory_analysis()``; eager torch compiles
nothing, so for each cell this

  * builds the cell (``build_cell(shape, device="meta")``) and makes its
    arguments on ``meta`` from ``param_shapes`` / ``_batch_shapes`` /
    ``init_cache`` (:func:`meta_args`): nothing is allocated anywhere;
  * runs ``cell.fn`` once under ``launch.roofline.CostMode``, which
    counts its FLOPs by dtype and its bytes, the kernel wrappers' calls
    included;
  * reckons its memory (``launch.memmodel.memory_model``, ``fits_80GB``)
    and its roofline terms on one card.

A step that reads a device value on the host (``int()`` of a cache
length, ``.tolist()`` of expert counts, a graph's id range) cannot run
on meta.  Its FLOPs are then the reference's analytic substitute, as the
reference does for scanned stacks: ``model_flops`` x 4/3 for a train
cell with remat on (the forward recomputed), x 1 otherwise, its bytes
``analytic_bytes``, and ``flops_source`` names the read as ``"analytic:
src/repro_torch/...:line"`` (else ``"counted"``).

Usage (CPU or card alike; nothing leaves the host):
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out DIR] [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import init_train_state
from repro_torch.launch.memmodel import memory_model
from repro_torch.launch.roofline import (CostMode, HostRead, analytic_bytes,
                                         model_flops, roofline_terms)
from repro_torch.models import transformer
from repro_torch.training.tree import tree_map

# fwd + bwd + fwd-recompute / (fwd + bwd)
REMAT_RECOMPUTE_FACTOR = 4.0 / 3.0
META = torch.device("meta")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def meta_args(arch, shape_name: str, cell) -> tuple:
    """A cell's arguments on meta, as its ``fn`` takes them: ``(state,
    batch)`` for a train cell (the state from ``init_train_state``),
    ``(params, cache, tokens)`` for an LM serve cell, ``(params, batch)``
    otherwise.  Parameters in the arch's dtype; ids int32, features and
    labels float32; a full graph's batch without its neighbour table (the
    step builds it)."""
    spec = arch.shapes[shape_name]
    if arch.family == "lm":
        cfg = arch.cfg
        params = tree_map(lambda s: _empty(s, cfg.dtype),
                          transformer.param_shapes(cfg))
        b, s = spec["global_batch"], spec["seq_len"]
        if spec["kind"] == "serve":
            return (params, transformer.init_cache(cfg, b, s, META),
                    _empty((b,), torch.int32))

        def toks():
            return {"tokens": _empty((b, s), torch.int32),
                    "mask": _empty((b, s), torch.int32)}

        batch = ({"query": toks(), "passage": toks()}
                 if spec["kind"] == "train" else toks())
    elif arch.family == "recsys":
        params = {k: _empty(s, arch.cfg.dtype)
                  for k, s in arch.param_shapes().items()}
        batch = {k: _empty(s, torch.float32 if k == "labels"
                           else torch.int32)
                 for k, s in arch._batch_shapes(spec).items()}
    else:
        cfg = arch.shape_cfg(shape_name)
        params = {k: _empty(s, cfg.dtype)
                  for k, s in arch.param_shapes(shape_name).items()}
        batch = {k: _empty(s, torch.int32 if is_int else torch.float32)
                 for k, (s, is_int) in arch._batch_shapes(shape_name).items()}
    if cell.kind == "train":
        return init_train_state(cell, params), batch
    return params, batch


def _remat(arch) -> bool:
    return bool(getattr(arch.cfg, "remat", False))


def analytic_cost(arch, shape_name: str, kind: str) -> dict:
    """The reference's substitute where a step cannot be counted:
    ``model_flops`` (x 4/3 for a train cell with remat on), under the
    arch's parameter dtype, and ``analytic_bytes``."""
    mult = REMAT_RECOMPUTE_FACTOR if kind == "train" and _remat(arch) \
        else 1.0
    flops = model_flops(arch, shape_name) * mult
    dtype = str(arch.cfg.dtype).removeprefix("torch.")
    return {"flops": flops, "flops_by_dtype": {dtype: flops},
            "bytes": analytic_bytes(arch, shape_name)}


def count_cell(cell, args) -> CostMode:
    """One step of ``cell`` on ``args`` under a fresh :class:`CostMode`
    (meta, CPU or CUDA alike); raises ``HostRead`` on meta where the step
    reads a device value on the host."""
    mode = CostMode()
    with mode:
        cell.fn(*args)
    return mode


def run_cell(arch_name: str, shape_name: str, *, arch=None) -> dict:
    """Cost one cell at its shape on one card; the reference's record
    keys (``xla_*``, ``lower_s`` and ``compile_s`` have no eager
    counterpart; ``wall_s`` is this count's host seconds)."""
    arch = arch or get_arch(arch_name)
    cell = arch.build_cell(shape_name, device=META)
    args = meta_args(arch, shape_name, cell)
    mem = memory_model(arch, shape_name, cell, args)
    t0 = time.monotonic()
    kernels = {}
    try:
        mode = count_cell(cell, args)
        cost, kernels, source = mode.cost(), mode.kernels, "counted"
    except HostRead as e:
        cost = analytic_cost(arch, shape_name, cell.kind)
        source = f"analytic: {e.where}"
    wall = time.monotonic() - t0
    terms = roofline_terms(cost, 0)
    mf = model_flops(arch, shape_name)
    coll = dict.fromkeys(COLLECTIVES, 0)
    coll.update(count=0, total=0)
    return {
        "arch": arch_name, "shape": shape_name, "kind": cell.kind,
        "n_devices": 1,
        "memory": {"model": mem},
        "cost": cost,
        "kernels": kernels,
        "collectives": coll,
        "roofline": terms,
        "flops_source": source,
        "model_flops_global": mf,
        "useful_compute_ratio": mf / cost["flops"] if cost["flops"] else None,
        "wall_s": round(wall, 3),
    }


def _not_ported(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs a device mesh across cards (ROADMAP queue 1 item "
        f"10); the port's dry run costs one card")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    for flag in ("multi_pod", "both_meshes"):
        if getattr(args, flag):
            raise _not_ported("--" + flag.replace("_", "-"))
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch_name, shape_name in cells:
        path = os.path.join(args.out, f"onecard__{arch_name}__{shape_name}"
                                      f".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {arch_name} {shape_name}")
            continue
        try:
            rec = run_cell(arch_name, shape_name)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            mm = rec["memory"]["model"]
            print(f"[ok]   {arch_name} {shape_name} "
                  f"count={rec['wall_s']:.1f}s "
                  f"mem={mm['total_bytes'] / 1e9:.2f}GB"
                  f"{'' if mm['fits_80GB'] else '(!)'} "
                  f"dom={r['dominant']} "
                  f"c={r['compute_s'] * 1e3:.2f}ms "
                  f"m={r['memory_s'] * 1e3:.2f}ms "
                  f"n={r['collective_s'] * 1e3:.2f}ms "
                  f"flops={rec['flops_source']}", flush=True)
        except Exception as e:                      # noqa: BLE001
            failures.append((arch_name, shape_name, str(e)))
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"[FAIL] {arch_name} {shape_name}: "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print(f"\nALL {len(cells)} CELLS COSTED")


if __name__ == "__main__":
    main()

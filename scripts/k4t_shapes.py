#!/usr/bin/env python3
"""Time K4T (the port's EmbeddingBag backward) of one checkout at the
training shape, and DeepFM's training step around it, on one NVIDIA GPU.

    python3 scripts/k4t_shapes.py [--src CHECKOUT/src] [--sweep]
                                  [--steps N]

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package to time, so two trees can be compared in one
run on one card: an unpacked ``git archive`` of another commit, then this
one.  K4T's Python entry point
``repro_torch.kernels.embedding_bag.embedding_bag_backward_`` is the same
in every tree that has it; trees without K4T's row tiles (no
``backward_plan``) fill the gradient with zeros inside that call.

Rows (train_batch, B = 65,536, seed 0): DeepFM's 39 fields over its
34,312,192 rows at D = 10 (the FM sum) and D = 1 (the linear term),
Wide&Deep's 40 at D = 1 (the wide term), and DeepFM's at D = 10 with 5 %
of each field's ids on one hot row (``chip_smoke.hot_ids``).  Each row
times the whole call, the sort of the ids, the zero fill (what the older
form runs first) and the kernel alone through the C entry point; then
DeepFM's pair of calls (D = 10 then D = 1) each sorting its ids, and, in
trees with ``ops.BagKeys``, sharing one sort; then ``--steps`` steps of
DeepFM's ``train_batch`` cell at full width (seeded weights, one seeded
batch), each between two CUDA events.  ``--sweep`` also times K4T's
other plans at DeepFM's rows: tile bytes x threads x an entry's work x
the plan's grid or twice it.
Each kernel time is the median of 30 calls between two CUDA events
(``chip_smoke.median_ms``).  Prints the card's name and power limit,
then one JSON line: ``{"src": ..., "card": ..., "rows": [...], "pair":
{...}, "step_ms": [...], "sweep": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--steps", type=int, default=12)
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"k4t_shapes.py: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [src, HERE]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k4t_shapes.py: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops, topk
    from repro_torch.kernels import embedding_bag as bag

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(f"card: {card}")
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiled = hasattr(bag, "backward_plan")
    # trees whose K4T sorts padding past the last row take a scratch
    # buffer for its first pass's NaN flags
    scratch = ((torch.empty(1024, dtype=torch.int32, device=dev).data_ptr(),)
               if hasattr(bag, "PAD_KEY") else ())
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    deepfm, wide = get_arch("deepfm"), get_arch("wide-deep")

    def nothing():
        pass

    def ids(arch, skewed=False):
        idx = arch.smoke_inputs(cs.TRAIN_SHAPE, np.random.default_rng(
            cs.SEED), dev)["sparse_idx"]
        return cs.hot_ids(arch, idx, g) if skewed else idx

    def kernel(out, grad, idx, keys, plan=None):
        b, n_slots = idx.shape
        v, d = out.shape
        head = (grad.data_ptr(), 0, idx.data_ptr(), None, keys[0].data_ptr(),
                keys[1].data_ptr(), b * n_slots, n_slots, v, d)
        if not tiled:
            return lambda: lib.repro_embedding_bag_backward(
                *head, bag.BACKWARD_THREADS, out.data_ptr(), stream)
        if plan is None:
            plan = (*bag.backward_plan(v, d, 4, topk.sm_count(dev)),
                    bag.backward_entry_work(d))
        rows, threads, grid, entry_work = plan
        return lambda: lib.repro_embedding_bag_backward(
            *head, rows, threads, grid, entry_work, *scratch, out.data_ptr(),
            stream)

    rows, sweep = [], {}
    for label, arch, d, skewed in (("DeepFM", deepfm, 10, False),
                                   ("DeepFM", deepfm, 1, False),
                                   ("Wide&Deep", wide, 1, False),
                                   ("DeepFM 5% hot", deepfm, 10, True)):
        idx = ids(arch, skewed)
        v = arch.cfg.total_vocab
        grad = torch.randn(idx.shape[0], d, generator=g,
                           device=dev).mul_(1e-3)
        out = torch.empty((v, d), device=dev)
        keys = bag.backward_keys(idx)
        name = f"{label} D={d}"
        rows.append({
            "row": name,
            "ms": cs.median_ms(lambda: bag.embedding_bag_backward_(
                out, grad, idx), nothing),
            "sort_ms": cs.median_ms(lambda: bag.backward_keys(idx),
                                    nothing),
            "fill_ms": cs.median_ms(out.zero_, nothing),
            "kernel_ms": cs.median_ms(kernel(out, grad, idx, keys),
                                      out.zero_ if not tiled else nothing)})
        print(f"{name}: {json.dumps(rows[-1])}")
        if args.sweep and tiled and not label.startswith("Wide"):
            sms = topk.sm_count(dev)
            sweep[name] = {}
            base = bag.backward_entry_work(d)
            plans = [(t, th, w, m) for t in (8192, 16384)
                     for th in (128, 256) for w in (base // 2, base, 2 * base)
                     for m in (1, 2)]
            for tile_bytes, threads, work, mult in plans:
                rows_, threads_, grid = bag.backward_plan(
                    v, d, 4, sms, tile_bytes=tile_bytes, threads=threads)
                plan = (rows_, threads_, grid * mult, work)
                key = f"{tile_bytes},{threads},{work},x{mult}"
                sweep[name][key] = ([rows_, grid * mult], cs.median_ms(
                    kernel(out, grad, idx, keys, plan), nothing))
            print(f"{name} sweep: {json.dumps(sweep[name])}")
        del out, grad, keys
        torch.cuda.empty_cache()

    # DeepFM's pair of backwards in one step, over one set of ids
    idx = ids(deepfm)
    v = deepfm.cfg.total_vocab
    grads = {d: torch.randn(idx.shape[0], d, generator=g,
                            device=dev).mul_(1e-3) for d in (10, 1)}
    outs = {d: torch.empty((v, d), device=dev) for d in (10, 1)}

    def pair(shared):
        kw = {"keys": ops.BagKeys(idx)} if shared else {}
        for d in (10, 1):
            bag.embedding_bag_backward_(outs[d], grads[d], idx, **kw)

    pair_ms = {"pair_ms": cs.median_ms(lambda: pair(False), nothing)}
    if hasattr(ops, "BagKeys"):
        pair_ms["pair_shared_ms"] = cs.median_ms(lambda: pair(True), nothing)
    print(f"DeepFM pair: {json.dumps(pair_ms)}")
    del outs, grads
    torch.cuda.empty_cache()

    # DeepFM's train_batch step at full width
    cell, state = cs.train_state(deepfm, dev)
    batch = deepfm.smoke_inputs(cs.TRAIN_SHAPE, np.random.default_rng(
        cs.SEED), dev)
    step_ms = []
    for _ in range(args.steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _m = cell.fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    later = step_ms[2:] or step_ms
    print(f"DeepFM train_batch step ms: median of steps 3.. "
          f"{statistics.median(later):.3f}, all {step_ms}")
    print(json.dumps({"src": src, "card": card, "rows": rows,
                      "pair": pair_ms, "step_ms": step_ms,
                      "step_median_ms": statistics.median(later),
                      "sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

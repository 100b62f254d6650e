#!/usr/bin/env python3
"""Time K4 (the port's EmbeddingBag) of one checkout at its path shapes,
on one NVIDIA GPU.

    python3 scripts/k4_shapes.py [--src CHECKOUT/src] [--sweep]

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package to time, so two trees can be compared in one
run on one card: an unpacked ``git archive`` of another commit, then this
one.  K4's Python entry point ``repro_torch.kernels.ops.embedding_bag`` is
the same in every tree that has it.  Shapes: DeepFM's 39 fields at
serve_p99 (B = 512), serve_bulk (B = 262,144) and retrieval_cand (B =
10^6, the candidate column beside the broadcast user), into random
float32 tables of its 34,312,192 rows at D = 10 (the FM sum) and D = 1
(the linear term); the L2 cache flushed before each call.  Each time is
the median of 30 calls between two CUDA events, the card spinning before
the start event (``chip_smoke.median_ms``).  ``--sweep`` also times other
plans (bags per tile, slots per pass) through the C entry point, which
only trees that take a plan have.  Prints the card's name and power
limit, then one JSON line:
``{"src": ..., "card": ..., "ms": {shape: ms}, "sweep": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(HERE, "src"))
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"k4_shapes.py: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [src, HERE]
    import torch
    if not torch.cuda.is_available():
        print("k4_shapes.py: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(f"card: {card}")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    deepfm = get_arch("deepfm")
    v = deepfm.cfg.total_vocab
    tables = {d: torch.randn(v, d, generator=g, device=dev).mul_(0.01)
              for d in (10, 1)}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def cold():
        flush.zero_()

    ms, sweep = {}, {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        idx = cs.deepfm_ids(deepfm, shape, dev)
        b, n_slots = idx.shape
        for d, table in tables.items():
            name = f"{shape} D={d}"
            ms[name] = cs.median_ms(lambda: ops.embedding_bag(table, idx),
                                    cold)
            if not args.sweep:
                continue
            from repro_torch.kernels import embedding_bag as bag
            from repro_torch.kernels import topk
            bags, n_pass = bag.bag_plan(b, n_slots, d, 4,
                                        topk.sm_count(dev))
            out = torch.empty(b, d, device=dev)
            plans = sorted({(bags, p) for p in (1, 4, 8, 16, n_slots)} |
                           {(t, n_pass) for t in (3, 8, 16, 24, 32, 51, 128)})
            sweep[name] = {"plan": [bags, n_pass], "ms": {
                f"{t},{p}": cs.median_ms(
                    lambda t=t, p=p: cs.k4_at_plan(dev, out, table, idx,
                                                   None, t, p), cold)
                for t, p in plans}}
    print(json.dumps({"src": src, "card": card, "ms": ms, "sweep": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

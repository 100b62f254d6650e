#!/usr/bin/env python3
"""Time K1 (the port's fused score + top-k) of one checkout at its three
path shapes, on one NVIDIA GPU.

    python3 scripts/k1_shapes.py [--src CHECKOUT/src]

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package to time, so two trees can be compared in one
run on one card: an unpacked ``git archive`` of another commit, then this
one.  K1's Python entry point ``repro_torch.kernels.topk.fused_score_topk_``
is the same in every tree that has it.  Shapes: the (fused, kernel)
evaluation path's superchunk (Q = 256, S = 64 chunks of C = 32 rows) and a
serving request of 32 queries at S = 8 and S = 256; d = 768, k = 100, unit
vectors, an empty state reset before each call.  Each time is the median
of 30 calls between two CUDA events, the card spinning before the start
event so that the events time the device's work.  Prints the card's name
and power limit, then one JSON line:
``{"src": ..., "card": ..., "ms": {shape: median ms}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((256, 64), (32, 8), (32, 256))
C, D, K = 32, 768, 100
SPIN_CYCLES = 400_000


def median_ms(torch, fn, reset, n: int = 30) -> float:
    for _ in range(3):
        reset()
        fn()
    times = []
    for _ in range(n):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(here, "src"))
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"k1_shapes.py: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("k1_shapes.py: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops, topk

    dev = resolve_device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    g = torch.Generator(device=dev).manual_seed(0)

    def unit(*shape):
        x = torch.randn(*shape, generator=g, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    out = {}
    for q, s in SHAPES:
        queries, tile = unit(q, D), unit(s, C, D)
        offs = torch.arange(s, dtype=torch.int32, device=dev) * C
        nvs = torch.full((s,), C, dtype=torch.int32, device=dev)
        v, i = ops.empty_state(q, K, dev)

        def reset():
            v.fill_(float("-inf"))
            i.fill_(-1)

        out[f"Q={q} S={s}"] = median_ms(
            torch, lambda: topk.fused_score_topk_(v, i, queries, tile, offs,
                                                  nvs), reset)
    print(json.dumps({"src": src, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

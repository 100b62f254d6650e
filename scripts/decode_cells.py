#!/usr/bin/env python3
"""Phase (q) of ``chip_smoke.py`` alone: the KV-cache decode cells.

Draws qwen2-0.5b, stablelm-3b, gemma-7b, granite-moe-3b-a800m and
llama4-maverick-400b-a17b (cut to one (dense, MoE) pair) at their
published widths with seeded weights on the card, one after the other,
and runs ``chip_smoke.decode_turn`` on each: both serve cells at the cuts
of ``chip_smoke.Q_CUTS`` and (q1)'s decode against prefill.  No kernel is
built: the decode path launches none.  A check that fails is printed and
the next arch runs; the exit code is 1 if any failed.

    python3 scripts/decode_cells.py
"""

import dataclasses
import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                    "src")]

ARCHS = ("qwen2-0.5b", "stablelm-3b", "gemma-7b", "granite-moe-3b-a800m",
         "llama4-maverick-400b-a17b")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(f"[a] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    paths: dict = {}
    failed = []
    t0 = time.perf_counter()
    for name in ARCHS:
        cfg = get_arch(name).cfg
        llama4 = name == cs.P_LLAMA4
        if llama4:
            cfg = dataclasses.replace(cfg, n_layers=cs.P3_LAYERS)
        lm = cs.lm_model(dev, name, cfg)
        try:
            cs.decode_turn(dev, card, name, lm, paths, "alone",
                           consume=llama4)
        except AssertionError as e:
            failed.append(name)
            print(f"[a] {name} FAILED: {e}", flush=True)
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        sys.stdout.flush()
    print(f"[a] {time.perf_counter() - t0:.1f} s; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

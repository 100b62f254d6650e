"""Hill-climb runner: cost named variants of a cell on one card and diff
the roofline terms against the baseline.

The counterpart of ``repro.launch.hillclimb``.  The LM variants that
have a meaning in eager torch on one card are ported (capacity factor,
attention chunk, remat); those that name a compile or mesh knob the port
does not have, by decision (ROADMAP "Not ported, by decision":
``inline_mask``, ``dus_cache_update``, ``seq_shard_acts``,
``moe_impl``), raise a ValueError; every recsys variant but the baseline
is a mesh rule (ROADMAP queue 1 items 4a and 10) and raises
NotImplementedError.

  python -m repro_torch.launch.hillclimb --cell gemma-7b:train_4k \\
      --variants baseline,no_remat --out build/hillclimb
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import run_cell

# named config transforms (LMArch.variant)
LM_VARIANTS = {
    "baseline": {},
    "cap1.0": dict(capacity_factor=1.0),
    "chunk2048": dict(attn_chunk=2048),
    "chunk1024": dict(attn_chunk=1024),
    "chunk8192": dict(attn_chunk=8192),
    "no_remat": dict(remat=False),
}
# the reference's LM variants whose knobs have no eager one-card meaning
NOT_PORTED = ("inline_mask", "dus_cache", "inline_mask+dus", "no_sp_acts",
              "moe_shardmap", "moe_shardmap+inline_mask",
              "inline_mask+chunk2048")
# the reference's recsys variants: embedding and candidate sharding rules
RECSYS_VARIANTS = ("psum_lookup", "cand_full_shard", "psum+cand_shard",
                   "psum_bf16+mlp_shard", "mlp_shard", "replicated_table",
                   "repl_table+full_shard")


def variant_arch(arch, name: str):
    if name == "baseline":
        return arch
    if arch.family == "lm":
        if name in NOT_PORTED:
            raise ValueError(
                f"variant {name!r} sets a compile or mesh knob that is not "
                f"ported, by decision (ROADMAP 'Not ported, by decision'); "
                f"the one-card variants are {sorted(LM_VARIANTS)}")
        return arch.variant(**LM_VARIANTS[name])
    if arch.family == "recsys" and name in RECSYS_VARIANTS:
        raise NotImplementedError(
            f"variant {name!r} is a sharding rule over a device mesh "
            f"(ROADMAP queue 1 items 4a and 10), which the port does not "
            f"have yet")
    raise KeyError(name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="build/hillclimb")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs a device mesh across cards (ROADMAP queue 1 "
            "item 10); the port's hill-climb costs one card")

    arch_name, shape = args.cell.split(":")
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for vname in args.variants.split(","):
        arch = variant_arch(get_arch(arch_name), vname)
        rec = run_cell(arch_name, shape, arch=arch)
        rec["variant"] = vname
        path = os.path.join(args.out, f"{arch_name}__{shape}__{vname}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        r = rec["roofline"]
        rows.append((vname, r))
        print(f"[ok] {vname:18s} count={rec['wall_s']:6.1f}s "
              f"flops={r['flops_per_device']:.3e} "
              f"c={r['compute_s'] * 1e3:9.2f}ms "
              f"m={r['memory_s'] * 1e3:9.2f}ms "
              f"n={r['collective_s'] * 1e3:9.2f}ms "
              f"mem={rec['memory']['model']['total_bytes'] / 1e9:.2f}GB "
              f"flops_source={rec['flops_source']}", flush=True)
    if len(rows) > 1:
        base = rows[0][1]
        print("\ndeltas vs", rows[0][0])
        for vname, r in rows[1:]:
            for term in ("compute_s", "memory_s", "collective_s"):
                if base[term] > 0:
                    d = (r[term] - base[term]) / base[term] * 100
                    print(f"  {vname:18s} {term:13s} {d:+7.1f}%")
    return rows


if __name__ == "__main__":
    main()

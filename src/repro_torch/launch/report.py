"""Roofline report: the dry run's records -> markdown tables.

The counterpart of ``repro.launch.report`` over the port's one-card
records (``launch/dryrun.py``).  It recomputes the memory term with the
fusion-aware analytic traffic model (``roofline.analytic_bytes``) beside
the counted bytes (which take the place of the reference's XLA number),
names the dominant term and renders the roofline and dry-run tables.

  PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_arch
from repro_torch.launch.roofline import HBM_BW, analytic_bytes


def load_records(dir_: str, tag: str = "onecard") -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, f"{tag}__*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def enrich(rec: dict, flash_attn: bool = False, arch=None) -> dict:
    """Add ``roofline_model``: the memory term from ``analytic_bytes``
    beside the counted one, and the bound and dominant term with it.
    ``arch`` is the record's (a cut shape's) where it is not the
    registry's ``rec["arch"]``."""
    arch = arch or get_arch(rec["arch"])
    mem_model_bytes = analytic_bytes(arch, rec["shape"], flash_attn)
    r = rec["roofline"]
    compute_s = r["compute_s"]
    mem_s = mem_model_bytes / HBM_BW
    coll_s = r["collective_s"]
    bound = max(compute_s, mem_s, coll_s)
    dom = {compute_s: "compute", mem_s: "memory",
           coll_s: "collective"}[bound]
    rec["roofline_model"] = {
        "compute_s": compute_s,
        "memory_s_model": mem_s,
        "memory_s_counted": r["memory_s"],
        "collective_s": coll_s,
        "analytic_bytes_per_device": mem_model_bytes,
        "dominant": dom,
        "step_lower_bound_s": bound,
        "roofline_fraction": compute_s / bound if bound else 0.0,
    }
    return rec


def table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | kind | mem GB | compute ms | memory ms "
           "(model / counted) | collective ms | dominant | roofline frac | "
           "useful ratio | flops |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for rec in recs:
        rm = rec["roofline_model"]
        mm = rec["memory"]["model"]
        ratio = rec.get("useful_compute_ratio")
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['kind']} "
            f"| {mm['total_bytes'] / 1e9:.2f}"
            f"{'' if mm['fits_80GB'] else ' (!)'} "
            f"| {rm['compute_s'] * 1e3:.2f} "
            f"| {rm['memory_s_model'] * 1e3:.2f} / "
            f"{rm['memory_s_counted'] * 1e3:.2f} "
            f"| {rm['collective_s'] * 1e3:.2f} "
            f"| {rm['dominant']} "
            f"| {rm['roofline_fraction'] * 100:.1f}% "
            f"| {'-' if ratio is None else f'{ratio:.2f}'} "
            f"| {rec['flops_source']} |")
    return hdr + "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | count s | params+state GB | act GB "
           "| GFLOPs (bf16 / f32) | counted GB | kernel calls |\n"
           "|---|---|---|---|---|---|---|---|\n")
    rows = []
    for rec in recs:
        mm = rec["memory"]["model"]
        by = rec["cost"]["flops_by_dtype"]
        calls = ", ".join(f"{k} {v['calls']}"
                          for k, v in sorted(rec["kernels"].items()))
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['wall_s']:.1f} "
            f"| {(mm['state_and_args_bytes'] + mm['grad_transient_bytes']) / 1e9:.2f} "
            f"| {mm['activation_bytes'] / 1e9:.2f} "
            f"| {by.get('bfloat16', 0) / 1e9:.0f} / "
            f"{by.get('float32', 0) / 1e9:.0f} "
            f"| {rec['cost']['bytes'] / 1e9:.2f} "
            f"| {calls or '-'} |")
    return hdr + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--tag", default="onecard")
    ap.add_argument("--flash-attn", action="store_true")
    args = ap.parse_args(argv)
    recs = [enrich(r, args.flash_attn)
            for r in load_records(args.dir, args.tag)]
    print("## Roofline table (one H100)\n")
    print(table(recs))
    print("\n## Dry-run detail\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()

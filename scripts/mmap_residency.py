#!/usr/bin/env python3
"""Show how this host's kernel counts the pages of a read-only file mmap
in a process's resident set (VmRSS).

    python3 scripts/mmap_residency.py [--mb 200]

The memory claim of ``MMapTable`` / ``TableView`` (resident memory grows
with the rows touched, not with the table) rests on the kernel faulting
file-backed pages in one by one and ``MADV_DONTNEED`` dropping them.  The
script writes a file of ``--mb`` MB into a temporary directory, maps it
as ``np.memmap`` (as ``MMapTable`` maps its payload) and prints VmRSS in
MB after: the map, one byte read, a second byte half way in, one byte
read per MB, and ``MADV_DONTNEED`` over the whole map.  On a kernel that
faults page by page the first reads add little; on one that makes the
whole mapping resident on first touch, the first read adds the file.
Run it on the machine whose host RSS ``chip_smoke.py`` phase (j5)
reports, to read those numbers.  Host memory only; no GPU is used.
"""

from __future__ import annotations

import argparse
import mmap
import os
import tempfile

import numpy as np


def vm_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("/proc/self/status has no VmRSS")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=200)
    args = ap.parse_args(argv)
    mb = 1 << 20
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "payload.bin")
        with open(path, "wb") as f:
            f.write(os.urandom(mb) * args.mb)
        print(f"start: VmRSS {vm_rss_mb():.2f} MB")
        m = np.memmap(path, dtype=np.uint8, mode="r")
        print(f"mapped {args.mb} MB: VmRSS {vm_rss_mb():.2f} MB")
        int(m[0])
        print(f"one byte read: VmRSS {vm_rss_mb():.2f} MB")
        int(m[len(m) // 2])
        print(f"a second byte, {args.mb // 2} MB in: VmRSS "
              f"{vm_rss_mb():.2f} MB")
        for off in range(0, len(m), mb):
            int(m[off])
        print(f"one byte per MB: VmRSS {vm_rss_mb():.2f} MB")
        m._mmap.madvise(mmap.MADV_DONTNEED, 0, len(m))
        print(f"after MADV_DONTNEED: VmRSS {vm_rss_mb():.2f} MB")
        del m


if __name__ == "__main__":
    main()

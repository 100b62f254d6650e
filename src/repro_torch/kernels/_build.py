"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source in this package to an object for
``sm_90a`` (Hopper), one process per source, all started together, and
links the objects into one shared library with a plain C interface,
which ``ctypes`` loads.  The library lands in ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
sources and the flags: a changed source builds anew, an unchanged one is
reused.  ``nvcc -Xptxas -v`` output (registers, shared memory, spills)
is kept beside the library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (argtypes, restype) of the C interface in csrc/*.cu
_SIGNATURES = {
    "repro_fused_score_topk": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P, _P, _P, _P, _P], _I),
    "repro_topk_update": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
                          _I),
    "repro_topk_smem_bytes": ([_I], ctypes.c_longlong),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    "repro_embedding_bag": ([_P, _I, _P, _P, _I, _I, ctypes.c_longlong, _I,
                             _I, _I, _P, _P], _I),
    "repro_embedding_bag_backward": ([_P, _I, _P, _P, _P, _P, _I, _I,
                                      ctypes.c_longlong, _I, _I, _I, _I, _I,
                                      _P, _P, _P], _I),
}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    sources = sorted(CSRC.glob("*.cu"))
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory beside the target and rename into
    # place: a concurrent or interrupted build never leaves a half-written
    # library under the name
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp, f"{src.stem}.o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [src.name for src, proc in zip(sources, procs)
                  if proc.returncode != 0]
        if not failed:
            lib = Path(tmp, out.name)
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=False)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append("link")
        out.with_suffix(".log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}) building "
                               f"{out.name}:\n{''.join(logs)[-4000:]}")
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib

"""Fault-tolerant checkpointing: atomic, async, in the reference's layout.

Layout (one directory per step), as ``repro.training.checkpoint``
writes it, so either package restores the other's checkpoints:

    step_00000123/
      manifest.json      leaf paths, shapes, dtypes, step, save time
      arrays.npz         leaf arrays keyed by their ``/``-joined tree path
                         (``params/blocks/wq``, ``opt/mu/...``, ``step``,
                         ``rng``)

numpy has no bfloat16: a bf16 leaf is stored as its raw two-byte words
(a ``|V2`` array, the bytes the reference's ``ml_dtypes`` arrays leave
in the npz) with ``"dtype": "bfloat16"`` in the manifest, and restored
by that dtype (uint16 bits -> ``torch.int16`` -> ``.view(torch.
bfloat16)``), bit for bit.

Guarantees:
  * atomic — built in a tmp dir and ``os.replace``d into place; a crash
    mid-save leaves a ``.tmp_*`` directory that is never picked up.
  * async  — ``CheckpointManager(async_save=True)`` copies the state to
    host memory synchronously (the trainer updates its tensors in place
    on the next step) and writes on a background thread; a write's
    error surfaces on the next ``save`` / ``wait``.
  * keep-M — after each write only the newest ``keep`` steps remain.
  * elastic — on a mesh (``shardings = (mesh, specs)``, a spec tree of
    the state) every rank gathers each leaf, rank 0 writes the full
    leaves, synchronously, and the ranks meet at a barrier; a restore
    reads the full leaves and keeps each rank's slice under the target
    layout, which may be another mesh than the one saved from (the
    reference's ``restore_checkpoint(..., shardings)``), or no mesh.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.data.table import atomic_write_dir
from repro_torch.training.tree import flatten, unflatten

_BF16 = "bfloat16"


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` as numpy (bf16 as its raw ``|V2`` words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf, copy=True)


def tree_to_flat(tree: Any) -> dict[str, np.ndarray]:
    return {path: _to_host(leaf) for path, leaf in flatten(tree)}


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    return _write_flat(ckpt_dir, step, tree_to_flat(state))


def _write_flat(ckpt_dir: str, step: int, flat: dict) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with atomic_write_dir(path) as tmp:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"step_\d+", d)
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps))


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(path: str, template: Any,
                       shardings: tuple | None = None) -> Any:
    """Restore the leaves of ``template``'s structure (other leaves in the
    checkpoint are not read).  A tensor leaf of the template comes back
    as a tensor of the stored dtype on the template leaf's device; any
    other leaf as a numpy array.  ``shardings = (mesh, specs)`` keeps
    this rank's slice of each tensor leaf under its spec (the template
    holds local slices).  A missing leaf or another shape raises."""
    from repro_torch.sharding.layout import local_slice
    from repro_torch.sharding.partitioning import local_shape

    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    mesh = shardings[0] if shardings is not None else None
    specs = ([s for _, s in flatten(shardings[1])]
             if shardings is not None else [None] * len(flatten(template)))
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for (key, tmpl), spec in zip(flatten(template), specs):
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = z[key]
            shape = tuple(arr.shape)
            if spec is not None and isinstance(tmpl, torch.Tensor):
                shape = local_shape(shape, spec, mesh)
            if shape != tuple(np.shape(tmpl)):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{shape} != {tuple(np.shape(tmpl))}")
            if isinstance(tmpl, torch.Tensor):
                t = _decode(arr, dtypes[key])
                if spec is not None:
                    t = local_slice(t, spec, mesh)
                out.append(t.to(tmpl.device))
            else:
                out.append(arr)
    return unflatten(template, out)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return int(json.load(f)["step"])


class CheckpointManager:
    """save-every-N / keep-M manager with async background writes."""

    def __init__(self, ckpt_dir: str, save_every: int = 100,
                 keep: int = 2, async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, state: Any, blocking: bool | None = None,
             shardings: tuple | None = None):
        """Save ``state`` as ``step``.  With ``shardings = (mesh,
        specs)`` (``state`` holds this rank's slices) every rank gathers
        the full leaves, rank 0 writes them synchronously, and the ranks
        then meet at a barrier, so that a restore on any rank sees the
        write."""
        self.wait()
        if shardings is not None:
            import torch.distributed as dist

            from repro_torch.sharding.layout import gather_tree
            mesh, specs = shardings
            full = gather_tree(state, specs, mesh)
            if mesh.rank == 0:
                self._write(step, tree_to_flat(full))
            del full
            dist.barrier()
            return
        # the host copy is taken here, synchronously: the trainer updates
        # the state's tensors in place on its next step
        host_state = tree_to_flat(state)
        if blocking or not self.async_save:
            self._write(step, host_state)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host_state),
                daemon=True, name="checkpoint-write")
            self._thread.start()

    def _write_guarded(self, step, host_state):
        try:
            self._write(step, host_state)
        except Exception as e:         # surfaced on next save() / wait()
            self._error = e

    def _write(self, step, flat):
        _write_flat(self.ckpt_dir, step, flat)
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if re.fullmatch(r"step_\d+", d))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Any, shardings: tuple | None = None):
        """(state restored into ``template``, its step), or (None, -1)
        when there is no checkpoint; ``shardings`` as for
        :func:`restore_checkpoint`."""
        path = latest_checkpoint(self.ckpt_dir)
        if path is None:
            return None, -1
        return (restore_checkpoint(path, template, shardings),
                checkpoint_step(path))

"""RetrievalTrainer: the training loop (paper §3.4) on one card.

The port of ``repro.training.trainer``:
  * gradient accumulation: the batch reshaped to ``(accum, B/accum,
    ...)``, the microbatch gradients summed in float32 and averaged;
  * global-norm clipping, then AdamW / Adafactor with the LR schedule
    (``training.optimizer``), in place under ``torch.no_grad()``;
  * atomic / async checkpoints in the reference's layout, resume from
    the latest, keep-M (``training.checkpoint``);
  * fault tolerance: ``resilient_loop`` restores the latest checkpoint
    after a failed step, a ``Heartbeat`` file, a ``PreemptionGuard``
    that checkpoints and exits at a step boundary on SIGTERM;
  * training-time IR metrics on a dev set (``IRMetrics``).

The step is plain eager autograd over the parameter dict (no
``torch.compile``).  Batches are drawn from the reference's stream
(``np.random.default_rng(seed)``, ``per_device_batch_size x
grad_accum_steps`` indices a step), so both packages train on the same
batches.  Three things differ from the reference, on purpose: step ``s``
always takes the stream's ``s``-th draw, also after a restore (the
reference's stream runs on, so a resumed run sees other batches than an
uninterrupted one), ``inject_failure_at`` fails once (the reference's
fails again each time the resumed loop reaches that step), and a restore
resumes at the restored state's own step count.

An MoE encoder's load-balance loss enters the retriever's loss as
``aux_loss_weight`` (0.01) times it, logged as ``moe_aux_loss`` (0.0
for a dense encoder), as in the reference.

On a mesh (``mesh=``, bound to a process group of its size; ``rules``
default to the encoder's ``axis_rules()``) the state is held as each
rank's slices under :meth:`RetrievalTrainer.state_shardings` (the
reference's: optimizer state mirrors the parameters, Adafactor's
factored ``vr`` / ``vc`` drop the spec's last / second-to-last entry),
the stream's batch grows to ``per_device_batch_size`` x the mesh's ranks,
and a step is ``sharding.layout``'s meshed step: gather, forward and
backward on this rank's rows (the retriever's scores over the whole
batch), data-axis mean, clip, update on local slices.
``dp_mode="shard_map"`` then compresses the already averaged gradient
as the reference does (bf16 round trip, or int8 with error feedback in
``state["ef"]``; ROADMAP queue 3, fault 12).  Checkpoints hold full
leaves (rank 0 writes them) and restore onto any mesh.  The state's
``rng`` leaf is a uint32 (2,) array under
the reference's key, so the reference's restore templates find every
leaf they ask for; it holds the reference's initial key data (threefry
``key(seed + 1)``) and is not advanced by a step, so its values are not
the reference's after the first step.  No step reads it.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.config import RetrievalTrainingArguments
from repro_torch.core.metrics import IRMetrics
from repro_torch.device import resolve_device
from repro_torch.sharding.layout import (batch_shard, clip_local,
                                         data_specs, gather_leaf,
                                         gather_tree, local_slice,
                                         meshed_grads, shard_tree,
                                         update_local)
from repro_torch.sharding.partitioning import AxisRules, P, data_axes
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import grad_compression as gc
from repro_torch.training.fault_tolerance import (Heartbeat, PreemptionGuard,
                                                  resilient_loop)
from repro_torch.training.optimizer import (OptimizerConfig, _state_at,
                                            adafactor_entries,
                                            clip_by_global_norm,
                                            make_optimizer)
from repro_torch.training.tree import flatten, tree_map, unflatten

STEP_PHASES = ("forward", "backward", "update")


class RetrievalTrainer:
    def __init__(self, retriever, args: RetrievalTrainingArguments,
                 collator=None, train_dataset=None,
                 loss_fn: Callable | None = None,
                 dev_dataset=None,
                 compute_metrics: IRMetrics | None = None,
                 mesh=None, rules: AxisRules | None = None,
                 dp_mode: str = "pjit",
                 device: str | torch.device = "cuda"):
        if dp_mode not in ("pjit", "shard_map"):
            raise ValueError(f"unknown dp_mode {dp_mode!r}")
        self.retriever = retriever
        self.args = args
        self.collator = collator
        self.train_dataset = train_dataset
        self.dev_dataset = dev_dataset
        self.compute_metrics = compute_metrics
        self.device = resolve_device(device)
        self.mesh = mesh
        encoder = getattr(retriever, "encoder", None)
        self.rules = rules or (encoder.axis_rules()
                               if hasattr(encoder, "axis_rules")
                               else AxisRules())
        self.dp_mode = dp_mode
        self.specs = None               # the state's, set by init_state
        if retriever is not None:
            retriever.aux_loss_weight = args.aux_loss_weight
        self._ctx = (mesh, self.rules) if mesh is not None else None
        # without a mesh, any retriever duck-type's forward(params, batch)
        self.loss_fn = loss_fn or (
            (lambda p, b: retriever.forward(p, b)) if mesh is None else
            (lambda p, b: retriever.forward(p, b, self._ctx)))
        self.opt_cfg = OptimizerConfig(
            name=args.optimizer, learning_rate=args.learning_rate,
            weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
            total_steps=args.max_steps, grad_clip=args.grad_clip)
        self.opt_init, self.opt_update = make_optimizer(self.opt_cfg)
        self.ckpt_mgr = ckpt.CheckpointManager(
            os.path.join(args.output_dir, "checkpoints"),
            save_every=args.checkpoint_every, keep=args.keep_checkpoints,
            async_save=args.async_checkpoint)
        self.logs: list[dict] = []
        # per step: (phase, mark) pairs, a mark a CUDA event on the card
        # and a perf_counter reading on the CPU (see step_ms)
        self._marks: list[list] = []

    # -- state -------------------------------------------------------------
    def init_state(self, params=None) -> dict:
        """step 0, ``params`` (seeded from ``args.seed`` when None), the
        optimizer state, the ``rng`` leaf and, for int8 compression, the
        error-feedback residuals ``ef``."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.args.seed)
            params = self.retriever.init_params(gen, self.device)
        state = {"step": torch.zeros((), dtype=torch.int32),
                 "params": params, "opt": self.opt_init(params),
                 "rng": np.array([0, self.args.seed + 1], np.uint32)}
        if self.args.grad_compression == "int8":
            state["ef"] = gc.init_error_feedback(params)
        if self.mesh is not None:
            self.specs = self.state_shardings(state)
            state = shard_tree(state, self.specs, self.mesh)
        return state

    def state_shardings(self, state) -> dict | None:
        """The specs of a full (unsliced) train state under the rules
        (the reference's ``state_shardings``): the parameters' from their
        logical axes, AdamW's moments and ``ef`` mirroring them,
        Adafactor's from the parameter's spec by
        ``optimizer.adafactor_entries`` (its cells re-resolve the logical
        axes instead, as the reference's do); ``step`` and ``rng``
        replicated."""
        if self.mesh is None:
            return None
        param_specs = tree_map(
            lambda p, axes: self.rules.spec_for(axes, tuple(p.shape),
                                                self.mesh),
            state["params"], self.retriever.param_logical_axes())
        opt = state["opt"]
        if "mu" in opt:
            opt_specs = {"mu": param_specs, "nu": param_specs}
        else:
            def fac(path, spec):
                v = _state_at(opt["v"], path)
                return {k: P(*e) for k, e in
                        adafactor_entries(spec, "vr" in v).items()}
            opt_specs = {"v": unflatten(param_specs, [
                fac(path, spec) for path, spec in flatten(param_specs)])}
        specs = {"step": P(), "params": param_specs, "opt": opt_specs,
                 "rng": P()}
        if "ef" in state:
            specs["ef"] = param_specs
        return specs

    def batch_sharding(self):
        """The batch's spec: dim 0 over the data axes (None without a
        mesh)."""
        if self.mesh is None:
            return None
        axes = data_axes(self.mesh)
        return P(axes if axes else None)

    # -- timing --------------------------------------------------------------
    def _mark(self, phase: str) -> None:
        if self.device.type == "cuda":
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        else:
            mark = time.perf_counter()
        self._marks[-1].append((phase, mark))

    def step_ms(self) -> list[dict]:
        """Each step's ms in forward / backward / update (clip +
        optimizer) and in all, in order; the card is synchronised first.
        On the card the marks are CUDA events, so a phase's ms is the
        device timeline between its marks, host gaps included."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = []
        for marks in self._marks:
            rec = dict.fromkeys(STEP_PHASES, 0.0)
            for (_, a), (phase, b) in zip(marks, marks[1:]):
                rec[phase] += (a.elapsed_time(b) if self.device.type ==
                               "cuda" else (b - a) * 1e3)
            rec["total"] = sum(rec[p] for p in STEP_PHASES)
            out.append(rec)
        return out

    # -- train step ----------------------------------------------------------
    def _to_device(self, batch):
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)

    def _grads_of(self, params, batch):
        """(loss, metrics, grads) of one (micro)batch.  The parameters go
        in as detached leaves that require grad (views of the same
        storage), so the state's tensors carry no autograd history."""
        paths_leaves = flatten(params)
        leaves = [p.detach().requires_grad_(True) for _, p in paths_leaves]
        out = self.loss_fn(unflatten(params, leaves), batch)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        self._mark("forward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        self._mark("backward")
        return (loss.detach(),
                {k: torch.as_tensor(v).detach() for k, v in metrics.items()},
                unflatten(params, grads))

    def _step(self, state: dict, batch) -> tuple[dict, dict]:
        self._marks.append([])
        self._mark("start")
        batch = self._to_device(batch)
        if self.mesh is not None:
            return self._meshed_step(state, batch)
        accum = self.args.grad_accum_steps
        params = state["params"]
        if accum > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                mb = tree_map(lambda x: x[i], batch)
                mb_loss, metrics, mb_grads = self._grads_of(params, mb)
                grads = tree_map(torch.add, grads, mb_grads)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        else:
            loss, metrics, grads = self._grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, self.opt_cfg.grad_clip)
        self.opt_update(grads, state["opt"], params, state["step"])
        self._mark("update")
        state["step"] = state["step"] + 1
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm)
        return state, metrics

    def _meshed_step(self, state: dict, batch) -> tuple[dict, dict]:
        """One step on the mesh over the global ``batch`` (this rank
        takes its rows; microbatches along dim 0, rows along dim 1)."""
        mesh, specs, accum = self.mesh, self.specs, self.args.grad_accum_steps
        pspecs = specs["params"]
        rows = data_specs(batch, mesh)
        if accum > 1:
            rows = tree_map(lambda s: P(None, *s), rows)
        local = batch_shard(batch, rows, mesh)
        if accum > 1:
            grads, loss = None, 0.0
            for i in range(accum):
                mb_loss, metrics, mb_grads, full = meshed_grads(
                    self.loss_fn, state["params"], pspecs,
                    tree_map(lambda x: x[i], local), mesh, marks=self._mark)
                # float32 sums, as the one-process accumulation
                grads = (tree_map(lambda g: g.float(), mb_grads)
                         if grads is None else
                         tree_map(torch.add, grads, mb_grads))
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        else:
            loss, metrics, grads, full = meshed_grads(
                self.loss_fn, state["params"], pspecs, local, mesh,
                marks=self._mark)
        if self.dp_mode == "shard_map":
            grads = self._compressed_sync(grads, state)
        grads, gnorm = clip_local(grads, pspecs, mesh,
                                  self.opt_cfg.grad_clip)
        update_local(self.opt_cfg, self.opt_update, grads, state["opt"],
                     state["params"], state["step"], pspecs,
                     specs["opt"], mesh, full)
        self._mark("update")
        state["step"] = state["step"] + 1
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm)
        return state, metrics

    @torch.no_grad()
    def _compressed_sync(self, grads, state):
        """The reference's ``dp_mode="shard_map"`` on the averaged full
        gradient: a bf16 round trip, or int8 with the residual carried in
        ``state["ef"]`` (this rank's slice, the quantization over the
        whole leaf); gradients come back in float32."""
        method = self.args.grad_compression
        if method == "none":
            return grads
        if method == "bf16":
            return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
        if method != "int8":
            raise ValueError(method)
        out, residuals = [], []
        for (path, g), e, spec in zip(
                flatten(grads), [t for _, t in flatten(state["ef"])],
                [s for _, s in flatten(self.specs["ef"])]):
            g = g.float() + gather_leaf(e, spec, self.mesh)
            deq = gc.dequantize_int8(*gc.quantize_int8(g))
            out.append(deq)
            residuals.append(local_slice(g - deq, spec, self.mesh))
        for e, r in zip([t for _, t in flatten(state["ef"])], residuals):
            e.copy_(r)
        return unflatten(grads, out)

    # -- data ------------------------------------------------------------------
    def _batches(self, start: int) -> Iterator[dict]:
        """The batch stream from step ``start`` on: the reference's
        ``default_rng(seed)`` draws, the first ``start`` skipped; on a
        mesh ``per_device_batch_size`` x its ranks a draw."""
        n = len(self.train_dataset)
        bsz = self.args.per_device_batch_size * (
            self.mesh.size if self.mesh is not None else 1)
        accum = self.args.grad_accum_steps
        rng = np.random.default_rng(self.args.seed)
        for _ in range(start):
            rng.integers(0, n, size=bsz * accum)
        while True:
            idx = rng.integers(0, n, size=bsz * accum)
            feats = [self.train_dataset[int(i)] for i in idx]
            batch = self.collator(feats)
            if accum > 1:
                batch = tree_map(
                    lambda x: np.reshape(
                        x, (accum, x.shape[0] // accum) + x.shape[1:]),
                    batch)
            yield batch

    # -- main loop ---------------------------------------------------------------
    def train(self, state: dict | None = None,
              inject_failure_at: int | None = None) -> dict:
        """Train to ``args.max_steps`` from the latest checkpoint in
        ``output_dir/checkpoints`` if there is one, else from ``state``
        (``init_state()`` when None); returns the final state, which is
        also saved as ``step_{max_steps}``.  ``inject_failure_at`` makes
        that step fail once, after its batch is drawn."""
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        if state is None:
            state = self.init_state()
        restored, _ = self.ckpt_mgr.restore_latest(state, **self._layout())
        if restored is not None:
            state = restored
        start = int(state["step"])
        box = {"state": state, "batches": self._batches(start),
               "inject": inject_failure_at}
        t_start = time.monotonic()

        def do_step(step: int):
            batch = next(box["batches"])
            if box["inject"] is not None and step == box["inject"]:
                box["inject"] = None
                raise RuntimeError(f"injected failure at step {step}")
            box["state"], metrics = self._step(box["state"], batch)
            if step % args.log_every == 0 or step == args.max_steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step,
                           wall=time.monotonic() - t_start)
                if self.dev_dataset is not None and self.compute_metrics:
                    rec.update(self._dev_metrics(box["state"]["params"]))
                self.logs.append(rec)
            if self.ckpt_mgr.should_save(step):
                self.ckpt_mgr.save(step, box["state"], **self._layout())
            hb.update(step)
            if guard.should_exit:
                self.ckpt_mgr.save(step, box["state"], blocking=True,
                                   **self._layout())
                raise SystemExit(0)

        def on_failure(exc):
            # a save still in flight may be the one to restore
            self.ckpt_mgr.wait()
            restored, _ = self.ckpt_mgr.restore_latest(box["state"],
                                                       **self._layout())
            if restored is None:
                box["state"], resume = self.init_state(), 0
            else:
                # the state's own step count: a periodic save of step s
                # holds s + 1 updates, the final save of max_steps holds
                # max_steps (the reference's rstep + 1 skips a step there)
                box["state"], resume = restored, int(restored["step"])
            box["batches"] = self._batches(resume)
            return resume

        rank = self.mesh.rank if self.mesh is not None else 0
        beat = "heartbeat.json" if not rank else f"heartbeat-{rank}.json"
        with Heartbeat(os.path.join(args.output_dir, beat)) \
                as hb, PreemptionGuard() as guard:
            resilient_loop(do_step, start, args.max_steps, on_failure)
        self.ckpt_mgr.save(args.max_steps, box["state"], blocking=True,
                           **self._layout())
        self.ckpt_mgr.wait()
        return box["state"]

    def _layout(self) -> dict:
        """The checkpoint manager's ``shardings`` on a mesh (nothing on
        one process, so its one-process calls stay as they were)."""
        return {} if self.mesh is None else {
            "shardings": (self.mesh, self.specs)}

    # -- training-time IR metrics (paper §3.4) -------------------------------------
    @torch.no_grad()
    def _dev_metrics(self, params) -> dict:
        if self.mesh is not None:
            params = gather_tree(params, self.specs["params"], self.mesh)
        groups = self.dev_dataset
        feats = groups if isinstance(groups, list) else groups.dev_groups(32)
        host = self.collator(feats)
        batch = self._to_device(host)
        q = self.retriever.encode_query(params, batch["query"])
        p = self.retriever.encode_passage(params, batch["passage"])
        nq = q.shape[0]
        p = p.reshape(nq, -1, p.shape[-1])
        scores = torch.einsum("qd,qgd->qg", q, p).float().cpu().numpy()
        labels = host.get("labels")
        if labels is None:
            labels = np.zeros(scores.shape, np.float32)
            labels[:, 0] = 1.0
        return self.compute_metrics(scores, np.asarray(labels))

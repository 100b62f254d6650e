"""Fault-tolerance utilities: heartbeat, preemption handling, retry loop.

The port's own copy of ``repro.training.fault_tolerance`` (no JAX in it):

  * :class:`Heartbeat` — a periodic liveness signal from a background
    thread, written to a file an external watchdog can monitor, or
    handed to any ``sink`` callable;
  * :class:`PreemptionGuard` — SIGTERM (a preemption notice) becomes a
    polled flag, so a train loop checkpoints at a step boundary;
  * :func:`resilient_loop` — transient step failures restore the last
    checkpoint and continue, up to a bound of consecutive failures.

``repro_torch.training.trainer.RetrievalTrainer`` runs its loop
through all three.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable


class Heartbeat:
    """Periodic liveness signal from a background thread.

    The default sink writes a heartbeat *file* (atomic tmp+replace) for
    an external watchdog.  ``sink`` swaps that for any callable taking
    the payload dict.
    """

    def __init__(self, path: str | None = None, interval: float = 10.0,
                 sink: Callable[[dict], None] | None = None):
        if path is None and sink is None:
            raise ValueError("Heartbeat needs a path or a sink")
        self.path = path
        self.interval = interval
        self.sink = sink if sink is not None else self._write_file
        self._stop = threading.Event()
        self._step = 0
        self._thread: threading.Thread | None = None

    def update(self, step: int):
        self._step = step

    def _run(self):
        while not self._stop.wait(self.interval):
            self._emit()

    def _emit(self):
        self.sink({"step": self._step, "time": time.time(),
                   "pid": os.getpid()})

    def _write_file(self, payload: dict):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def __enter__(self):
        self._emit()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="heartbeat")
        self._thread.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        self._emit()
        return False


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a polled ``should_exit`` flag so the
    train loop can checkpoint at a clean step boundary before exiting."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_exit = False
        self._signals = signals
        self._old = {}

    def _handler(self, signum, frame):
        self.should_exit = True

    def __enter__(self):
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:          # non-main thread (tests)
                pass
        return self

    def __exit__(self, *a):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False


def resilient_loop(step_fn: Callable[[int], None], start_step: int,
                   end_step: int,
                   on_failure: Callable[[BaseException], int],
                   max_failures: int = 3):
    """Run ``step_fn(step)`` for each step; on exception call
    ``on_failure(exc) -> resume_step`` (restore from checkpoint) and
    continue, up to ``max_failures`` consecutive failures."""
    step = start_step
    failures = 0
    while step < end_step:
        try:
            step_fn(step)
            step += 1
            failures = 0
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:      # noqa: BLE001 — deliberate catch-all
            failures += 1
            if failures > max_failures:
                raise
            step = on_failure(e)
    return step

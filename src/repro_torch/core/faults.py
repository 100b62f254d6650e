"""Search outcomes with coverage metadata.

The part of ``repro.core.faults`` that the single-worker driver touches.
Fault injection and the resilient gathers come with the multi-worker
slice.
"""

from __future__ import annotations

import numpy as np


class SearchOutcome(tuple):
    """A result tuple that still unpacks like the plain tuple every call
    site expects, plus:

    ``coverage``  — per-query fraction of the round's search space that
        was actually scored (``1.0`` everywhere on a clean round).
    ``degraded``  — True when any coverage < 1.
    """

    coverage: np.ndarray | None
    degraded: bool

    def __new__(cls, items, coverage=None, degraded: bool = False):
        self = super().__new__(cls, tuple(items))
        self.coverage = coverage
        self.degraded = bool(degraded)
        return self


def full_coverage(n_queries: int) -> np.ndarray:
    return np.ones(n_queries, np.float32)

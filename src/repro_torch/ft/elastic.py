"""Fault tolerance of training: stragglers and the restart protocol.

The port's copies of two parts of the reference's ``ft/elastic.py``:

* :class:`StragglerDetector` (``elastic.py:98-130``) — per-step wall-time
  EMA + deviation; a step whose time exceeds ``mean + z * std``
  persistently is flagged.  Pure Python.
* :func:`resume_or_init` (``elastic.py:167-179``) — the train driver's
  restart protocol: restore the latest complete, digest-verified
  checkpoint if one exists, else initialize fresh — so a crashed or
  preempted job is the same command again.

:class:`~repro_torch.ft.preemption.PreemptionGuard` lives in
``preemption.py``; the reference's ``ElasticMesh`` waits for the
distributed slice (ROADMAP A12).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

from ..ckpt import CheckpointManager


class StragglerDetector:
    """EMA step-time monitor; flags persistent outliers."""

    def __init__(self, z: float = 3.0, patience: int = 3,
                 alpha: float = 0.1):
        self.z = z
        self.patience = patience
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var = 0.0
        self._strikes = 0
        self.flagged = False
        self.history: list[float] = []

    def observe(self, step_seconds: float) -> bool:
        """Feed one step time; returns True if this step is an outlier."""
        self.history.append(step_seconds)
        if self.mean is None:
            self.mean = step_seconds
            return False
        std = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
        outlier = step_seconds > self.mean + self.z * std
        if outlier:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.flagged = True
        else:
            self._strikes = 0
            # only track healthy steps in the baseline
            d = step_seconds - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return outlier


def resume_or_init(mgr: CheckpointManager, init_fn: Callable[[], tuple],
                   params_like: Any, opt_like: Any, device=None) -> tuple:
    """Restart protocol: ``(step, params, opt_state, extra)`` from the
    latest complete checkpoint (restored onto ``device``, default each
    ``like`` leaf's device), else ``(0, *init_fn(), {})``."""
    got = mgr.restore_latest(params_like, opt_like, device=device)
    if got is not None:
        return got
    params, opt_state = init_fn()
    return 0, params, opt_state, {}

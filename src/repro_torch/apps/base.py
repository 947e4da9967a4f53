"""Shared plumbing for the benchmark apps."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from ..core.engines import ENGINES, SimReport


@dataclasses.dataclass
class AppResult:
    name: str
    report: SimReport
    correct: Optional[bool]          # None when the sim itself failed
    max_err: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok and bool(self.correct)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"<AppResult {self.name} sim={'ok' if self.report.ok else 'FAIL'}"
                f" correct={self.correct} err={self.max_err:.2e} "
                f"wall={self.report.wall_s*1e3:.1f}ms "
                f"insts={self.report.n_instances} "
                f"chans={self.report.n_channels}>")


def simulate(name: str, top: Callable, args: tuple, engine: str,
             check: Callable[[], tuple[bool, float]],
             engine_kwargs: Optional[dict] = None) -> AppResult:
    """``engine_kwargs`` go to the engine constructor — e.g.
    ``{"mesh": 4}`` runs the compiled engine partitioned over 4
    devices."""
    rep = ENGINES[engine](**(engine_kwargs or {})).run(top, *args)
    if not rep.ok:
        return AppResult(name=name, report=rep, correct=None)
    good, err = check()
    return AppResult(name=name, report=rep, correct=good, max_err=err)

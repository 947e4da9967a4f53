"""The paper's Table 3 apps on the synthesis path: the step-form graphs of
gemm, gaussian and page_rank.

Each exposes ``build_step(..., device=None)`` and ``run_step(engine=...,
device=None, ...) -> AppResult``: the graph runs under a simulation
engine (its twin) or synthesized by ``CompiledEngine``, and the result is
verified numerically against a numpy reference.  Inputs come from
``np.random.default_rng(seed)`` exactly as in the reference package.
"""

from . import gaussian, gemm, page_rank
from .base import AppResult

APPS = {"gaussian": gaussian, "gemm": gemm, "page_rank": page_rank}

__all__ = ["APPS", "AppResult", "gaussian", "gemm", "page_rank"]

"""The paper's benchmark suite (Table 3) as task graphs.

| app       | paper graph                      | feedback? | exercises      |
|-----------|----------------------------------|-----------|----------------|
| cannon    | 8x8 toroidal PE mesh             | YES       | C2 (seq fails) |
| cnn       | PolySA systolic conv layer       | no        | dedup (C3)     |
| gaussian  | SODA stencil dataflow pipeline   | no        | many instances |
| gcn       | edge-centric GCN layer           | no        | transactions   |
| gemm      | PolySA systolic matmul           | no        | dedup (C3)     |
| network   | 8x8 Omega switch                 | no        | peek (C1)      |
| page_rank | scatter/gather + control loop    | YES       | C2 (seq fails) |

Every app exposes ``run(engine=..., **size_overrides) -> AppResult``, which
simulates the graph on host numpy buffers and *numerically verifies* the
result against a numpy reference; ``FEEDBACK_APPS`` lists the two the paper
documents as failing under sequential simulation.  gemm, gaussian and
page_rank also have the step-function form (``build_step``/``run_step``,
``device=None`` is the card) that ``CompiledEngine`` synthesizes, gemm and
page_rank an async-port one (``build_step_async``/``run_step_async``), and
network a step form whose compiled run is refused naming its switch.
Inputs come from ``np.random.default_rng(seed)`` exactly as in the
reference package.
"""

from . import cannon, cnn, gaussian, gcn, gemm, network, page_rank
from .base import AppResult

APPS = {
    "cannon": cannon,
    "cnn": cnn,
    "gaussian": gaussian,
    "gcn": gcn,
    "gemm": gemm,
    "network": network,
    "page_rank": page_rank,
}

FEEDBACK_APPS = ("cannon", "page_rank")

__all__ = ["APPS", "FEEDBACK_APPS", "AppResult", "cannon", "cnn", "gaussian",
           "gcn", "gemm", "network", "page_rank"]

"""Fixtures of the benchmark's own tests (``perfbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where no card is visible; the
rest run on the CPU at the apps' small sizes.  Run them from the root of
the repository:

    python -m pytest -q perfbench/tests
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the apps' small sizes: gemm P=2, n=32, K=4; gaussian 64 x 64, 2 passes
_GEMM = dict(params={"P": 2, "n": 32, "K": 4},
             inputs={"A": [64, 128], "B": [128, 64]})
SMALL = {
    "gemm-13x13": _GEMM,
    "gemm-13x13-async": _GEMM,
    "gaussian-uhd": dict(params={"h": 64, "w": 64, "iters": 2},
                         inputs={"img": [64, 64]}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible (run on the card)")
    return torch.device("cuda", 0)


def small_tree(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``perfbench/`` under ``dst`` with
    every configuration cut to :data:`SMALL`; returns ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, cut in SMALL.items():
        path = dst / "perfbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["params"].update(cut["params"])
        for k, shape in cut["inputs"].items():
            cfg["inputs"][k]["shape"] = shape
        path.write_text(json.dumps(cfg))
    return dst


@pytest.fixture
def small(tmp_path):
    from perfbench import harness
    return harness.Bench(small_tree(tmp_path))

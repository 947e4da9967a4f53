"""``run.py`` as a benchmark runner starts it, and the import check."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from perfbench import harness
from perfbench.conftest import ROOT

ARGS = ["--workload", "gemm-13x13.tiles", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(root, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    """Here no card is visible (or none is let through): exit 1, no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in spec["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()


def _python(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    """Every module the harness, the bindings, the references and the
    readers load, and a whole small run on the CPU: no ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (compared whole)."""
    got = _python("""
        import json, sys, time, tempfile
        from pathlib import Path
        import torch
        from perfbench import harness
        from perfbench.conftest import small_tree
        bench = harness.Bench(small_tree(Path(tempfile.mkdtemp())))
        spec = bench.spec
        for w in spec["workloads"]:
            app = bench.config(w["config"])["app"]
            bench.module("apps", app), bench.module("reference", app)
        for m in spec["end_to_end"] + spec["per_layer"]:
            bench.reader(m["name"])
        harness.run_cell(bench, "gemm-13x13-async.tiles", 7, 0.0, True,
                         torch.device("cpu"), time.perf_counter())
        print(json.dumps(harness.forbidden_modules()))
    """)
    assert got == []


def test_reference_loads_nothing_of_the_program():
    got = _python("""
        import json, sys
        from pathlib import Path
        from perfbench import harness
        for f in sorted(Path("perfbench/reference").glob("*.py")):
            harness._load(f, "reference_" + f.stem)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                                & {"jax", "jaxlib", "flax", "repro",
                                   "repro_torch"})))
    """)
    assert got == []

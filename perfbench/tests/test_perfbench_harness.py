"""The harness on the CPU at the apps' small sizes: discovery by file name,
the result line, the references, the counts behind ``invocation_mfu``."""

import json
import re
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
RATES = [m for m in SPEC["end_to_end"] if m["name"] != "setup_s"]


def end_to_end(cell):
    """The names of the end-to-end metrics ``cell`` reports."""
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def run(bench, cell, trace=False, seed=2 ** 31 + 11, seconds=0.0):
    return harness.run_cell(bench, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    # every cell: set-up and exactly one rate of invocations
    for cell in CELLS:
        got = end_to_end(cell)
        assert "setup_s" in got and len(got) == 2
        assert next(iter(got - {"setup_s"})).startswith("invocations_per_s.")
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        # a per-layer metric's cells all report the metric it moves
        assert all(m["moves"] in end_to_end(c) for c in m["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves_to_its_file(cell):
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    assert bench.traffic(w["traffic"])["loop"] == "closed"
    for kind in ("apps", "reference"):
        assert bench.module(kind, cfg["app"])
    for trace in (False, True):
        for m in bench.metrics(cell, trace):
            assert callable(bench.reader(m["name"]).read)
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / entry["file"]).is_file()
    # every cut is listed with its cause, in the file and in BENCHMARK.json
    assert entry["reduced"] == cfg["reduced"] == sorted(
        cfg["cuts"], key=cfg["reduced"].index)


def test_added_files_are_picked_up(small):
    """A new traffic mix, cell and per-layer metric, added as files and
    entries only, run with no other edit."""
    root = small.root
    traffic = json.loads(
        (root / "perfbench/traffic/closed-loop.json").read_text())
    traffic["input_sets"] = 2
    (root / "perfbench/traffic/closed-loop.two-sets.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/metrics/sweeps_per_invocation.py").write_text(
        "def read(rec):\n"
        "    runs = [r for r in rec['invocations'] if 'n_sweeps' in r]\n"
        "    return sum(r['n_sweeps'] for r in runs) / len(runs)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="gemm-13x13.two-sets",
                                  config="gemm-13x13",
                                  traffic="closed-loop.two-sets", chips=1,
                                  why="a test cell"))
    spec["per_layer"].append(dict(
        name="sweeps_per_invocation", unit="sweeps", better="lower",
        source="program_counter", layer="sweep loop",
        moves="invocations_per_s.host_bound",
        workloads=["gemm-13x13.two-sets"]))
    for m in spec["end_to_end"]:
        if m["name"] == "invocations_per_s.host_bound":
            m["workloads"].append("gemm-13x13.two-sets")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(harness.Bench(root), "gemm-13x13.two-sets", trace=True)
    assert res["correct"]
    assert set(res["compared"]) == {"rel_gap_set0", "rel_gap_set1"}
    assert res["metrics"]["sweeps_per_invocation"]["value"] > 0
    assert "sweeps_per_invocation" not in run(
        small, "gemm-13x13.tiles", trace=True)["metrics"]
    plain = run(harness.Bench(root), "gemm-13x13.two-sets")["metrics"]
    assert set(plain) == {"invocations_per_s.host_bound", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_on_the_cpu(small, cell):
    """The whole run at small sizes: correct against the reference on
    every input set, and the line's keys in the contract's order."""
    res = run(small, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 4
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(res["metrics"]) == end_to_end(cell)
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    assert all(v["unit"] == units[k] for k, v in res["metrics"].items())
    assert all(c["value"] < c["limit"] for c in res["compared"].values())
    traced = run(small, cell, trace=True)
    assert list(traced)[-2:] == ["breakdown", "compared"]
    split = next(iter(end_to_end(cell) - {"setup_s"})).split(".")[1]
    assert {f"{q}.{split}" for q in ("lower_ms", "loop_ms", "carry_io_ms",
                                     "replays_per_sweep", "invocation_mfu")
            } <= set(traced["metrics"])
    # device-only readings leave their metrics out on the CPU
    assert f"graph_us_per_replay.{split}" not in traced["metrics"]
    assert traced["device"]["window_s"] > 0
    assert all(len(v) <= 10 for v in traced["breakdown"].values())


def test_report_prints_the_compared_numbers_last(small, capsys):
    harness.report(run(small, "gaussian-uhd.frames"))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    tail = err.strip().splitlines()[-4:]
    assert [t.split()[0] for t in tail] == list(line["compared"])
    assert all(" limit " in t for t in tail)


def test_same_seed_same_inputs():
    recipe = {"x": {"shape": [3, 5], "dtype": "float32", "dist": "normal"}}
    draws = []
    for seed in (2 ** 31 + 5, 2 ** 31 + 5, 2 ** 31 + 6):
        g = torch.Generator().manual_seed(seed)
        draws.append(harness.draw_inputs(recipe, g, torch.device("cpu"))["x"])
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_gaussian_reference_against_a_pixel_loop(small):
    ref = small.module("reference", "gaussian")
    cfg = {"params": {"h": 6, "w": 7, "iters": 2}}
    img = torch.randn(6, 7, generator=torch.Generator().manual_seed(3))
    k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]) / 16.0
    want = img.double().numpy()
    for _ in range(2):
        nxt = want.copy()
        for y in range(1, 5):
            for x in range(1, 6):
                nxt[y, x] = (k * want[y - 1:y + 2, x - 1:x + 2]).sum()
        want = nxt
    got = ref.reference(cfg, {"img": img})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_gemm_reference_against_numpy(small):
    ref = small.module("reference", "gemm")
    g = torch.Generator().manual_seed(4)
    a, b = torch.randn(8, 12, generator=g), torch.randn(12, 8, generator=g)
    got = ref.reference({}, {"A": a, "B": b})
    np.testing.assert_allclose(got.numpy(),
                               a.double().numpy() @ b.double().numpy(),
                               rtol=1e-12, atol=1e-12)


def test_work_counts():
    bench = harness.Bench(ROOT)
    gemm = bench.module("reference", "gemm").work(bench.config("gemm-13x13"))
    assert gemm == {"flops": 2 * 3328 * 3328 * 4096,
                    "bytes": 4 * (3328 * 4096 * 2 + 3328 * 3328)}
    assert bench.module("reference", "gemm").work(
        bench.config("gemm-13x13-async")) == gemm
    gauss = bench.module("reference", "gaussian").work(
        bench.config("gaussian-uhd"))
    assert gauss == {"flops": 17 * 2158 * 3838 * 8,
                     "bytes": 2 * 4 * 2160 * 3840}


def test_tf32_on_refuses_the_run(small, monkeypatch):
    """The configurations state float32: a run in which TF32 is on for
    float32 products (here as if the program had set it at import) is
    refused, not measured."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(harness.Refused, match="TF32"):
        run(small, "gemm-13x13.tiles")


def test_a_split_metric_reads_with_its_quantity(small):
    """``lower_ms.host_bound`` has no file of its own: the quantity's
    reader serves it; a file of its own is taken first."""
    assert small.reader("lower_ms.host_bound") is small.module("metrics",
                                                               "lower_ms")
    (small.dir / "metrics" / "lower_ms.other.py").write_text(
        "def read(rec):\n    return 1.0\n")
    assert small.reader("lower_ms.other").read({}) == 1.0


def test_invocation_mfu_is_the_least_time_over_the_mean():
    bench = harness.Bench(ROOT)
    rec = dict(invocations=[dict(wall_s=0.5, ok=True),
                            dict(wall_s=1.5, ok=True)],
               work={"flops": 67e9, "bytes": 3.35e9 * 2},
               peaks=json.loads((ROOT / "perfbench/peaks.json").read_text()))
    # 1 ms of operations, 2 ms of bytes: bytes bound it; mean 1 s
    assert bench.reader("invocation_mfu.host_bound").read(rec) == \
        pytest.approx(0.2)


def test_rate_and_idle_readers():
    bench = harness.Bench(ROOT)
    rec = dict(invocations=[dict(wall_s=0.25, ok=True)] * 4, window_s=1.0,
               graph_device_s=0.25, replays_timed=1000)
    assert bench.module("metrics", "invocations_per_s").read(rec) == 4.0
    assert bench.module("metrics", "device_idle").read(rec) == 75.0
    assert bench.module("metrics", "graph_us_per_replay").read(rec) == 250.0
    rec["graph_device_s"] = None
    assert bench.module("metrics", "device_idle").read(rec) is None

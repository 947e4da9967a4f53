"""One run of one cell: the benchmark of ``repro_torch``'s synthesized task
graphs, invoked back to back by one host caller.

Everything that belongs to one configuration, traffic mix, app or metric
sits in a file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the builder form and the sizes as run, the
  input recipe, the limit of the comparison;
* ``traffic/<traffic>.json``: the loop's parameters (input sets, warm
  invocations);
* ``apps/<app>.py``: how the harness writes an input set into the buffers
  that the port's builder bound, and which buffers are outputs;
* ``reference/<app>.py``: the plain reference and the operations and bytes
  an invocation needs (no ``repro_torch``);
* ``metrics/<metric>.py``: ``read(rec)``, one number from the run's record,
  or ``None`` where the record has nothing to read.  A metric split by
  the end-to-end metric it moves (``lower_ms.host_bound``) reads with the
  quantity's reader (``metrics/lower_ms.py``) unless it has one of its own.

The window (:func:`run_cell`): before each invocation the harness copies
the next input set into the bound input buffers in place and fills the
output buffers with NaN, outside the invocation's timer; an invocation is
``CompiledEngine(device=...).run(top, *args)`` and a synchronize.  The
window closes at the first invocation boundary past ``seconds`` once every
input set has run.  The first output of each input set is kept; every later
one is compared with it on the device, and once the window has closed the
kept ones are compared with the reference, so the widest gap of every
invocation is bounded by the sum of the two.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (the JAX package's name is a prefix of the port's, so names are
    compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Refused(RuntimeError):
    """The run cannot measure what the configuration states."""


def _load(path: Path, tag: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = "perfbench_" + "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files under ``perfbench/``
    that its names point to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._mods: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def module(self, kind: str, name: str) -> ModuleType:
        key = (kind, name)
        if key not in self._mods:
            self._mods[key] = _load(self.dir / kind / f"{name}.py",
                                    f"{kind}_{name}")
        return self._mods[key]

    def reader(self, metric: str) -> ModuleType:
        """``metrics/<metric>.py``, else the reader of the quantity the
        name starts with (the part before the first dot)."""
        own = self.dir / "metrics" / f"{metric}.py"
        return self.module("metrics", metric if own.is_file()
                           else metric.split(".")[0])

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries this cell reports: the end-to-end ones
        without ``--trace``, the per-layer ones with it."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def draw_inputs(recipe: dict, gen: torch.Generator,
                device: torch.device) -> dict:
    """One input set from the configuration's recipe, on ``device``, from
    ``gen``: ``{name: {"shape": [...], "dist": "normal"}}``."""
    out = {}
    for name, r in recipe.items():
        if r["dist"] != "normal":
            raise ValueError(f"input {name}: unknown dist {r['dist']!r}")
        out[name] = torch.randn(r["shape"], generator=gen, device=device,
                                dtype=getattr(torch, r["dtype"]))
    return out


class _TimedReplays:
    """Inside the block, each block of replays of a sweep's graph
    (``SweepGraph.replay(k)``) is bracketed by two CUDA events on the
    current stream; :meth:`device_s` sums them after a synchronize."""

    def __enter__(self):
        from repro_torch.kernels.ring import SweepGraph
        self.events, self._orig = [], SweepGraph.replay
        events, orig = self.events, self._orig

        def replay(graph, k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig(graph, k)
            e1.record()
            events.append((k, e0, e1))

        SweepGraph.replay = replay
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ring import SweepGraph
        SweepGraph.replay = self._orig

    def device_s(self) -> tuple:
        """Seconds in all the blocks of replays, and their replays."""
        torch.cuda.synchronize()
        return (sum(a.elapsed_time(b) for _, a, b in self.events) / 1e3,
                sum(k for k, _, _ in self.events))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in float64; inf where either holds a NaN or an inf."""
    d = (a.double() - b.double()).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max())


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             control: bool = False) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``t_start`` is the host clock at the process's start (``setup_s``).
    ``control`` runs the app's lower-precision control in the program's
    place (``perfbench/control.py``; the benchmark's runs never do)."""
    marks = [("start", t_start)]

    def mark(what: str) -> None:
        marks.append((what, time.perf_counter()))

    from repro_torch.core.synth import CompiledEngine
    from repro_torch.kernels.dispatch import launch_counts
    mark("import")

    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic {cell['traffic']!r}: loop "
                         f"{traffic['loop']!r}; this harness runs a closed "
                         f"loop")
    app = bench.module("apps", cfg["app"])
    ref = bench.module("reference", cfg["app"])
    cuda = device.type == "cuda"

    def precision_as_stated() -> None:
        # the configurations state float32: a TF32 product is another
        # precision than the one users are given, never set here
        if torch.backends.cuda.matmul.allow_tf32 and not control:
            raise Refused("TF32 is on for float32 products (set by the "
                          "program or its environment); the configuration "
                          "states float32")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    top, args = app.build(cfg, device)
    _sync(device)
    mark("build")
    sets = [draw_inputs(cfg["inputs"], gen, device)
            for _ in range(traffic["input_sets"])]
    _sync(device)
    mark("inputs")

    def program(top, args):
        eng = CompiledEngine(device=device)
        return eng, eng.run(top, *args)

    ctrl = app.control(cfg, ref) if control else contextlib.nullcontext()
    with ctrl as replaced:
        invoke: Callable = replaced or program

        def invocation(s: int) -> tuple:
            app.load(args, sets[s])
            for t in app.outputs(args):
                t.fill_(math.nan)
            _sync(device)
            t0 = time.perf_counter()
            try:
                eng, rep = invoke(top, args)
                _sync(device)
                ok = rep is None or bool(rep.ok)
            except Exception as e:     # a failed invocation counts, the
                print(f"invocation failed: {type(e).__name__}: {e}",
                      file=sys.stderr)  # window goes on
                _sync(device)
                eng, ok = None, False
            return time.perf_counter() - t0, eng, ok

        for w in range(traffic["warm_invocations"]):
            _, eng, _ = invocation(w % len(sets))
            mark(f"warm{w}" + ("" if eng is None else
                               f" (lower {eng.lower_s:.3f}, capture "
                               f"{eng.capture_s:.3f}, loop {eng.loop_s:.3f})"))
        _sync(device)
        setup_s = time.perf_counter() - t_start
        precision_as_stated()

        launches0 = launch_counts() if cuda else {}
        timed = _TimedReplays() if trace and cuda else \
            contextlib.nullcontext()
        invs, kept, drift = [], {}, [0.0] * len(sets)
        t_open = time.perf_counter()
        with timed:
            while True:
                s = len(invs) % len(sets)
                wall, eng, ok = invocation(s)
                rec = dict(wall_s=wall, ok=ok, set=s)
                if eng is not None:
                    rec.update(lower_s=eng.lower_s, capture_s=eng.capture_s,
                               loop_s=eng.loop_s, program_s=eng.program_s,
                               n_replays=eng.n_replays,
                               n_sweeps=eng.n_sweeps)
                invs.append(rec)
                out = app.output(args)
                if s not in kept:
                    kept[s] = out.clone()
                else:
                    drift[s] = max(drift[s], _gap(out, kept[s]))
                if time.perf_counter() - t_open >= seconds and \
                        len(invs) >= len(sets):
                    break
        graph_s, replays_timed = timed.device_s() if trace and cuda \
            else (None, None)
        launches1 = launch_counts() if cuda else {}
    precision_as_stated()

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    for key in ("wall_s", "lower_s", "capture_s", "loop_s"):
        print(f"invocations' {key} (ms): " + " ".join(
            f"{r[key] * 1e3:.1f}" for r in invs if key in r), file=sys.stderr)
    print("setup s: " + ", ".join(
        f"{w} {t - t0:.3f}" for (_, t0), (w, t) in zip(marks, marks[1:])),
        file=sys.stderr)
    del top, args
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison: each kept output against the reference, plus the
    # widest drift of that set's later outputs from it
    compared = {}
    limit = cfg["compare"]["rel_gap_limit"]
    for s in range(len(sets)):
        want = ref.reference(cfg, sets[s])
        scale = float(want.abs().max())
        gap = _gap(kept[s], want) + drift[s]
        compared[f"rel_gap_set{s}"] = dict(value=gap / scale, limit=limit)
        del want
    failed = sum(not r["ok"] for r in invs)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())

    work = ref.work(cfg)
    record = dict(
        invocations=invs, setup_s=setup_s,
        window_s=sum(r["wall_s"] for r in invs),
        graph_device_s=graph_s, replays_timed=replays_timed,
        launches=sum(launches1.values()) - sum(launches0.values())
        if cuda else None,
        work=work, peaks=json.loads((bench.dir / "peaks.json").read_text()))
    metrics = {}
    for m in bench.metrics(workload, trace):
        v = bench.reader(m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=memory_peak)
    result = dict(correct=correct, attempted=len(invs), failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=graph_s or 0.0, window_s=record["window_s"])
        result["breakdown"] = breakdown(record)
    result["compared"] = compared
    return result


def breakdown(rec: dict) -> dict:
    """The device's time in the sweep graphs, and where the host kept the
    device idle, summed over the window's invocations (seconds)."""
    invs = [r for r in rec["invocations"] if "lower_s" in r]
    tot = {k: sum(r[k] for r in invs)
           for k in ("lower_s", "capture_s", "loop_s", "program_s")}
    graph = rec["graph_device_s"] or 0.0
    gaps = [["lowering", tot["lower_s"]], ["capture", tot["capture_s"]],
            ["carry_and_writeback",
             tot["program_s"] - tot["capture_s"] - tot["loop_s"]],
            ["sweep_loop_host", tot["loop_s"] - graph],
            ["outside_engine", rec["window_s"] - tot["lower_s"]
             - tot["program_s"]]]
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [["sweep_graph_replays", graph]],
            "idle_gaps": gaps}


def report(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error; the result as the last line on standard output."""
    out, err = sys.stdout, sys.stderr
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def check_device(chips: int) -> Optional[str]:
    """Why a run cannot measure here, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device is visible"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} are visible")
    return None

"""The program's own trace of a cell's invocations on the card, the sweep
graph's stamps included.

    python3 perfbench/stamped.py --workload <cell> --seed <n> [--plain 3]

In one process the cell is built and its input sets drawn as
``harness.run_cell`` does (the same seed draws the same sets); the
traffic's warm invocations run, then ``--plain`` invocations on input set 0
as the window runs them (``CompiledEngine(device=...)``), then one stamped
invocation on set 0 (``CompiledEngine(device=..., trace=True)``).  On
standard error: each span's host ms, device-busy ms and idle ms
(``Trace.table``) of the last plain invocation and of the stamped one, and
the stamped sweep graph's regions.  The last line on standard output is
one JSON object:

* ``plain``: a summary of each plain invocation (the engine's timing
  attributes, ``carry_io_ms`` as the benchmark's reader takes it, the span
  table, the counters, ``graph_us_per_replay`` from the program's events,
  ``nodes_per_sweep``);
* ``stamped``: the same of the stamped invocation, and ``regions``: one
  stamp's own cost (``stamp_us``, the empty region's mean) and the guards,
  fired, skipped and tail regions in us a replay with that cost taken off
  each interval, ``stamped_us_per_replay`` (the stamped graph's events
  over the replays), ``unattributed_us_per_replay`` (that less the four
  regions and the stamps' own cost: the time between a replay's last
  stamp and the next one's first), ``on_cost_us_per_replay`` (the stamped
  graph's us a replay less the plain ones' mean),
  ``plain_unattributed_us_per_replay`` (the plain graph's us a replay less
  the four regions), ``bodies``, every (task, phase) body with its
  firings and skips and its us a firing and a skip, the most time first,
  and ``plain_regions_us_per_replay``: the four regions less
  ``stamp_us_whole`` an interval, the stamped graph's extra time a replay
  over its intervals (a stamp also slows the node after it, so the empty
  region's mean is less than a stamp's whole cost), and the empty region
  so corrected (near 0 where the model holds); these five sum to the
  plain graph's us a replay less the unattributed remainder;
* ``output``: the stamped output's widest gap to the first plain one
  (``stamped_gap``, 0.0 when bitwise equal, with ``bitwise``) and the plain
  invocations' own widest drift (``plain_drift``).

It reports only; nothing of it enters the benchmark's result line.
"""

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _summary(eng, rep_ok: bool) -> dict:
    tr = eng.trace
    c = tr.counters
    graph_s = eng.graph_device_s
    return dict(
        ok=rep_ok, lower_s=eng.lower_s, capture_s=eng.capture_s,
        loop_s=eng.loop_s, program_s=eng.program_s,
        carry_io_ms=(eng.program_s - eng.capture_s - eng.loop_s) * 1e3,
        spans={p: [h * 1e3, b * 1e3, i * 1e3]
               for p, (h, b, i) in tr.table().items()},
        counters={k: v for k, v in c.items() if "[" not in k},
        graph_device_s=graph_s,
        graph_us_per_replay=graph_s / eng.n_replays * 1e6
        if eng.n_replays else None,
        nodes_per_sweep=eng.nodes_per_sweep)


def _regions(eng, plain_us: float) -> dict:
    """The stamped graph's regions in us a replay, each interval's stamp
    cost taken off."""
    st = eng.trace.stamps
    n = st["replays"]
    stamp_ns, stamp_n = st["stamp"]
    cost = stamp_ns / stamp_n if stamp_n else 0.0

    def net(pairs) -> float:
        return sum(ns - cost * k for ns, k in pairs) / n / 1e3

    intervals = stamp_n + st["guards"][1] + st["tail"][1] + sum(
        k for _, k in st["fired"].values()) + sum(
        k for _, k in st["skipped"].values())
    out = dict(replays=n, stamp_us=cost / 1e3,
               guards_us_per_replay=net([st["guards"]]),
               fired_us_per_replay=net(st["fired"].values()),
               skipped_us_per_replay=net(st["skipped"].values()),
               tail_us_per_replay=net([st["tail"]]) if st["tail"][1]
               else None,
               stamps_us_per_replay=cost * intervals / n / 1e3)
    stamped = eng.graph_device_s / eng.n_replays * 1e6
    out["stamped_us_per_replay"] = stamped
    out["unattributed_us_per_replay"] = stamped - sum(
        out[k] or 0.0 for k in ("guards_us_per_replay", "fired_us_per_replay",
                                "skipped_us_per_replay", "tail_us_per_replay",
                                "stamps_us_per_replay"))
    out["on_cost_us_per_replay"] = stamped - plain_us
    out["plain_unattributed_us_per_replay"] = plain_us - sum(
        out[k] or 0.0 for k in ("guards_us_per_replay", "fired_us_per_replay",
                                "skipped_us_per_replay", "tail_us_per_replay"))

    def per(ns: float, k: int):
        return (ns - cost * k) / k / 1e3 if k else None

    rows = sorted(st["fired"], key=lambda r: -(st["fired"][r][0] +
                                               st["skipped"][r][0]))
    out["bodies"] = [dict(body=st["names"][r], fired=st["fired"][r][1],
                          us_per_fire=per(*st["fired"][r]),
                          skipped=st["skipped"][r][1],
                          us_per_skip=per(*st["skipped"][r]))
                     for r in rows]
    # the stamps also slow what runs around them: the plain graph's time a
    # replay spread over the intervals gives each stamp's whole cost
    whole = (stamped - plain_us) / (intervals / n)
    out["stamp_us_whole"] = whole
    out["plain_regions_us_per_replay"] = {
        k: sum(ns - whole * 1e3 * c for ns, c in pairs) / n / 1e3
        for k, pairs in (("empty", [st["stamp"]]), ("guards", [st["guards"]]),
                         ("fired", st["fired"].values()),
                         ("skipped", st["skipped"].values()),
                         ("tail", [st["tail"]]))}
    return out


def _print_table(title: str, spans: dict) -> None:
    print(f"{title}: span, host ms, device-busy ms, idle ms",
          file=sys.stderr)
    for path, (h, b, i) in spans.items():
        print(f"  {path:<40} {h:10.3f} {b:10.3f} {i:10.3f}",
              file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--plain", type=int, default=3)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness
    from repro_torch.core.synth import CompiledEngine

    bench = harness.Bench(ROOT)
    cell = bench.cell(a.workload)
    why = harness.check_device(cell["chips"])
    if why:
        print(f"{a.workload}: {why}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    app = bench.module("apps", cfg["app"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed % 2 ** 63)
    top, args = app.build(cfg, dev)
    sets = [harness.draw_inputs(cfg["inputs"], gen, dev)
            for _ in range(traffic["input_sets"])]

    def invoke(s: int, **kw) -> tuple:
        app.load(args, sets[s])
        for t in app.outputs(args):
            t.fill_(math.nan)
        torch.cuda.synchronize(dev)
        eng = CompiledEngine(device=dev, **kw)
        rep = eng.run(top, *args)
        torch.cuda.synchronize(dev)
        return eng, bool(rep.ok), app.output(args).clone()

    for w in range(traffic["warm_invocations"]):
        invoke(w % len(sets))
    plain, outs = [], []
    for _ in range(a.plain):
        eng, ok, out = invoke(0)
        plain.append(_summary(eng, ok))
        outs.append(out)
    eng, ok, out = invoke(0, trace=True)
    stamped = _summary(eng, ok)
    plain_us = sum(p["graph_us_per_replay"] for p in plain) / len(plain)
    stamped["regions"] = _regions(eng, plain_us)
    drift = max((harness._gap(o, outs[0]) for o in outs[1:]), default=0.0)
    gap = harness._gap(out, outs[0])
    _print_table(f"{a.workload} plain (last of {a.plain})",
                 plain[-1]["spans"])
    _print_table(f"{a.workload} stamped", stamped["spans"])
    print(f"{a.workload} regions (us a replay): " + json.dumps(
        {k: v for k, v in stamped["regions"].items() if k != "bodies"}),
        file=sys.stderr)
    for b in stamped["regions"]["bodies"][:24]:
        print(f"  {json.dumps(b)}", file=sys.stderr)
    print(f"{a.workload} stamped output: gap {gap!r} to the plain set-0 "
          f"output (bitwise {bool(torch.equal(out, outs[0]))}), plain "
          f"drift {drift!r}", file=sys.stderr)
    print(json.dumps(dict(
        workload=a.workload, seed=a.seed,
        card=torch.cuda.get_device_name(dev), plain=plain, stamped=stamped,
        output=dict(stamped_gap=gap, bitwise=bool(torch.equal(out, outs[0])),
                    plain_drift=drift))))
    return 0 if ok and all(p["ok"] for p in plain) else 1


if __name__ == "__main__":
    sys.exit(main())

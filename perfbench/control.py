"""The readings a cell's limit is set from, on the card, in one process:
the numbers compared for the program over many seeds (the lower reading)
and for the app's lower-precision control in the program's place (the
upper reading).  The benchmark's own runs never run the control.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 3]

Each reading is a run of the cell's timed path at its own size with a short
window (every input set at least once); one JSON line a run, then a
summary line: the largest program reading and the smallest control one.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import harness

    why = harness.check_device(1)
    if why:
        print(why, file=sys.stderr)
        return 1
    bench = harness.Bench(ROOT)
    dev = torch.device("cuda", 0)
    worst = {"program": [], "control": []}
    for side, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            r = harness.run_cell(bench, a.workload, seed, a.seconds, False,
                                 dev, time.perf_counter(),
                                 control=side == "control")
            top = max(c["value"] for c in r["compared"].values())
            worst[side].append(top)
            print(json.dumps(dict(workload=a.workload, side=side, seed=seed,
                                  correct=r["correct"], widest=top,
                                  compared=r["compared"])), flush=True)
    print(json.dumps(dict(
        workload=a.workload, card=torch.cuda.get_device_name(dev),
        program_max=max(worst["program"], default=None),
        control_min=min(worst["control"], default=None), readings=worst)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

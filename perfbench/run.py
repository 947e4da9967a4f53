"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line on standard output is the result (JSON); the numbers
compared with the reference are the last lines on standard error.  Exits
with 1, printing no result, when no card is visible, when the checkout
lacks the port (``src/repro_torch``), when TF32 is on for float32
products, or when the JAX package or JAX is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the port is not in this checkout ({ROOT / 'src'})",
              file=sys.stderr)
        return 1
    # every cache the program may build stays inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "perfbench"]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from perfbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(a.workload)
    why = harness.check_device(cell["chips"])
    if why:
        print(f"{a.workload}: {why}", file=sys.stderr)
        return 1
    try:
        result = harness.run_cell(bench, a.workload, a.seed, a.seconds,
                                  bool(a.trace), torch.device("cuda", 0),
                                  T_START)
    except harness.Refused as e:
        print(f"{a.workload}: {e}", file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 1
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

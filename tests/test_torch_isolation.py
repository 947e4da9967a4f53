"""The port stands alone: importing and running ``repro_torch`` pulls in
neither JAX nor the reference package."""

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")

PROG = """
import json, sys
import repro_torch
from repro_torch.apps import gemm
r = gemm.run_step("compiled", P=2, n=4, K=2, device="cpu")
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"ok": r.ok, "mods": mods}))
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", PROG], capture_output=True,
                         text=True, timeout=120, cwd=SRC,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ok": True, "mods": []}

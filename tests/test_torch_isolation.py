"""The port stands alone: importing and running ``repro_torch`` pulls in
neither JAX nor the reference package; and its entry points run on the
card unless the caller asks for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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

SERVE = """
import json, sys
from repro_torch.launch.serve import serve
rc = serve(["--device", "cpu", "--requests", "3", "--max-new", "3",
            "--slots", "2", "--max-seq", "32"])
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rc": rc, "mods": mods}))
"""


TRAIN = """
import json, sys, tempfile
from repro_torch.launch.train import train
with tempfile.TemporaryDirectory() as d:
    rc = train(["--device", "cpu", "--arch", "mamba2-130m", "--reduced",
                "--use-kernel", "--steps", "2", "--batch", "2", "--seq",
                "32", "--ckpt-dir", d])
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rc": rc, "mods": mods}))
"""


def _run(prog: str) -> dict:
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, cwd=SRC,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_reference():
    assert _run(PROG) == {"ok": True, "mods": []}


def test_serving_on_cpu_imports_neither_jax_nor_reference():
    """``repro_torch.launch.serve --device cpu`` on the reduced config
    serves every request and never imports jax, jaxlib or repro."""
    assert _run(SERVE) == {"rc": 0, "mods": []}


def test_training_on_cpu_imports_neither_jax_nor_reference():
    """``repro_torch.launch.train --device cpu`` trains the reduced Mamba2
    through the kernels' path and never imports jax, jaxlib or repro."""
    assert _run(TRAIN) == {"rc": 0, "mods": []}


def test_train_defaults_to_cuda(monkeypatch, tmp_path):
    """With no ``--device``, the train driver goes to the card, and raises
    where there is none; it does not train on the CPU instead."""
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train(["--arch", "mamba2-130m", "--reduced", "--steps", "1",
               "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """With no device given, ``init_params``, ``serving_adapter`` and
    ``launch.serve`` go to the card, and raise where there is none."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b").with_reduced()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm.serving_adapter(params, cfg, max_seq=16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve(["--requests", "1"])
    # parameters on one device, adapter asked for another: refused
    with pytest.raises(ValueError, match="lie on cpu"):
        lm.serving_adapter(params, cfg, max_seq=16, device="meta")

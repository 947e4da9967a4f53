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

CODEGEN = """
import json, sys, tempfile
import numpy as np
from repro_torch.apps import gaussian
from repro_torch.core import CompileCache
with tempfile.TemporaryDirectory() as d:
    g, rep, prog = gaussian.compile_app(cache=CompileCache(root=d),
                                        device="cpu")
    out = prog(np.ones((12, 12), np.float32)).numpy()
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"compiled": rep.n_compiled,
                  "ok": bool(np.allclose(out, 1.0)), "mods": mods}))
"""


def _run(prog: str, **env) -> dict:
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120, cwd=SRC,
                         env={**os.environ, "PYTHONPATH": SRC, **env})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_reference():
    assert _run(PROG) == {"ok": True, "mods": []}


def test_serving_on_cpu_imports_neither_jax_nor_reference():
    """``repro_torch.launch.serve --device cpu`` on the reduced config
    serves every request and never imports jax, jaxlib or repro."""
    assert _run(SERVE) == {"rc": 0, "mods": []}


COMPILED_SERVE = """
import contextlib, io, json, sys
from repro_torch.core.compile_cache import default_cache
from repro_torch.launch.serve import serve
runs = []
for _ in range(2):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve(["--device", "cpu", "--requests", "2", "--max-new", "2",
                    "--slots", "2", "--max-seq", "16"])
    warm = [l for l in out.getvalue().splitlines()
            if l.startswith("[serve] warmup:")][0]
    runs.append([rc, "fresh-compile=-" in warm, warm.endswith("compiled")])
    default_cache().clear_memory()     # the second run: from disk
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"runs": runs, "mods": mods}))
"""


def test_compiled_serving_on_cpu_imports_neither_jax_nor_reference(
        tmp_path):
    """``launch.serve --device cpu`` warms up through the compile cache:
    the first run compiles every step, the second loads them all from
    the store; neither imports jax, jaxlib or repro."""
    assert _run(COMPILED_SERVE, REPRO_TORCH_COMPILE_CACHE=str(tmp_path)) \
        == {"runs": [[0, False, True], [0, True, False]], "mods": []}


MOE_VLM = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import lm
rcs = [serve(["--device", "cpu", "--arch", arch, "--requests", "2",
              "--max-new", "2", "--slots", "2", "--max-seq", "32"])
       for arch in ("granite-moe-1b-a400m", "phi-3-vision-4.2b")]
cfg = get_config("phi-3-vision-4.2b").with_reduced(dtype="float32")
p = lm.init_params(cfg, device="cpu")
logits, _ = make_prefill_step(cfg)(p, {
    "tokens": torch.zeros((1, 12), dtype=torch.int32),
    "patches": torch.ones((1, cfg.vlm.n_patches, cfg.vlm.d_patch))})
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rcs": rcs, "finite": bool(logits.isfinite().all()),
                  "mods": mods}))
"""


def test_moe_vlm_on_cpu_imports_neither_jax_nor_reference():
    """Serving the reduced granite-moe and phi-3-vision through
    ``launch.serve --device cpu``, and a prefill with patches, never
    import jax, jaxlib or repro."""
    assert _run(MOE_VLM) == {"rcs": [0, 0], "finite": True, "mods": []}


RECURRENT_AUDIO = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm
rcs = [serve(["--device", "cpu", "--arch", arch, "--requests", "2",
              "--max-new", "2", "--slots", "2", "--max-seq", "32"])
       for arch in ("mamba2-130m", "zamba2-1.2b")]
cfg = get_config("whisper-small").with_reduced(dtype="float32")
p = lm.init_params(cfg, device="cpu")
logits, cache = make_prefill_step(cfg, max_seq=16)(p, {
    "tokens": torch.zeros((1, 12), dtype=torch.int32),
    "frames": torch.ones((1, cfg.encdec.n_audio_ctx, cfg.d_model))})
logits, _ = make_decode_step(cfg)(p, logits.argmax(-1), cache)
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rcs": rcs, "finite": bool(logits.isfinite().all()),
                  "mods": mods}))
"""


def test_recurrent_audio_on_cpu_imports_neither_jax_nor_reference():
    """Serving the reduced mamba2 and zamba2 per slot through
    ``launch.serve --device cpu``, and whisper's prefill and decode step
    with frames, never import jax, jaxlib or repro."""
    assert _run(RECURRENT_AUDIO) == {"rcs": [0, 0], "finite": True,
                                     "mods": []}


def test_training_on_cpu_imports_neither_jax_nor_reference():
    """``repro_torch.launch.train --device cpu`` trains the reduced Mamba2
    through the kernels' path and never imports jax, jaxlib or repro."""
    assert _run(TRAIN) == {"rc": 0, "mods": []}


def test_codegen_on_cpu_imports_neither_jax_nor_reference():
    """Compiling gaussian's stage chain through the compile cache and
    running its program on the CPU never imports jax, jaxlib or repro."""
    assert _run(CODEGEN) == {"compiled": 3, "ok": True, "mods": []}


PARTITIONED = """
import json, sys
import numpy as np
from repro_torch.apps import gemm
from repro_torch.core import CompiledEngine, plan_placement
from repro_torch.core.cost import task_cost
from repro_torch.core.synth import elaborate_step_graph
top, args, check = gemm.build_step(P=2, n=4, K=2, device="cpu")
plan, graph, _ = elaborate_step_graph(top, *args)
pl = plan_placement(plan, graph, 2, cache=False)
top, args, check = gemm.build_step(P=2, n=4, K=2, device="cpu")
rep = CompiledEngine(device="cpu", mesh=2, cache=False).run(top, *args)
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"ok": rep.ok and bool(check()[0]),
                  "spread": len(set(pl.owners)) > 1, "mods": mods}))
"""


def test_partitioned_synthesis_imports_neither_jax_nor_reference():
    """The cost probes, the floorplanner and ``CompiledEngine(mesh=2)`` on
    the CPU never import jax, jaxlib or repro."""
    assert _run(PARTITIONED) == {"ok": True, "spread": True, "mods": []}


@pytest.mark.parametrize("path", ["src/repro_torch/core/cost.py",
                                  "src/repro_torch/core/floorplan.py",
                                  "chip_smoke.py"])
def test_sources_import_neither_jax_nor_reference(path):
    """No import statement of these files names jax, jaxlib or repro (the
    reference's floorplanner imports no JAX itself, through its cost
    module; the port keeps its own copy)."""
    import ast
    tree = ast.parse((Path(SRC).parent / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_codegen_defaults_to_cuda(monkeypatch):
    """With no device, ``compile_stages``, ``compile_app`` and the keys
    go to the card, and raise where there is none."""
    from repro_torch.apps import gaussian
    from repro_torch.core import StageInstance, compile_stages
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = StageInstance(fn=lambda x: x + 1, args=(torch.ones(2),))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compile_stages([inst], cache=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        inst.key
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gaussian.compile_app(cache=False)
    assert inst.executable is None


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


MESH = """
import json, sys, tempfile
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.train import train
from repro_torch.models.config import InputShape
with tempfile.TemporaryDirectory() as d:
    rc = train(["--device", "cpu", "--arch", "mamba2-130m", "--reduced",
                "--use-kernel", "--steps", "1", "--batch", "2", "--seq",
                "32", "--ckpt-dir", d, "--model-parallel", "1"])
with fake_world(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rec = run_cell(get_config("qwen3-0.6b").with_reduced(),
                   InputShape("t", 32, 4, "decode"), mesh, "t2x2",
                   verbose=False)
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"rc": rc, "ok": rec["ok"], "mods": mods}))
"""


def test_mesh_side_on_cpu_imports_neither_jax_nor_reference():
    """``launch.train --model-parallel 1`` through a (1, 1) gloo mesh and a
    dry-run cell on a fake 4-rank group never import jax, jaxlib or
    repro."""
    assert _run(MESH) == {"rc": 0, "ok": True, "mods": []}

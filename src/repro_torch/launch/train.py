"""End-to-end training driver, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --use-kernel --batch 8 --seq 2048 --steps 20  # full width, card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch mamba2-130m --reduced --steps 20       # reduced, on the CPU

The port's counterpart of the reference's ``launch/train.py``: config
registry, the seeded data pipeline, init, the train step (loss, autograd
gradients, AdamW with clipping), checkpoint/restart (the driver always
restores the latest complete checkpoint if one exists, so a preempted job
re-runs the same command), the preemption guard and straggler
detection.  ``--use-kernel`` routes attention through the flash kernel
and Mamba2's SSD scan through its kernel.  ``--device`` (default: the
card; without one it raises).

``--model-parallel N`` runs through a mesh, as the reference's
``launch.train`` always does: ``make_host_mesh(N)`` over the process
group's world (one rank unless the job was started by ``torchrun``), the
parameters and the optimizer state initialised or restored into the
placements of ``param_specs``/``opt_state_specs`` (ZeRO-1), each batch
placed by
``batch_spec``, and the train step run on DTensors.  With one rank the
mesh is (1, 1) and the step still runs on DTensors.  Only rank 0 logs
and writes metrics and checkpoints (every rank takes part in gathering
a checkpoint's leaves); checkpoints hold whole tensors, so a run under
one mesh resumes under another, or without one.  Without the flag the
step runs unsharded on ``--device``.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2 ...                        # a 2 x 2 mesh

Returns 1 when at least 20 steps ran and the mean loss of the last five
did not fall below that of the first five, else 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..configs import get_config
from ..core.synth import resolve_device
from ..data import make_pipeline
from ..distributed import sharding as shd
from ..dtensor import is_dtensor
from ..ft import PreemptionGuard, StragglerDetector, resume_or_init
from ..models import lm
from ..optim import AdamWConfig, adamw_init, opt_state_specs
from .mesh import destroy_host_group, make_host_mesh
from .steps import make_train_step


def _value(x) -> float:
    """A 0-d metric as a float (a replicated DTensor's local value)."""
    return float(x.to_local() if is_dtensor(x) else x)


def train(argv=None) -> int:
    try:
        return _train(argv)
    finally:
        destroy_host_group()


def _train(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="the flash-attention and SSD-scan kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="run through a (world / N, N) data x model mesh")
    ap.add_argument("--metrics", default=None,
                    help="write JSONL metrics to this path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.with_reduced()
    dev = resolve_device(args.device)
    mesh = None
    if args.model_parallel is not None:
        mesh = make_host_mesh(args.model_parallel, dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or mesh.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    log(f"[train] arch={cfg.name} family={cfg.family} "
        f"params={cfg.param_count()/1e6:.1f}M "
        f"(active {cfg.active_param_count()/1e6:.1f}M) device={dev}"
        + ("" if mesh is None else f" mesh={dict(shd.mesh_shape(mesh))}"))

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    data = make_pipeline(cfg.vocab, args.seq, args.batch, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, writer=lead)
    straggler = StragglerDetector()

    # ---- the mesh's layouts ------------------------------------------------
    pspec = ospec = bspec = pshard = oshard = None
    if mesh is not None:
        pol = shd.for_mesh(mesh)
        pspec = shd.param_specs(cfg, mesh, pol)
        ospec = opt_state_specs(cfg, mesh, pol)
        bspec = shd.batch_spec(cfg, mesh, args.batch, pol)
        pshard, oshard = shd.shardings(pspec, mesh), \
            shd.shardings(ospec, mesh)

    # ---- init or resume --------------------------------------------------
    # resume_or_init goes through digest-verified restore_latest: a
    # checkpoint corrupted after publish is skipped and the scan falls
    # back to the previous good step
    params_like = lm.init_params(cfg, device="meta")
    opt_like = adamw_init(params_like, opt)

    def _init():
        params = lm.init_params(cfg, args.seed, device=dev)
        state = adamw_init(params, opt)
        if mesh is None:
            return params, state
        return (shd.place_tree(params, pspec, mesh),
                shd.place_tree(state, ospec, mesh))

    start, params, opt_state, extra = resume_or_init(
        mgr, _init, params_like, opt_like, device=dev,
        param_shardings=pshard, opt_shardings=oshard)
    if start > 0:
        data.load_state_dict(extra.get("data", {"step": start}))
        log(f"[train] resumed from checkpoint step {start}")
    if start >= args.steps:
        log(f"[train] checkpoint already at step {start} >= "
            f"--steps {args.steps}; nothing to do")
        return 0

    step_fn = make_train_step(cfg, opt, use_kernel=args.use_kernel)
    metrics_f = open(args.metrics, "a") if args.metrics and lead else None
    losses = []
    t_run = time.perf_counter()
    try:
        with PreemptionGuard() as guard:
            for step in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.next_batch().items()}
                if mesh is not None:
                    batch = {k: shd.place(v, bspec[k], mesh)
                             for k, v in batch.items()}
                params, opt_state, m = step_fn(params, opt_state, batch)
                loss = _value(m["loss"])         # waits for the step
                dt = time.perf_counter() - t0
                losses.append(loss)
                slow = straggler.observe(dt)
                if (step + 1) % args.log_every == 0 or step == start:
                    log(f"[train] step {step+1:5d} loss {loss:.4f} "
                        f"lr {_value(m['lr']):.2e} "
                        f"gnorm {_value(m['grad_norm']):.3f} "
                        f"{dt*1e3:.0f}ms{'  [straggler]' if slow else ''}")
                if metrics_f:
                    metrics_f.write(json.dumps(
                        {"step": step + 1, "loss": loss, "dt": dt,
                         "grad_norm": _value(m["grad_norm"])}) + "\n")
                if (step + 1) % args.ckpt_every == 0 or guard.requested:
                    mgr.save(step + 1, params, opt_state,
                             extra={"data": data.state_dict()},
                             blocking=False)
                if guard.requested:
                    mgr.wait()
                    log(f"[train] preempted at step {step+1}; "
                        f"checkpoint saved")
                    return 0
        mgr.save(args.steps, params, opt_state,
                 extra={"data": data.state_dict()})
    finally:
        mgr.wait()
        if metrics_f:
            metrics_f.close()
    wall = time.perf_counter() - t_run
    tok_s = (args.steps - start) * args.batch * args.seq / max(wall, 1e-9)
    log(f"[train] done: {args.steps - start} steps in {wall:.1f}s "
        f"({tok_s:,.0f} tok/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if len(losses) >= 20 and not (np.mean(losses[-5:]) <
                                  np.mean(losses[:5])):
        log("[train] WARNING: loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(train())

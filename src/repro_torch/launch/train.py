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
card; without one the driver raises) replaces the reference's mesh;
``--model-parallel`` waits for the distributed slice (ROADMAP A12).

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
from ..ft import PreemptionGuard, StragglerDetector, resume_or_init
from ..models import lm
from ..optim import AdamWConfig, adamw_init
from .steps import make_train_step


def train(argv=None) -> int:
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
    ap.add_argument("--metrics", default=None,
                    help="write JSONL metrics to this path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.with_reduced()
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M) device={dev}")

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    data = make_pipeline(cfg.vocab, args.seq, args.batch, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    straggler = StragglerDetector()

    # ---- init or resume --------------------------------------------------
    # resume_or_init goes through digest-verified restore_latest: a
    # checkpoint corrupted after publish is skipped and the scan falls
    # back to the previous good step
    params_like = lm.init_params(cfg, device="meta")
    opt_like = adamw_init(params_like, opt)

    def _init():
        params = lm.init_params(cfg, args.seed, device=dev)
        return params, adamw_init(params, opt)

    start, params, opt_state, extra = resume_or_init(
        mgr, _init, params_like, opt_like, device=dev)
    if start > 0:
        data.load_state_dict(extra.get("data", {"step": start}))
        print(f"[train] resumed from checkpoint step {start}")
    if start >= args.steps:
        print(f"[train] checkpoint already at step {start} >= "
              f"--steps {args.steps}; nothing to do")
        return 0

    step_fn = make_train_step(cfg, opt, use_kernel=args.use_kernel)
    metrics_f = open(args.metrics, "a") if args.metrics else None
    losses = []
    t_run = time.perf_counter()
    try:
        with PreemptionGuard() as guard:
            for step in range(start, args.steps):
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.next_batch().items()}
                params, opt_state, m = step_fn(params, opt_state, batch)
                loss = float(m["loss"])          # waits for the step
                dt = time.perf_counter() - t0
                losses.append(loss)
                slow = straggler.observe(dt)
                if (step + 1) % args.log_every == 0 or step == start:
                    print(f"[train] step {step+1:5d} loss {loss:.4f} "
                          f"lr {float(m['lr']):.2e} "
                          f"gnorm {float(m['grad_norm']):.3f} "
                          f"{dt*1e3:.0f}ms{'  [straggler]' if slow else ''}")
                if metrics_f:
                    metrics_f.write(json.dumps(
                        {"step": step + 1, "loss": loss, "dt": dt,
                         "grad_norm": float(m["grad_norm"])}) + "\n")
                if (step + 1) % args.ckpt_every == 0 or guard.requested:
                    mgr.save(step + 1, params, opt_state,
                             extra={"data": data.state_dict()},
                             blocking=False)
                if guard.requested:
                    mgr.wait()
                    print(f"[train] preempted at step {step+1}; "
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
    print(f"[train] done: {args.steps - start} steps in {wall:.1f}s "
          f"({tok_s:,.0f} tok/s); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if len(losses) >= 20 and not (np.mean(losses[-5:]) <
                                  np.mean(losses[:5])):
        print("[train] WARNING: loss did not decrease")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(train())

"""AdamW with global-norm clipping, a cosine schedule, a configurable
state dtype and ZeRO-1 state sharding.

The port's copy of the reference's ``optim/adamw.py``: the same
defaults, float32 update math whatever the parameters' and the state's
dtypes, and the same functional form (:func:`adamw_update` returns new
parameters and state; it updates nothing in place).

ZeRO-1: the moments get an *additional* data-axis sharding on their
largest unsharded dim (:func:`opt_state_specs`), so m/v live partitioned
across the data-parallel group while the parameters keep their compute
layout; in the sharded step DTensor takes the gradient's slice for the
moments and all-gathers the updated parameter back to its own layout
(``launch.steps.make_train_step``), the ZeRO-1 communication schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..distributed.sharding import (ShardingPolicy, Spec, _divides,
                                    abstract_params, for_mesh, param_specs)
from ..models.config import ModelConfig
from ..tree import leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" to halve optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 0, float32, of an int step
    tensor."""
    step = step.float()
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) /
                       max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    return c.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_init(params: dict, c: AdamWConfig) -> dict:
    """Zero moments in ``c.state_dtype`` beside each parameter, and an
    int32 step counter, on the parameters' device."""
    dt = _DTYPES[c.state_dtype]
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict,
                 c: AdamWConfig) -> tuple:
    """Returns ``(new_params, new_state, metrics)``; metrics hold the
    pre-clip global gradient norm and the step's learning rate as 0-d
    float32 tensors."""
    step = state["step"] + 1
    lr = cosine_lr(c, step)
    gf = tree_map(lambda g: g.float(), grads)
    gnorm = torch.sqrt(sum(g.square().sum() for g in leaves(gf)) + 1e-30)
    scale = torch.clamp(c.clip_norm / gnorm, max=1.0)
    bc1 = 1.0 - c.b1 ** step.float()
    bc2 = 1.0 - c.b2 ** step.float()
    sdt = _DTYPES[c.state_dtype]

    def upd(p, g, m, v):
        g = g * scale
        mf = m.float() * c.b1 + g * (1 - c.b1)
        vf = v.float() * c.b2 + g.square() * (1 - c.b2)
        pf = p.float()
        pf = pf - lr * ((mf / bc1) / (torch.sqrt(vf / bc2) + c.eps)
                        + c.weight_decay * pf)
        return pf.to(p.dtype), mf.to(sdt), vf.to(sdt)

    out = tree_map(upd, params, gf, state["m"], state["v"])
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}, {"grad_norm": gnorm, "lr": lr}


def _pick(tree: dict, i: int) -> dict:
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def opt_state_specs(cfg: ModelConfig, mesh,
                    pol: Optional[ShardingPolicy] = None,
                    zero1: bool = True) -> dict:
    """Specs of the AdamW state; ZeRO-1 adds dp sharding to the moments
    (the largest unsharded dim of at least 1024 that the dp axes
    divide); ``step`` is replicated."""
    pol = pol or for_mesh(mesh)
    like = abstract_params(cfg)
    pspecs = param_specs(cfg, mesh, pol, like=like)

    def zero_one(spec: Spec, leaf) -> Spec:
        if leaf.ndim == 0:
            return spec
        ent = list(spec) + [None] * (leaf.ndim - len(spec))
        dp = pol.dp_spec
        order = sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i])
        for i in order:
            if ent[i] is None and _divides(leaf.shape[i], mesh, dp) and \
                    leaf.shape[i] >= 1024:
                ent[i] = dp
                break
        return Spec(*ent)

    mspec = tree_map(zero_one, pspecs, like) if zero1 else pspecs
    return {"m": mspec, "v": mspec, "step": Spec()}

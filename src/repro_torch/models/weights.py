"""Carry the reference's parameters over to the port.

The reference keeps a dense model's parameters as a nested dict with
per-layer leaves stacked along ``[L, ...]`` and matrices laid out
``[in, out]`` (applied as ``x @ W``); the port keeps the same names,
layouts and stacking (:mod:`repro_torch.models.layers`), so the
conversion is leaf for leaf with no transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.synth import resolve_device
from .config import ModelConfig
from .lm import torch_dtype


def from_jax_params(params_np, cfg: ModelConfig, device=None) -> dict:
    """The port's parameter dict from the reference's parameter pytree
    with numpy leaves (``jax.tree.map(np.asarray, params)``), cast to
    ``cfg.dtype`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        # float32 first: numpy has no bfloat16 of its own; np.array copies,
        # so a read-only leaf becomes a tensor that owns its memory
        return torch.from_numpy(np.array(t, np.float32)).to(dev, dt)
    return conv(params_np)

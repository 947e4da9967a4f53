"""Carry the reference's parameters over to the port.

The reference keeps a model's parameters as a nested dict with per-layer
leaves stacked along ``[L, ...]`` and matrices laid out ``[in, out]``
(applied as ``x @ W``); the port keeps the same names, layouts and
stacking (:mod:`repro_torch.models.layers`), so the conversion is leaf
for leaf with no transpose.  Each leaf keeps its own dtype: a bf16 model
holds Mamba2's ``A_log``, ``D`` and ``dt_bias`` in float32, and so does
its port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.synth import resolve_device


def _leaf(arr) -> torch.Tensor:
    # np.array copies, so a read-only leaf becomes a tensor that owns its
    # memory; numpy has no bfloat16 of its own (the reference's leaves
    # carry ml_dtypes' type), so its 2-byte pattern travels as uint16
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(params_np, device=None) -> dict:
    """The port's parameter dict from the reference's parameter pytree
    with numpy leaves (``jax.tree.map(np.asarray, params)``), each leaf in
    its own dtype, on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _leaf(t).to(dev)
    return conv(params_np)

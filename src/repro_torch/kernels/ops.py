"""Model-layout entry points of the attention kernels.

The port's counterpart of the reference's ``kernels/ops.py``
(``flash_attention`` ``:100``, ``decode_attention`` ``:120``).  Both take
the model's layout (``[B, S, heads, hd]`` activations, ``[B, S_max, nkv,
hd]`` caches), and the kernels read that layout through strides, so no
transpose is made here.  Routing is the one rule of :mod:`.dispatch`: a
CUDA tensor launches the kernel, whatever its shape (the kernels mask
ragged edges themselves, so the reference's fallback to the jnp oracle
for shapes that do not tile has no counterpart), and a CPU or meta tensor
takes the kernel's plain version.

Forward only: an input that needs a gradient raises
``NotImplementedError``; the flash backward comes with the training
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention_fwd
from .flash_attention import flash_attention_fwd


def _forward_only(op: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op}: the port's attention kernels are forward only; the "
            f"backward (an autograd.Function) lands with the training "
            f"slice (ROADMAP queue A, training)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention, model layout.

    q: [B, Sq, nh, hd]; k/v: [B, Sk, nkv, hd].  Returns [B, Sq, nh, hd].
    """
    _forward_only("flash_attention", q, k, v)
    out, _ = flash_attention_fwd(q, k, v, causal=causal, window=window)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode against a cache (serving only).

    q: [B, nh, hd]; k/v: [B, S_max, nkv, hd]; kv_len: [B] int32 valid
    lengths on q's device.  Returns [B, nh, hd].
    """
    _forward_only("decode_attention", q, k, v)
    return decode_attention_fwd(q, k, v, kv_len)

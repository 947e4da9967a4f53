"""Model-layout entry points of the kernels, with their gradients.

The port's counterpart of the reference's ``kernels/ops.py``
(``flash_attention`` ``:100``, ``decode_attention`` ``:120``,
``ssd_scan`` ``:224``).  Each takes the model's layout (``[B, S, heads,
hd]`` activations, ``[B, S_max, nkv, hd]`` caches, ``[B, S, H, P]`` SSD
inputs), and the kernels read that layout through strides, so no
transpose is made here.  Routing is the one rule of :mod:`.dispatch`: a
CUDA tensor launches the kernel, whatever its shape (the kernels mask
ragged edges themselves, so the reference's fallback to the jnp oracle
for shapes that do not tile has no counterpart), and a CPU or meta tensor
takes the kernel's plain version.

Gradients, as the reference's ``jax.custom_vjp`` rules give them:

* :func:`flash_attention` is a ``torch.autograd.Function``: the forward
  kernel saves ``(q, k, v, out, lse)`` and the backward is the
  reference's ``_flash_bwd`` (``ops.py:50-89``) in torch ops — the
  reference computes it outside any Pallas kernel too;
* :func:`ssd_scan` is one as well: the backward recomputes through the
  model's chunked SSD in torch ops
  (:func:`repro_torch.models.layers.ssd_chunked` with ``use_kernel=False``)
  and takes autograd's vector-Jacobian product, the state's cotangent
  included.  (The reference recomputes through the sequential
  ``ref.ssd_scan_ref``, ``ops.py:214``, although its kernel's docstring
  names ``ssd_chunked``; a sequential scan would be 2,048 eager steps a
  layer here.)
* :func:`decode_attention` is serving only: an input that needs a
  gradient raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .decode_attention import decode_attention_fwd
from .flash_attention import _masks, flash_attention_fwd
from .ssd_scan import ssd_scan_fwd, ssd_sequence


def _forward_only(op: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op}: serving only, the port's kernel has no backward (nor "
            f"has the reference's)")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_backward(q, k, v, out, lse, dout, *, causal: bool,
                   window: Optional[int]) -> tuple:
    """The reference's ``_flash_bwd`` from saved ``(q, k, v, out, lse)``,
    fp32 math; returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, Sq, nkv, g, hd).float()
    kf, vf = k.float(), v.float()
    dof = dout.reshape(B, Sq, nkv, g, hd).float()
    of = out.reshape(B, Sq, nkv, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    mask = _masks(Sq, Sk, causal, window, q.device)
    p = torch.exp(s - lse.reshape(B, nkv, g, Sq)[..., None])
    p = torch.where(mask, p, 0.0)
    dv_row = (dof * of).sum(dim=-1).permute(0, 2, 3, 1)    # [B,nkv,g,Sq]
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - dv_row[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout,
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention, model layout, differentiable.

    q: [B, Sq, nh, hd]; k/v: [B, Sk, nkv, hd].  Returns [B, Sq, nh, hd].
    """
    return _Flash.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode against a cache (serving only).

    q: [B, nh, hd]; k/v: [B, S_max, nkv, hd]; kv_len: [B] int32 valid
    lengths on q's device.  Returns [B, nh, hd].
    """
    _forward_only("decode_attention", q, k, v)
    return decode_attention_fwd(q, k, v, kv_len)


# ---------------------------------------------------------------------------
# SSD scan (Mamba-2)
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, s0, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, s0)
        ctx.chunk = chunk
        return ssd_sequence(ssd_scan_fwd, x, dt, A, Bm, Cm, D, chunk, s0)

    @staticmethod
    def backward(ctx, dy, dfinal):
        from ..models.layers import ssd_chunked
        saved = ctx.saved_tensors
        want = [i for i in range(len(saved)) if ctx.needs_input_grad[i]]
        grads = [None] * (len(saved) + 1)
        if want:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(i in want)
                       for i, t in enumerate(saved)]
                y, final = ssd_chunked(*ins[:6], ctx.chunk,
                                       init_state=ins[6], use_kernel=False)
                got = torch.autograd.grad((y, final), [ins[i] for i in want],
                                          (dy, dfinal))
            for i, g in zip(want, got):
                grads[i] = g
        return tuple(grads)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256,
             init_state: Optional[torch.Tensor] = None) -> tuple:
    """Chunked SSD sequence mixing (kernel-backed), differentiable.

    x: [B, S, H, P]; dt: [B, S, H]; A: [H]; Bm/Cm: [B, S, G, N]; D: [H];
    init_state: [B, H, P, N] or None (zeros).  Returns ``(y [B, S, H, P]
    in x's dtype, final_state [B, H, P, N] float32)``.
    """
    B, S, H, P = x.shape
    N = Bm.shape[3]
    s0 = init_state if init_state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    return _SSD.apply(x, dt, A, Bm, Cm, D, s0, chunk)

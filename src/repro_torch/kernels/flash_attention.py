"""Flash attention forward: a CUDA kernel for Hopper + its plain version.

:func:`flash_attention_fwd` takes q/k/v in the model's layout
(``q[B, Sq, nh, hd]``, ``k/v[B, Sk, nkv, hd]``, GQA through
``h // (nh // nkv)``) and returns ``(out[B, Sq, nh, hd], lse[B, nh, Sq])``
with ``lse`` in fp32 — the function of the reference's
``flash_attention_fwd`` (``src/repro/kernels/flash_attention.py:113``,
Pallas body ``_fwd_kernel`` at ``:45``), whose layout is head-major.

Masks: causal (``j <= i``) and sliding window (``j > i - window``); a
row with no visible key gives ``out = 0`` and ``lse = -1e30``, as the
Pallas kernel's ``l == 0`` guard does.

A CUDA tensor launches ``csrc/flash_attention.cu`` (any ``Sq``/``Sk``,
``hd`` 64 or 128, float32 or bfloat16; anything else raises); a CPU or
meta tensor takes :func:`flash_attention_plain` (:mod:`.dispatch`).  The
source's header says what bounds the kernel and what its design does.
Forward only: the backward lands with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .dispatch import count_launch, uses_kernel

NEG_INF = -1e30
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_fwd": [_VP] * 5 + [_LL] * 9 + [_INT] * 10
               + [ctypes.c_float, _VP]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _masks(sq: int, sk: int, causal: bool, window: Optional[int],
           device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: Optional[int]) -> tuple:
    """Plain version of :func:`flash_attention_fwd` (CPU and meta tensors,
    and the card-side yardstick the kernel is held against)."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qf = q.reshape(B, Sq, nkv, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * (1.0 /
                                                           math.sqrt(hd))
    mask = _masks(Sq, Sk, causal, window, q.device)[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgqs,bskh->bkgqh", p, v.float()) / safe
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype)
    lse = (m + torch.log(safe))[..., 0].reshape(B, nh, Sq)
    return out, lse


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are contiguous and 16-byte aligned (the
    kernel's loads), else a fresh contiguous copy (a fresh allocation is
    aligned; ``contiguous()`` of a contiguous view at an odd offset is
    the view itself)."""
    vec = 16 // x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and \
            all(st % vec == 0 for st in x.stride()[:-1]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool,
                        window: Optional[int] = None) -> tuple:
    """Attention forward in the model's layout; returns ``(out, lse)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not "
                         f"[B, Sq, nh, hd] / [B, Sk, nkv, hd] with nkv | nh")
    if not uses_kernel("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or hd not in (64, 128):
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype with head_dim 64 or 128, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype} and hd={hd}")
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _build.bind("flash_attention", _SIGNATURES)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, Sq, Sk, nh, nh // nkv, hd, _DTYPES[q.dtype], int(causal),
        int(window is not None), int(window or 0), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", "flash_attention", rc)
    count_launch("flash_attention")
    return out, lse

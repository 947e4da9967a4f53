"""Flash-decode: a CUDA kernel for Hopper + its plain version.

:func:`decode_attention_fwd` is one new token per sequence attending to
its own prefix of a KV cache: ``q[B, nh, hd]`` against ``k/v[B, S_max,
nkv, hd]`` (the model's cache layout, read through its strides, never
transposed) over the first ``kv_len[b]`` positions, GQA through
``h // (nh // nkv)``.  A row with ``kv_len == 0`` (a dead serving slot)
gives exact zeros.  It is the function of the reference's
``decode_attention_fwd`` (``src/repro/kernels/decode_attention.py:85``,
Pallas body ``_decode_kernel`` at ``:35``), whose layout is head-major.

A CUDA tensor launches ``csrc/decode_attention.cu`` — a split-KV pass
and a combine pass in one call, counted as one launch — which reads
``kv_len`` on the device (no host sync) and skips every cache block at or
past it (``hd`` 64 or 128, float32 or bfloat16, at most 8 query heads per
KV head; anything else raises).  A CPU or meta tensor takes
:func:`decode_attention_plain` (:mod:`.dispatch`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .dispatch import count_launch, uses_kernel
from .flash_attention import _aligned

NEG_INF = -1e30
MAX_GROUP = 8
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention": [_VP] * 8 + [_LL] * 8 + [_INT] * 6
               + [ctypes.c_float, _VP],
               "decode_attention_split": []}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decode_attention_fwd` (CPU and meta
    tensors, and the card-side yardstick the kernel is held against)."""
    B, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (1.0 /
                                                         math.sqrt(hd))
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float()) / \
        torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, nh, hd).to(q.dtype)


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: [B, nh, hd]; k/v: [B, S_max, nkv, hd]; kv_len: [B] int32 on
    q's device.  Returns [B, nh, hd] in q's dtype."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[3] or \
            k.shape[2] == 0 or q.shape[1] % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not "
                         f"[B, nh, hd] / [B, S_max, nkv, hd] with nkv | nh")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (q.shape[0],):
        raise ValueError(f"decode_attention: kv_len must be int32 "
                         f"[{q.shape[0]}], got {kv_len.dtype}"
                         f"{tuple(kv_len.shape)}")
    if not uses_kernel("decode_attention", q, k, v, kv_len):
        return decode_attention_plain(q, k, v, kv_len)
    B, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or hd not in (64, 128) or group > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, head_dim 64 or 128 and at "
                         f"most {MAX_GROUP} query heads per KV head, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}, hd={hd}, "
                         f"group={group}")
    out = torch.empty((B, nh, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out.zero_()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    kv_len = kv_len.contiguous()
    lib = _build.bind("decode_attention", _SIGNATURES)
    n_split = -(-S // lib.decode_attention_split())
    part = torch.empty((2 + hd) * B * nkv * n_split * group,
                       dtype=torch.float32, device=q.device)
    n_stat = B * nkv * n_split * group
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), part[n_stat:].data_ptr(),
        part[2 * n_stat:].data_ptr(), q.stride(0), q.stride(1),
        *k.stride()[:3], *v.stride()[:3], B, S, nkv, group, hd,
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd), _build.stream(q))
    _build.check(lib, "decode_attention", "decode_attention", rc)
    count_launch("decode_attention")
    return out

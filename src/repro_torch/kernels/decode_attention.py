"""Flash-decode: a CUDA kernel for Hopper + its plain version.

:func:`decode_attention_fwd` is one new token per sequence attending to
its own prefix of a KV cache: ``q[B, nh, hd]`` against ``k/v[B, S_max,
nkv, hd]`` (the model's cache layout, read through its strides, never
transposed) over the first ``kv_len[b]`` positions, GQA through
``h // (nh // nkv)``.  A row with ``kv_len == 0`` (a dead serving slot)
gives exact zeros.  On request it also gives each row's log-sum-exp,
and the output in float32 before its rounding: what merges the results
of a cache split along its sequence (a sequence-split mesh, :mod:`.ops`)
with one rounding, as the kernel's own splits are merged.  It is the function of the reference's
``decode_attention_fwd`` (``src/repro/kernels/decode_attention.py:85``,
Pallas body ``_decode_kernel`` at ``:35``), whose layout is head-major.

A CUDA tensor launches ``csrc/decode_attention.cu`` — a split-KV pass
over 64-row splits (``decode_partial_kernel``) and a merge pass
(``decode_merge_kernel``) in one call, counted as one launch — which
reads ``kv_len`` on the device (no host sync) and skips every cache block
at or past it (``hd`` 64, 96 or 128, float32 or bfloat16; anything
else raises; hd 96 runs in tiles 128 wide whose last 32 columns are
zeros, reading only 96 columns).  A launch takes at most ``MAX_GROUP``
(16) query heads per KV head; a larger group, which the reference's
kernel also takes, runs one launch a chunk of :func:`head_chunks` (each
reads the cache again).  :func:`launch_args` is the
launch's host side as plain numbers (split count from ``S_max`` alone,
grids, scratch, strides).  A CPU or meta tensor takes
:func:`decode_attention_plain` (:mod:`.dispatch`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build
from .dispatch import count_launch, uses_kernel
from .flash_attention import _aligned

NEG_INF = -1e30
MAX_GROUP = 16          # query heads per KV head a launch (csrc kMaxGroup)
SPLIT = 64              # cache rows a block (csrc kSplit)
HEAD_DIMS = (64, 96, 128)
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention": [_VP] * 9 + [_LL] * 8 + [_INT] * 8
               + [ctypes.c_float, _VP],
               "decode_attention_smem_bytes": [_INT] * 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Launch(NamedTuple):
    """One call's launch as :func:`launch_args` prepares it."""
    q: torch.Tensor         # the tensors the kernels read (``_aligned``)
    k: torch.Tensor
    v: torch.Tensor
    strides: tuple          # (b, h) of q, (b, s, h) of k, of v
    dims: tuple             # (B, S_max, nkv, group, hd)
    dtype: int              # 0 float32, 1 bfloat16
    n_split: int            # ceil(S_max / SPLIT)
    grid_partial: tuple     # (n_split, nkv, B)
    grid_merge: tuple       # (nkv, B)
    smem_partial: int       # dynamic shared memory a block, bytes
    n_stat: int             # m (and l) slots, rounded up to 4: acc aligned
    part_numel: int         # float32 scratch: m, l and acc of each split
    scale: float
    chunks: tuple           # query heads a KV head of each launch


def group_bound(group: int) -> int:
    """The partial kernel instantiation a launch of ``group`` query heads
    a KV head runs: the most it takes (2, 4, 8 or 16)."""
    return 2 if group <= 2 else 4 if group <= 4 else 8 if group <= 8 \
        else MAX_GROUP


def head_chunks(group: int) -> tuple:
    """The query heads a KV head of each launch: the whole group up to
    ``MAX_GROUP``, a larger one in ``ceil(group / MAX_GROUP)`` chunks as
    equal as they come (24 -> 12 + 12)."""
    n = -(-group // MAX_GROUP)
    size, extra = divmod(group, n)
    return tuple(size + (i < extra) for i in range(n))


def padded(hd: int) -> int:
    """A shared tile row's width for head width ``hd``: ``hd`` rounded up
    to a power of two (csrc ``padded``)."""
    return 64 if hd <= 64 else 128


def smem_bytes(dtype: torch.dtype, hd: int, group: int) -> int:
    """Dynamic shared memory a block of the partial kernel: its K and V
    tiles (rows :func:`padded` wide) and the scores of its group bound's
    heads (csrc partial_smem); for a group over ``MAX_GROUP``, a block
    of its largest chunk's launch."""
    return 2 * SPLIT * padded(hd) * dtype.itemsize + \
        4 * group_bound(max(head_chunks(group))) * SPLIT


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: torch.Tensor) -> Launch:
    """Everything a launch needs but the outputs, scratch and stream, on
    any device; raises on what no kernel takes.  ``n_split`` comes from
    ``S_max`` alone (``kv_len`` stays on the device).  A group over
    ``MAX_GROUP`` runs one launch a chunk (``chunks``); ``smem_partial``,
    ``n_stat`` and ``part_numel`` are then those of its largest chunk's
    launch, and the other fields describe the whole call."""
    _check_shapes(q, k, v, kv_len)
    B, nh, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype and head_dim 64, 96 or 128, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}, hd={hd}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    n_split = -(-S // SPLIT)
    chunks = head_chunks(group)
    slots = B * nkv * n_split * max(chunks)
    n_stat = -(-slots // 4) * 4         # acc's float4 stores stay aligned
    return Launch(q, k, v, (q.stride(0), q.stride(1), *k.stride()[:3],
                            *v.stride()[:3]),
                  (B, S, nkv, group, hd), _DTYPES[q.dtype], n_split,
                  (n_split, nkv, B), (nkv, B), smem_bytes(q.dtype, hd, group),
                  n_stat, 2 * n_stat + hd * slots, 1.0 / math.sqrt(hd),
                  chunks)


def _check_shapes(q, k, v, kv_len) -> None:
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


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor, *,
                           return_lse: bool = False):
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
    if not return_lse:
        return o.reshape(B, nh, hd).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(l), -math.inf)
    return o.reshape(B, nh, hd), lse.reshape(B, nh)


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, *, return_lse: bool = False):
    """q: [B, nh, hd]; k/v: [B, S_max, nkv, hd]; kv_len: [B] int32 on
    q's device.  Returns [B, nh, hd] in q's dtype; with ``return_lse``
    the pair ``(out, lse)``, both float32 and unrounded: ``out`` [B, nh,
    hd], ``lse`` [B, nh] each row's log-sum-exp of its scaled scores
    (-inf for a row with no valid key), what merges results over pieces
    of one cache."""
    if not uses_kernel("decode_attention", q, k, v, kv_len):
        _check_shapes(q, k, v, kv_len)
        return decode_attention_plain(q, k, v, kv_len, return_lse=return_lse)
    a = launch_args(q, k, v, kv_len)
    B, S, nkv, group, hd = a.dims
    out = q.new_empty(q.shape, dtype=torch.float32 if return_lse
                      else q.dtype)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B == 0 or S == 0:
        out.zero_()
        return (out, lse.fill_(-math.inf)) if return_lse else out
    if len(a.chunks) > 1:
        return _by_chunks(q, k, v, kv_len, a.chunks, out, lse)
    kv_len = kv_len.contiguous()
    part = torch.empty(a.part_numel, dtype=torch.float32, device=q.device)
    lib = _build.bind("decode_attention", _SIGNATURES)
    rc = lib.decode_attention(
        a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), part[a.n_stat:].data_ptr(),
        part[2 * a.n_stat:].data_ptr(),
        None if lse is None else lse.data_ptr(), *a.strides, B, S, nkv,
        group, hd, a.dtype, SPLIT, a.n_split, a.scale, _build.stream(q))
    _build.check(lib, "decode_attention", "decode_attention", rc)
    count_launch("decode_attention")
    return (out, lse) if return_lse else out


def _by_chunks(q, k, v, kv_len, chunks: tuple, out: torch.Tensor, lse):
    """A group over ``MAX_GROUP``: one launch a chunk of each KV head's
    query heads (its own contiguous copy of those rows of ``q``), the
    results written into ``out`` (and ``lse``) at the chunk's heads."""
    B, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, nkv, nh // nkv, hd)
    og = out.view(B, nkv, nh // nkv, hd)
    c0 = 0
    for c in chunks:
        part = decode_attention_fwd(
            qg[:, :, c0:c0 + c].reshape(B, nkv * c, hd), k, v, kv_len,
            return_lse=lse is not None)
        if lse is None:
            og[:, :, c0:c0 + c] = part.view(B, nkv, c, hd)
        else:
            og[:, :, c0:c0 + c] = part[0].view(B, nkv, c, hd)
            lse.view(B, nkv, nh // nkv)[:, :, c0:c0 + c] = \
                part[1].view(B, nkv, c)
        c0 += c
    return out if lse is None else (out, lse)

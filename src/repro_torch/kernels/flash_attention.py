"""Flash attention forward: two CUDA kernels for Hopper + a plain version.

:func:`flash_attention_fwd` takes q/k/v in the model's layout
(``q[B, Sq, nh, hd]``, ``k/v[B, Sk, nkv, hd]``, GQA through
``h // (nh // nkv)``) and returns ``(out[B, Sq, nh, hd], lse[B, nh, Sq])``
with ``lse`` in fp32 — the function of the reference's
``flash_attention_fwd`` (``src/repro/kernels/flash_attention.py:113``,
Pallas body ``_fwd_kernel`` at ``:45``), whose layout is head-major.

Masks: causal (``j <= i``) and sliding window (``j > i - window``); a
row with no visible key gives ``out = 0`` and ``lse = -1e30``, as the
Pallas kernel's ``l == 0`` guard does.

A CUDA tensor launches one of two kernels of ``csrc/flash_attention.cu``,
chosen by dtype alone (:func:`launch_args`), any ``Sq``/``Sk``, ``hd`` 64,
96 or 128; anything else raises, and neither kernel stands in for the
other:

* bfloat16 (serving, training) -> ``flash_wgmma_kernel``.  Bound by
  operations (the bf16 tensor cores' 989 TFLOP/s).  Both products on the
  tensor cores through ``wgmma``: S = Q Kᵀ from shared memory, O += P V
  with P rounded to bf16 in registers (the one rounding the reference does
  not make; S, the softmax and O stay fp32).  128 query rows a block, two
  consumer warpgroups, a producer warp feeding a 2-stage ring of 128-key
  K/V tiles by TMA (tensor maps encoded per call over the tensors'
  strides), masks only on the tiles that cross an edge, heaviest causal
  tiles first.  hd 96 (Phi-3) loads each 96-wide row as two 64-column
  TMA boxes, the second clipped to zeros past column 96 by the tensor
  map, and multiplies P V with one m64n96k16 product a k16 step.
* float32 (the card-vs-CPU checks, held at 1e-5 / 1e-4, which TF32 would
  not meet) -> ``flash_fwd_kernel``: fp32 FMAs on the CUDA cores (67
  TFLOP/s peak) over 64 x 64 tiles in shared memory.

A CPU or meta tensor takes :func:`flash_attention_plain` (:mod:`.dispatch`).
The source's header says more of each design.  The backward is torch ops
(:func:`.ops.flash_backward`), reading ``out`` and ``lse``.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import NamedTuple, Optional

import torch

from . import _build
from .dispatch import count_launch, uses_kernel

NEG_INF = -1e30
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, out, lse, the packed launch (_PACKED), the stream
_FWD_ARGS = [_VP] * 5 + [ctypes.c_char_p, _VP]
_SIGNATURES = {"flash_attention_fwd_fma": _FWD_ARGS,
               "flash_attention_fwd_wgmma": _FWD_ARGS,
               "flash_attention_smem_bytes": [_INT, _INT]}
# dtype -> (entry point, dtype code): the only choice between the kernels
ENTRIES = {torch.float32: ("flash_attention_fwd_fma", 0),
           torch.bfloat16: ("flash_attention_fwd_wgmma", 1)}
HEAD_DIMS = (64, 96, 128)
# csrc/flash_attention.cu's struct FlashLaunch: strides, dims, dtype,
# causal, has_window, window, scale (one argument, not 21: ctypes converts
# each argument on every call)
_PACKED = struct.Struct("<9q10if4x")


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
    st = x.stride()
    if st[-1] == 1 and not (x.data_ptr() % 16 or
                            math.gcd(*st[:-1]) % (16 // x.element_size())):
        return x
    return x.clone(memory_format=torch.contiguous_format)


class Launch(NamedTuple):
    """One kernel launch as :func:`launch_args` prepares it: the entry
    point, the tensors the kernel reads (``_aligned``), and the arguments
    after the five pointers."""
    entry: str
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    strides: tuple          # (b, s, h) of q, then of k, then of v
    dims: tuple             # (B, Sq, Sk, nh, group, hd)
    dtype: int
    causal: int
    has_window: int
    window: int
    scale: float


def _check_shapes(q, k, v) -> tuple:
    """Raise unless q/k/v are [B, Sq, nh, hd] / [B, Sk, nkv, hd] with nkv
    dividing nh; returns q's and k's shapes."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape or qs[0] != ks[0] \
            or qs[3] != ks[3] or ks[2] == 0 or qs[2] % ks[2]:
        raise ValueError(f"flash_attention: q {tuple(qs)} and k/v "
                         f"{tuple(ks)}/{tuple(v.shape)} are not "
                         f"[B, Sq, nh, hd] / [B, Sk, nkv, hd] with nkv | nh")
    return qs, ks


def _operand(x: torch.Tensor, shape) -> tuple:
    """``x`` as the kernels read it (:func:`_aligned`) and its (batch, seq,
    head) strides in elements.  A dimension of size 1 is never stepped
    along, so it gets the span of the dimensions inside it, which a tensor
    map takes whatever stride ``x`` reports for it."""
    x = _aligned(x)
    (nb, ns, nh, hd), (sb, ss, sh, _) = shape, x.stride()
    sh = sh if nh > 1 else hd
    ss = ss if ns > 1 else sh * nh
    return x, ((sb if nb > 1 else ss * ns), ss, sh)


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: Optional[int]) -> Launch:
    """Everything a launch needs but the outputs and the stream, on any
    device: the entry point by dtype (bfloat16 -> the wgmma kernel,
    float32 -> the FMA kernel), q/k/v copied only where ``_aligned``
    must, their strides, ``group`` and the mask arguments.  Raises on a
    dtype or head width no kernel takes.  On the serving path it runs
    once a layer a prefill, so it stays lean: it is most of a short
    call's host time."""
    qs, ks = _check_shapes(q, k, v)
    B, Sq, nh, hd = qs
    _, Sk, nkv, _ = ks
    route = ENTRIES.get(q.dtype)
    if route is None or k.dtype != q.dtype or v.dtype != q.dtype \
            or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take float32 or bfloat16 "
                         f"q/k/v of one dtype with head_dim 64, 96 or 128, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype} and hd={hd}")
    (q, sq), (k, sk), (v, sv) = (_operand(q, qs), _operand(k, ks),
                                 _operand(v, ks))
    return Launch(route[0], q, k, v, sq + sk + sv,
                  (B, Sq, Sk, nh, nh // nkv, hd), route[1], int(causal),
                  int(window is not None), int(window or 0),
                  1.0 / math.sqrt(hd))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool,
                        window: Optional[int] = None) -> tuple:
    """Attention forward in the model's layout; returns ``(out, lse)``."""
    if not uses_kernel("flash_attention", q, k, v):
        _check_shapes(q, k, v)
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    a = launch_args(q, k, v, causal=causal, window=window)
    B, Sq, Sk, nh, _, hd = a.dims
    out = q.new_empty((B, Sq, nh, hd))
    lse = q.new_empty((B, nh, Sq), dtype=torch.float32)
    if B == 0 or Sq == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    lib = _build.bind("flash_attention", _SIGNATURES)
    rc = getattr(lib, a.entry)(
        a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _PACKED.pack(*a.strides, *a.dims, a.dtype, a.causal,
                                     a.has_window, a.window, a.scale),
        _build.stream(q))
    _build.check(lib, "flash_attention", a.entry, rc)
    count_launch("flash_attention")
    return out, lse

"""Mamba-2 SSD chunked scan: a CUDA kernel for Hopper + its plain version.

:func:`ssd_scan_fwd` takes the dt-weighted input ``xdt[B, S, H, P]``, the
per-step log decays ``dA[B, S, H]`` (``dt * A``, negative), the
projections ``Bm/Cm[B, S, G, N]`` (head ``h`` reads group ``h // (H //
G)``) and an initial state ``s0[B, H, P, N]``, all float32, with ``S`` a
multiple of ``chunk``, and returns ``(y[B, S, H, P], final_state[B, H,
P, N])`` in float32 — the function of the reference's ``ssd_scan_fwd``
(``src/repro/kernels/ssd_scan.py:92``, Pallas body ``_ssd_kernel`` at
``:43``), whose layout is head-major; here the model's layout is read
through strides and nothing is transposed.

A CUDA tensor launches ``csrc/ssd_scan.cu`` — chunk states, state
passing and the chunk scan, three kernels in one call counted as one
launch — for ``(P, N)`` in ``(64, 128)``, ``(64, 64)``, ``(16, 16)`` and
``chunk <= 256`` (anything else raises); a CPU or meta tensor takes
:func:`ssd_scan_plain` (:mod:`.dispatch`).  The source's header says what
bounds the kernel and what its design does.

:func:`ssd_sequence` is the model-layout wrapper around either: it pads
``S`` to a multiple of the chunk with ``dt = 0`` (decay 1, no input: the
state passes through unchanged), forms ``xdt`` and ``dA``, adds the
``D`` skip outside the scan and trims, as the reference's ``ops.py:184-
205`` does.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

from . import _build
from .dispatch import count_launch, uses_kernel
from .flash_attention import _aligned

MAX_CHUNK = 256
KERNEL_SHAPES = ((64, 128), (64, 64), (16, 16))     # (P, N) built
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_scan_fwd": [_VP] * 9 + [_LL] * 12 + [_INT] * 7 + [_VP]}


def _check_shapes(xdt, dA, Bm, Cm, s0, chunk: int) -> None:
    if xdt.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan: xdt {tuple(xdt.shape)} / Bm "
                         f"{tuple(Bm.shape)} are not [B, S, H, P] / "
                         f"[B, S, G, N]")
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dA.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S)
            or Cm.shape != Bm.shape or tuple(s0.shape) != (B, H, P, N)
            or G == 0 or H % G):
        raise ValueError(
            f"ssd_scan: inconsistent shapes xdt {tuple(xdt.shape)}, dA "
            f"{tuple(dA.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)}, s0 {tuple(s0.shape)} (G must divide H)")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk}")


def ssd_scan_plain(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, s0: torch.Tensor, *,
                   chunk: int) -> tuple:
    """Plain version of :func:`ssd_scan_fwd` (CPU and meta tensors, the
    card-side yardstick, and — through :func:`ssd_sequence` — the
    model's differentiable chunked SSD).  Computes in the inputs' dtype
    (float32, or float64 for a reference evaluation)."""
    _check_shapes(xdt, dA, Bm, Cm, s0, chunk)
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q, rep = S // chunk, chunk, H // G
    x = xdt.reshape(B, nc, Q, H, P)
    a = dA.reshape(B, nc, Q, H)
    Bf = Bm.repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, N)
    Cf = Cm.repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, N)

    cum = a.cumsum(dim=2)                               # inclusive
    # decay from step j (exclusive) to step i (inclusive), j <= i; the
    # exponent is masked, not the exp, so no inf/NaN appears either way
    tril = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    decay = torch.exp(torch.where(tril[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, x)

    tail = torch.exp(cum[:, :, -1:, :] - cum)           # decay j -> end
    own = torch.einsum("bcjhn,bcjhp->bchpn", Bf, x * tail[..., None])
    total = torch.exp(cum[:, :, -1, :])                 # [B, nc, H]
    state = s0.to(xdt.dtype)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total[:, c, :, None, None] + own[:, c]
    entering = torch.stack(entering, dim=1)             # [B, nc, H, P, N]
    head = torch.exp(cum)                               # decay start -> i
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Cf * head[..., None],
                           entering)
    return (y_intra + y_inter).reshape(B, S, H, P), state


def ssd_scan_fwd(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int) -> tuple:
    """The SSD scan in the model's layout; returns ``(y, final_state)``,
    both float32."""
    _check_shapes(xdt, dA, Bm, Cm, s0, chunk)
    if not uses_kernel("ssd_scan", xdt, dA, Bm, Cm, s0):
        return ssd_scan_plain(xdt, dA, Bm, Cm, s0, chunk=chunk)
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if any(t.dtype != torch.float32 for t in (xdt, dA, Bm, Cm, s0)) or \
            (P, N) not in KERNEL_SHAPES or chunk > MAX_CHUNK:
        raise ValueError(
            f"ssd_scan kernel takes float32 inputs with (P, N) in "
            f"{KERNEL_SHAPES} and chunk <= {MAX_CHUNK}, got "
            f"{[str(t.dtype) for t in (xdt, dA, Bm, Cm, s0)]}, "
            f"(P, N) = ({P}, {N}), chunk {chunk}")
    dev = xdt.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return y, s_out.copy_(s0)
    nc = S // chunk
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
    decay = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    xdt, Bm, Cm = _aligned(xdt), _aligned(Bm), _aligned(Cm)
    s0 = _aligned(s0.contiguous())          # read as whole float4 rows
    lib = _build.bind("ssd_scan", _SIGNATURES)
    rc = lib.ssd_scan_fwd(
        xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), states.data_ptr(),
        decay.data_ptr(), *xdt.stride()[:3], *dA.stride(), *Bm.stride()[:3],
        *Cm.stride()[:3], B, S, H, G, P, N, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ssd_scan", "ssd_scan", rc)
    count_launch("ssd_scan")
    return y, s_out


def ssd_sequence(scan: Callable, x: torch.Tensor, dt: torch.Tensor,
                 A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 D: torch.Tensor, chunk: int, s0: torch.Tensor) -> tuple:
    """SSD sequence mixing in the model's layout through ``scan``
    (:func:`ssd_scan_fwd` or :func:`ssd_scan_plain`).

    x: [B, S, H, P]; dt: [B, S, H] (softplus-ed); A: [H] (negative);
    Bm/Cm: [B, S, G, N]; D: [H]; s0: [B, H, P, N].  Returns ``(y [B, S,
    H, P] in x's dtype, final_state [B, H, P, N] float32)``."""
    S = x.shape[1]
    pad = (-S) % chunk
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    xdt = xf * dtf[..., None]
    dA = dtf * A.float()
    y, final = scan(xdt, dA, Bf, Cf, s0.float(), chunk=chunk)
    y = y[:, :S] + xf[:, :S] * D.float()[None, None, :, None]
    return y.to(x.dtype), final

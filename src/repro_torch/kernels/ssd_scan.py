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

A CUDA tensor launches ``csrc/ssd_scan.cu`` — chunk states
(``ssd_state_mma``, wgmma), state passing (``ssd_state_pass``) and the
chunk scan (``ssd_scan_mma``, mma.sync, C B^T shared by the heads of a
group), three kernels in one call counted as one launch, their products
on the tensor cores in 3xTF32 — for ``(P, N)`` in ``(64, 128)``,
``(64, 64)``, ``(16, 16)`` and ``chunk <= 256`` (anything else raises); a
CPU or meta tensor takes :func:`ssd_scan_plain` (:mod:`.dispatch`).
:func:`launch_args` is the launch's host side as plain numbers (heads a
block, grids, shared memory, scratch, strides); the source's header says
what bounds the kernel and what its design does.

:func:`ssd_sequence` is the model-layout wrapper around either: it pads
``S`` to a multiple of the chunk with ``dt = 0`` (decay 1, no input: the
state passes through unchanged), forms ``xdt`` and ``dA``, adds the
``D`` skip outside the scan and trims, as the reference's ``ops.py:184-
205`` does.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .dispatch import count_launch, uses_kernel
from .flash_attention import _aligned

MAX_CHUNK = 256
KERNEL_SHAPES = ((64, 128), (64, 64), (16, 16))     # (P, N) built
ROWS = 64               # rows of a query / key tile (csrc kRows)
THREADS = 256           # threads a block of the state and scan kernels
MAX_HEADS = 24          # heads a block of the scan (csrc kMaxHeads)
MAX_STATE_HEADS = 2     # of the chunk states (csrc kMaxStateHeads)
SMS = 132               # streaming multiprocessors of an H100 SXM
_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_scan_fwd": [_VP] * 9 + [_LL] * 12 + [_INT] * 9 + [_VP],
               "ssd_scan_smem_bytes": [_INT] * 5}


class Launch(NamedTuple):
    """One call's launch as :func:`launch_args` prepares it."""
    xdt: torch.Tensor       # the tensors the kernels read (``_aligned``)
    dA: torch.Tensor
    Bm: torch.Tensor
    Cm: torch.Tensor
    s0: torch.Tensor
    strides: tuple          # (b, s, h/g) of xdt, dA, Bm, Cm: 12 numbers
    dims: tuple             # (B, S, H, G, P, N, chunk)
    nc: int                 # chunks
    heads_state: int        # heads a block of ssd_state_mma
    heads_scan: int         # heads a block of ssd_scan_mma
    grid_state: tuple       # (nc, H / heads_state, B)
    grid_pass: tuple        # (ceil(P N / 1024), H, B)
    grid_scan: tuple        # (nc H / heads_scan B, query tiles)
    smem_state: int         # dynamic shared memory a block, bytes
    smem_scan: int
    states_shape: tuple     # scratch: each chunk's state [B, nc, H, P, N]
    decay_shape: tuple      # scratch: exp(cum at the chunk's end) [B, nc, H]


def heads_per_block(group: int, heads: int, blocks_per_set: int,
                    most: int = MAX_HEADS) -> int:
    """Heads a block: the largest divisor of ``group`` (heads a group) up
    to ``most`` whose grid, ``blocks_per_set`` blocks for each set of
    heads, still fills the ``SMS`` SMs once (each kernel holds one block
    an SM); 1 when none does."""
    for d in range(min(group, most), 0, -1):
        if group % d == 0 and blocks_per_set * (heads // d) >= SMS:
            return d
    return 1


def smem_bytes(P: int, N: int, chunk: int, heads: int) -> tuple:
    """Dynamic shared memory a block of ssd_state_mma and of ssd_scan_mma
    (the csrc's ``state_smem`` / ``scan_smem``)."""
    qt = -(-chunk // ROWS) * ROWS
    # raw key tiles of B and xdt; tf32 hi and lo planes of B [N][64 keys]
    # and of each head's xdt [64 wgmma rows][64 keys]; 1024-byte alignment
    raw = 4 * (ROWS * N + MAX_STATE_HEADS * ROWS * P)
    planes = 2 * 4 * ROWS * (N + MAX_STATE_HEADS * 64)
    state = 1024 + planes + raw + 4 * heads * qt
    st = max(P * (N + 4), 4 * 2 * (P // 8) * 4 * 32)
    xs = max(4 * ROWS * (P + 4), 2 * ROWS * (N + 4))
    return state, 8 * heads * qt + 4 * (ROWS * (N + 4) + 2 * st + xs)


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


def launch_args(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, s0: torch.Tensor, *, chunk: int) -> Launch:
    """Everything a launch needs but the outputs, scratch and stream, on
    any device: the inputs as the kernels read them, their strides, the
    heads a block of each kernel, the grids and shared memory.  Raises on
    a dtype, ``(P, N)`` or chunk no kernel takes."""
    _check_shapes(xdt, dA, Bm, Cm, s0, chunk)
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if any(t.dtype != torch.float32 for t in (xdt, dA, Bm, Cm, s0)) or \
            (P, N) not in KERNEL_SHAPES or chunk > MAX_CHUNK:
        raise ValueError(
            f"ssd_scan kernel takes float32 inputs with (P, N) in "
            f"{KERNEL_SHAPES} and chunk <= {MAX_CHUNK}, got "
            f"{[str(t.dtype) for t in (xdt, dA, Bm, Cm, s0)]}, "
            f"(P, N) = ({P}, {N}), chunk {chunk}")
    nc, n_tiles, group = S // chunk, -(-chunk // ROWS), H // G
    hb_state = heads_per_block(group, H, nc * B, MAX_STATE_HEADS)
    hb_scan = heads_per_block(group, H, nc * n_tiles * B)
    xdt, Bm, Cm = _aligned(xdt), _aligned(Bm), _aligned(Cm)
    s0 = _aligned(s0.contiguous())          # read as whole 16-byte rows
    return Launch(
        xdt, dA, Bm, Cm, s0,
        (*xdt.stride()[:3], *dA.stride(), *Bm.stride()[:3],
         *Cm.stride()[:3]),
        (B, S, H, G, P, N, chunk), nc, hb_state, hb_scan,
        (nc, H // hb_state, B), (-(-P * N // (4 * THREADS)), H, B),
        (nc * (H // hb_scan) * B, n_tiles),
        smem_bytes(P, N, chunk, hb_state)[0],
        smem_bytes(P, N, chunk, hb_scan)[1],
        (B, nc, H, P, N), (B, nc, H))


def ssd_scan_fwd(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int) -> tuple:
    """The SSD scan in the model's layout; returns ``(y, final_state)``,
    both float32."""
    if not uses_kernel("ssd_scan", xdt, dA, Bm, Cm, s0):
        return ssd_scan_plain(xdt, dA, Bm, Cm, s0, chunk=chunk)
    a = launch_args(xdt, dA, Bm, Cm, s0, chunk=chunk)
    B, S, H, G, P, N, _ = a.dims
    dev = xdt.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return y, s_out.copy_(s0)
    states = torch.empty(a.states_shape, dtype=torch.float32, device=dev)
    decay = torch.empty(a.decay_shape, dtype=torch.float32, device=dev)
    lib = _build.bind("ssd_scan", _SIGNATURES)
    rc = lib.ssd_scan_fwd(
        a.xdt.data_ptr(), a.dA.data_ptr(), a.Bm.data_ptr(), a.Cm.data_ptr(),
        a.s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), states.data_ptr(),
        decay.data_ptr(), *a.strides, B, S, H, G, P, N, chunk,
        a.heads_state, a.heads_scan, _build.stream(xdt))
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

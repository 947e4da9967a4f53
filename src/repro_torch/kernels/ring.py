"""Ring-buffer ops of the compiled interconnect: CUDA kernels + plain versions.

``CompiledEngine`` keeps every channel as a ring buffer ``buf[cap, *elem]``
on the device, with its head and size as int32 entries of two device
vectors; ``head``/``size`` arguments below are 0-d int32 tensors (views of
those entries).  The three ops of the sweep loop:

* :func:`ring_pop` — pop ``n`` tokens from the head, advancing head and
  size in place;
* :func:`ring_push` — push ``arr[n, *elem]`` at the tail, writing ``buf``
  and advancing size in place;
* :func:`eval_guards` — every task's fire predicate in one op.

Each has a hand-written CUDA kernel for Hopper (``csrc/ring.cu``, built at
first use by :mod:`._build`) and, beside it, a plain PyTorch version of
the same function.  A CUDA tensor launches the kernel; a CPU or meta
tensor takes the plain version (:mod:`.dispatch`).  All three are exact
integer/copy ops, so kernel and plain version agree bit for bit, and both
agree with the reference package's ``ring_pop``/``ring_push``/
``eval_guards`` (``src/repro/kernels/ring.py``).

Source notes, per kernel (the card's bound and what the design does):

* ``ring_pop`` replaces ``_pop_kernel`` (``src/repro/kernels/ring.py:84``).
  Bound by bytes moved (``n`` rows read and written once: 8 KiB to
  256 KiB a burst on the main path).  The kernel is one block, so head
  and size are updated in place without a race across blocks; that caps
  it at what one SM can copy, and rows move as 16-byte words where
  alignment allows.  At these sizes the host's launch path costs more
  than the copy (PERF.md); a multi-block copy is later work.
* ``ring_push`` replaces ``_push_kernel`` (``ring.py:141``).  Same bound.
  It writes in place: the Pallas kernel copies the whole ring through only
  because JAX arrays are immutable.
* ``eval_guards`` replaces ``_guard_kernel`` (``ring.py:200``).  Bound by
  the launch at every size the port runs (``T*C`` int32 compares, a few
  tens of KiB); one warp per task row, ``__all_sync`` over the channels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import count_launch, uses_kernel

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "ring_pop": [_VP, _VP, _VP, _VP, _INT, _INT, ctypes.c_longlong, _INT,
                 _VP],
    "ring_push": [_VP, _VP, _VP, _VP, _INT, _INT, ctypes.c_longlong, _INT,
                  _VP],
    "eval_guards": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring")
    if not getattr(lib, "_argtypes_set", False):
        for fn, args in _ARGTYPES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = _INT
        lib.ring_error_string.argtypes = [_INT]
        lib.ring_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launched(lib: ctypes.CDLL, op: str, rc: int) -> None:
    if rc != 0:
        msg = lib.ring_error_string(rc).decode()
        raise RuntimeError(f"{op} kernel launch failed: {msg} (cuda error "
                           f"{rc})")
    count_launch(op)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _word(row_bytes: int, *tensors: torch.Tensor) -> int:
    """Widest copy word (16, 4 or 1 bytes) that divides the row and every
    pointer."""
    for w in (16, 4):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0
                                      for t in tensors):
            return w
    return 1


def _check_counter(op: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 0:
        raise ValueError(f"{op}: {name} must be a 0-d int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def _check_ring(op: str, buf: torch.Tensor, head: torch.Tensor,
                size: torch.Tensor) -> None:
    if buf.dim() < 1 or buf.shape[0] < 1:
        raise ValueError(f"{op}: buf must be [cap >= 1, *elem], got shape "
                         f"{tuple(buf.shape)}")
    _check_counter(op, "head", head)
    _check_counter(op, "size", size)


# ---------------------------------------------------------------------------
# pop
# ---------------------------------------------------------------------------

def ring_pop_plain(buf: torch.Tensor, head: torch.Tensor,
                   size: torch.Tensor, n: int):
    """Plain version of :func:`ring_pop` (CPU and meta tensors)."""
    cap = buf.shape[0]
    idx = (head + torch.arange(n, dtype=torch.int32, device=buf.device)) \
        % cap
    toks = buf.index_select(0, idx)
    head.copy_((head + n) % cap)
    size.sub_(n)
    return toks, head, size


def ring_pop(buf: torch.Tensor, head: torch.Tensor, size: torch.Tensor,
             n: int):
    """Pop ``n`` tokens from a ring buffer.

    Returns ``(toks[n, *elem], head, size)``: ``toks`` is a new tensor,
    and ``head``/``size`` are the argument tensors, advanced in place to
    ``(head + n) % cap`` and ``size - n``.  ``n`` is a static int (the
    synthesis contract); ``size >= n`` is the caller's guard.
    """
    n = int(n)
    _check_ring("ring_pop", buf, head, size)
    cap = buf.shape[0]
    if not 0 <= n <= cap:
        raise ValueError(f"ring_pop: n={n} outside [0, cap={cap}]")
    if not uses_kernel("ring_pop", buf, head, size):
        return ring_pop_plain(buf, head, size, n)
    if not buf.is_contiguous():
        raise ValueError("ring_pop: buf must be contiguous")
    out = torch.empty((n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    if n == 0:
        return out, head, size
    row_bytes = buf[0].numel() * buf.element_size()
    lib = _lib()
    rc = lib.ring_pop(buf.data_ptr(), out.data_ptr(), head.data_ptr(),
                      size.data_ptr(), cap, n, row_bytes,
                      _word(row_bytes, buf, out), _stream(buf))
    _launched(lib, "ring_pop", rc)
    return out, head, size


# ---------------------------------------------------------------------------
# push
# ---------------------------------------------------------------------------

def ring_push_plain(buf: torch.Tensor, head: torch.Tensor,
                    size: torch.Tensor, arr: torch.Tensor):
    """Plain version of :func:`ring_push` (CPU and meta tensors)."""
    n, cap = arr.shape[0], buf.shape[0]
    idx = (head + size
           + torch.arange(n, dtype=torch.int32, device=buf.device)) % cap
    buf.index_copy_(0, idx.long(), arr)
    size.add_(n)
    return buf, head, size


def ring_push(buf: torch.Tensor, head: torch.Tensor, size: torch.Tensor,
              arr: torch.Tensor):
    """Push ``arr[n, *elem]`` at the tail of a ring buffer, in place.

    Writes the rows into ``buf`` at ``(head + size + i) % cap`` and
    advances ``size`` by ``n``; returns ``(buf, head, size)``, the
    argument tensors.  ``size + n <= cap`` is the caller's guard.
    """
    _check_ring("ring_push", buf, head, size)
    if arr.dim() != buf.dim() or arr.dtype != buf.dtype or \
            tuple(arr.shape[1:]) != tuple(buf.shape[1:]):
        raise ValueError(
            f"ring_push: arr {arr.dtype}{tuple(arr.shape)} does not match "
            f"ring elements {buf.dtype}{tuple(buf.shape[1:])}")
    cap, n = buf.shape[0], arr.shape[0]
    if not 0 <= n <= cap:
        raise ValueError(f"ring_push: n={n} outside [0, cap={cap}]")
    if not uses_kernel("ring_push", buf, head, size, arr):
        return ring_push_plain(buf, head, size, arr)
    if not buf.is_contiguous():
        raise ValueError("ring_push: buf must be contiguous")
    if n == 0:
        return buf, head, size
    arr = arr.contiguous()
    row_bytes = buf[0].numel() * buf.element_size()
    lib = _lib()
    rc = lib.ring_push(buf.data_ptr(), arr.data_ptr(), head.data_ptr(),
                       size.data_ptr(), cap, n, row_bytes,
                       _word(row_bytes, buf, arr), _stream(buf))
    _launched(lib, "ring_push", rc)
    return buf, head, size


# ---------------------------------------------------------------------------
# fused guard evaluation
# ---------------------------------------------------------------------------

def eval_guards_plain(sizes: torch.Tensor, caps: torch.Tensor,
                      need_r: torch.Tensor, need_w: torch.Tensor,
                      live: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`eval_guards` (CPU and meta tensors)."""
    if need_r.shape[1] == 0:
        return live.clone()
    space = caps - sizes
    ok_r = (need_r <= sizes[None, :]).all(dim=1)
    ok_w = (need_w <= space[None, :]).all(dim=1)
    return live & ok_r & ok_w


def eval_guards(sizes: torch.Tensor, caps: torch.Tensor,
                need_r: torch.Tensor, need_w: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """Every task's firing predicate in one op.

    ``sizes``/``caps`` are int32 ``[C]`` (occupancy and capacity),
    ``need_r``/``need_w`` int32 ``[T, C]`` (each task's current-phase
    per-firing token needs), ``live`` bool ``[T]``.  Returns a new bool
    ``fire[T]``::

        fire[t] = live[t] & all_c(need_r[t,c] <= sizes[c])
                          & all_c(need_w[t,c] <= caps[c] - sizes[c])

    With no channels (``C == 0``) it is ``live``.
    """
    t, c = need_r.shape
    for name, x, dt, shape in (("sizes", sizes, torch.int32, (c,)),
                               ("caps", caps, torch.int32, (c,)),
                               ("need_r", need_r, torch.int32, (t, c)),
                               ("need_w", need_w, torch.int32, (t, c)),
                               ("live", live, torch.bool, (t,))):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"eval_guards: {name} must be {dt}{shape}, "
                             f"got {x.dtype}{tuple(x.shape)}")
    if not uses_kernel("eval_guards", sizes, caps, need_r, need_w, live):
        return eval_guards_plain(sizes, caps, need_r, need_w, live)
    if c == 0 or t == 0:
        return live.clone()
    args = [x.contiguous() for x in (sizes, caps, need_r, need_w, live)]
    fire = torch.empty(t, dtype=torch.bool, device=live.device)
    lib = _lib()
    rc = lib.eval_guards(*(x.data_ptr() for x in args), fire.data_ptr(),
                         t, c, _stream(live))
    _launched(lib, "eval_guards", rc)
    return fire

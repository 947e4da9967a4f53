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

A caller that pops and pushes one ring many times (the sweep loop's
stream views) prepares a :class:`RingHandle` once: it holds everything
that depends only on the ring, so an op on the card is the output (pop;
from a slab allocated ahead), one ctypes call of three plain arguments
and the launch count.  :func:`ring_pop`/:func:`ring_push` build a handle per
call.

Source notes, per kernel (the card's bound and what the design does):

* ``ring_pop`` replaces ``_pop_kernel`` (``src/repro/kernels/ring.py:84``).
  Bound by bytes moved (``n`` rows read and written once: 8 KiB to
  256 KiB a burst on the main path).  One launch is one thread-block
  cluster of :func:`cluster_blocks` blocks, each copying at most two
  flat spans of the ring; a cluster barrier orders every block's read of
  head/size before block 0 writes them (``csrc/ring.cu``).
* ``ring_push`` replaces ``_push_kernel`` (``ring.py:141``).  Same bound
  and design.  It writes in place: the Pallas kernel copies the whole
  ring through only because JAX arrays are immutable.
* ``eval_guards`` replaces ``_guard_kernel`` (``ring.py:200``).  Bound by
  the launch at every size the port runs (``T*C`` int32 compares, a few
  tens of KiB); one warp per task row, ``__all_sync`` over the channels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .dispatch import count_launch, uses_kernel

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    # the ring's _RingLaunch by reference, the flat rows, burst_arg(n):
    # three arguments, as ctypes converts each one on every call
    "ring_pop": [_VP, _VP, ctypes.c_longlong],
    "ring_push": [_VP, _VP, ctypes.c_longlong],
    "eval_guards": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
}
# csrc/ring.cu: kCopyThreads threads a block, each moving kUnroll 16-byte
# words a pass, and clusters of at most kMaxCluster blocks (the portable
# limit)
COPY_THREADS, UNROLL, MAX_CLUSTER = 512, 4, 8
BLOCK_BYTES = COPY_THREADS * UNROLL * 16        # 32 KiB: one block's pass
# popped tokens are allocated SLAB_BYTES (at most SLAB_MAX tokens) at a time
SLAB_BYTES, SLAB_MAX = 16 << 20, 256
# (token shape, dtype, device index) -> popped-token outputs not yet used,
# with their addresses, shared by the rings of one token type (RingHandle)
_SPARE: dict = {}


def _launched(lib: ctypes.CDLL, op: str, rc: int) -> None:
    _build.check(lib, "ring", op, rc)
    count_launch(op)


class _RingLaunch(ctypes.Structure):
    """``csrc/ring.cu``'s ``struct RingLaunch``: what a launch needs that
    depends only on the ring, and the stream of its last launch."""
    _fields_ = [("buf", _VP), ("head", _VP), ("size", _VP), ("stream", _VP),
                ("row_bytes", ctypes.c_longlong), ("cap", _INT),
                ("word", _INT)]


def copy_word(row_bytes: int, *ptrs: int) -> int:
    """Widest copy word (16, 4 or 1 bytes) that divides the row and every
    pointer.  The kernel narrows a ring's word by the other pointer of
    each launch (``narrowed`` in ``csrc/ring.cu``), which gives this
    function over both pointers."""
    for w in (16, 4):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def cluster_blocks(nbytes: int) -> int:
    """Blocks in the cluster that moves ``nbytes`` (one way): one per
    :data:`BLOCK_BYTES`, at least 1 and at most :data:`MAX_CLUSTER` (a
    gaussian row of 8 KiB takes one block, a 256 KiB token eight)."""
    return max(1, min(MAX_CLUSTER, -(-nbytes // BLOCK_BYTES)))


def slab_tokens(token_bytes: int) -> int:
    """Popped tokens allocated together: :data:`SLAB_BYTES` of them, at
    least 1 and at most :data:`SLAB_MAX` (256 of gaussian's 8 KiB rows, 64
    of a 256 KiB gemm token, 1 of anything past 16 MiB)."""
    return max(1, min(SLAB_MAX, SLAB_BYTES // max(1, token_bytes)))


def burst_arg(n: int, row_bytes: int) -> int:
    """The C entries' ``burst`` argument for ``n`` rows of ``row_bytes``:
    ``n`` and the cluster size (:func:`cluster_blocks`) packed as
    ``n * 16 + blocks``."""
    return n << 4 | cluster_blocks(n * row_bytes)


class RingArgs(NamedTuple):
    """The launch arguments that depend only on the ring."""
    cap: int
    elem: tuple
    row_bytes: int
    word: int               # copy_word over the rows and buf's address


def _check_counter(op: str, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 0:
        raise ValueError(f"{op}: {name} must be a 0-d int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def ring_args(buf: torch.Tensor, head: torch.Tensor,
              size: torch.Tensor) -> RingArgs:
    """Check a ring and return its :class:`RingArgs`, on any device:
    ``buf`` must be a contiguous ``[cap >= 1, *elem]`` tensor and
    ``head``/``size`` 0-d int32 tensors."""
    if buf.dim() < 1 or buf.shape[0] < 1:
        raise ValueError(f"ring: buf must be [cap >= 1, *elem], got shape "
                         f"{tuple(buf.shape)}")
    _check_counter("ring", "head", head)
    _check_counter("ring", "size", size)
    if not buf.is_contiguous():
        raise ValueError("ring: buf must be contiguous")
    elem = tuple(buf.shape[1:])
    row_bytes = math.prod(elem) * buf.element_size()
    return RingArgs(buf.shape[0], elem, row_bytes,
                    copy_word(row_bytes, buf.data_ptr()))


class RingHandle:
    """One ring's pops and pushes, prepared once.

    The constructor checks the ring (:func:`ring_args`) and, for a ring on
    the card, binds the library, fills the ``_RingLaunch`` struct the C
    entry reads by reference and binds the device's current-stream
    lookup; a launch updates the struct's stream when the current stream
    has moved.  A pop or push then checks only what the kernel's memory
    safety needs (``n`` within ``[0, cap]``, once per burst size; a pushed
    tensor's dtype, whole rows of bytes and device; a non-contiguous one
    is copied); the element-shape check is :func:`ring_push`'s, and
    synthesis's counting pass makes it for every firing.  A CPU or meta
    ring takes the plain versions.

    Popped tokens on the card are allocated :func:`slab_tokens` at a time
    (one ``torch.empty`` and one ``unbind``, which cost less than one
    ``torch.empty`` a pop), and the spare ones are shared by every ring of
    the same token shape, dtype and device (``_SPARE``): each token is a
    new tensor of its own elements, a view of a slab that no ring and no
    other token's elements share; a slab's memory is freed when its last
    token is.
    """

    __slots__ = ("buf", "head", "size", "cap", "elem", "row_bytes",
                 "_dtype", "_device", "_dev", "_kernel",
                 "_lib", "_launch", "_ref", "_stream", "_st", "_pop_fn",
                 "_push_fn", "_bursts", "_spare")

    def __init__(self, buf: torch.Tensor, head: torch.Tensor,
                 size: torch.Tensor):
        a = ring_args(buf, head, size)
        self.buf, self.head, self.size = buf, head, size
        self.cap, self.elem, self.row_bytes = a.cap, a.elem, a.row_bytes
        self._dtype, self._device = buf.dtype, buf.device
        self._dev = buf.get_device()
        self._kernel = uses_kernel("ring", buf, head, size)
        self._bursts: dict = {}     # n -> burst_arg(n), for n in [1, cap]
        self._spare: dict = {}      # n (None: one token) -> _SPARE's list
        if self._kernel:
            self._lib = _build.bind("ring", _ARGTYPES)
            self._pop_fn, self._push_fn = self._lib.ring_pop, \
                self._lib.ring_push
            self._stream = functools.partial(
                torch._C._cuda_getCurrentRawStream, self._dev)
            self._st = self._stream()
            self._launch = _RingLaunch(buf.data_ptr(), head.data_ptr(),
                                       size.data_ptr(), self._st,
                                       a.row_bytes, a.cap, a.word)
            self._ref = ctypes.addressof(self._launch)

    def _check_n(self, op: str, n: int) -> None:
        if not 0 <= n <= self.cap:
            raise ValueError(f"{op}: n={n} outside [0, cap={self.cap}]")

    def _burst(self, op: str, n: int) -> int:
        """:func:`burst_arg` of an ``n``-row burst, kept for the next; 0
        for ``n == 0``, which launches nothing."""
        self._check_n(op, n)
        if n == 0:
            return 0
        b = self._bursts[n] = burst_arg(n, self.row_bytes)
        return b

    # -- pop -----------------------------------------------------------------
    def pop(self, n: int, _one: bool = False) -> torch.Tensor:
        """Pop ``n`` tokens: a new ``[n, *elem]`` tensor (``_one``: one
        ``elem``-shaped token, :meth:`pop_one`)."""
        key = None if _one else n   # the spare outputs' shape
        if not self._kernel:
            self._check_n("ring_pop", n)
            toks = ring_pop_plain(self.buf, self.head, self.size, n)[0]
            return toks if key is not None else toks[0]
        try:
            out, ptr = self._spare[key].pop()
        except (KeyError, IndexError):  # first pop of this size, or none left
            out, ptr = self._refill(n, key)
            if n == 0:
                return out
        st = self._stream()
        if st != self._st:
            self._launch.stream = self._st = st
        rc = self._pop_fn(self._ref, ptr, self._bursts[n])
        if rc:
            _build.check(self._lib, "ring", "ring_pop", rc)
        count_launch("ring_pop")
        return out

    def pop_one(self) -> torch.Tensor:
        """Pop one token: a new ``elem``-shaped tensor."""
        return self.pop(1, True)

    def _refill(self, n: int, key) -> tuple:
        """An output for ``key`` (an ``n``-row burst, or None: one token)
        and its address: a spare one of this token type if there is one,
        else one of a new slab whose other tokens become the spare ones;
        for ``n == 0`` an empty output."""
        shape = (n, *self.elem) if key is not None else self.elem
        if not self._burst("ring_pop", n):
            return torch.empty(shape, dtype=self._dtype,
                               device=self._device), 0
        spare = self._spare[key] = _SPARE.setdefault(
            (shape, self._dtype, self._dev), [])
        try:
            return spare.pop()
        except IndexError:
            pass
        k, tb = slab_tokens(n * self.row_bytes), n * self.row_bytes
        slab = torch.empty((k, *shape), dtype=self._dtype,
                           device=self._device)
        base = slab.data_ptr()
        slab = list(zip(slab.unbind(0), range(base, base + k * tb, tb)
                        if tb else [base] * k))
        out = slab.pop()
        spare.extend(slab)
        return out

    # -- push ----------------------------------------------------------------
    def push(self, arr: torch.Tensor) -> None:
        """Push ``arr`` at the tail: ``[n, *elem]`` rows, or one
        ``elem``-shaped token.  ``n`` is ``arr``'s bytes over the row's;
        ``arr`` must be a whole number of rows of the ring's dtype on its
        device (the element shape is the caller's to check)."""
        nbytes, rb = arr.nbytes, self.row_bytes
        n = nbytes // rb if rb else len(arr)
        burst = self._bursts.get(n)
        if burst is None or not self._kernel:
            burst = self._burst("ring_push", n)
        if arr.dtype is not self._dtype or n * rb != nbytes or \
                arr.get_device() != self._dev:
            self._refuse(arr, n)
        if not self._kernel:
            if arr.device.type != self._device.type:
                self._refuse(arr, n)
            ring_push_plain(self.buf, self.head, self.size,
                            arr.reshape((n, *self.elem)))
            return
        if not burst:
            return
        if not arr.is_contiguous():
            arr = arr.contiguous()
        st = self._stream()
        if st != self._st:
            self._launch.stream = self._st = st
        rc = self._push_fn(self._ref, arr.data_ptr(), burst)
        if rc:
            _build.check(self._lib, "ring", "ring_push", rc)
        count_launch("ring_push")

    def _refuse(self, arr: torch.Tensor, n: int) -> None:
        if arr.dtype is not self._dtype or n * self.row_bytes != arr.nbytes:
            raise ValueError(
                f"ring_push: {arr.dtype}{tuple(arr.shape)} is not whole "
                f"rows of ring elements {self._dtype}{self.elem}")
        raise ValueError(f"ring_push: arr on {arr.device}, ring on "
                         f"{self._device}")


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
    return RingHandle(buf, head, size).pop(int(n)), head, size


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
    ring = RingHandle(buf, head, size)
    if arr.dim() != buf.dim() or arr.dtype != buf.dtype or \
            tuple(arr.shape[1:]) != ring.elem:
        raise ValueError(
            f"ring_push: arr {arr.dtype}{tuple(arr.shape)} does not match "
            f"ring elements {buf.dtype}{ring.elem}")
    ring.push(arr)
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
    lib = _build.bind("ring", _ARGTYPES)
    rc = lib.eval_guards(*(x.data_ptr() for x in args), fire.data_ptr(),
                         t, c, _build.stream(live))
    _launched(lib, "eval_guards", rc)
    return fire

"""Ring-buffer ops of the compiled interconnect: CUDA kernels + plain versions.

``CompiledEngine`` keeps every channel as a ring buffer ``buf[cap, *elem]``
on the device, with its head and size as int32 entries of two device
vectors; ``head``/``size`` arguments below are 0-d int32 tensors (views of
those entries).  The ops of the sweep loop:

* :func:`ring_pop` — pop ``n`` tokens from the head, advancing head and
  size in place;
* :func:`ring_push` — push ``arr[n, *elem]`` at the tail, writing ``buf``
  and advancing size in place;
* :class:`SweepGuards` / :func:`sweep_guards` — a sweep's control in one
  launch: every task's phase and fire predicate, the predicate of each
  (task, phase) body, the firing counters, the sweep count and the done
  flag; the head of the captured sweep (``core/synth.py``);
* :func:`eval_guards` — every task's fire predicate in one op, the
  counterpart of the reference's API;
* :class:`ServicePorts` (``service_ports``) — every ``async_mmap``
  port's latency queue, serviced once a sweep after the bodies, and the
  commit of a sweep of a graph with ports (its count and done flag).

Each has a hand-written CUDA kernel for Hopper (``csrc/ring.cu``, built at
first use by :mod:`._build`) and, beside it, a plain PyTorch version of
the same function.  A CUDA tensor launches the kernel; a CPU or meta
tensor takes the plain version (:mod:`.dispatch`).  All are exact
integer/copy ops, so kernel and plain version agree bit for bit, and both
agree with the reference package's ``ring_pop``/``ring_push``/
``eval_guards`` (``src/repro/kernels/ring.py``).

A caller that pops and pushes one ring many times (the sweep loop's
stream views) prepares a :class:`RingHandle` once: it holds everything
that depends only on the ring, so an op on the card is the output (pop),
one ctypes call of three plain arguments and nothing else.
:func:`ring_pop`/:func:`ring_push` build a handle per call.

``ring_pop``, ``ring_push``, ``sweep_guards`` and ``service_ports`` count
their launches on the card (:data:`DEVICE_COUNTED`): each launch adds one
to a counter in the library's device memory, also where a replayed CUDA
graph launches it, and :func:`.dispatch.launch_counts` reads the
counters.

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
* ``sweep_guards`` replaces ``_guard_kernel`` (``ring.py:200``) on the
  sweep loop's path, redesigned as the sweep's device-side head: it also
  does the control the eager loop did on the host between sweeps, so a
  sweep is one captured program.  Bound by the launch (a few KiB of
  sparse tables: per (task, phase) only the channels it touches); one
  block, one thread a task, at most :data:`MAX_SWEEP_TASKS` tasks.
* ``eval_guards`` replaces ``_guard_kernel`` for the reference's API.
  Bound by the launch at every size the port runs (``T*C`` int32
  compares, a few tens of KiB); one warp per task row, ``__all_sync`` over
  the channels.
* ``service_ports`` has no Pallas counterpart: it is the reference's
  per-sweep ``_service_ports`` (``src/repro/core/synth.py:951``, XLA ops
  in the reference's loop body), moved onto the card so that a sweep of a
  graph with ports stays one captured program.  Bound by bytes: the rows
  it copies (256 KiB each on gemm's ports, 8 B on page_rank's).  One
  cluster a port (ports touch disjoint rings); every block's thread 0
  makes the port's chain of decisions, the cluster copies the rows; the
  block that finishes last commits the sweep.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .dispatch import add_device_counters, count_launch, uses_kernel

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    # the ring's _RingLaunch by reference, the flat rows, burst_arg(n):
    # three arguments, as ctypes converts each one on every call
    "ring_pop": [_VP, _VP, ctypes.c_longlong],
    "ring_push": [_VP, _VP, ctypes.c_longlong],
    "eval_guards": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "sweep_guards": [_VP],          # the program's _SweepLaunch by reference
    "service_ports": [_VP],         # the program's _ServiceLaunch
    "sweep_graph_create": [_VP, _VP, _VP, _INT, _VP, _VP, _VP],
    "sweep_graph_replay": [_VP, _VP, _INT],
    "sweep_graph_destroy": [_VP],
    "sweep_graph_nodes": [_VP],
    "ring_launch_counters": [_VP],
}
# csrc/ring.cu: kCopyThreads threads a block, each moving kUnroll 16-byte
# words a pass, and clusters of at most kMaxCluster blocks (the portable
# limit)
COPY_THREADS, UNROLL, MAX_CLUSTER = 512, 4, 8
BLOCK_BYTES = COPY_THREADS * UNROLL * 16        # 32 KiB: one block's pass
# the kernels that count their own launches on the card, in the order of
# csrc/ring.cu's ring_launches
DEVICE_COUNTED = ("ring_pop", "ring_push", "sweep_guards", "service_ports")
_counted: set = set()       # devices whose counters dispatch reads
# csrc/ring.cu: sweep_guards runs one block of one thread a task, for
# tasks of at most 4 phases, with the occupancy vector in 48 KiB of shared
# memory
MAX_SWEEP_TASKS, MAX_SWEEP_PHASES, MAX_SWEEP_CHANNELS = 1024, 4, 12288
# csrc/ring.cu: a port's counters (the reference's port carry, PortQueue.st)
# and its largest in-flight window
(P_RHEAD, P_RSIZE, P_WHEAD, P_WSIZE, P_ACC_R, P_DEL_R, P_ACC_W, P_DEL_W,
 P_MAX_R, P_MAX_W) = range(10)
PORT_WORDS, MAX_PORT_DEPTH = 10, 64


def _launched(lib: ctypes.CDLL, op: str, rc: int) -> None:
    _build.check(lib, "ring", op, rc)
    count_launch(op)


class _DeviceWords:
    """``n`` int64 words at a device address, as ``torch.as_tensor`` takes
    them (``__cuda_array_interface__``, no copy)."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = dict(
            shape=(n,), typestr="<i8", data=(ptr, False), version=3)


def _ring_lib(dev: int) -> ctypes.CDLL:
    """The ring library, bound; the first call on device ``dev`` also
    hands its launch counters there (``ring_launches``) to
    :func:`.dispatch.add_device_counters`."""
    lib = _build.bind("ring", _ARGTYPES)
    if dev not in _counted:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _build.check(lib, "ring", "ring_launch_counters",
                         lib.ring_launch_counters(ctypes.byref(ptr)))
            counters = torch.as_tensor(
                _DeviceWords(ptr.value, len(DEVICE_COUNTED)),
                device=f"cuda:{dev}")
        add_device_counters(DEVICE_COUNTED, counters)
        _counted.add(dev)
    return lib


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

    Each pop on the card allocates its output with ``torch.empty``: a new
    tensor that no ring and no other token shares.  Under a CUDA-graph
    capture (the captured sweep's bodies) it comes from the graph's
    memory pool, which the graph owns for its life.
    """

    __slots__ = ("buf", "head", "size", "cap", "elem", "row_bytes",
                 "_dtype", "_device", "_dev", "_kernel", "_lib", "_launch",
                 "_ref", "_stream", "_st", "_pop_fn", "_push_fn", "_bursts")

    def __init__(self, buf: torch.Tensor, head: torch.Tensor,
                 size: torch.Tensor):
        a = ring_args(buf, head, size)
        self.buf, self.head, self.size = buf, head, size
        self.cap, self.elem, self.row_bytes = a.cap, a.elem, a.row_bytes
        self._dtype, self._device = buf.dtype, buf.device
        self._dev = buf.get_device()
        self._kernel = uses_kernel("ring", buf, head, size)
        self._bursts: dict = {}     # n -> burst_arg(n), for n in [1, cap]
        if self._kernel:
            self._lib = _ring_lib(self._dev)
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
        if not self._kernel:
            self._check_n("ring_pop", n)
            toks = ring_pop_plain(self.buf, self.head, self.size, n)[0]
            return toks[0] if _one else toks
        burst = self._bursts.get(n)
        if burst is None:
            burst = self._burst("ring_pop", n)
        out = torch.empty(self.elem if _one else (n, *self.elem),
                          dtype=self._dtype, device=self._device)
        if not burst:
            return out
        st = self._stream()
        if st != self._st:
            self._launch.stream = self._st = st
        rc = self._pop_fn(self._ref, out.data_ptr(), burst)
        if rc:
            _build.check(self._lib, "ring", "ring_pop", rc)
        return out

    def pop_one(self) -> torch.Tensor:
        """Pop one token: a new ``elem``-shaped tensor."""
        return self.pop(1, True)

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


# ---------------------------------------------------------------------------
# a sweep's control: the captured sweep's head
# ---------------------------------------------------------------------------

class _SweepLaunch(ctypes.Structure):
    """``csrc/ring.cu``'s ``struct SweepLaunch``: one program's tables,
    carry and outputs, and the stream of its last launch."""
    _fields_ = [("totals", _VP), ("bounds", _VP), ("row_ptr", _VP),
                ("entries", _VP), ("sizes", _VP), ("fires", _VP),
                ("state", _VP), ("run", _VP), ("fire", _VP), ("phase", _VP),
                ("flags", _VP), ("handles", _VP), ("stream", _VP),
                ("T", _INT), ("P", _INT), ("C", _INT)]


def sparse_needs(need_r, need_w, caps) -> tuple:
    """The sparse need tables of :func:`sweep_guards` from dense numpy
    ``need_r``/``need_w[T, P, C]`` and ``caps[C]``: ``row_ptr[T*P + 1]``
    and ``entries[nnz, 4]`` (int32), row ``t*P + p`` holding one entry
    ``(channel, need_r, need_w, cap)`` per channel that phase ``p`` of task
    ``t`` reads or writes, in channel order.  A channel a phase does not
    touch needs nothing, so it drops out of the guard."""
    import numpy as np
    n_tasks, n_ph, _ = need_r.shape
    t, p, c = np.nonzero((need_r != 0) | (need_w != 0))
    row_ptr = np.zeros(n_tasks * n_ph + 1, np.int32)
    np.cumsum(np.bincount(t * n_ph + p, minlength=n_tasks * n_ph),
              out=row_ptr[1:])
    entries = np.stack([c, need_r[t, p, c], need_w[t, p, c],
                        np.asarray(caps, np.int64)[c]], axis=1)
    return row_ptr, entries.astype(np.int32).reshape(-1, 4)


def sweep_guards_plain(totals, bounds, row_ptr, entries, sizes, fires,
                       state, run, fire, phase, flags=None) -> None:
    """Plain version of :func:`sweep_guards` (CPU tensors; on the card,
    the comparison's)."""
    n_tasks, n_ph = run.shape
    dev = fires.device
    ph = (fires[:, None] >= bounds).sum(1, dtype=torch.int32)
    done = state[0] != 0
    live = (fires < totals) & ~done
    owner = torch.repeat_interleave(
        torch.arange(n_tasks * n_ph, device=dev), row_ptr.diff().long())
    s = sizes[entries[:, 0].long()]
    short = (entries[:, 1] > s) | (entries[:, 2] > entries[:, 3] - s)
    unmet = torch.zeros(n_tasks * n_ph, dtype=torch.int32, device=dev) \
        .index_add_(0, owner, short.int())
    ok = live & (unmet.view(n_tasks, n_ph)
                 .gather(1, ph.long()[:, None])[:, 0] == 0)
    any_live, any_fire = live.any(), ok.any()
    fires.add_(ok.int())
    any_left = (fires < totals).any()
    if flags is not None:
        flags.copy_(torch.stack([any_fire, any_left]).int())
    else:
        over = done | ~any_live | ~any_fire | ~any_left
        state[1:].add_(any_live.int())
        state[:1].copy_(over.int())
    fire.copy_(ok)
    phase.copy_(ph)
    run.copy_(ok[:, None] & (torch.arange(n_ph, device=dev) == ph[:, None]))


class SweepGuards:
    """One program's sweep-control launch, prepared once.

    Calling it runs one sweep's control (``csrc/ring.cu``,
    ``sweep_guards_kernel``), from the static tables ``totals[T]``,
    ``bounds[T, P-1]`` (cumulative phase bounds, padded with int32-max),
    ``row_ptr``/``entries`` (:func:`sparse_needs`) and the carry
    ``sizes[C]``, ``fires[T]`` and ``state[2]`` (done, sweeps):

    * ``phase[t]`` = the bounds ``fires[t]`` has passed;
    * ``fire[t]`` = ``fires[t] < totals[t]`` and, for every entry of row
      ``(t, phase[t])``, ``need_r <= sizes[c]`` and ``need_w <= cap -
      sizes[c]``; ``run[t, p]`` = ``fire[t]`` and ``p == phase[t]``;
    * ``fires += fire``; the sweep is counted (``state[1] += 1``) unless no
      task was live, and ``state[0]`` (done) is set when no task was live,
      none fired or none has firings left;
    * once done is set, every predicate is false and nothing else changes;
    * given ``flags`` (int32 ``[2]``, a graph with async ports) it writes
      any(fire) and any(firings left) there and leaves ``state`` to
      :class:`ServicePorts`, which commits the sweep after the bodies.

    int32 tables and carry, bool ``run``/``fire``, int32 ``phase``, all
    contiguous on one device.  A CUDA program launches the kernel (one
    block: at most :data:`MAX_SWEEP_TASKS` tasks of
    :data:`MAX_SWEEP_PHASES` phases over :data:`MAX_SWEEP_CHANNELS`
    channels); a CPU one takes :func:`sweep_guards_plain`.
    """

    __slots__ = ("args", "flags", "_kernel", "_fn", "_lib", "_launch",
                 "_ref", "_stream", "_st")

    def __init__(self, totals, bounds, row_ptr, entries, sizes, fires, state,
                 run, fire, phase, flags=None):
        n_tasks, n_ph = run.shape
        self.args = (totals, bounds, row_ptr, entries, sizes, fires, state,
                     run, fire, phase)
        self.flags = flags
        i32, b = torch.int32, torch.bool
        if flags is not None and (flags.dtype != i32 or tuple(flags.shape)
                                  != (2,) or not flags.is_contiguous()):
            raise ValueError(f"sweep_guards: flags must be a contiguous "
                             f"{i32}(2,), got {flags.dtype}"
                             f"{tuple(flags.shape)}")
        for name, x, dt, shape in (
                ("totals", totals, i32, (n_tasks,)),
                ("bounds", bounds, i32, (n_tasks, n_ph - 1)),
                ("row_ptr", row_ptr, i32, (n_tasks * n_ph + 1,)),
                ("entries", entries, i32, (entries.shape[0], 4)),
                ("sizes", sizes, i32, (sizes.shape[0],)),
                ("fires", fires, i32, (n_tasks,)),
                ("state", state, i32, (2,)), ("run", run, b, (n_tasks, n_ph)),
                ("fire", fire, b, (n_tasks,)), ("phase", phase, i32,
                                                (n_tasks,))):
            if x.dtype != dt or tuple(x.shape) != shape or \
                    not x.is_contiguous():
                raise ValueError(f"sweep_guards: {name} must be a contiguous "
                                 f"{dt}{shape}, got {x.dtype}"
                                 f"{tuple(x.shape)}")
        self._kernel = uses_kernel(
            "sweep_guards", *self.args, *([flags] if flags is not None
                                          else []))
        if not self._kernel:
            return
        n_chans = sizes.shape[0]
        if not (1 <= n_tasks <= MAX_SWEEP_TASKS and n_ph <= MAX_SWEEP_PHASES
                and n_chans <= MAX_SWEEP_CHANNELS):
            raise ValueError(
                f"sweep_guards: {n_tasks} tasks of {n_ph} phases over "
                f"{n_chans} channels; the kernel runs one block of one "
                f"thread a task, at most {MAX_SWEEP_TASKS} tasks of "
                f"{MAX_SWEEP_PHASES} phases over {MAX_SWEEP_CHANNELS} "
                f"channels")
        dev = fires.get_device()
        self._lib = _ring_lib(dev)
        self._fn = self._lib.sweep_guards
        self._stream = functools.partial(torch._C._cuda_getCurrentRawStream,
                                         dev)
        self._st = self._stream()
        self._launch = _SweepLaunch(
            *(x.data_ptr() for x in self.args),
            None if flags is None else flags.data_ptr(), None, self._st,
            n_tasks, n_ph, n_chans)
        self._ref = ctypes.addressof(self._launch)

    def __call__(self) -> None:
        if not self._kernel:
            sweep_guards_plain(*self.args, flags=self.flags)
            return
        st = self._stream()
        if st != self._st:
            self._launch.stream = self._st = st
        rc = self._fn(self._ref)
        if rc:
            _build.check(self._lib, "ring", "sweep_guards", rc)


def sweep_guards(totals, bounds, row_ptr, entries, sizes, fires, state, run,
                 fire, phase, flags=None) -> None:
    """One sweep's control in one op, in place: :class:`SweepGuards` built
    for the call."""
    SweepGuards(totals, bounds, row_ptr, entries, sizes, fires, state, run,
                fire, phase, flags)()


class SweepGraph:
    """A sweep on the card as one CUDA graph, instantiated once
    (``csrc/ring.cu``, ``sweep_graph_create``): the ``sweep_guards`` kernel
    of ``guards``, then one conditional node for each (task, phase) body,
    in the order given, whose body is that body's captured graph, then,
    given ``tail`` (a captured ``cudaGraph_t``: a graph with async ports'
    :class:`ServicePorts` launch), that graph unconditionally.  The kernel
    sets the condition of the phase that fires; a launch resets every
    condition to false.  ``bodies`` is ``[(row, cudaGraph_t)]`` with
    ``row = t * P + p``; the caller keeps each body graph, the tail and
    their memory for the life of this one.  ``nodes``: the graph's
    top-level nodes (the guards, one a body that holds any node, the
    tail)."""

    def __init__(self, guards: SweepGuards, bodies: list, tail=None):
        if not guards._kernel:
            raise ValueError("SweepGraph: the guards of a program on the card")
        self._lib = guards._lib
        run = guards.args[7]
        n = len(bodies)
        self._handles = torch.zeros(run.numel(), dtype=torch.int64,
                                    device=run.device)
        rows = (ctypes.c_int * n)(*(r for r, _ in bodies))
        graphs = (ctypes.c_void_p * n)(*(g for _, g in bodies))
        out = ctypes.c_void_p()
        rc = self._lib.sweep_graph_create(guards._ref, rows, graphs, n, tail,
                                          self._handles.data_ptr(),
                                          ctypes.byref(out))
        _build.check(self._lib, "ring", "sweep_graph_create", rc)
        self._graph = out.value
        self.nodes = self._lib.sweep_graph_nodes(self._graph)
        self._stream = guards._stream

    def replay(self, k: int) -> None:
        """``k`` sweeps back to back on the current stream."""
        rc = self._lib.sweep_graph_replay(self._graph, self._stream(), k)
        if rc:
            _build.check(self._lib, "ring", "sweep_graph_replay", rc)

    def close(self) -> None:
        if self._graph:
            graph, self._graph = self._graph, None
            _build.check(self._lib, "ring", "sweep_graph_destroy",
                         self._lib.sweep_graph_destroy(graph))


# ---------------------------------------------------------------------------
# async_mmap ports: the latency queues' service step and the sweep's commit
# ---------------------------------------------------------------------------

class PortQueue:
    """One ``async_mmap`` port's latency queue on a device, as the
    reference's port carry (``_port_carry0``, ``src/repro/core/synth.py``)
    holds it: the port's buffer ``data[nrow, *row]``; the read and write
    windows ``win[4, depth]`` (read address, read due, write address, write
    due) and the write window's values ``wval[depth, *row]``; the counters
    ``st[10]`` (``P_RHEAD`` .. ``P_MAX_W``: each window's head and size, the
    accepted and delivered reads and writes, and each window's highwater
    mark).  ``chans`` are the channel indices of its five rings (read_addr,
    read_data, write_addr, write_data, write_resp): int32 addresses, rows
    of ``data``, int32 addresses, rows, bools.  ``win``, ``wval`` and ``st``
    start at zero (``st`` may be a row of a larger tensor)."""

    __slots__ = ("data", "win", "wval", "st", "chans", "depth", "latency")

    def __init__(self, data: torch.Tensor, st: torch.Tensor, chans: tuple,
                 depth: int, latency: int):
        self.data, self.st, self.chans = data, st, tuple(chans)
        self.depth, self.latency = int(depth), int(latency)
        self.win = torch.zeros((4, self.depth), dtype=torch.int32,
                               device=data.device)
        self.wval = torch.zeros((self.depth, *data.shape[1:]),
                                dtype=data.dtype, device=data.device)


def _service_one(q: PortQueue, bufs, hs: list, ss: list,
                 sweeps: int) -> tuple:
    """The reference's ``_service_ports`` for one port, step for step, on
    host ints (``hs``/``ss``: every channel's head and size, updated in
    place) and row copies.  Returns (moved, waiting, pending)."""
    d, lat, nrow = q.depth, q.latency, q.data.shape[0]
    ra, rd, wa, wd, wr = q.chans
    cap = {c: bufs[c].shape[0] for c in q.chans}
    st = q.st.tolist()
    r_addr, r_due, w_addr, w_due = q.win.tolist()
    moved = False
    # 1. deliver due reads, FIFO, while read_data has room
    while st[P_RSIZE] > 0 and r_due[st[P_RHEAD]] <= sweeps and \
            ss[rd] < cap[rd]:
        addr = min(max(r_addr[st[P_RHEAD]], 0), nrow - 1)
        bufs[rd][(hs[rd] + ss[rd]) % cap[rd]] = q.data[addr]
        ss[rd] += 1
        st[P_RHEAD] = (st[P_RHEAD] + 1) % d
        st[P_RSIZE] -= 1
        st[P_DEL_R] += 1
        moved = True
    # 2. deliver due writes, FIFO, while write_resp has room
    while st[P_WSIZE] > 0 and w_due[st[P_WHEAD]] <= sweeps and \
            ss[wr] < cap[wr]:
        addr = min(max(w_addr[st[P_WHEAD]], 0), nrow - 1)
        q.data[addr] = q.wval[st[P_WHEAD]]
        bufs[wr][(hs[wr] + ss[wr]) % cap[wr]] = True
        ss[wr] += 1
        st[P_WHEAD] = (st[P_WHEAD] + 1) % d
        st[P_WSIZE] -= 1
        st[P_DEL_W] += 1
        moved = True
    # 3. accept queued reads into the read window
    if ss[ra] > 0 and st[P_RSIZE] < d:
        toks = bufs[ra].tolist()
        while ss[ra] > 0 and st[P_RSIZE] < d:
            slot = (st[P_RHEAD] + st[P_RSIZE]) % d
            r_addr[slot], r_due[slot] = toks[hs[ra]], sweeps + lat
            hs[ra] = (hs[ra] + 1) % cap[ra]
            ss[ra] -= 1
            st[P_RSIZE] += 1
            st[P_ACC_R] += 1
            moved = True
    st[P_MAX_R] = max(st[P_MAX_R], st[P_RSIZE])
    # 4. accept queued writes: an address and a value token each
    if ss[wa] > 0 and ss[wd] > 0 and st[P_WSIZE] < d:
        toks = bufs[wa].tolist()
        while ss[wa] > 0 and ss[wd] > 0 and st[P_WSIZE] < d:
            slot = (st[P_WHEAD] + st[P_WSIZE]) % d
            w_addr[slot], w_due[slot] = toks[hs[wa]], sweeps + lat
            q.wval[slot] = bufs[wd][hs[wd]]
            hs[wa] = (hs[wa] + 1) % cap[wa]
            ss[wa] -= 1
            hs[wd] = (hs[wd] + 1) % cap[wd]
            ss[wd] -= 1
            st[P_WSIZE] += 1
            st[P_ACC_W] += 1
            moved = True
    st[P_MAX_W] = max(st[P_MAX_W], st[P_WSIZE])
    # 5. an in-flight request due after this sweep keeps the run going
    waiting = any(r_due[(st[P_RHEAD] + i) % d] > sweeps
                  for i in range(st[P_RSIZE])) or \
        any(w_due[(st[P_WHEAD] + i) % d] > sweeps
            for i in range(st[P_WSIZE]))
    dev = q.st.device
    q.st.copy_(torch.tensor(st, dtype=torch.int32, device=dev))
    q.win.copy_(torch.tensor([r_addr, r_due, w_addr, w_due],
                             dtype=torch.int32, device=dev))
    return moved, waiting, st[P_RSIZE] > 0 or st[P_WSIZE] > 0


def service_ports_plain(ports: list, bufs, heads, sizes, maxocc, state,
                        flags) -> None:
    """Plain version of :func:`service_ports` (CPU tensors; on the card,
    the comparison's).  ``bufs`` maps a channel index to its ring
    buffer."""
    done, sweeps = state.tolist()
    if done:
        return
    fired, left = flags.tolist()
    progress, work = bool(fired), bool(left)
    hs, ss = heads.tolist(), sizes.tolist()
    for q in ports:
        moved, waiting, pending = _service_one(q, bufs, hs, ss, sweeps)
        progress |= moved or waiting
        work |= pending
    i32 = dict(dtype=torch.int32, device=heads.device)
    heads.copy_(torch.tensor(hs, **i32))
    sizes.copy_(torch.tensor(ss, **i32))
    torch.maximum(maxocc, sizes, out=maxocc)
    state.copy_(torch.tensor([int(not (progress and work)), sweeps + 1],
                             **i32))


class _PortLaunch(ctypes.Structure):
    """``csrc/ring.cu``'s ``struct PortLaunch``: one port's queue."""
    _fields_ = [("data", _VP), ("wval", _VP), ("win", _VP), ("st", _VP),
                ("buf", _VP * 5), ("row_bytes", ctypes.c_longlong),
                ("nrow", _INT), ("depth", _INT), ("latency", _INT),
                ("word", _INT), ("chan", _INT * 5), ("cap", _INT * 5)]


class _ServiceLaunch(ctypes.Structure):
    """``csrc/ring.cu``'s ``struct ServiceLaunch``: one program's ports,
    carry and scratch, and the stream of its last launch."""
    _fields_ = [("ports", _VP), ("heads", _VP), ("sizes", _VP),
                ("maxocc", _VP), ("state", _VP), ("flags", _VP),
                ("scratch", _VP), ("stream", _VP), ("n", _INT), ("C", _INT),
                ("blocks", _INT)]


class ServicePorts:
    """One program's port service, prepared once.

    Calling it runs, unless the done flag ``state[0]`` is set, one service
    step of every port (:class:`PortQueue`) against the sweep counter
    ``state[1]`` as it stands before this sweep is counted, in the
    reference's order: deliver due reads in FIFO order while read_data has
    room (the address clipped to ``[0, nrow - 1]``), deliver due writes the
    same way (``True`` into write_resp), accept queued reads into free
    window slots (due ``sweeps + latency``), accept queued writes (an
    address and a value token each).  Then it commits the sweep: the
    highwater marks ``maxocc`` over every channel, ``state[1] += 1`` and
    ``state[0]`` = not (progress and work left), where progress is a task
    fired (``flags[0]``, from :class:`SweepGuards`), a request moved, or
    one is due after this sweep, and work left is a task with firings left
    (``flags[1]``) or a window that is not empty.  ``rings`` maps each
    channel index to its ring (:class:`RingHandle` or its buffer).

    A CUDA program launches the kernel (one cluster a port, windows of at
    most :data:`MAX_PORT_DEPTH`); a CPU one takes
    :func:`service_ports_plain`, at any depth.
    """

    __slots__ = ("ports", "bufs", "args", "_kernel", "_fn", "_lib", "_launch",
                 "_ref", "_stream", "_st", "_table", "scratch", "blocks")

    def __init__(self, ports: list, rings: dict, heads, sizes, maxocc, state,
                 flags):
        self.ports = list(ports)
        self.bufs = {ci: getattr(r, "buf", r) for ci, r in rings.items()}
        self.args = (heads, sizes, maxocc, state, flags)
        i32 = torch.int32
        n_chans = heads.shape[0]
        for name, x, n in (("heads", heads, n_chans),
                           ("sizes", sizes, n_chans),
                           ("maxocc", maxocc, n_chans), ("state", state, 2),
                           ("flags", flags, 2)):
            if x.dtype != i32 or tuple(x.shape) != (n,) or \
                    not x.is_contiguous():
                raise ValueError(f"service_ports: {name} must be a "
                                 f"contiguous {i32}({n},), got {x.dtype}"
                                 f"{tuple(x.shape)}")
        if not self.ports:
            raise ValueError("service_ports: a program with no ports")
        tensors = list(self.args)
        for q in self.ports:
            self._check(q, n_chans)
            tensors += [q.data, q.win, q.wval, q.st] + \
                [self.bufs[c] for c in q.chans]
        self._kernel = uses_kernel("service_ports", *tensors)
        if not self._kernel:
            return
        for q in self.ports:
            if q.depth > MAX_PORT_DEPTH:
                raise ValueError(f"service_ports: depth {q.depth} above the "
                                 f"kernel's {MAX_PORT_DEPTH}")
        dev = heads.get_device()
        self._lib = _ring_lib(dev)
        self._fn = self._lib.service_ports
        table = (_PortLaunch * len(self.ports))()
        rows = []
        for k, q in enumerate(self.ports):
            bufs = [self.bufs[c] for c in q.chans]
            rb = math.prod(q.data.shape[1:]) * q.data.element_size()
            rows.append(rb)
            table[k] = _PortLaunch(
                q.data.data_ptr(), q.wval.data_ptr(), q.win.data_ptr(),
                q.st.data_ptr(), (_VP * 5)(*(b.data_ptr() for b in bufs)),
                rb, q.data.shape[0], q.depth, q.latency,
                copy_word(rb, q.data.data_ptr(), q.wval.data_ptr(),
                          bufs[1].data_ptr(), bufs[3].data_ptr()),
                (_INT * 5)(*q.chans), (_INT * 5)(*(b.shape[0] for b in bufs)))
        self._table = torch.frombuffer(bytearray(table), dtype=torch.uint8) \
            .to(heads.device)
        self.scratch = torch.zeros(3, dtype=i32, device=heads.device)
        self.blocks = max(cluster_blocks(rb) for rb in rows)
        self._stream = functools.partial(torch._C._cuda_getCurrentRawStream,
                                         dev)
        self._st = self._stream()
        self._launch = _ServiceLaunch(
            self._table.data_ptr(), *(x.data_ptr() for x in self.args),
            self.scratch.data_ptr(), self._st, len(self.ports), n_chans,
            self.blocks)
        self._ref = ctypes.addressof(self._launch)

    def _check(self, q: PortQueue, n_chans: int) -> None:
        i32, b = torch.int32, torch.bool
        d, row = q.depth, tuple(q.data.shape[1:])
        if d < 1 or q.latency < 0:
            raise ValueError(f"service_ports: depth {d} < 1 or latency "
                             f"{q.latency} < 0")
        if q.data.dim() < 1 or q.data.shape[0] < 1 or \
                not q.data.is_contiguous():
            raise ValueError(f"service_ports: a port's buffer must be a "
                             f"contiguous [nrow >= 1, *row], got "
                             f"{tuple(q.data.shape)}")
        if not all(0 <= c < n_chans for c in q.chans) or \
                len(set(q.chans)) != 5:
            raise ValueError(f"service_ports: channels {q.chans} are not five "
                             f"distinct channels of {n_chans}")
        want = [(i32, ()), (q.data.dtype, row), (i32, ()),
                (q.data.dtype, row), (b, ())]
        for c, (dt, elem) in zip(q.chans, want):
            x = self.bufs[c]
            if x.dtype != dt or tuple(x.shape[1:]) != elem or \
                    not x.is_contiguous():
                raise ValueError(f"service_ports: ring {c} must be a "
                                 f"contiguous [cap, *{elem}] of {dt}, got "
                                 f"{x.dtype}{tuple(x.shape)}")
        for name, x, dt, shape in (("win", q.win, i32, (4, d)),
                                   ("wval", q.wval, q.data.dtype, (d, *row)),
                                   ("st", q.st, i32, (PORT_WORDS,))):
            if x.dtype != dt or tuple(x.shape) != shape or \
                    not x.is_contiguous():
                raise ValueError(f"service_ports: {name} must be a "
                                 f"contiguous {dt}{shape}, got {x.dtype}"
                                 f"{tuple(x.shape)}")

    def __call__(self) -> None:
        if not self._kernel:
            service_ports_plain(self.ports, self.bufs, *self.args)
            return
        st = self._stream()
        if st != self._st:
            self._launch.stream = self._st = st
        rc = self._fn(self._ref)
        if rc:
            _build.check(self._lib, "ring", "service_ports", rc)


"""Whole-graph synthesis on the card: lower a task graph to device ring
buffers and guarded steps, and run it on one CUDA device.

The paper's two-sided contract (Fig. 2) is *simulate for correctness,
synthesize for QoR*.  This module is the PyTorch counterpart of the
reference package's ``core/synth.py`` (single device):

* every :class:`~repro_torch.core.channel.Channel` becomes a fixed-capacity
  **ring buffer on the device** — ``buf[capacity, *elem_shape]`` plus its
  head and size, kept as entries of two device ``int32[C]`` vectors;
* every task becomes a **guarded step**: it fires only when its declared
  reads are available and its writes fit, mirroring the engines' blocking
  semantics exactly;
* bursts become ring transfers (:mod:`repro_torch.kernels.ring`: the
  ``ring_pop``/``ring_push`` kernels on a CUDA device);
* mmap buffers become device tensors, written back to the host buffers
  after the run;
* every bounded ``async_mmap`` port becomes a **latency queue** on the
  device: its five member streams are ordinary rings, and the queue is
  serviced once a sweep, after the task bodies
  (:class:`~repro_torch.kernels.ring.ServicePorts`).

The synthesizable subset is the **step-function form**: a leaf task is a
:class:`StepTask` whose phases are functions ``state, *port_views ->
state`` on tensors with *static* I/O rates.  Calling a StepTask is its
**simulation twin**: the Python engines run the same phase functions
against real blocking streams, so one graph definition is both the
correctness vehicle and the synthesized program, bit for bit on one
device.

The program is a sweep loop (:class:`_SweepProgram`).  A sweep is one
launch of the ``sweep_guards`` kernel — every task's phase and guard, the
predicate of each (task, phase) body, the firing counters, the sweep
count and the done flag, all on the device — followed by every (task,
phase) body in task order behind its predicate.  On the card the sweep is
captured once as a CUDA graph whose bodies sit in conditional nodes, and
the host replays it in blocks (:data:`SWEEP_BLOCKS`), reading the done
flag once a block; on the CPU the same sweep runs with Python branches.
A sweep that fires nothing ends the run as a stall.

Rates and refusals come from a **counting pass**: one firing of every
phase on ``meta`` tensors, where the ring ops take their shape-only plain
path.  Anything outside the subset is *refused with a diagnostic naming
the task/channel* (:class:`~repro_torch.core.errors.SynthesisError`),
never miscompiled: non-step leaf tasks, channels without a declared
element spec, data-dependent I/O rates, wrong token shapes or dtypes,
reads or writes beyond capacity, unstable state specs, EoT-closing tasks,
mmaps both written and read across tasks, ``async_mmap`` ports with an
unbounded window (``depth=None``), ports both read and written, and
``read_pipelined`` in a phase body.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from .channel import Channel, IStream, OStream, np_dtype
from .context import clear_context, set_context
from .engines import ENGINES, EngineBase, SimReport
from .errors import (ChannelMisuse, DeadlockReport, GraphValidationError,
                     SynthesisError)
from .graph import extract_graph
from .interface import AsyncMMap, MMap
from .task import (AutoStream, TaskInstance, bind_streams,
                   builder_stack_depth, join_pending_builders)
from ..kernels.ring import (MAX_PORT_DEPTH, MAX_SWEEP_CHANNELS,
                            MAX_SWEEP_TASKS, P_ACC_R,
                            P_ACC_W, P_DEL_R, P_DEL_W, P_MAX_R, P_MAX_W,
                            PORT_WORDS, PortQueue, RingHandle, ServicePorts,
                            SweepGraph, SweepGuards, sparse_needs)

# JAX's canonicalization with 64-bit mode off, which the reference
# package's rings, mmaps and states carry
_CANON = {np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


def canon_dtype(dtype: Any) -> np.dtype:
    """The dtype a ring buffer, mmap or state carries on the device: the
    declared (numpy or torch) dtype canonicalized as the reference does
    (float64 -> float32, int64 -> int32; bool stays bool).  Element checks
    compare against THIS, so a float64 declaration is not misreported as
    the task's fault."""
    d = np_dtype(dtype)
    return _CANON.get(d, d)


def _torch_dtype(dtype: Any) -> torch.dtype:
    return torch.from_numpy(np.empty(0, canon_dtype(dtype))).dtype


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  With no CUDA device and no explicit choice it raises
    rather than carry on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the card "
                "by default — pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the leaves of a state pytree (tuples, lists, dicts;
    ``None`` is an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> list:
    """The leaves of a state pytree in a fixed order (dict entries by
    key), the order :func:`_tree_map` visits a tuple or list."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_canon(x: Any, device: Any = None) -> torch.Tensor:
    """One leaf as a tensor of canonical dtype.  ``device=None`` keeps a
    tensor where it is and puts anything else on the CPU."""
    if isinstance(x, torch.Tensor):
        dt = _torch_dtype(x.dtype)
        return x.to(device=x.device if device is None else device, dtype=dt)
    arr = np.asarray(x)
    arr = arr.astype(canon_dtype(arr.dtype), copy=False)
    return torch.tensor(arr, device="cpu" if device is None else device)


def _materialize_state(init: Any, device: Any = None) -> Any:
    """Canonicalize an initial-state pytree to fresh tensors — the same
    representation the twin and the compiled program both carry."""
    return _tree_map(lambda x: _as_canon(x, device).clone(), init)


def to_torch_state(tree: Any, device: Any) -> Any:
    """A reference-package state pytree or mmap array, given as numpy (or
    Python numbers), as the port's tensors on ``device``, with the
    canonical dtypes: float64 -> float32, int64 -> int32, bool stays
    bool.  The data always lands in fresh tensors."""
    return _materialize_state(tree, torch.device(device))


def _leaf_spec(x: Any) -> tuple:
    t = x if isinstance(x, torch.Tensor) else _as_canon(x)
    return tuple(t.shape), np_dtype(t.dtype)


def _meta_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _const_key(t: torch.Tensor) -> tuple:
    return str(t.dtype), tuple(t.shape), t.numpy().tobytes()


def _on_device(x: Any, ctx: "_Ctx", rec: Optional["_Recorder"],
               inst: TaskInstance) -> torch.Tensor:
    """``x`` — a token, a stored value or a returned state leaf — as a
    tensor on the program's device (``ctx.device``).  A tensor already
    there is returned as it is.  A number, an array or a CPU tensor is a
    host constant of the phase: the counting pass (``rec``) records it,
    and the sweep takes the copy the program put on the device before the
    sweep was captured (a copy from host memory cannot be captured).  A
    host value the counting pass did not see depends on data, which
    synthesis cannot lower."""
    if rec is None and isinstance(x, torch.Tensor) and \
            x.get_device() == ctx.dev:
        return x
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return x.to(ctx.device)
        host = x
    else:
        host = _as_canon(x)
    key = _const_key(host)
    if rec is not None:
        rec.consts[key] = host
        return host.to(ctx.device)
    t = ctx.consts.get(key)
    if t is None:
        raise SynthesisError(
            f"task {inst.name!r} used a host value {host.dtype}"
            f"{tuple(host.shape)} that its counting pass never saw: a "
            f"value computed on the host from data cannot be synthesized; "
            f"compute it on the device")
    return t


def dynamic_slice(x: torch.Tensor, start: Any, n: int,
                  dim: int = 0) -> torch.Tensor:
    """``x`` sliced to ``n`` entries from ``start`` along ``dim``, with
    ``start`` clamped so the slice fits (as ``lax.dynamic_slice`` does).
    A tensor ``start`` stays on the device: the slice is an
    ``index_select`` and nothing is read back to the host."""
    size = x.shape[dim]
    if not 0 <= n <= size:
        raise ValueError(f"dynamic_slice of {n} from a dim of size {size}")
    if isinstance(start, torch.Tensor):
        start = start.to(x.device).clamp(0, size - n).to(torch.int64)
        idx = start + torch.arange(n, dtype=torch.int64, device=x.device)
        return x.index_select(dim, idx)
    start = min(max(int(start), 0), size - n)
    return x.narrow(dim, start, n).clone()


# ---------------------------------------------------------------------------
# the step-function task form
# ---------------------------------------------------------------------------

class StepTask:
    """A leaf task in step-function form.

    Up to three phases, each a function ``state, *ports -> state`` on
    tensors with static per-firing I/O rates:

    * ``warmup`` — fires ``n_warmup`` times (pipeline fill: e.g. read the
      first stencil row without emitting);
    * ``step``   — the steady state, fires ``steps`` times;
    * ``flush``  — fires ``n_flush`` times (drain: e.g. emit the
      accumulated result block).

    ``init`` is the initial state pytree.  Ports are the invoke arguments:
    channels appear as stream views (``read``/``read_burst``/``write``/
    ``write_burst`` only — no EoT, no peek: termination is by firing
    count), mmaps as memory views, scalars as plain values.  A phase must
    create any new tensor on the device of its inputs (``x.device``): the
    counting pass runs it on ``meta`` tensors.

    Calling a StepTask *is* its simulation twin: the classic engines
    invoke it like any task body, and it runs the phase functions against
    the real blocking streams.  ``CompiledEngine`` instead runs every
    firing as a guarded step of the sweep loop.
    """

    is_step_task = True

    def __init__(self, step: Callable, *, steps: int, init: Any = None,
                 warmup: Optional[Callable] = None, n_warmup: int = 1,
                 flush: Optional[Callable] = None, n_flush: int = 1,
                 close_outputs: bool = False, name: Optional[str] = None):
        if not isinstance(steps, int) or steps < 0:
            raise ValueError("StepTask steps must be a static int >= 0")
        self.step = step
        self.steps = steps
        self.init = init
        self.warmup = warmup
        self.n_warmup = int(n_warmup) if warmup is not None else 0
        self.flush = flush
        self.n_flush = int(n_flush) if flush is not None else 0
        # interop with EoT-consuming free-form tasks: the twin closes every
        # written stream after its last firing.  EoT is outside the
        # synthesizable subset, so synthesis refuses such tasks.
        self.close_outputs = close_outputs
        self.__name__ = name or getattr(step, "__name__", "step_task")
        try:
            sig = inspect.signature(step)
            params = list(sig.parameters.values())[1:]   # drop ``state``
            self.__signature__ = sig.replace(parameters=params)
        except (TypeError, ValueError):
            pass

    def phases(self) -> list[tuple[str, Callable, int]]:
        out = []
        if self.warmup is not None and self.n_warmup:
            out.append(("warmup", self.warmup, self.n_warmup))
        if self.steps:
            out.append(("step", self.step, self.steps))
        if self.flush is not None and self.n_flush:
            out.append(("flush", self.flush, self.n_flush))
        return out

    @property
    def total_fires(self) -> int:
        return sum(n for _, _, n in self.phases())

    # -- simulation twin -----------------------------------------------------
    def __call__(self, *args, **kwargs):
        streams: list[_TwinStream] = []
        views = tuple(_twin_view(a, streams) for a in args)
        kw = {k: _twin_view(v, streams) for k, v in kwargs.items()}
        state = _materialize_state(self.init)
        for _, fn, n in self.phases():
            for _ in range(n):
                state = fn(state, *views, **kw)
        if self.close_outputs:
            for s in streams:
                # close written streams, and annotated output ports even
                # when this instance never fired (an empty schedule must
                # still end its downstream consumer's transaction)
                if s._wrote or isinstance(s._s, OStream):
                    s._s.close()
        return state

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"StepTask({self.__name__!r}, "
                f"fires={self.total_fires})")


class _TwinStream:
    """Simulation-twin stream view: the synthesizable port API
    (``read``/``read_burst``/``write``/``write_burst``) over a real
    blocking stream.  Burst reads stack to a tensor so the phase function
    sees the exact value shape synthesis hands it."""

    __slots__ = ("_s", "_wrote")

    def __init__(self, s):
        self._s = s
        self._wrote = False

    def read(self):
        return self._s.read()

    def read_burst(self, n: int):
        toks = self._s.read_burst(n)
        if len(toks) != n:
            raise ChannelMisuse(
                f"step task read_burst({n}) hit EoT after {len(toks)} "
                f"tokens on channel {self._s.channel.name!r}; step graphs "
                f"terminate by firing counts, not EoT")
        return torch.stack([_as_canon(t) for t in toks])

    def write(self, tok) -> None:
        self._wrote = True
        self._s.write(tok)

    def write_burst(self, arr) -> None:
        self._wrote = True
        self._s.write_burst(list(arr))


def _twin_view(v: Any, streams: Optional[list] = None) -> Any:
    if isinstance(v, (IStream, OStream, AutoStream)):
        tw = _TwinStream(v)
        if streams is not None:
            streams.append(tw)
        return tw
    if isinstance(v, (list, tuple)):
        return type(v)(_twin_view(x, streams) for x in v)
    return v


# ---------------------------------------------------------------------------
# synthesis views (shared by the counting pass and the sweep loop)
# ---------------------------------------------------------------------------

class _Ctx:
    """The device (or meta) state a firing reads and updates in place:
    ``chans`` maps a channel index to its ring's :class:`RingHandle`,
    ``mmaps`` an mmap index to its tensor, ``consts`` a host constant's
    key to its copy on ``device`` (:func:`_on_device`)."""

    __slots__ = ("chans", "mmaps", "consts", "device", "dev")

    def __init__(self, chans: dict, mmaps: dict, device: Any,
                 consts: Optional[dict] = None):
        self.chans = chans
        self.mmaps = mmaps
        self.consts = consts if consts is not None else {}
        self.device = torch.device(device)
        self.dev = -1 if self.device.type != "cuda" else \
            self.device.index if self.device.index is not None else \
            torch.cuda.current_device()


class _Recorder:
    """Counting-pass sink: per-phase I/O rates + endpoint/direction
    registration.  Absent (None) in the sweep loop — the counts are
    already validated, and the sweep runs the same Python."""

    def __init__(self, inst: TaskInstance, label: str):
        self.inst = inst
        self.label = label
        self.reads: dict[int, int] = {}
        self.writes: dict[int, int] = {}
        self.mmap_loads: dict[int, int] = {}     # element counts
        self.mmap_stores: dict[int, int] = {}
        self.mmap_load_ops: dict[int, int] = {}  # transfer counts
        self.mmap_store_ops: dict[int, int] = {}
        self.consts: dict = {}      # host constants (_on_device)
        self.pops = 0               # ring ops of one firing that move
        self.pushes = 0             # tokens: one kernel launch each


class _SynthStream:
    """Stream view over a ring buffer; every op updates the ring in
    place through the ring's :class:`RingHandle`.

    The counting pass (``_rec`` set) checks every op: static burst sizes,
    element shape and dtype, rates within capacity.  The sweep loop runs
    the same Python on the same specs (the counting pass also pins the
    state spec), so there it only moves tokens; the handle still checks
    what the kernel's memory safety needs."""

    __slots__ = ("_ring", "_ci", "_chan", "_inst", "_rec", "_ctx")

    def __init__(self, ctx: _Ctx, ci: int, chan: Channel,
                 inst: TaskInstance, rec: Optional[_Recorder]):
        self._ring = ctx.chans[ci]
        self._ci = ci
        self._chan = chan
        self._inst = inst
        self._rec = rec
        self._ctx = ctx

    # -- reads ---------------------------------------------------------------
    def read(self):
        if self._rec is not None:
            self._account("read", 1)
        return self._ring.pop_one()

    def read_burst(self, n: int):
        if self._rec is not None:
            n = self._static(n, "read_burst")
            self._account("read", n)
        return self._ring.pop(n)

    # -- writes --------------------------------------------------------------
    def write(self, tok) -> None:
        tok = self._on_ring(tok)
        if self._rec is not None:
            self._check_elem(tok, burst=False)
            self._account("write", 1)
        self._ring.push(tok)

    def write_burst(self, arr) -> None:
        if isinstance(arr, (list, tuple)):
            arr = torch.stack([_as_canon(t) for t in arr])
        arr = self._on_ring(arr)
        if self._rec is not None:
            self._check_elem(arr, burst=True)
            self._account("write", int(arr.shape[0]))
        self._ring.push(arr)

    # -- everything else is outside the synthesizable subset -----------------
    def _unsupported(self, op: str):
        raise SynthesisError(
            f"task {self._inst.name!r} used stream op {op!r} on channel "
            f"{self._chan.name!r}: step-function tasks may only "
            f"read/read_burst/write/write_burst (termination is by firing "
            f"count, availability routing needs the simulation engines)")

    def close(self):
        self._unsupported("close")

    def peek(self):
        self._unsupported("peek")

    def eot(self):
        self._unsupported("eot")

    def open(self):
        self._unsupported("open")

    def empty(self):
        self._unsupported("empty")

    def full(self):
        self._unsupported("full")

    def try_read(self):
        self._unsupported("try_read")

    def try_write(self, v):
        self._unsupported("try_write")

    # -- helpers -------------------------------------------------------------
    def _on_ring(self, x: Any) -> torch.Tensor:
        """``x`` as a tensor on the ring's device (:func:`_on_device`)."""
        return _on_device(x, self._ctx, self._rec, self._inst)

    def _static(self, n: Any, op: str) -> int:
        if not isinstance(n, (int, np.integer)):
            raise SynthesisError(
                f"task {self._inst.name!r}: {op} size on channel "
                f"{self._chan.name!r} is data-dependent (a traced value); "
                f"synthesis needs static I/O rates")
        return int(n)

    def _check_elem(self, arr: torch.Tensor, burst: bool) -> None:
        c = self._chan
        got_shape = tuple(arr.shape[1:]) if burst else tuple(arr.shape)
        if got_shape != c.shape:
            raise SynthesisError(
                f"task {self._inst.name!r} wrote a token of shape "
                f"{got_shape} to channel {c.name!r} declaring element "
                f"shape {c.shape}")
        if np_dtype(arr.dtype) != canon_dtype(c.dtype):
            raise SynthesisError(
                f"task {self._inst.name!r} wrote a token of dtype "
                f"{np_dtype(arr.dtype)} to channel {c.name!r} declaring "
                f"element dtype {c.dtype} (canonicalized "
                f"{canon_dtype(c.dtype)})")

    def _account(self, op: str, n: int) -> None:
        rec = self._rec
        c = self._chan
        if op == "read":
            c._bind("consumer", self._inst)
            total = rec.reads[self._ci] = rec.reads.get(self._ci, 0) + n
            rec.pops += n > 0
            verb, prep = "reads", "from"
        else:
            c._bind("producer", self._inst)
            total = rec.writes[self._ci] = rec.writes.get(self._ci, 0) + n
            rec.pushes += n > 0
            verb, prep = "writes", "to"
        if total > c.capacity:
            raise SynthesisError(
                f"task {self._inst.name!r}: phase {rec.label!r} {verb} "
                f"{total} tokens per firing {prep} channel {c.name!r} of "
                f"capacity {c.capacity}; it could never fire")


class _SynthMMap:
    """Memory view: the MMap API over a device (or meta) tensor, updated
    in place.  Loads and stores may take tensor indices: a burst from a
    device-scalar ``start`` stays on the device."""

    __slots__ = ("_t", "_mi", "_mmap", "_inst", "_rec", "_ctx")

    def __init__(self, ctx: _Ctx, mi: int, mmap: MMap,
                 inst: TaskInstance, rec: Optional[_Recorder]):
        self._t = ctx.mmaps[mi]
        self._mi = mi
        self._mmap = mmap
        self._inst = inst
        self._rec = rec
        self._ctx = ctx

    @property
    def shape(self) -> tuple:
        return tuple(self._mmap.shape)

    @property
    def dtype(self):
        return self._t.dtype

    def __len__(self) -> int:
        return len(self._mmap)

    def __getitem__(self, idx):
        v = self._t[idx].clone()        # a copy, as MMap loads return
        self._account("read", v)
        return v

    def __setitem__(self, idx, value) -> None:
        value = _as_canon(_on_device(value, self._ctx, self._rec,
                                     self._inst))
        self._account("write", value)
        self._t[idx] = value

    def read_burst(self, start, n: int):
        if not isinstance(n, (int, np.integer)):
            raise SynthesisError(
                f"task {self._inst.name!r}: mmap {self._mmap.name!r} "
                f"read_burst size is data-dependent; synthesis needs a "
                f"static transfer size")
        out = dynamic_slice(self._t, start, int(n))
        self._account("read", out)
        return out

    def write_burst(self, start, seq) -> None:
        seq = _on_device(seq, self._ctx, self._rec, self._inst) \
            .to(self._t.dtype)
        self._account("write", seq)
        n, size = int(seq.shape[0]), self._t.shape[0]
        if isinstance(start, torch.Tensor):
            start = start.to(self._t.device).clamp(0, size - n)
            idx = start.to(torch.int64) + torch.arange(
                n, dtype=torch.int64, device=self._t.device)
            self._t.index_copy_(0, idx, seq)
        else:
            start = min(max(int(start), 0), size - n)
            self._t[start:start + n] = seq

    def _account(self, op: str, v: torch.Tensor) -> None:
        rec = self._rec
        if rec is None:
            return
        n = v.numel()
        if op == "read":
            rec.mmap_loads[self._mi] = rec.mmap_loads.get(self._mi, 0) + n
            rec.mmap_load_ops[self._mi] = \
                rec.mmap_load_ops.get(self._mi, 0) + 1
        else:
            rec.mmap_stores[self._mi] = rec.mmap_stores.get(self._mi, 0) + n
            rec.mmap_store_ops[self._mi] = \
                rec.mmap_store_ops.get(self._mi, 0) + 1
        b = self._mmap._by_inst.get(self._inst.uid)
        if b is not None:
            b.direction.add(op)


# ---------------------------------------------------------------------------
# lowering plan
# ---------------------------------------------------------------------------

class _ChanRef:
    __slots__ = ("ci",)

    def __init__(self, ci: int):
        self.ci = ci


class _MMapRef:
    __slots__ = ("mi",)

    def __init__(self, mi: int):
        self.mi = mi


class _PortRef:
    __slots__ = ("pi", "cis")

    def __init__(self, pi: int, cis: tuple):
        self.pi = pi
        self.cis = cis      # (raddr, rdata, waddr, wdata, wresp) chan ids


class _SynthAsyncPort:
    """Synthesis view of an async memory port: the five member streams
    are ordinary :class:`_SynthStream` views over their rings, so port I/O
    gets guards and static-rate counting as any stream does, while the
    memory side is the latency queue the sweep services once a sweep
    (:class:`_SweepProgram`)."""

    __slots__ = ("_port", "_inst", "read_addr", "read_data", "write_addr",
                 "write_data", "write_resp")

    def __init__(self, ctx: _Ctx, cis: tuple, port: AsyncMMap,
                 inst: TaskInstance, rec: Optional[_Recorder],
                 plan: "_Plan"):
        self._port = port
        self._inst = inst
        views = [_SynthStream(ctx, ci, plan.channels[ci], inst, rec)
                 for ci in cis]
        (self.read_addr, self.read_data, self.write_addr, self.write_data,
         self.write_resp) = views

    @property
    def shape(self) -> tuple:
        return tuple(self._port.shape)

    @property
    def dtype(self):
        return self._port.dtype

    @property
    def latency(self) -> int:
        return self._port.latency

    @property
    def depth(self):
        return self._port.depth

    @property
    def name(self) -> str:
        return self._port.name

    def __len__(self) -> int:
        return len(self._port)

    def read_pipelined(self, addrs):
        raise SynthesisError(
            f"task {self._inst.name!r} used read_pipelined on async_mmap "
            f"{self._port.name!r}: its issue/drain interleaving is "
            f"availability-routed (try_write/select), outside the static-"
            f"rate subset.  Software-pipeline it instead: issue addresses "
            f"with write/write_burst on read_addr and drain read_data with "
            f"read/read_burst across warmup/step/flush phases (see "
            f"docs/synthesis.md, kernel lowering)")


@dataclass
class _PhasePlan:
    label: str
    fn: Callable
    count: int
    reads: dict = field(default_factory=dict)    # ci -> tokens per firing
    writes: dict = field(default_factory=dict)
    mmap_loads: dict = field(default_factory=dict)    # mi -> elems/firing
    mmap_stores: dict = field(default_factory=dict)
    mmap_load_ops: dict = field(default_factory=dict)  # mi -> transfers
    mmap_store_ops: dict = field(default_factory=dict)
    pops: int = 0               # ring pops / pushes of one firing that move
    pushes: int = 0             # tokens (a kernel launch each on the card)


@dataclass
class _TaskPlan:
    inst: TaskInstance
    task: StepTask
    t_args: tuple = ()
    t_kwargs: dict = field(default_factory=dict)
    chan_ids: list = field(default_factory=list)
    mmap_ids: list = field(default_factory=list)
    phases: list = field(default_factory=list)   # [_PhasePlan]
    state0: Any = None

    @property
    def total(self) -> int:
        return sum(p.count for p in self.phases)

    @property
    def bounds(self) -> list[int]:
        out, acc = [], 0
        for p in self.phases:
            acc += p.count
            out.append(acc)
        return out


class _Plan:
    def __init__(self):
        self.channels: list[Channel] = []
        self._chan_idx: dict[int, int] = {}
        self.mmaps: list[MMap] = []
        self._mmap_idx: dict[int, int] = {}
        self.ports: list[AsyncMMap] = []
        self._port_idx: dict[int, int] = {}
        self.port_chan_ids: dict[int, tuple] = {}   # pi -> 5 member cis
        self.port_dirs: list[set] = []              # pi -> {"read","write"}
        self.tasks: list[_TaskPlan] = []
        self.consts: dict = {}      # the phases' host constants, on the CPU

    def chan_index(self, c: Channel) -> int:
        i = self._chan_idx.get(id(c))
        if i is None:
            i = self._chan_idx[id(c)] = len(self.channels)
            self.channels.append(c)
        return i

    def mmap_index(self, m: MMap) -> int:
        i = self._mmap_idx.get(id(m))
        if i is None:
            i = self._mmap_idx[id(m)] = len(self.mmaps)
            self.mmaps.append(m)
        return i

    def port_index(self, p: AsyncMMap) -> int:
        i = self._port_idx.get(id(p))
        if i is None:
            i = self._port_idx[id(p)] = len(self.ports)
            self.ports.append(p)
            self.port_dirs.append(set())
        return i


def _build_template(v: Any, plan: _Plan, tp: _TaskPlan) -> Any:
    """Replace bound stream/mmap views with plan references; everything
    else (scalars, None, raw tensors — constants of the step) passes
    through."""
    if isinstance(v, (IStream, OStream, AutoStream)):
        ci = plan.chan_index(v.channel)
        if ci not in tp.chan_ids:
            tp.chan_ids.append(ci)
        return _ChanRef(ci)
    if isinstance(v, MMap):
        mi = plan.mmap_index(v)
        if mi not in tp.mmap_ids:
            tp.mmap_ids.append(mi)
        return _MMapRef(mi)
    if isinstance(v, AsyncMMap):
        if not isinstance(v.depth, int):
            raise SynthesisError(
                f"task {tp.inst.name!r} binds async_mmap {v.name!r} with "
                f"an unbounded in-flight window (depth=None): synthesis "
                f"sizes the latency queue in the sweep's carry from a "
                f"static depth — give the port a bounded depth (e.g. "
                f"depth=4) or run on a simulation engine")
        pi = plan.port_index(v)
        cis = []
        for ch in v.channels():
            ci = plan.chan_index(ch)
            if ci not in tp.chan_ids:
                tp.chan_ids.append(ci)
            cis.append(ci)
        plan.port_chan_ids[pi] = tuple(cis)
        return _PortRef(pi, tuple(cis))
    if isinstance(v, (list, tuple)):
        conv = [_build_template(x, plan, tp) for x in v]
        return type(v)(conv) if isinstance(v, tuple) else conv
    return v


def _instantiate(t: Any, ctx: _Ctx, plan: _Plan, inst: TaskInstance,
                 rec: Optional[_Recorder]) -> Any:
    if isinstance(t, _ChanRef):
        return _SynthStream(ctx, t.ci, plan.channels[t.ci], inst, rec)
    if isinstance(t, _MMapRef):
        return _SynthMMap(ctx, t.mi, plan.mmaps[t.mi], inst, rec)
    if isinstance(t, _PortRef):
        return _SynthAsyncPort(ctx, t.cis, plan.ports[t.pi], inst, rec,
                               plan)
    if isinstance(t, (list, tuple)):
        conv = [_instantiate(x, ctx, plan, inst, rec) for x in t]
        return type(t)(conv) if isinstance(t, tuple) else conv
    return t


def _bind_views(plan: _Plan, tp: _TaskPlan, ctx: _Ctx,
                rec: Optional[_Recorder]) -> tuple[tuple, dict]:
    args = tuple(_instantiate(t, ctx, plan, tp.inst, rec)
                 for t in tp.t_args)
    kw = {k: _instantiate(t, ctx, plan, tp.inst, rec)
          for k, t in tp.t_kwargs.items()}
    return args, kw


def _meta_ctx(plan: _Plan, tp: _TaskPlan) -> _Ctx:
    chans = {}
    for ci in tp.chan_ids:
        c = plan.channels[ci]
        chans[ci] = RingHandle(
            torch.empty((c.capacity,) + c.shape, dtype=_torch_dtype(c.dtype),
                        device="meta"),
            torch.zeros((), dtype=torch.int32, device="meta"),
            torch.zeros((), dtype=torch.int32, device="meta"))
    mmaps = {mi: torch.empty(tuple(plan.mmaps[mi].shape),
                             dtype=_torch_dtype(plan.mmaps[mi].dtype),
                             device="meta")
             for mi in tp.mmap_ids}
    return _Ctx(chans, mmaps, "meta")


def _count_phase(plan: _Plan, tp: _TaskPlan, label: str, fn: Callable,
                 count: int) -> _PhasePlan:
    """One firing of ``fn`` on meta tensors: records the phase's I/O rates
    and refuses what synthesis cannot lower."""
    rec = _Recorder(tp.inst, label)
    ctx = _meta_ctx(plan, tp)
    args, kw = _bind_views(plan, tp, ctx, rec)
    state = _tree_map(_meta_like, tp.state0)
    try:
        out_state = fn(state, *args, **kw)
    except (SynthesisError, ChannelMisuse, GraphValidationError):
        raise
    except Exception as e:
        raise SynthesisError(
            f"task {tp.inst.name!r}: phase {label!r} failed to trace "
            f"({type(e).__name__}: {e}); step-function bodies must run on "
            f"meta tensors with static I/O rates") from e
    got = _tree_map(_leaf_spec, out_state)
    want = _tree_map(_leaf_spec, state)
    if got != want:
        raise SynthesisError(
            f"task {tp.inst.name!r}: phase {label!r} changed the state "
            f"spec from {want} to {got}; step state must be shape- and "
            f"dtype-stable across firings")
    for x in _leaves(out_state):        # host leaves are constants too
        _on_device(x, ctx, rec, tp.inst)
    plan.consts.update(rec.consts)
    return _PhasePlan(label=label, fn=fn, count=count, reads=rec.reads,
                      writes=rec.writes, mmap_loads=rec.mmap_loads,
                      mmap_stores=rec.mmap_stores,
                      mmap_load_ops=rec.mmap_load_ops,
                      mmap_store_ops=rec.mmap_store_ops, pops=rec.pops,
                      pushes=rec.pushes)


# ---------------------------------------------------------------------------
# the whole-graph program
# ---------------------------------------------------------------------------

def _guard_tables(plan: _Plan):
    """Static guard tables: per (task, phase) read/write token needs over
    every channel, and the cumulative phase bounds (padded with int32-max
    so shorter tasks never advance past their last phase).  Returns
    ``(need_r, need_w, bounds_or_None, n_ph_max)``."""
    n_tasks = len(plan.tasks)
    n_chans = len(plan.channels)
    n_ph_max = max((len(tp.phases) for tp in plan.tasks), default=1)
    need_r_np = np.zeros((n_tasks, n_ph_max, n_chans), np.int32)
    need_w_np = np.zeros_like(need_r_np)
    for ti, tp in enumerate(plan.tasks):
        for pi, ph in enumerate(tp.phases):
            for ci, r in ph.reads.items():
                need_r_np[ti, pi, ci] = r
            for ci, w in ph.writes.items():
                need_w_np[ti, pi, ci] = w
    bounds_np = None
    if n_ph_max > 1:
        bounds_np = np.full((n_tasks, n_ph_max - 1),
                            np.iinfo(np.int32).max, np.int32)
        for ti, tp in enumerate(plan.tasks):
            b = tp.bounds[:-1]
            bounds_np[ti, :len(b)] = b
    return need_r_np, need_w_np, bounds_np, n_ph_max


# Sweeps replayed between two reads of the done flag on the card, one block
# after another; the last size repeats.  Doubling from 1 keeps what a short
# run replays past its end below its own sweeps (gemm: 33 sweeps in 63
# replays, page_rank: 21 in 31), and blocks of 64 keep a long run to one
# host sync every 64 sweeps (gaussian: 2,057 sweeps in 38 blocks) while
# what it replays past its end stays under 64 sweeps, each of which only
# launches the guards and finds every predicate false.  Fixed here, not by
# the caller: the results do not depend on it.
SWEEP_BLOCKS = (1, 2, 4, 8, 16, 32, 64)


def _block_sizes():
    yield from SWEEP_BLOCKS
    while True:
        yield SWEEP_BLOCKS[-1]


@contextlib.contextmanager
def _if_node(pred: torch.Tensor, capture: Optional["_Capture"] = None,
             key: tuple = ()):
    """A conditional node of the sweep; yields whether to run its body.

    On the card (``capture`` given) the block is captured as the body of
    the conditional node of ``key`` = (task, phase), which a replay runs
    only where ``pred`` is true, and this yields True.  On the CPU it
    yields ``bool(pred)``, and the caller's ``if`` is the branch: the CPU
    runs the structure the card captures."""
    if capture is None:
        yield bool(pred)
        return
    with capture.body(key):
        yield True


def _require_conditional_nodes() -> None:
    ver = tuple(int(v) for v in (torch.version.cuda or "0.0").split(".")[:2])
    if ver < (12, 4):
        raise SynthesisError(
            f"the captured sweep needs CUDA-graph conditional nodes, CUDA "
            f">= 12.4; this is torch {torch.__version__} built with CUDA "
            f"{torch.version.cuda}")


class _Capture:
    """Captures the (task, phase) bodies of one sweep on the card, each
    into its own CUDA graph (``torch.cuda.CUDAGraph(keep_graph=True)``,
    on a side stream), all in one memory pool: a body's temporaries are
    dead when it ends, and the sweep runs the bodies one after another,
    so they may share memory.  ``graphs`` holds ``(row, graph)`` with
    ``row = t * P + p``; ``tail`` the graph of the port service (a graph
    with async ports), which runs after the bodies unconditionally."""

    def __init__(self, plan: _Plan, device: torch.device, mode: str,
                 n_ph: int):
        self.plan, self.mode, self.n_ph = plan, mode, n_ph
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: list = []
        self.tail = None

    @contextlib.contextmanager
    def _graph(self, what: str):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode=self.mode)
            try:
                yield graph
            except BaseException:
                with contextlib.suppress(RuntimeError):   # already invalid
                    graph.capture_end()
                raise
            try:
                graph.capture_end()
            except RuntimeError as e:
                raise SynthesisError(
                    f"{what} failed to capture into the sweep's CUDA graph: "
                    f"{e}") from e

    @contextlib.contextmanager
    def body(self, key: tuple):
        ti, pi = key
        tp = self.plan.tasks[ti]
        with self._graph(f"task {tp.inst.name!r}: phase "
                         f"{tp.phases[pi].label!r}") as graph:
            yield
        self.graphs.append((ti * self.n_ph + pi, graph))

    @contextlib.contextmanager
    def port_service(self):
        with self._graph("the port service") as graph:
            yield
        self.tail = graph


class _Carry:
    """Everything a sweep reads and updates in place, on one device, so
    that a captured sweep replays on it: the rings (``rings``: channel
    index -> :class:`RingHandle` over its buffer and its ``heads``/
    ``sizes`` entries), ``maxocc``, the firing counters ``fires`` and the
    sweep state ``state`` (int32: done, sweeps), each task's state in
    static buffers (``states``; a firing copies its returned state into
    them), the mmaps and each async port's latency queue (``ports``:
    :class:`PortQueue`, its counters the rows of ``pint``).
    ``run``/``fire``/``phase`` and ``flags`` (any fired, any left) are the
    guards' outputs for the sweep in progress, not carried across
    sweeps."""

    def __init__(self, plan: _Plan, device: torch.device, states0: tuple,
                 mmaps0: tuple, n_ph: int, ports0: tuple = ()):
        n_chans, n_tasks = len(plan.channels), len(plan.tasks)
        zeros = functools.partial(torch.zeros, dtype=torch.int32,
                                  device=device)
        self.heads, self.sizes, self.maxocc = (zeros(n_chans)
                                               for _ in range(3))
        self.fires, self.state, self.phase = zeros(n_tasks), zeros(2), \
            zeros(n_tasks)
        self.run = torch.zeros((n_tasks, n_ph), dtype=torch.bool,
                               device=device)
        self.fire = torch.zeros(n_tasks, dtype=torch.bool, device=device)
        self.rings = {ci: RingHandle(torch.zeros((c.capacity,) + c.shape,
                                                 dtype=_torch_dtype(c.dtype),
                                                 device=device),
                                     self.heads[ci], self.sizes[ci])
                      for ci, c in enumerate(plan.channels)}
        self.states = list(states0)
        self.mmaps = list(mmaps0)
        self.ctx = _Ctx(self.rings, dict(enumerate(self.mmaps)), device,
                        {k: v.to(device) for k, v in plan.consts.items()})
        self.flags = zeros(2)
        self.pint = torch.zeros((len(plan.ports), PORT_WORDS),
                                dtype=torch.int32, device=device)
        self.ports = [PortQueue(data, self.pint[pi], plan.port_chan_ids[pi],
                                p.depth, p.latency)
                      for pi, (p, data) in enumerate(zip(plan.ports, ports0))]

    def tensors(self) -> list:
        """Every carried tensor."""
        return [r.buf for r in self.rings.values()] + [
            self.heads, self.sizes, self.maxocc, self.fires, self.state] + \
            [x for st in self.states for x in _leaves(st)] + self.mmaps + \
            [self.pint] + [x for q in self.ports
                           for x in (q.data, q.win, q.wval)]


class _SweepProgram:
    """The whole graph as one sweep loop on ``device``.

    ``program(states0, mmaps0, ports0)`` runs the graph to completion (or
    to a stall) and returns ``(mmaps, fires, sweeps, maxocc, sizes,
    (port_counters, port_buffers))``.  One sweep (:meth:`_sweep`) gives
    every task instance one guarded chance to fire, then every async port
    one service step:

    1. one ``sweep_guards`` launch (:class:`SweepGuards`) derives every
       task's phase and liveness from the firing counters, evaluates every
       guard from the start-of-sweep occupancy vector over sparse need
       tables, writes the predicate ``run[t, p]`` of each (task, phase),
       commits ``fires += fire``, counts the sweep and sets the done flag;
       in a graph with ports it leaves the count and the done flag to
       step 3;
    2. each (task, phase) body runs in task order behind its predicate
       (:func:`_if_node`): the phase function through the task's stream,
       mmap and port views, bound once (ring ops and mmap stores update the
       device tensors in place), its returned state copied into the task's
       static state buffers, and the occupancy highwater marks sampled
       after the firing (a sweep-boundary sample would always see drained
       FIFOs);
    3. in a graph with ports, one ``service_ports`` launch
       (:class:`ServicePorts`) services every latency queue against the
       sweep counter as it stands before this sweep is counted, samples
       the highwater marks over every channel and commits the sweep: the
       run goes on while it made progress (a body fired, a request moved,
       or one is due later) and work is left (firings, or a window that is
       not empty), as the reference's loop condition reads.

    On the card the sweep is one CUDA graph (:class:`SweepGraph`): the
    guards kernel, then one conditional node a (task, phase) whose body is
    that body's captured graph (:class:`_Capture`), then the port
    service's captured graph; the kernel sets the condition of the phase
    that fires.  The host replays it in blocks of
    :data:`SWEEP_BLOCKS` with no sync inside a block, reads the done flag
    once a block (one copy into pinned memory) and everything else once
    at the end.  A body
    that cannot be captured raises :class:`SynthesisError` naming its task
    and phase; nothing falls back to an eager loop.  On the CPU the same
    sweep runs eagerly, its predicates as Python branches.  A replay after
    the done flag is set changes no carried tensor.

    Evaluating every guard at sweep start is sound because each channel
    has one producer and one consumer: a consumer's available tokens only
    shrink through its own firing, and a producer's free space only
    through its own, so a guard true at sweep start still holds when the
    task's effects apply in task order.  The loop ends when every task
    has spent its firing budget, or after a sweep that fired nothing (the
    compiled analogue of the engines' deadlock detection).

    After a run: ``capture_s`` (host seconds capturing, 0 on the CPU),
    ``n_replays`` (sweeps replayed, those past the end included),
    ``n_blocks`` and ``n_host_syncs`` (one a block and one final read),
    ``n_graph_nodes`` (the sweep graph's top-level nodes, 0 on the CPU).
    On the card the ring kernels count their own launches, replayed ones
    included (:mod:`..kernels.dispatch`).
    """

    def __init__(self, plan: _Plan, device: torch.device):
        self.plan, self.device = plan, device
        need_r, need_w, bounds, self.n_ph = _guard_tables(plan)
        caps = [c.capacity for c in plan.channels]
        n_tasks = len(plan.tasks)
        if device.type == "cuda" and (n_tasks > MAX_SWEEP_TASKS or len(
                plan.channels) > MAX_SWEEP_CHANNELS):
            raise SynthesisError(
                f"graph has {n_tasks} task instances and "
                f"{len(plan.channels)} channels; the captured sweep's guards "
                f"run one block of one thread a task, at most "
                f"{MAX_SWEEP_TASKS} tasks over {MAX_SWEEP_CHANNELS} channels")
        for p in plan.ports:
            if device.type == "cuda" and p.depth > MAX_PORT_DEPTH:
                raise SynthesisError(
                    f"async_mmap {p.name!r} has depth {p.depth}; the port "
                    f"service on the card keeps at most {MAX_PORT_DEPTH} "
                    f"requests in flight a direction")
        if bounds is None:
            bounds = np.zeros((n_tasks, 0), np.int32)
        row_ptr, entries = sparse_needs(need_r, need_w, caps)
        totals = np.asarray([tp.total for tp in plan.tasks], np.int32)
        self._tables = [torch.from_numpy(a).to(device)
                        for a in (totals, bounds, row_ptr, entries)]
        self.carry: Optional[_Carry] = None
        self.capture_s = 0.0
        self.n_replays = self.n_blocks = self.n_host_syncs = 0
        self.n_graph_nodes = 0
        self._graph = self._flag = None

    def __call__(self, states0: tuple, mmaps0: tuple, ports0: tuple = ()):
        c = self.carry = _Carry(self.plan, self.device, states0, mmaps0,
                                self.n_ph, ports0)
        self._guards = SweepGuards(*self._tables, c.sizes, c.fires, c.state,
                                   c.run, c.fire, c.phase,
                                   c.flags if c.ports else None)
        self._service = ServicePorts(c.ports, c.rings, c.heads, c.sizes,
                                     c.maxocc, c.state, c.flags) \
            if c.ports else None
        self._views = [_bind_views(self.plan, tp, c.ctx, None)
                       for tp in self.plan.tasks]
        self._bodies = [(ti, pi, c.run[ti, pi])
                        for ti, tp in enumerate(self.plan.tasks)
                        for pi in range(len(tp.phases))]
        self._own = [{x.untyped_storage().data_ptr() for x in _leaves(st)}
                     for st in c.states]
        if self.device.type == "cuda":
            self._flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            self._build_graph()
        try:
            for k in _block_sizes():
                self.block(k)
                if self._done():
                    break
            out = self._read()
        except BaseException:
            if self._graph is not None:     # no replay may outlive its graph
                torch.cuda.synchronize(self.device)
            raise
        finally:
            if self._graph is not None:
                self._graph.close()
        return out

    def block(self, k: int) -> None:
        """``k`` sweeps back to back, with no sync between them."""
        if self._graph is not None:
            self._graph.replay(k)
        else:
            for _ in range(k):
                self._sweep()
        self.n_replays += k
        self.n_blocks += 1

    def _sweep(self, capture: Optional[_Capture] = None) -> None:
        """One sweep; on the card (``capture``) it captures the bodies and
        the port service, and the guards are the graph's first node."""
        if capture is None:
            self._guards()
        for ti, pi, pred in self._bodies:
            with _if_node(pred, capture, (ti, pi)) as taken:
                if taken:
                    self._fire(ti, pi, capture is not None)
        if self._service is not None:
            with capture.port_service() if capture is not None else \
                    contextlib.nullcontext():
                self._service()

    def _fire(self, ti: int, pi: int, capturing: bool) -> None:
        tp, c = self.plan.tasks[ti], self.carry
        args, kw = self._views[ti]
        try:
            out = tp.phases[pi].fn(c.states[ti], *args, **kw)
            self._store(ti, out)
        except SynthesisError:
            raise
        except Exception as e:
            if not capturing:
                raise
            raise SynthesisError(
                f"task {tp.inst.name!r}: phase {tp.phases[pi].label!r} "
                f"cannot be captured into the sweep's CUDA graph "
                f"({type(e).__name__}: {e}); a phase body must not read a "
                f"device value on the host (.item(), .cpu(), a Python "
                f"branch on a tensor)") from e
        if tp.chan_ids:
            # only this task's channels moved since the last sample, so a
            # whole-vector max is the per-channel max
            torch.maximum(c.maxocc, c.sizes, out=c.maxocc)

    def _store(self, ti: int, out: Any) -> None:
        """Copy a firing's returned state into the task's static buffers;
        a returned leaf that is another buffer of the same state is
        copied aside first (a state may swap its parts)."""
        c = self.carry
        pairs = []
        for dst, src in zip(_leaves(c.states[ti]), _leaves(out)):
            if src is dst:
                continue
            src = _on_device(src, c.ctx, None, self.plan.tasks[ti].inst)
            if src.untyped_storage().data_ptr() in self._own[ti]:
                src = src.clone()
            pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)

    def _build_graph(self) -> None:
        """Capture the sweep's bodies and build its graph.  A first
        capture in relaxed mode is thrown away: it warms up what a body's
        first call does beside the stream (cuBLAS handles and workspaces,
        allocator growth, kernel loading) without running anything; the
        second is the one the graph holds."""
        _require_conditional_nodes()
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        for mode in ("relaxed", "global"):
            capture = _Capture(self.plan, self.device, mode, self.n_ph)
            self._sweep(capture)
        self._graph = SweepGraph(
            self._guards, [(row, g.raw_cuda_graph())
                           for row, g in capture.graphs],
            capture.tail.raw_cuda_graph() if capture.tail is not None
            else None)
        self.n_graph_nodes = self._graph.nodes
        self.capture_s = time.perf_counter() - t0

    def _done(self) -> bool:
        """One read of the done flag: on the card, one copy into pinned
        memory and one sync."""
        self.n_host_syncs += 1
        flag = self.carry.state[:1]
        if self._flag is not None:
            self._flag.copy_(flag, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            flag = self._flag
        return bool(flag[0])

    def _read(self) -> tuple:
        """The run's results in one read: ``(mmaps, fires, sweeps, maxocc,
        sizes, (port_counters, port_buffers))``, all but the mmaps on the
        host: ``port_counters[port, PORT_WORDS]`` and the buffer of each
        port the graph writes (``{port: tensor}``)."""
        c = self.carry
        vec = torch.cat([c.fires, c.state, c.maxocc, c.sizes,
                         c.pint.view(-1)])
        written = {pi: c.ports[pi].data
                   for pi, dirs in enumerate(self.plan.port_dirs)
                   if "write" in dirs}
        if self._flag is not None:
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            for pi, x in written.items():
                written[pi] = torch.empty(x.shape, dtype=x.dtype,
                                          pin_memory=True)
                written[pi].copy_(x, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            vec = host
        self.n_host_syncs += 1
        t, n = len(c.fires), len(c.sizes)
        fires = vec[:t].numpy().astype(np.int64)
        counters = vec[t + 2 + 2 * n:].view(-1, PORT_WORDS).numpy()
        return (tuple(c.mmaps), fires, int(vec[t + 1]),
                vec[t + 2:t + 2 + n], vec[t + 2 + n:t + 2 + 2 * n],
                (counters, written))


# ---------------------------------------------------------------------------
# the fourth engine
# ---------------------------------------------------------------------------

class CompiledEngine(EngineBase):
    """Whole-graph synthesis engine (the compiled twin of the simulators).

    ``run(top, *args)`` elaborates the graph by executing the *wiring*
    bodies (parents that instantiate channels and invoke children) and
    recording every :class:`StepTask` leaf, lowers the entire graph to a
    sweep loop over device ring buffers, runs it on ``device``, writes
    mmap results back into the host buffers, and returns a real
    :class:`SimReport` (fires, token counts, occupancy highwater marks,
    sweep count as ``switches``).

    ``device=None`` is the card; without one it raises and asks the caller
    for ``device="cpu"``.  On a CUDA device the interconnect runs the
    hand-written ring kernels; on the CPU, their plain versions.

    A graph outside the synthesizable subset raises
    :class:`SynthesisError` naming the offending task/channel; a lowered
    graph that stalls (a genuine dataflow deadlock) returns ``ok=False``
    with the blocked tasks listed, mirroring the simulation engines.
    """

    name = "compiled"

    def __init__(self, track_stats: bool = False, device: Any = None, **kw):
        super().__init__(track_stats, **kw)
        self.device = resolve_device(device)
        self._cur: Optional[TaskInstance] = None
        # post-run introspection: sweeps, and host seconds spent in the
        # wiring + counting pass (lower_s) and in the sweep loop with its
        # capture and the write-back (program_s); of the sweep loop
        # (_SweepProgram): the capture's host seconds (capture_s, 0 on the
        # CPU), sweeps replayed (n_replays, those past the end included),
        # blocks and host syncs (n_host_syncs: one a block and one final
        # read), the sweep graph's top-level nodes (n_graph_nodes); the ring
        # pops and pushes the firings made (ring_ops: on the card, the
        # kernel launches the run should count)
        self.n_sweeps = 0
        self.lower_s = 0.0
        self.program_s = 0.0
        self.capture_s = 0.0
        self.n_replays = self.n_blocks = self.n_host_syncs = 0
        self.n_graph_nodes = 0
        self.ring_ops: dict = {}

    # -- runtime protocol: any live stream op means "not step form" ----------
    def _refuse(self, op: str):
        name = self._cur.name if self._cur is not None else "<top>"
        raise SynthesisError(
            f"task {name!r} performed a runtime stream operation ({op}) "
            f"during synthesis elaboration: it is not in step-function "
            f"form.  CompiledEngine only lowers graphs whose leaf tasks "
            f"are StepTask definitions (availability-routed designs using "
            f"peek/select stay on the simulation engines); see "
            f"docs/synthesis.md")

    def wait(self, chan, side):
        self._refuse("wait")

    def wait_many(self, keys):
        self._refuse("select")

    def push(self, chan, tok):
        self._refuse("write")

    def pop(self, chan):
        self._refuse("read")

    def push_burst(self, chan, toks):
        self._refuse("write_burst")

    def pop_burst(self, chan, n):
        self._refuse("read_burst")

    def schedule_async(self, delay, deliver):
        # a live delivery callback during elaboration means a *wiring
        # body* performed memory I/O, which is not step-function form
        name = self._cur.name if self._cur is not None else "<top>"
        raise SynthesisError(
            f"task {name!r} issued an async_mmap request during synthesis "
            f"elaboration: memory I/O belongs in StepTask phase bodies, "
            f"not in wiring bodies; see docs/synthesis.md")

    # -- elaboration ---------------------------------------------------------
    def spawn(self, inst: TaskInstance) -> None:
        self._register(inst)
        if getattr(inst.fn, "is_step_task", False):
            return                  # recorded; lowered later, never executed
        self._exec(inst)            # wiring body runs inline

    def join(self, insts: list[TaskInstance]) -> None:
        for i in insts:
            if i.state == "failed" and i.error is not None:
                raise i.error

    def _exec(self, inst: TaskInstance) -> Any:
        prev = self._cur
        self._cur = inst
        set_context(self, inst)
        depth = builder_stack_depth()
        inst.state = "running"
        try:
            a, k = bind_streams(inst)
            out = inst.fn(*a, **k)
            join_pending_builders(depth)
            inst.state = "finished"
            return out
        except BaseException as e:
            inst.state = "failed"
            inst.error = e
            raise
        finally:
            self._cur = prev
            set_context(self, prev)

    # -- lowering ------------------------------------------------------------
    def _lower(self) -> tuple[_Plan, Any]:
        step_insts = [i for i in self.instances
                      if getattr(i.fn, "is_step_task", False)]
        if not step_insts:
            raise SynthesisError(
                "graph contains no step-function tasks; CompiledEngine "
                "lowers StepTask leaves (see docs/synthesis.md)")
        plan = _Plan()
        bound = []
        for inst in step_insts:
            a, k = bind_streams(inst)
            bound.append((inst, a, k))
        for inst, a, k in bound:
            if inst.fn.close_outputs:
                raise SynthesisError(
                    f"task {inst.name!r} closes its outputs (EoT) after "
                    f"its last firing; EoT-terminated streams are outside "
                    f"the synthesizable subset — downstream consumers "
                    f"must terminate by firing count instead")
            tp = _TaskPlan(inst=inst, task=inst.fn)
            tp.t_args = tuple(_build_template(x, plan, tp) for x in a)
            tp.t_kwargs = {key: _build_template(x, plan, tp)
                           for key, x in k.items()}
            tp.state0 = _materialize_state(inst.fn.init)
            plan.tasks.append(tp)
        for c in plan.channels:
            if c.shape is None or not isinstance(c.dtype, np.dtype):
                raise SynthesisError(
                    f"channel {c.name!r} has no declared element spec; "
                    f"synthesis sizes its ring buffer from "
                    f"Channel(dtype=..., shape=...)")
        for tp in plan.tasks:
            for label, fn, count in tp.task.phases():
                tp.phases.append(
                    _count_phase(plan, tp, label, fn, count))
            if not tp.phases:
                raise SynthesisError(
                    f"task {tp.inst.name!r} has zero total firings")
        # async ports: record each port's direction from its member-channel
        # traffic, and refuse read+write ports — a read racing an in-flight
        # write to the same buffer resolves by response timing, which the
        # sweep schedule must not be allowed to decide
        for tp in plan.tasks:
            for ph in tp.phases:
                for ci in list(ph.reads) + list(ph.writes):
                    c = plan.channels[ci]
                    pi = plan._port_idx.get(id(c.iface)) \
                        if c.iface is not None else None
                    if pi is None:
                        continue
                    p = plan.ports[pi]
                    if c is p._raddr or c is p._rdata:
                        plan.port_dirs[pi].add("read")
                    else:
                        plan.port_dirs[pi].add("write")
        for pi, dirs in enumerate(plan.port_dirs):
            if dirs >= {"read", "write"}:
                raise SynthesisError(
                    f"async_mmap {plan.ports[pi].name!r} is both read and "
                    f"written in the synthesized graph: read-after-write "
                    f"through an async port depends on response timing; "
                    f"use one port per direction (or route the value "
                    f"through a channel)")
        # schedule-independence: an mmap written by one task and read by
        # another would make results depend on sweep order — refuse
        readers: dict[int, set] = {}
        writers: dict[int, set] = {}
        for tp in plan.tasks:
            for ph in tp.phases:
                for mi in ph.mmap_loads:
                    readers.setdefault(mi, set()).add(tp.inst.name)
                for mi in ph.mmap_stores:
                    writers.setdefault(mi, set()).add(tp.inst.name)
        for mi, ws in writers.items():
            m = plan.mmaps[mi]
            if len(ws) > 1:
                raise SynthesisError(
                    f"mmap {m.name!r} has multiple writers {sorted(ws)} "
                    f"(one-writer rule)")
            others = readers.get(mi, set()) - ws
            if others:
                raise SynthesisError(
                    f"mmap {m.name!r} is written by {sorted(ws)} and read "
                    f"by {sorted(others)}: cross-task read-after-write "
                    f"through memory is schedule-dependent; route the "
                    f"value through a channel instead")
        graph = extract_graph(self)
        try:
            graph.validate()
        except GraphValidationError as e:
            raise SynthesisError(f"graph failed validation: {e}") from e
        return plan, graph

    # -- run -----------------------------------------------------------------
    def _elaborate(self, top: Callable, *args, **kwargs):
        """Execute the wiring bodies and lower to a plan, without running
        the program.  Returns ``(plan, graph, result)``.  The caller owns
        ``clear_context()``."""
        root = TaskInstance(top, args, kwargs, detach=False, parent=None,
                            name=getattr(top, "__name__", "top"))
        set_context(self, None)
        self._register(root)
        result = self._exec(root)
        plan, graph = self._lower()
        return plan, graph, result

    def run(self, top: Callable, *args, **kwargs) -> SimReport:
        t0 = time.perf_counter()
        try:
            plan, graph, result = self._elaborate(top, *args, **kwargs)
            t1 = time.perf_counter()
            self.lower_s = t1 - t0
            states0 = tuple(_materialize_state(tp.state0, self.device)
                            for tp in plan.tasks)
            mmaps0 = tuple(_as_canon(m.data, self.device).clone()
                           for m in plan.mmaps)
            ports0 = tuple(_as_canon(p.data, self.device).clone()
                           for p in plan.ports)
            program = _SweepProgram(plan, self.device)
            mm_final, fires, sweeps, maxocc, sizes, (counters, written) = \
                program(states0, mmaps0, ports0)
            self.capture_s = program.capture_s
            self.n_replays, self.n_blocks, self.n_host_syncs = \
                program.n_replays, program.n_blocks, program.n_host_syncs
            self.n_graph_nodes = program.n_graph_nodes
            self._writeback_ports(plan, written)
            self._fill_port_stats(plan, counters)
            rep = self._finish(plan, mm_final, fires, sweeps, maxocc, sizes,
                               result, t0)
            self.program_s = time.perf_counter() - t1
            return rep
        finally:
            clear_context()

    def _finish(self, plan: _Plan, mm_final, fires, sweeps, maxocc,
                sizes, result, t0: float) -> SimReport:
        """Back half of a compiled run: write mmaps back to host, fill
        stats, diagnose stalls, build the report."""
        fires = np.asarray(fires)
        maxocc = maxocc.cpu().numpy()
        sizes = sizes.cpu().numpy()
        self.n_sweeps = self.switches = int(sweeps)
        self._writeback(plan, mm_final)
        self._fill_stats(plan, fires, maxocc)
        totals = np.asarray([tp.total for tp in plan.tasks], np.int64)
        stuck = bool(np.any(fires < totals))
        for tp, f, tot in zip(plan.tasks, fires, totals):
            tp.inst.state = "finished" if f >= tot else "blocked"
        err = None
        if stuck:
            blocked = [tp.inst.name for tp, f, tot
                       in zip(plan.tasks, fires, totals) if f < tot]
            occ = {c.name: int(s)
                   for c, s in zip(plan.channels, sizes)}
            err = (f"synthesized graph stalled after {self.switches} "
                   f"sweeps; blocked tasks: {blocked}; channel "
                   f"occupancy at stall: {occ}")
            # unified diagnostic (docs/robustness.md): the same
            # structured payload the simulation engines attach
            self._deadlock_report = DeadlockReport(
                engine=self.name, reason="stall",
                blocked=[(n, "stalled") for n in blocked],
                occupancy=occ, clock=self.switches,
                switches=self.switches,
                wall_s=time.perf_counter() - t0)
        return self._report(not stuck, time.perf_counter() - t0, err,
                            result)

    def _writeback(self, plan: _Plan, mm_final: tuple) -> None:
        """Copy device results back into the mmaps' own buffers (host
        numpy arrays or tensors), so the same ``check()`` that verifies a
        simulation run verifies the compiled run."""
        written = set()
        for tp in plan.tasks:
            for ph in tp.phases:
                written.update(ph.mmap_stores)
        for mi in sorted(written):
            m = plan.mmaps[mi]
            out = mm_final[mi]
            if isinstance(m.data, torch.Tensor):
                m.data.copy_(out)
            elif isinstance(m.data, np.ndarray):
                np.copyto(m.data, out.cpu().numpy())
            else:
                m.data = out

    def _writeback_ports(self, plan: _Plan, written: dict) -> None:
        """Copy the buffer of every port the graph writes back into the
        port's own buffer (``written``: port index -> host tensor)."""
        for pi, out in written.items():
            p = plan.ports[pi]
            if isinstance(p.data, torch.Tensor):
                p.data.copy_(out)
            elif isinstance(p.data, np.ndarray):
                np.copyto(p.data, out.numpy())
            else:
                p.data = out

    def _fill_port_stats(self, plan: _Plan, counters: np.ndarray) -> None:
        """Fill each port's request counters from the compiled carry, so
        ``SimReport.interfaces`` carries real numbers — the compiled twin
        of ``AsyncMMap.pump``'s bookkeeping."""
        for p, pc in zip(plan.ports, counters):
            p.read_reqs = int(pc[P_ACC_R])
            p.read_resps = int(pc[P_DEL_R])
            p.write_reqs = int(pc[P_ACC_W])
            p.write_resps = int(pc[P_DEL_W])
            p.max_outstanding_reads = int(pc[P_MAX_R])
            p.max_outstanding_writes = int(pc[P_MAX_W])
            # service-side member-channel totals (the task side is
            # reconstructed from firing counters in _fill_stats)
            p._raddr.total_read += p.read_reqs
            p._rdata.total_written += p.read_resps
            p._waddr.total_read += p.write_reqs
            p._wdata.total_read += p.write_reqs
            p._wresp.total_written += p.write_resps

    def _fill_stats(self, plan: _Plan, fires: np.ndarray,
                    maxocc: np.ndarray) -> None:
        """Reconstruct per-channel token counts and occupancy highwater
        marks from the firing counters — the compiled analogue of the
        simulators' per-push statistics — and the ring ops the firings
        made (``ring_ops``)."""
        ops = {"ring_pop": 0, "ring_push": 0}
        for tp, f in zip(plan.tasks, fires):
            start = 0
            for ph in tp.phases:
                k = int(np.clip(int(f) - start, 0, ph.count))
                start += ph.count
                ops["ring_pop"] += ph.pops * k
                ops["ring_push"] += ph.pushes * k
                for ci, r in ph.reads.items():
                    plan.channels[ci].total_read += r * k
                for ci, w in ph.writes.items():
                    plan.channels[ci].total_written += w * k
                if self.track_stats:
                    for mi, n in ph.mmap_loads.items():
                        plan.mmaps[mi].loads += ph.mmap_load_ops[mi] * k
                        plan.mmaps[mi].load_elems += n * k
                    for mi, n in ph.mmap_stores.items():
                        plan.mmaps[mi].stores += ph.mmap_store_ops[mi] * k
                        plan.mmaps[mi].store_elems += n * k
        for c, occ in zip(plan.channels, maxocc):
            c.max_occupancy = int(occ)
        self.ring_ops = ops


def elaborate_step_graph(top: Callable, *args, **kwargs):
    """Elaborate a step-form graph without executing it.

    Runs the wiring bodies and the counting pass under a throwaway
    :class:`CompiledEngine` and returns ``(plan, graph, result)`` — the
    lowering plan (task order, phase I/O rates, channel/mmap tables), the
    validated graph IR, and the top body's return value.  No firing runs
    on any device, so the engine is a CPU one.  Raises
    :class:`SynthesisError` for graphs outside the synthesizable subset.

    NOTE: elaboration *executes the wiring bodies*, which binds channel
    endpoints to the throwaway engine's task instances.
    """
    eng = CompiledEngine(device="cpu")
    try:
        return eng._elaborate(top, *args, **kwargs)
    finally:
        clear_context()


ENGINES["compiled"] = CompiledEngine

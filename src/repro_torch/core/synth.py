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
  after the run.

The synthesizable subset is the **step-function form**: a leaf task is a
:class:`StepTask` whose phases are functions ``state, *port_views ->
state`` on tensors with *static* I/O rates.  Calling a StepTask is its
**simulation twin**: the Python engines run the same phase functions
against real blocking streams, so one graph definition is both the
correctness vehicle and the synthesized program, bit for bit on one
device.

The program is a sweep loop (:func:`_build_program`).  Each sweep
evaluates every task's guard at once on the device (the ``eval_guards``
kernel), copies the fire vector to the host — one synchronisation per
sweep — and runs each fired task's phase function eagerly, in task order.
A sweep that fires nothing ends the run as a stall.

Rates and refusals come from a **counting pass**: one firing of every
phase on ``meta`` tensors, where the ring ops take their shape-only plain
path.  Anything outside the subset is *refused with a diagnostic naming
the task/channel* (:class:`~repro_torch.core.errors.SynthesisError`),
never miscompiled: non-step leaf tasks, channels without a declared
element spec, data-dependent I/O rates, wrong token shapes or dtypes,
reads or writes beyond capacity, unstable state specs, EoT-closing tasks,
and mmaps both written and read across tasks.  ``async_mmap`` ports are
refused too: their synthesis is not ported yet.
"""

from __future__ import annotations

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
from ..kernels.ring import eval_guards, ring_pop, ring_push

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
    ``chans`` maps a channel index to its ring ``(buf, head, size)``,
    ``mmaps`` an mmap index to its tensor."""

    __slots__ = ("chans", "mmaps")

    def __init__(self, chans: dict, mmaps: dict):
        self.chans = chans
        self.mmaps = mmaps


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


class _SynthStream:
    """Stream view over a ring buffer; every op updates the ring in
    place."""

    __slots__ = ("_ring", "_ci", "_chan", "_inst", "_rec")

    def __init__(self, ctx: _Ctx, ci: int, chan: Channel,
                 inst: TaskInstance, rec: Optional[_Recorder]):
        self._ring = ctx.chans[ci]
        self._ci = ci
        self._chan = chan
        self._inst = inst
        self._rec = rec

    # -- reads ---------------------------------------------------------------
    def read(self):
        self._account("read", 1)
        toks, _, _ = ring_pop(*self._ring, 1)
        return toks[0]

    def read_burst(self, n: int):
        n = self._static(n, "read_burst")
        self._account("read", n)
        toks, _, _ = ring_pop(*self._ring, n)
        return toks

    # -- writes --------------------------------------------------------------
    def write(self, tok) -> None:
        tok = _as_canon(tok) if not isinstance(tok, torch.Tensor) else tok
        self._check_elem(tok, burst=False)
        self._account("write", 1)
        ring_push(*self._ring, tok.to(self._ring[0].device)[None])

    def write_burst(self, arr) -> None:
        if isinstance(arr, (list, tuple)):
            arr = torch.stack([_as_canon(t) for t in arr])
        elif not isinstance(arr, torch.Tensor):
            arr = _as_canon(arr)
        self._check_elem(arr, burst=True)
        self._account("write", int(arr.shape[0]))
        ring_push(*self._ring, arr.to(self._ring[0].device))

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
        if rec is None:
            return
        c = self._chan
        if op == "read":
            c._bind("consumer", self._inst)
            total = rec.reads[self._ci] = rec.reads.get(self._ci, 0) + n
            verb, prep = "reads", "from"
        else:
            c._bind("producer", self._inst)
            total = rec.writes[self._ci] = rec.writes.get(self._ci, 0) + n
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

    __slots__ = ("_t", "_mi", "_mmap", "_inst", "_rec")

    def __init__(self, ctx: _Ctx, mi: int, mmap: MMap,
                 inst: TaskInstance, rec: Optional[_Recorder]):
        self._t = ctx.mmaps[mi]
        self._mi = mi
        self._mmap = mmap
        self._inst = inst
        self._rec = rec

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
        value = _as_canon(value, self._t.device)
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
        seq = _as_canon(seq, self._t.device).to(self._t.dtype)
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
        self.tasks: list[_TaskPlan] = []

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
        raise SynthesisError(
            f"task {tp.inst.name!r} binds async_mmap {v.name!r}: "
            f"async-port synthesis (the latency-queue lowering) is not yet "
            f"ported to repro_torch; run this graph on a simulation "
            f"engine, or read the buffer through an mmap")
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
        chans[ci] = (torch.empty((c.capacity,) + c.shape,
                                 dtype=_torch_dtype(c.dtype), device="meta"),
                     torch.zeros((), dtype=torch.int32, device="meta"),
                     torch.zeros((), dtype=torch.int32, device="meta"))
    mmaps = {mi: torch.empty(tuple(plan.mmaps[mi].shape),
                             dtype=_torch_dtype(plan.mmaps[mi].dtype),
                             device="meta")
             for mi in tp.mmap_ids}
    return _Ctx(chans, mmaps)


def _count_phase(plan: _Plan, tp: _TaskPlan, label: str, fn: Callable,
                 count: int) -> _PhasePlan:
    """One firing of ``fn`` on meta tensors: records the phase's I/O rates
    and refuses what synthesis cannot lower."""
    rec = _Recorder(tp.inst, label)
    args, kw = _bind_views(plan, tp, _meta_ctx(plan, tp), rec)
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
    return _PhasePlan(label=label, fn=fn, count=count, reads=rec.reads,
                      writes=rec.writes, mmap_loads=rec.mmap_loads,
                      mmap_stores=rec.mmap_stores,
                      mmap_load_ops=rec.mmap_load_ops,
                      mmap_store_ops=rec.mmap_store_ops)


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


def _build_program(plan: _Plan, device: torch.device) -> Callable:
    """The whole graph as one sweep loop on ``device``.

    ``program(states0, mmaps0)`` runs the graph to completion (or to a
    stall) and returns ``(mmaps, fires, sweeps, maxocc, sizes)``.  One
    sweep gives every task instance one guarded chance to fire:

    1. the phase and live vectors follow from the host's firing counters;
    2. ``eval_guards`` computes every task's fire predicate on the device
       from the start-of-sweep occupancy vector;
    3. the fire vector comes back to the host — one synchronisation per
       sweep;
    4. each fired task runs its phase eagerly, in task order; its stream
       views launch ``ring_pop``/``ring_push`` on the device rings;
    5. the occupancy highwater marks are sampled after every firing (a
       sweep-boundary sample would always see drained FIFOs).

    Evaluating every guard at sweep start is sound because each channel
    has one producer and one consumer: a consumer's available tokens only
    shrink through its own firing, and a producer's free space only
    through its own, so a guard true at sweep start still holds when the
    task's effects apply in task order.  The loop ends when every task
    has spent its firing budget, or after a sweep that fired nothing (the
    compiled analogue of the engines' deadlock detection).
    """
    caps = [c.capacity for c in plan.channels]
    totals = np.asarray([tp.total for tp in plan.tasks], np.int64)
    n_chans = len(plan.channels)
    n_tasks = len(plan.tasks)
    need_r_np, need_w_np, bounds_np, n_ph_max = _guard_tables(plan)
    rows = np.arange(n_tasks)

    def program(states0: tuple, mmaps0: tuple):
        dev = device
        heads = torch.zeros(n_chans, dtype=torch.int32, device=dev)
        sizes = torch.zeros(n_chans, dtype=torch.int32, device=dev)
        maxocc = torch.zeros(n_chans, dtype=torch.int32, device=dev)
        caps_t = torch.tensor(caps, dtype=torch.int32, device=dev)
        chans = {ci: (torch.zeros((c.capacity,) + c.shape,
                                  dtype=_torch_dtype(c.dtype), device=dev),
                      heads[ci], sizes[ci])
                 for ci, c in enumerate(plan.channels)}
        mmaps = list(mmaps0)
        ctx = _Ctx(chans, dict(enumerate(mmaps)))
        # ring ops and mmap stores update the device tensors in place, so
        # each task's views are bound once for the whole run
        views = [_bind_views(plan, tp, ctx, None) for tp in plan.tasks]
        states = list(states0)
        fires = np.zeros(n_tasks, np.int64)
        sweeps = 0
        guard_key = None
        while True:
            live = fires < totals
            if not live.any():
                break
            if n_ph_max > 1:
                phase_vec = np.sum(fires[:, None] >= bounds_np, axis=1)
            else:
                phase_vec = np.zeros(n_tasks, np.int64)
            if n_chans:
                key = (phase_vec.tobytes(), live.tobytes())
                if key != guard_key:    # phases and budgets change rarely
                    guard_key = key
                    nr = torch.from_numpy(need_r_np[rows, phase_vec]).to(dev)
                    nw = torch.from_numpy(need_w_np[rows, phase_vec]).to(dev)
                    live_t = torch.from_numpy(live).to(dev)
                fire = eval_guards(sizes, caps_t, nr, nw, live_t)
                fire = fire.cpu().numpy()       # the sweep's one sync
            else:
                fire = live
            sweeps += 1
            for ti in np.flatnonzero(fire):
                tp = plan.tasks[ti]
                args, kw = views[ti]
                fn = tp.phases[phase_vec[ti]].fn
                states[ti] = fn(states[ti], *args, **kw)
                if tp.chan_ids:
                    # only this task's channels moved since the last
                    # sample, so a whole-vector max is the per-channel max
                    torch.maximum(maxocc, sizes, out=maxocc)
            fires += fire
            if not fire.any():
                break
        return tuple(mmaps), fires, sweeps, maxocc, sizes

    return program


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
        # wiring + counting pass (lower_s) and in the sweep loop with the
        # write-back (program_s)
        self.n_sweeps = 0
        self.lower_s = 0.0
        self.program_s = 0.0

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
            program = _build_program(plan, self.device)
            mm_final, fires, sweeps, maxocc, sizes = program(states0, mmaps0)
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

    def _fill_stats(self, plan: _Plan, fires: np.ndarray,
                    maxocc: np.ndarray) -> None:
        """Reconstruct per-channel token counts and occupancy highwater
        marks from the firing counters — the compiled analogue of the
        simulators' per-push statistics."""
        for tp, f in zip(plan.tasks, fires):
            start = 0
            for ph in tp.phases:
                k = int(np.clip(int(f) - start, 0, ph.count))
                start += ph.count
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

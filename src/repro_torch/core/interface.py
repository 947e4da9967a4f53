"""Typed task interfaces (paper Section 3.1.2, Table 2).

The paper's programming model gives a task *three* kinds of interface:

* **streams** — the bounded FIFOs of :mod:`repro_torch.core.channel`;
* **mmap / async_mmap** — views of external (off-chip) memory; and
* **scalars** — pass-by-value run parameters.

The seed reproduction only implemented streams: every app closure-captured
its numpy arrays, so external-memory traffic was invisible to the
simulators, absent from the graph IR, and baked into the structural hash as
constants (two instances differing only in captured array *values* hashed
apart).  This module makes the other two kinds first-class:

:class:`MMap`
    Synchronous memory view: loads/stores complete immediately
    (``m[i]`` / ``m[i] = v``) plus ``read_burst``/``write_burst`` slice
    transfers — the software analogue of an AXI burst.  Many tasks may
    read one ``MMap``; at most one may write it (the one-writer rule,
    mirroring the one-producer channel rule of Section 3.1.1).

:class:`AsyncMMap`
    The paper's five-channel decomposition of a memory port
    (``read_addr`` / ``read_data`` / ``write_addr`` / ``write_data`` /
    ``write_resp``), built on ordinary :class:`~repro_torch.core.channel.Channel`
    objects.  Requests are *accepted* into an in-flight window bounded by
    ``depth`` and *delivered* ``latency`` engine ticks later, so a task
    that pipelines its requests genuinely overlaps them — observable in
    ``max_outstanding_reads``.  Exactly one task may bind an
    ``AsyncMMap`` (it models one memory port).

:class:`Scalar`
    A declared pass-by-value argument.  Binding unwraps it — the task body
    receives the plain Python value — but the wrapper marks the parameter
    in the per-definition interface table and hashes by value.

Engines discover interfaces from task arguments exactly as they discover
channels; delivery scheduling is engine-mediated (see
``EngineBase.schedule_async``): the coroutine and thread engines deliver
responses at request-time + latency (fast-forwarding the clock when every
task is stalled on memory), while the sequential engine delivers
synchronously and *records* the violation — it cannot overlap requests,
the same documented failure mode as its channel-capacity growth.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

import numpy as np
import torch

from .channel import Channel, IStream, OStream, _rt, np_dtype, select
from .context import current_runtime, current_task
from .errors import ChannelMisuse

_iface_uid = itertools.count()

# Canonical interface kinds (Table 2 rows + the stream directions).
KINDS = ("istream", "ostream", "mmap", "async_mmap", "scalar")


class InterfaceBinding:
    """One (task instance, parameter) binding — a row of the per-definition
    interface table extracted into the graph IR (Section 3.4)."""

    __slots__ = ("param", "kind", "dtype", "direction", "ref", "inst")

    def __init__(self, param: str, kind: str, dtype: Any, ref: Any,
                 inst: Any, direction: Optional[set] = None):
        self.param = param
        self.kind = kind          # istream/ostream/stream/mmap/async_mmap/
        #                           scalar/null/other
        self.dtype = dtype
        self.direction = direction if direction is not None else set()
        self.ref = ref            # the Channel / Interface object (or None)
        self.inst = inst

    def resolved_kind(self) -> str:
        """Late-resolve stream direction: an unannotated (AutoStream)
        channel binding settles to istream/ostream once the simulated body
        has used it."""
        if self.kind == "stream" and isinstance(self.ref, Channel):
            if self.ref.producer is self.inst:
                return "ostream"
            if self.ref.consumer is self.inst:
                return "istream"
        return self.kind

    def resolved_direction(self) -> str:
        k = self.resolved_kind()
        if k == "istream":
            return "in"
        if k == "ostream":
            return "out"
        if k == "scalar":
            return "in"
        if self.direction >= {"read", "write"}:
            return "readwrite"
        if "write" in self.direction:
            return "write"
        if "read" in self.direction:
            return "read"
        return "unused"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"<InterfaceBinding {self.param}:{self.resolved_kind()} "
                f"{self.resolved_direction()}>")


class Interface:
    """Base class for non-stream task interfaces."""

    iface_kind = "interface"


def _is_ancestor(anc: Any, inst: Any) -> bool:
    p = getattr(inst, "parent", None)
    while p is not None:
        if p is anc:
            return True
        p = p.parent
    return False


def _numel(v: Any) -> int:
    """Element count of a load/store payload (``np.size`` reads a
    tensor's ``size`` method, not its element count)."""
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def _copy(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, torch.Tensor):
        return v.clone()
    return v


def _like(value: Any, data: Any) -> Any:
    """``value`` in the buffer's own framework: a store into a host numpy
    buffer brings a tensor to the host; a store into a tensor buffer
    moves the value to the tensor's device."""
    if isinstance(data, torch.Tensor):
        return torch.as_tensor(value, dtype=data.dtype, device=data.device)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def _buf_dtype(data: Any) -> np.dtype:
    """A buffer's element dtype as numpy spells it (tensor buffers
    included), so interface tables compare across frameworks."""
    d = getattr(data, "dtype", None)
    return np_dtype(d) if d is not None else np.asarray(data).dtype


class Scalar(Interface):
    """Declared pass-by-value argument (paper Table 2's third interface
    kind).  Binding hands the task body the raw ``value``."""

    iface_kind = "scalar"

    __slots__ = ("value", "dtype")

    def __init__(self, value: Any, dtype: Any = None):
        self.value = value
        self.dtype = dtype if dtype is not None else type(value).__name__

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Scalar({self.value!r})"


class MMap(Interface):
    """Synchronous external-memory view over an array-like buffer.

    ``m[idx]`` / ``m[idx] = v`` are single-beat load/store;
    ``read_burst(start, n)`` / ``write_burst(start, seq)`` move contiguous
    slices (rows for >1-D buffers) in one transfer.  Loads and stores are
    tracked per task instance, which is how the graph IR learns each
    binding's direction without any annotation, and how the one-writer
    rule is enforced: at most one task instance may store.

    Statistics (``loads``/``stores``/``load_elems``/``store_elems``) are
    burst-granular and only recorded under ``track_stats=True`` runs —
    same opt-in contract as channel statistics.
    """

    iface_kind = "mmap"

    __slots__ = ("uid", "name", "data", "writer", "_by_inst",
                 "loads", "stores", "load_elems", "store_elems")

    def __init__(self, data: Any, name: Optional[str] = None):
        self.uid = next(_iface_uid)
        self.name = name or f"mmap{self.uid}"
        self.data = data
        self.writer = None              # task instance holding write access
        self._by_inst: dict = {}        # inst uid -> InterfaceBinding
        self.loads = 0
        self.stores = 0
        self.load_elems = 0
        self.store_elems = 0

    # -- shape plumbing (lets the compile path treat MMaps as avals) -------
    @property
    def shape(self) -> tuple:
        return tuple(np.shape(self.data))

    @property
    def dtype(self):
        return _buf_dtype(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def _reset_run(self) -> None:
        """Clear run-scoped state (bindings, writer, statistics) — called
        by an engine the first time it registers this interface, so one
        host-created MMap can be re-simulated under many engines."""
        self.writer = None
        self._by_inst = {}
        self.loads = self.stores = 0
        self.load_elems = self.store_elems = 0

    # -- binding ------------------------------------------------------------
    def _bind_task(self, binding: InterfaceBinding) -> None:
        self._by_inst[binding.inst.uid] = binding

    def _note(self, op: str, n: int) -> None:
        inst = current_task()
        if inst is not None:
            b = self._by_inst.get(inst.uid)
            if b is not None:
                b.direction.add(op)
            if op == "write":
                if self.writer is None:
                    self.writer = inst
                elif self.writer is not inst:
                    raise ChannelMisuse(
                        f"mmap {self.name!r} already has writer "
                        f"{self.writer.name}; task {inst.name} may not "
                        f"also store (one-writer rule)")
        rt = current_runtime()
        if rt is not None and rt.track_stats:
            if op == "read":
                self.loads += 1
                self.load_elems += n
            else:
                self.stores += 1
                self.store_elems += n

    # -- access -------------------------------------------------------------
    def __getitem__(self, idx) -> Any:
        v = self.data[idx]
        self._note("read", _numel(v))
        return _copy(v)

    def __setitem__(self, idx, value) -> None:
        # element count = payload size (a broadcast scalar store counts 1)
        self._note("write", _numel(value))
        self.data[idx] = _like(value, self.data)

    def read_burst(self, start: int, n: int) -> Any:
        """Load ``n`` consecutive elements (rows, for >1-D buffers)
        starting at ``start`` in one transfer; returns a copy."""
        if n < 0:
            raise ValueError("read_burst size must be >= 0")
        start = int(start)      # a 0-d tensor start: one host read
        out = self.data[start:start + n]
        self._note("read", _numel(out))
        if isinstance(out, (np.ndarray, torch.Tensor)):
            return _copy(out)
        return list(out)

    def write_burst(self, start: int, seq) -> None:
        """Store the elements of ``seq`` contiguously from ``start`` in one
        transfer."""
        seq = _like(seq, self.data)
        if not isinstance(self.data, torch.Tensor):
            seq = np.asarray(seq)
        self._note("write", _numel(seq))
        start = int(start)
        self.data[start:start + len(seq)] = seq

    def stats(self) -> dict:
        return {"loads": self.loads, "stores": self.stores,
                "load_elems": self.load_elems,
                "store_elems": self.store_elems}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"MMap({self.name!r}, shape={self.shape})"


class _ReqStream(OStream):
    """Producer view of an ``AsyncMMap`` request channel: a plain OStream
    whose pushes immediately offer the queued requests to the memory model
    (``pump``), so acceptance — and therefore response scheduling — happens
    at issue time, not at the next engine stall."""

    __slots__ = ("_iface",)

    def __init__(self, iface: "AsyncMMap", chan: Channel):
        super().__init__(chan)
        self._iface = iface

    def write(self, v) -> None:
        super().write(v)
        _rt().iface_pump(self._iface)

    def write_burst(self, seq) -> None:
        super().write_burst(seq)
        _rt().iface_pump(self._iface)

    def try_write(self, v) -> bool:
        ok = super().try_write(v)
        if ok:
            _rt().iface_pump(self._iface)
        return ok

    def try_write_burst(self, seq) -> int:
        k = super().try_write_burst(seq)
        if k:
            _rt().iface_pump(self._iface)
        return k

    def close(self) -> None:
        raise ChannelMisuse(
            "memory request channels carry no EoT tokens; an async_mmap "
            "port has no transactions to close")

    try_close = close


class AsyncMMap(Interface):
    """Asynchronous external-memory port: the paper's five-channel
    decomposition (read_addr/read_data/write_addr/write_data/write_resp).

    A read is *issued* by writing an address to ``read_addr`` and
    *completes* when the value appears on ``read_data`` — ``latency``
    engine ticks after the request was accepted.  Up to ``depth`` requests
    may be in flight per direction; a task that issues a burst of
    addresses before draining responses overlaps the round-trips
    (``max_outstanding_reads > 1``), while a strict
    issue-one/wait-for-one loop serializes them.  Writes pair one token
    from ``write_addr`` with one from ``write_data`` and acknowledge on
    ``write_resp`` after the same latency.

    Exactly one task instance may bind an ``AsyncMMap`` — it models a
    single memory port (use one object per port, as TAPA does).
    """

    iface_kind = "async_mmap"

    __slots__ = ("uid", "name", "data", "latency", "depth", "owner",
                 "_raddr", "_rdata", "_waddr", "_wdata", "_wresp",
                 "read_addr", "read_data", "write_addr", "write_data",
                 "write_resp", "_binding",
                 "_pending_reads", "_pending_writes",
                 "_inflight_reads", "_inflight_writes",
                 "read_reqs", "write_reqs", "read_resps", "write_resps",
                 "max_outstanding_reads", "max_outstanding_writes")

    def __init__(self, data: Any, latency: int = 4,
                 depth: Optional[int] = 4, name: Optional[str] = None):
        if latency < 0:
            raise ValueError("async_mmap latency must be >= 0")
        if depth is not None and (not isinstance(depth, int)
                                  or isinstance(depth, bool) or depth < 1):
            raise ValueError(
                "async_mmap outstanding depth must be an int >= 1, or "
                "None for an unbounded in-flight window (simulation only)")
        self.uid = next(_iface_uid)
        self.name = name or f"amap{self.uid}"
        self.data = data
        self.latency = latency
        self.depth = depth
        self.owner = None
        # member channels carry a declared element spec so the synthesis
        # path (core/synth.py) can size their ring buffers: addresses are
        # int32 scalars, data tokens rows of the buffer, write acks bools
        try:
            elem_dt = self.dtype
            elem_shape: Optional[tuple] = tuple(self.shape[1:])
        except TypeError:
            elem_dt, elem_shape = None, None
        cap = depth if depth is not None else \
            max(1, self.shape[0] if self.shape else 1)
        mk = lambda side, dt, shp: Channel(  # noqa: E731
            cap, f"{self.name}.{side}", dtype=dt, shape=shp)
        self._raddr = mk("read_addr", np.int32, ())
        self._rdata = mk("read_data", elem_dt, elem_shape)
        self._waddr = mk("write_addr", np.int32, ())
        self._wdata = mk("write_data", elem_dt, elem_shape)
        self._wresp = mk("write_resp", np.bool_, ())
        for ch in self.channels():
            ch.iface = self
        # task-facing views (paper Table 2's async_mmap member streams)
        self.read_addr = _ReqStream(self, self._raddr)
        self.read_data = IStream(self._rdata)
        self.write_addr = _ReqStream(self, self._waddr)
        self.write_data = _ReqStream(self, self._wdata)
        self.write_resp = IStream(self._wresp)
        # accepted-but-undelivered request counts
        self._pending_reads = 0
        self._pending_writes = 0
        # accepted-but-undelivered request *payloads*, in acceptance order
        # (delivery is FIFO per direction, see pump()).  The engines never
        # read these — they exist so a GraphSnapshot (repro.ft.recovery)
        # can re-materialize in-flight requests, which otherwise live only
        # as closures in the engine's event heap.
        self._inflight_reads: list = []
        self._inflight_writes: list = []
        self._binding: Optional[InterfaceBinding] = None
        # statistics (request-granular, always on: acceptance is not the
        # per-token hot path)
        self.read_reqs = 0
        self.write_reqs = 0
        self.read_resps = 0
        self.write_resps = 0
        self.max_outstanding_reads = 0
        self.max_outstanding_writes = 0

    @property
    def shape(self) -> tuple:
        return tuple(np.shape(self.data))

    @property
    def dtype(self):
        return _buf_dtype(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def channels(self) -> tuple:
        return (self._raddr, self._rdata, self._waddr, self._wdata,
                self._wresp)

    def _reset_run(self) -> None:
        """Clear run-scoped state: ownership, in-flight counters, port
        FIFOs, and statistics — a host-created port is re-simulatable
        under a fresh engine."""
        self.owner = None
        self._binding = None
        self._pending_reads = self._pending_writes = 0
        self._inflight_reads = []
        self._inflight_writes = []
        self.read_reqs = self.write_reqs = 0
        self.read_resps = self.write_resps = 0
        self.max_outstanding_reads = self.max_outstanding_writes = 0
        for ch in self.channels():
            ch._q.clear()
            ch._rwait.clear()
            ch._wwait.clear()
            ch._eot_count = 0
            ch.producer = ch.consumer = None
            ch.total_written = ch.total_read = ch.max_occupancy = 0

    # -- binding ------------------------------------------------------------
    def _bind_task(self, binding: InterfaceBinding) -> None:
        inst = binding.inst
        if self.owner is not None and self.owner is not inst and \
                not _is_ancestor(self.owner, inst):
            raise ChannelMisuse(
                f"async_mmap {self.name!r} is already bound to task "
                f"{self.owner.name}; it models one memory port and cannot "
                f"also serve {inst.name}")
        # ownership follows the hierarchy down: a parent that receives the
        # port as an argument merely forwards it — the (unique) descendant
        # that binds it last is the task driving the port
        self.owner = inst
        self._binding = binding     # direction recorded at request accept
        # endpoint registration: the task produces requests and consumes
        # responses; the memory model is the opposite endpoint
        for ch in (self._raddr, self._waddr, self._wdata):
            ch.producer, ch.consumer = inst, self
        for ch in (self._rdata, self._wresp):
            ch.producer, ch.consumer = self, inst

    # the memory endpoint masquerades as a task for channel bookkeeping
    @property
    def parent(self):
        return self.owner.parent if self.owner is not None else None

    # -- the memory model ----------------------------------------------------
    def pump(self, engine) -> None:
        """Accept queued requests into the in-flight window.

        Called by the engines (at issue time via :class:`_ReqStream`, and
        from the scheduler's service step) — never by task bodies.  Each
        accepted request schedules its delivery ``latency`` ticks ahead via
        ``engine.schedule_async``.
        """
        # the window bounds *in-flight* requests (accepted, response not
        # yet produced); a full response FIFO additionally back-pressures
        # by deferring delivery, never by refusing acceptance — matching a
        # memory controller whose completions wait for the resp FIFO
        #
        # chaos harness: a fault plan with mem_spike entries perturbs the
        # per-request latency (FaultInjector.mem_delay).  Spikes may reorder
        # responses across ports/directions — legal, nothing guarantees
        # cross-port ordering — but mem_delay clamps due times so each
        # (port, direction) response FIFO stays in issue order.
        faults = getattr(engine, "faults", None)
        if faults is not None and not faults.affects_memory:
            faults = None
        while self._raddr._q and (self.depth is None or
                                  self._pending_reads < self.depth):
            addr = engine._iface_pop(self._raddr)
            if self._binding is not None:
                self._binding.direction.add("read")
            self._pending_reads += 1
            self._inflight_reads.append(addr)
            self.read_reqs += 1
            if self._pending_reads > self.max_outstanding_reads:
                self.max_outstanding_reads = self._pending_reads
            lat = self.latency if faults is None else faults.mem_delay(
                self.name, "read", self.latency, engine.clock)
            engine.schedule_async(
                lat,
                lambda eng, a=addr: self._deliver_read(eng, a))
        while (self._waddr._q and self._wdata._q and
               (self.depth is None or
                self._pending_writes < self.depth)):
            addr = engine._iface_pop(self._waddr)
            value = engine._iface_pop(self._wdata)
            if self._binding is not None:
                self._binding.direction.add("write")
            self._pending_writes += 1
            self._inflight_writes.append((addr, value))
            self.write_reqs += 1
            if self._pending_writes > self.max_outstanding_writes:
                self.max_outstanding_writes = self._pending_writes
            lat = self.latency if faults is None else faults.mem_delay(
                self.name, "write", self.latency, engine.clock)
            engine.schedule_async(
                lat,
                lambda eng, a=addr, v=value: self._deliver_write(eng, a, v))

    def _deliver_read(self, engine, addr) -> bool:
        """Complete one read: load the buffer and publish on read_data.
        Returns False (retry later) when the response channel is full."""
        if len(self._rdata._q) >= self._rdata.capacity and \
                not engine.force_async:
            return False
        v = _copy(self.data[addr])
        engine._iface_deliver(self._rdata, v)
        self._pending_reads -= 1
        if self._inflight_reads:
            self._inflight_reads.pop(0)   # FIFO per direction
        self.read_resps += 1
        self.pump(engine)       # a window slot freed: accept queued requests
        return True

    def _deliver_write(self, engine, addr, value) -> bool:
        if len(self._wresp._q) >= self._wresp.capacity and \
                not engine.force_async:
            return False
        self.data[addr] = _like(value, self.data)
        engine._iface_deliver(self._wresp, True)
        self._pending_writes -= 1
        if self._inflight_writes:
            self._inflight_writes.pop(0)  # FIFO per direction
        self.write_resps += 1
        self.pump(engine)
        return True

    # -- convenience: pipelined bulk helpers ---------------------------------
    def read_pipelined(self, addrs) -> list:
        """Issue every address in ``addrs`` as early as the in-flight
        window allows while draining responses — the idiomatic
        overlapped-read loop (request/response decoupling is the whole
        point of the five-channel form).  Returns the responses in
        request order."""
        addrs = list(addrs)
        out: list = []
        i = 0
        while len(out) < len(addrs):
            if i < len(addrs):
                i += self.read_addr.try_write_burst(addrs[i:])
            got = self.read_data.try_read_burst(len(addrs) - len(out))
            if got:
                out.extend(got)
            elif i < len(addrs):
                # never commit to a single side while both may progress:
                # block until the request channel has room OR a response
                # lands (a blocking write here would deadlock against a
                # full in-flight window)
                select(self.read_addr, self.read_data)
            else:
                out.extend(self.read_data.read_burst(len(addrs) - len(out)))
        return out

    def stats(self) -> dict:
        return {"read_reqs": self.read_reqs, "read_resps": self.read_resps,
                "write_reqs": self.write_reqs,
                "write_resps": self.write_resps,
                "max_outstanding_reads": self.max_outstanding_reads,
                "max_outstanding_writes": self.max_outstanding_writes,
                "latency": self.latency, "depth": self.depth}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"AsyncMMap({self.name!r}, shape={self.shape}, "
                f"latency={self.latency}, depth={self.depth})")


# ---------------------------------------------------------------------------
# factories (mirror repro_torch.channel)
# ---------------------------------------------------------------------------

def mmap(data: Any, name: Optional[str] = None) -> MMap:
    """Wrap an array as a synchronous memory-mapped task argument —
    ``tapa::mmap<T>``."""
    return MMap(data, name=name)


def async_mmap(data: Any, latency: int = 4, depth: Optional[int] = 4,
               name: Optional[str] = None) -> AsyncMMap:
    """Wrap an array as an asynchronous memory port — ``tapa::async_mmap``
    with a configurable response latency and outstanding-request depth.
    ``depth=None`` gives an unbounded in-flight window (simulation only;
    synthesis needs a bounded window to size the latency queue)."""
    return AsyncMMap(data, latency=latency, depth=depth, name=name)


def scalar(value: Any, dtype: Any = None) -> Scalar:
    """Declare a pass-by-value task argument (the body receives the raw
    value; the wrapper only feeds the interface table and the hash)."""
    return Scalar(value, dtype=dtype)

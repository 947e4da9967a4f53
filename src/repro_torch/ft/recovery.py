"""Crash recovery: engine-agnostic task-graph snapshots + supervised restart.

The port's counterpart of the reference package's ``ft/recovery.py``:

* :class:`GraphSnapshot` — the complete execution state of a step-form task
  graph at a quiescent point: per-task firing counters, per-task state
  pytrees, channel ring contents, mmap buffer copies and, for a graph with
  ``async_mmap`` ports, each port's latency queue, keyed by
  ``Graph.structural_hash()``.  Its rows are numpy arrays in the
  reference's layout (a port's queue is the reference's 16-entry
  ``_port_carry0`` tuple), so a snapshot means the same thing in both
  packages: one taken under any engine restores under any other, and a
  snapshot the reference made restores here.

* :class:`SnapshotStore` — persistence through the digest-verified
  :class:`~repro_torch.ckpt.manager.CheckpointManager`: atomic publish,
  sha256 manifests, and ``restore_latest`` falling past corrupt snapshots.

* :func:`run_recoverable` — chunked execution: the run is cut at sweep
  boundaries of the *abstract schedule* (a pure-Python replay of the
  compiled sweep over token counts alone); each boundary is quiescent by
  construction and snapshots there.  Under ``CompiledEngine`` the sweep's
  program is prepared (on the card: captured as one CUDA graph) once for
  the run, a snapshot is restored into its carry in place, and each chunk
  replays it for an exact budget of sweeps; under the Python engines each
  chunk re-invokes every task with a per-chunk firing quota derived from
  the same schedule.

* :func:`run_supervised` — bounded restarts with exponential backoff.  A
  :class:`~repro_torch.core.errors.CrashFault` (the ``FaultPlan.crash``
  kind) aborts the run; the supervisor restores the latest snapshot and
  resumes, so final outputs match the fault-free run.

Why sweep boundaries are consistent cuts: the abstract schedule is a valid
execution order, so the firing-count vector at any of its prefixes is
reachable under every fair blocking engine (the KPN argument: firing
counts determine channel contents, task states and mmap contents
deterministically for the step-function subset — no peek/select/EoT,
static I/O rates).

``async_mmap`` ports are recoverable on the compiled engine: the latency
queue lives in the sweep's carry, so snapshots carry its rows verbatim,
due stamps rebased to "sweeps remaining" at each chunk boundary, and the
abstract schedule replays the port service step over token counts.  On the
Python engines port graphs refuse: a per-chunk firing quota cannot bound
the simulators' event-driven port pumps at a sweep boundary.  Graphs
outside the step subset have no schedule-independent cut;
:func:`run_supervised` degrades to restart-from-scratch for them.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..core.channel import Channel
from ..core.engines import ENGINES, SimReport
from ..core.errors import CrashFault, SynthesisError
from ..core.faults import FaultInjector, FaultPlan
from ..core.interface import AsyncMMap
from ..core.synth import (_SweepProgram, _as_canon, _host_tensor, _leaves,
                          _port_carry0, _torch_dtype, _tree_map, _twin_view,
                          _unflatten, canon_dtype, elaborate_step_graph,
                          resolve_device, to_torch_state)
from ..core.task import task


def _np(x: Any) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a number) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# container-level capture/restore (any channel, any engine)
# ---------------------------------------------------------------------------

@dataclass
class ChannelState:
    """Raw contents of one channel: data tokens in order, with EoT tokens
    in place (the EOT singleton), plus the derived EoT count."""

    tokens: list
    eot_count: int = 0


def capture_channel(chan: Channel) -> ChannelState:
    return ChannelState(tokens=list(chan._q), eot_count=chan._eot_count)


def restore_channel(chan: Channel, st: ChannelState) -> None:
    """Overwrite a channel's queue with a captured state.  Waiter lists are
    cleared — restore happens between runs, when no task is parked."""
    chan._q = deque(st.tokens)
    chan._eot_count = st.eot_count
    chan._rwait.clear()
    chan._wwait.clear()


@dataclass
class PortState:
    """Outstanding-request state of one ``AsyncMMap`` port.

    ``queues`` holds the five port channels (issued-but-unaccepted requests
    and delivered-but-unread responses); ``inflight_*`` the accepted-but-
    undelivered requests, which otherwise live only as closures in the
    engine's event heap.  Restore re-queues them *ahead* of the unaccepted
    requests, so the next pump re-accepts and re-schedules them — same
    result values, fresh latency."""

    data: Any
    queues: list = field(default_factory=list)       # [ChannelState] x5
    inflight_reads: list = field(default_factory=list)
    inflight_writes: list = field(default_factory=list)  # [(addr, value)]


def capture_port(amap: AsyncMMap) -> PortState:
    return PortState(
        data=np.array(_np(amap.data), copy=True),
        queues=[capture_channel(c) for c in amap.channels()],
        inflight_reads=list(amap._inflight_reads),
        inflight_writes=list(amap._inflight_writes),
    )


def _copy_into(holder: Any, saved: np.ndarray) -> None:
    """Write ``saved`` into ``holder.data`` (a host array or a tensor) in
    place, or rebind it where it holds neither."""
    if isinstance(holder.data, np.ndarray):
        np.copyto(holder.data, saved)
    elif isinstance(holder.data, torch.Tensor):
        holder.data.copy_(torch.from_numpy(np.array(saved)))
    else:
        holder.data = np.array(saved, copy=True)


def restore_port(amap: AsyncMMap, st: PortState) -> None:
    _copy_into(amap, st.data)
    for c, cs in zip(amap.channels(), st.queues):
        restore_channel(c, cs)
    # accepted-but-undelivered requests go back to the head of the request
    # FIFOs, in acceptance order, ahead of anything not yet accepted
    for addr in reversed(st.inflight_reads):
        amap._raddr._q.appendleft(addr)
    for addr, value in reversed(st.inflight_writes):
        amap._wdata._q.appendleft(value)
        amap._waddr._q.appendleft(addr)
    amap._pending_reads = amap._pending_writes = 0
    amap._inflight_reads = []
    amap._inflight_writes = []
    # the re-queued requests will be re-accepted: rewind the acceptance
    # counters so stats don't double-count them
    amap.read_reqs -= len(st.inflight_reads)
    amap.write_reqs -= len(st.inflight_writes)


# ---------------------------------------------------------------------------
# graph snapshots (step-form subset, engine-agnostic)
# ---------------------------------------------------------------------------

@dataclass
class GraphSnapshot:
    """Execution state of a step-form graph at a sweep boundary, as numpy.

    ``chans`` stores each channel as a zero-padded ``(capacity, *elem)``
    buffer plus an occupancy count, head-normalized to index 0 — the ring's
    head position is value-irrelevant (all indexing is modular), so this is
    the canonical form every engine round-trips through."""

    graph_hash: str
    sweep: int
    fires: np.ndarray                  # (n_tasks,) int32 firing counters
    states: list                       # per-task state pytrees
    chans: list                        # [(buf ndarray, size int)]
    mmaps: list                        # [ndarray copy] per plan mmap
    engine: str = ""
    meta: dict = field(default_factory=dict)
    # per-port latency-queue rows: the reference's 16-entry ``_port_carry0``
    # tuple as np arrays (data buffer; read addr/due rings + head/size;
    # write addr/due/value rings + head/size; 6 request counters), with due
    # stamps rebased to "sweeps remaining" by the resumable program
    ports: list = field(default_factory=list)


def _snapshot_python(plan, graph_hash: str, sweep: int, fires, states,
                     caps: list, engine: str) -> GraphSnapshot:
    """Capture from live host state: channel deques + mmap buffers."""
    chans = []
    for ci, c in enumerate(plan.channels):
        shape = (caps[ci],) + c.shape
        buf = np.zeros(shape, canon_dtype(c.dtype))
        toks = list(c._q)
        if len(toks) > caps[ci]:
            raise ValueError(
                f"channel {c.name!r} holds {len(toks)} tokens at a sweep "
                f"boundary but snapshots reserve capacity {caps[ci]}")
        for i, t in enumerate(toks):
            buf[i] = _np(t)
        chans.append((buf, len(toks)))
    mmaps = [np.array(_np(_as_canon(m.data)), copy=True) for m in plan.mmaps]
    return GraphSnapshot(
        graph_hash=graph_hash, sweep=sweep,
        fires=np.asarray(fires, np.int32),
        states=[_tree_map(_np, s) for s in states],
        chans=chans, mmaps=mmaps, engine=engine)


def _snapshot_carry(plan, graph_hash: str, sweep: int, chans, states,
                    mmaps, fires, engine: str,
                    ports: tuple = ()) -> GraphSnapshot:
    """Capture from a resumable compiled carry read to the host (the carry
    *is* the snapshot; this only head-normalizes the rings).  Port rows
    copy verbatim (the program already rebased their due stamps to
    chunk-relative form)."""
    out_chans = []
    for (buf, head, size), c in zip(chans, plan.channels):
        b = np.asarray(buf)
        h, n = int(head), int(size)
        cap = b.shape[0]
        b = b[(h + np.arange(cap)) % cap]
        b[n:] = 0                       # canonical: tail slots zeroed
        out_chans.append((b, n))
    return GraphSnapshot(
        graph_hash=graph_hash, sweep=sweep,
        fires=np.asarray(fires, np.int32),
        states=[_tree_map(np.asarray, s) for s in states],
        mmaps=[np.asarray(m) for m in mmaps],
        chans=out_chans, engine=engine,
        ports=[[np.asarray(x) for x in pc] for pc in ports])


def _restore_python(plan, snap: GraphSnapshot, caps: list,
                    device: torch.device) -> None:
    """Write a snapshot back into live host state: channel deques refill
    (healing any torn mid-chunk pushes), with tokens on ``device``, and
    mmap buffers restore."""
    for ci, (c, (buf, size)) in enumerate(zip(plan.channels, snap.chans)):
        c.capacity = caps[ci]           # heal sequential capacity growth
        c._q = deque(torch.tensor(np.asarray(buf[i]), device=device)
                     for i in range(int(size)))
        c._eot_count = 0
        c._rwait.clear()
        c._wwait.clear()
    _restore_mmaps(plan, snap)


def _restore_mmaps(plan, snap: GraphSnapshot) -> None:
    for m, saved in zip(plan.mmaps, snap.mmaps):
        _copy_into(m, saved)


def _carry_from_snapshot(plan, snap: GraphSnapshot) -> tuple:
    """The rows :meth:`_SweepProgram.restore` takes: ``(fires, chans,
    states, mmaps, ports)``; a port graph's snapshot taken before ports
    were snapshotted restores fresh queues."""
    ports = snap.ports if len(snap.ports) == len(plan.ports) else \
        [_port_carry0(p) for p in plan.ports]
    return snap.fires, snap.chans, snap.states, snap.mmaps, ports


def _initial_snapshot(plan, graph_hash: str, caps: list,
                      engine: str) -> GraphSnapshot:
    """The sweep-0 snapshot: empty channels, initial states, and — the
    load-bearing part — a copy of every mmap's *initial* contents (and
    every port's backing buffer), so a restart can heal host buffers
    torn by a crash mid-chunk."""
    chans = [(np.zeros((caps[ci],) + c.shape, canon_dtype(c.dtype)), 0)
             for ci, c in enumerate(plan.channels)]
    return GraphSnapshot(
        graph_hash=graph_hash, sweep=0,
        fires=np.zeros((len(plan.tasks),), np.int32),
        states=[_tree_map(_np, tp.state0) for tp in plan.tasks],
        chans=chans,
        mmaps=[np.array(_np(_as_canon(m.data)), copy=True)
               for m in plan.mmaps],
        engine=engine,
        ports=[_port_carry0(p) for p in plan.ports])


# ---------------------------------------------------------------------------
# persistence (CheckpointManager-backed)
# ---------------------------------------------------------------------------

def _indexed(items) -> dict:
    """A list as the dict the checkpoint tree holds: keys "0", "1", ..."""
    return {str(i): x for i, x in enumerate(items)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _port_like(port: AsyncMMap) -> dict:
    """Meta tensors of ``port``'s rows, as :func:`_port_carry0` lays
    them out."""
    shape, dt, d = tuple(port.shape), _torch_dtype(port.dtype), port.depth
    i32 = torch.int32
    rows = [_meta(shape, dt)] + [_meta((d,), i32)] * 2 + \
        [_meta((), i32)] * 2 + [_meta((d,), i32)] * 2 + \
        [_meta((d,) + shape[1:], dt)] + [_meta((), i32)] * 8
    return _indexed(rows)


class SnapshotStore:
    """Persist :class:`GraphSnapshot` objects through the digest-verified
    checkpoint path: atomic tmp→rename publish, per-leaf sha256 manifests,
    and restore-latest falling past corrupt snapshots.  Snapshots are
    keyed by sweep number (the "step") and carry the graph's structural
    hash in the manifest — a snapshot of a *different* graph, or one that
    does not load into this graph's rows, is never restored.

    The tree is the reference's — ``fires``, ``chans`` (``buf``, ``size``
    each), ``states``, ``mmaps``, and ``ports`` only for a graph with
    ports — with each list held as a dict keyed by position, as the port's
    checkpoint trees are dicts."""

    def __init__(self, directory, keep: int = 3, faults: Any = None):
        self.mgr = CheckpointManager(directory, keep=keep, faults=faults)

    @staticmethod
    def _like(plan, caps: list) -> dict:
        tree = {
            "fires": _meta((len(plan.tasks),), torch.int32),
            "chans": _indexed(
                {"buf": _meta((caps[ci],) + c.shape, _torch_dtype(c.dtype)),
                 "size": _meta((), torch.int32)}
                for ci, c in enumerate(plan.channels)),
            "states": _indexed(
                _indexed(_as_canon(x).to("meta") for x in _leaves(tp.state0))
                for tp in plan.tasks),
            "mmaps": _indexed(_meta(tuple(m.shape), _torch_dtype(m.dtype))
                              for m in plan.mmaps),
        }
        if plan.ports:
            # schema rows for the latency queue — present only for port
            # graphs, so port-free snapshots keep the port-free schema
            tree["ports"] = _indexed(_port_like(p) for p in plan.ports)
        return tree

    def save(self, snap: GraphSnapshot) -> None:
        tree = {
            "fires": _host_tensor(np.asarray(snap.fires, np.int32)),
            "chans": _indexed({"buf": _host_tensor(buf),
                               "size": _host_tensor(np.int32(size))}
                              for buf, size in snap.chans),
            "states": _indexed(_indexed(_host_tensor(x) for x in _leaves(s))
                               for s in snap.states),
            "mmaps": _indexed(_host_tensor(m) for m in snap.mmaps),
        }
        if snap.ports:
            tree["ports"] = _indexed(_indexed(_host_tensor(x) for x in pc)
                                     for pc in snap.ports)
        self.mgr.save(snap.sweep, tree, {}, extra={
            "graph_hash": snap.graph_hash, "sweep": snap.sweep,
            "engine": snap.engine, **snap.meta})

    def load_latest(self, plan, graph_hash: str,
                    caps: Optional[list] = None) -> Optional[GraphSnapshot]:
        """The newest sound snapshot, if it is of this graph."""
        caps = caps if caps is not None \
            else [c.capacity for c in plan.channels]
        like = self._like(plan, caps)
        try:
            got = self.mgr.restore_latest(like, {}, device="cpu")
        except Exception:
            # a snapshot of a structurally different graph in this
            # directory: its leaf files don't line up with our like-tree.
            # Treat as "no usable snapshot" rather than poisoning the run.
            return None
        if got is None:
            return None
        step, tree, _, extra = got
        return self._snapshot(plan, graph_hash, like, step, tree, extra)

    def load(self, step: int, plan, graph_hash: str,
             caps: Optional[list] = None) -> Optional[GraphSnapshot]:
        """The snapshot saved at sweep ``step``, if it is of this graph."""
        caps = caps if caps is not None \
            else [c.capacity for c in plan.channels]
        like = self._like(plan, caps)
        try:
            tree, _, extra = self.mgr.restore(step, like, {}, device="cpu")
        except Exception:
            return None
        return self._snapshot(plan, graph_hash, like, step, tree, extra)

    @staticmethod
    def _snapshot(plan, graph_hash: str, like: dict, step: int, tree: dict,
                  extra: dict) -> Optional[GraphSnapshot]:
        if extra.get("graph_hash") != graph_hash:
            return None

        def shapes(t):
            if isinstance(t, dict):
                return {k: shapes(v) for k, v in t.items()}
            return tuple(t.shape)
        if shapes(tree) != shapes(like):
            return None
        rows = lambda d: [d[str(i)] for i in range(len(d))]  # noqa: E731
        return GraphSnapshot(
            graph_hash=graph_hash,
            sweep=int(extra.get("sweep", step)),
            fires=tree["fires"].numpy().astype(np.int32),
            states=[_unflatten(tp.state0, [x.numpy() for x in rows(s)])
                    for tp, s in zip(plan.tasks, rows(tree["states"]))],
            chans=[(c["buf"].numpy(), int(c["size"]))
                   for c in rows(tree["chans"])],
            mmaps=[m.numpy() for m in rows(tree["mmaps"])],
            engine=str(extra.get("engine", "")),
            ports=[[x.numpy() for x in rows(pc)]
                   for pc in rows(tree.get("ports", {}))])


# ---------------------------------------------------------------------------
# the abstract schedule (pure-Python replay of the compiled sweep)
# ---------------------------------------------------------------------------

def _abstract_schedule(plan) -> tuple[list, bool]:
    """Replay the compiled sweep's semantics over token counts alone.

    Returns ``(cuts, stalled)``: ``cuts[s]`` is the per-task firing vector
    after ``s`` sweeps (``cuts[0]`` all-zero), mirroring the compiled
    sweep exactly — plan-order task iteration, *start-of-sweep* guard
    visibility (the ``sweep_guards`` semantics: every task's fire
    predicate is computed from the occupancy vector as the sweep begins,
    then effects apply in task order), bounds-based phase selection,
    read-available / write-fits guards — so ``cuts[s]`` equals the
    compiled ``fires`` after ``s`` sweeps and is a consistent cut for
    every engine.

    Port graphs replay the service step too (after the task loop, in the
    service's exact order: deliver due reads, deliver due writes, accept
    reads, accept writes — up to ``depth`` each): the in-flight windows
    are pure-Python FIFOs of due sweeps, and sweeps where the only
    progress is an in-flight request maturing ("waiting") append
    duplicate cut entries, exactly like the compiled loop.

    ``stalled`` is True when the schedule stopped making progress before
    every task fired out (the abstract twin of the compiled stall /
    simulated deadlock)."""
    caps = [c.capacity for c in plan.channels]
    sizes = [0] * len(caps)
    fires = [0] * len(plan.tasks)
    totals = [tp.total for tp in plan.tasks]
    cuts = [tuple(fires)]
    read_q = [[] for _ in plan.ports]     # due sweeps, FIFO per port
    write_q = [[] for _ in plan.ports]
    sweeps = 0
    while any(f < t for f, t in zip(fires, totals)) or \
            any(read_q[pi] or write_q[pi] for pi in range(len(plan.ports))):
        progress = False
        sizes0 = list(sizes)    # start-of-sweep snapshot (fused guards)
        for ti, tp in enumerate(plan.tasks):
            f = fires[ti]
            if f >= totals[ti]:
                continue
            phase = sum(f >= b for b in tp.bounds[:-1])
            ph = tp.phases[phase]
            ok = all(sizes0[ci] >= r for ci, r in ph.reads.items()) and \
                all(caps[ci] - sizes0[ci] >= w
                    for ci, w in ph.writes.items())
            if ok:
                for ci, r in ph.reads.items():
                    sizes[ci] -= r
                for ci, w in ph.writes.items():
                    sizes[ci] += w
                fires[ti] = f + 1
                progress = True
        for pi, port in enumerate(plan.ports):
            d, lat = port.depth, port.latency
            ra, rd, wa, wd, wr = plan.port_chan_ids[pi]
            for _ in range(d):          # deliver due reads
                if read_q[pi] and read_q[pi][0] <= sweeps \
                        and sizes[rd] < caps[rd]:
                    read_q[pi].pop(0)
                    sizes[rd] += 1
                    progress = True
            for _ in range(d):          # deliver due writes
                if write_q[pi] and write_q[pi][0] <= sweeps \
                        and sizes[wr] < caps[wr]:
                    write_q[pi].pop(0)
                    sizes[wr] += 1
                    progress = True
            for _ in range(d):          # accept queued reads
                if sizes[ra] > 0 and len(read_q[pi]) < d:
                    sizes[ra] -= 1
                    read_q[pi].append(sweeps + lat)
                    progress = True
            for _ in range(d):          # accept queued writes (addr+value)
                if sizes[wa] > 0 and sizes[wd] > 0 and len(write_q[pi]) < d:
                    sizes[wa] -= 1
                    sizes[wd] -= 1
                    write_q[pi].append(sweeps + lat)
                    progress = True
            # an in-flight request due in the future counts as progress
            # pending, same as the compiled ``waiting`` flag
            progress = progress or any(
                due > sweeps for due in read_q[pi] + write_q[pi])
        if not progress:
            return cuts, True
        cuts.append(tuple(fires))
        sweeps += 1
    return cuts, False


def _reset_endpoints(plan) -> None:
    """Clear channel endpoint bindings so the same channel objects can be
    re-bound by the next chunk's fresh task instances (elaboration and
    every chunk each create their own :class:`TaskInstance` set; the
    one-producer/one-consumer rule is enforced per chunk)."""
    for c in plan.channels:
        c.producer = c.consumer = c.parent = None
        c._rwait.clear()
        c._wwait.clear()


# ---------------------------------------------------------------------------
# chunk execution
# ---------------------------------------------------------------------------

def _chunk_task_body(tp, start: int, stop: int, states: list,
                     ti: int) -> Callable:
    """A task body that runs firings ``start..stop`` of one StepTask
    instance against live blocking streams — the per-chunk slice of the
    simulation twin.  State is carried across chunks in ``states``."""
    bounds = tp.bounds
    phases = tp.phases

    def body(*args, **kwargs):
        views = tuple(_twin_view(a) for a in args)
        kw = {k: _twin_view(v) for k, v in kwargs.items()}
        state = states[ti]
        for f in range(start, stop):
            pi = 0
            while f >= bounds[pi]:
                pi += 1
            state = phases[pi].fn(state, *views, **kw)
        states[ti] = state

    body.__name__ = tp.inst.name.split("#", 1)[0]
    return body


def _run_python_chunk(plan, engine: str, fires0, fires1, states: list,
                      faults: Optional[FaultInjector],
                      device: torch.device) -> SimReport:
    """One chunk under a Python engine; ``states`` (each task's state on
    ``device``) is updated only when the chunk succeeds."""
    _reset_endpoints(plan)
    states_dev = [to_torch_state(s, device) for s in states]

    def recovery_chunk():
        tb = task()
        for ti, tp in enumerate(plan.tasks):
            tb.invoke(_chunk_task_body(tp, int(fires0[ti]), int(fires1[ti]),
                                       states_dev, ti),
                      *tp.inst.args, name=tp.inst.name, **tp.inst.kwargs)

    rep = ENGINES[engine](faults=faults).run(recovery_chunk)
    if rep.ok:
        for ti in range(len(plan.tasks)):
            states[ti] = states_dev[ti]
    return rep


def _synth_report(engine: str, ok: bool, wall: float, err: Optional[str],
                  result: Any, switches: int, plan,
                  failure: Optional[BaseException] = None) -> SimReport:
    return SimReport(
        engine=engine, ok=ok, wall_s=wall, switches=switches,
        n_instances=len(plan.tasks), n_channels=len(plan.channels),
        tokens=0, error=err, result=result, failure=failure)


@dataclass
class AttemptLog:
    """What one :func:`run_recoverable` call did, for measurement: the
    engine, the sweep it started from, and per chunk its sweeps; per saved
    snapshot its sweep, bytes, whether it holds a full channel or an
    in-flight port request, and the host ms of its read (device to host,
    compiled) and of the store's save; the ms of the restore (the store's
    load and, compiled, the in-place copy into the carry); the compiled
    program's captures, replays and host syncs; whether it crashed."""

    engine: str
    start_sweep: int = 0
    chunks: list = field(default_factory=list)       # sweeps a chunk
    saves: list = field(default_factory=list)        # dict a snapshot
    restore_ms: float = 0.0
    captures: int = 0
    replays: int = 0
    host_syncs: int = 0
    crashed: bool = False


def _snapshot_facts(plan, snap: GraphSnapshot) -> dict:
    caps = [c.capacity for c in plan.channels]
    return dict(
        sweep=snap.sweep,
        bytes=int(sum(np.asarray(b).nbytes for b, _ in snap.chans)
                  + sum(np.asarray(m).nbytes for m in snap.mmaps)
                  + sum(np.asarray(x).nbytes for s in snap.states
                        for x in _leaves(s))
                  + sum(np.asarray(x).nbytes for pc in snap.ports
                        for x in pc) + np.asarray(snap.fires).nbytes),
        full_channels=sum(int(n) == cap for (_, n), cap
                          in zip(snap.chans, caps)),
        inflight=sum(int(pc[4]) + int(pc[9]) for pc in snap.ports))


def run_recoverable(engine: str, top: Callable, *args,
                    store: Optional[SnapshotStore] = None,
                    snapshot_every: int = 8,
                    faults: Any = None, device: Any = None,
                    log: Optional[list] = None, **kwargs) -> SimReport:
    """Run a step-form graph in snapshot-bounded chunks.

    Elaborates the graph once (:func:`elaborate_step_graph` — raises
    :class:`SynthesisError` outside the step subset), derives the abstract
    sweep schedule, resumes from the latest matching snapshot in ``store``
    (if any), then executes chunk by chunk — snapshotting at every
    boundary.  A :class:`CrashFault` injected between chunks propagates to
    the caller (the supervisor's restart signal); everything the crash tore
    is healed by the snapshot restore on the next attempt.

    ``engine`` may be any of the four engines.  Under ``compiled`` the
    sweep's program is prepared once (on the card its CUDA graph is
    captured once), the snapshot is restored into its carry in place, and
    each chunk replays it for exactly the chunk's sweeps; the graph is
    closed on every exit, a crash included.  The sequential engine runs as
    a single chunk (its only quiescent points are start and finish: it
    cannot honor channel capacity mid-run, so intermediate cuts are not
    capturable) and fails on the same graphs plain sequential simulation
    fails on.

    ``device`` is where the run's tensors live: the card unless the caller
    asks for another (``device="cpu"``); it is not passed to ``top``.
    ``log``, a list, receives one :class:`AttemptLog`.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"choose from {sorted(ENGINES)}")
    dev = resolve_device(device)
    inj = faults.injector() if isinstance(faults, FaultPlan) else faults
    t0 = time.perf_counter()
    plan, graph, result = elaborate_step_graph(top, *args, **kwargs)
    if getattr(plan, "ports", None) and engine != "compiled":
        # compiled chunks carry the latency queue in the resumable carry
        # (snapshot rows since this schema); the Python engines'
        # event-driven port pumps cannot be cut at a sweep boundary by a
        # firing quota.  Refuse so the supervisor degrades to
        # restart-from-scratch (run_supervised).
        raise SynthesisError(
            f"recoverable execution of async_mmap ports "
            f"({[p.name for p in plan.ports]}) requires "
            f"engine='compiled': the simulation engines' in-flight port "
            f"requests live in the event heap, outside the sweep-"
            f"boundary snapshot; run engine='compiled' or under "
            f"restart-from-scratch supervision")
    ghash = graph.structural_hash()
    caps = [c.capacity for c in plan.channels]
    cuts, stalled = _abstract_schedule(plan)
    total_sweeps = len(cuts) - 1
    every = max(1, int(snapshot_every))
    if engine == "sequential":
        every = max(total_sweeps, 1)
    attempt = AttemptLog(engine=engine)
    if log is not None:
        log.append(attempt)

    def save(snap: GraphSnapshot, read_ms: Optional[float] = None) -> None:
        t = time.perf_counter()
        store.save(snap)
        attempt.saves.append(dict(_snapshot_facts(plan, snap),
                                  read_ms=read_ms, save_ms=(
                                      time.perf_counter() - t) * 1e3))

    t_restore = time.perf_counter()
    snap = store.load_latest(plan, ghash, caps) if store is not None \
        else None
    if snap is not None:
        if snap.sweep > total_sweeps or \
                not np.array_equal(snap.fires, np.asarray(cuts[snap.sweep],
                                                          np.int32)):
            snap = None             # stale/foreign snapshot: start over
    restore_ms = (time.perf_counter() - t_restore) * 1e3
    if snap is None:
        snap = _initial_snapshot(plan, ghash, caps, engine)
        if store is not None:
            save(snap)
    attempt.start_sweep = snap.sweep

    switches = 0
    try:
        if engine == "compiled":
            program = _SweepProgram(plan, dev)
            program.prepare(
                tuple(to_torch_state(tp.state0, dev) for tp in plan.tasks),
                tuple(_as_canon(m.data, dev).clone() for m in plan.mmaps),
                tuple(_as_canon(p.data, dev).clone() for p in plan.ports))
            try:
                t = time.perf_counter()
                program.carry.load(*_carry_from_snapshot(plan, snap))
                attempt.restore_ms = restore_ms + \
                    (time.perf_counter() - t) * 1e3
                last = None
                s0 = snap.sweep
                while s0 < total_sweeps:
                    if inj is not None:
                        inj.crash_point("chunk")
                    s1 = min(s0 + every, total_sweeps)
                    last = program.run_chunk(s1 - s0)
                    switches += last.sweeps
                    attempt.chunks.append(last.sweeps)
                    s0 = s1
                    if store is not None:
                        save(_snapshot_carry(plan, ghash, s0, last.chans,
                                             last.states, last.mmaps,
                                             last.fires, engine,
                                             ports=last.ports),
                             program.read_s * 1e3)
                    if not last.progress:
                        break
                if last is None:
                    last = program.read()
            finally:
                program.close()
                attempt.captures = program.n_captures
                attempt.replays = program.n_replays
                attempt.host_syncs = program.n_host_syncs
            # write device results back into the host buffers (all mmaps:
            # for a resumed-at-completion run this re-publishes the
            # snapshot)
            for m, out in zip(plan.mmaps, last.mmaps):
                _copy_into(m, out)
            for p, pc in zip(plan.ports, last.ports):
                _copy_into(p, pc[0])        # the port's buffer
            fires = np.asarray(last.fires, np.int32)
        else:
            _restore_python(plan, snap, caps, dev)
            attempt.restore_ms = restore_ms
            states = [to_torch_state(s, dev) for s in snap.states]
            s0 = snap.sweep
            fires = np.asarray(snap.fires, np.int32)
            while s0 < total_sweeps:
                if inj is not None:
                    inj.crash_point("chunk")
                s1 = min(s0 + every, total_sweeps)
                rep = _run_python_chunk(plan, engine, cuts[s0], cuts[s1],
                                        states, inj, dev)
                switches += rep.switches
                attempt.chunks.append(s1 - s0)
                if not rep.ok:
                    if isinstance(rep.failure, CrashFault):
                        raise rep.failure
                    return _synth_report(engine, False,
                                         time.perf_counter() - t0,
                                         rep.error, result, switches, plan,
                                         rep.failure)
                s0 = s1
                fires = np.asarray(cuts[s0], np.int32)
                if store is not None:
                    save(_snapshot_python(plan, ghash, s0, fires, states,
                                          caps, engine))
    except CrashFault:
        attempt.crashed = True
        raise

    totals = np.asarray([tp.total for tp in plan.tasks], np.int32)
    done = bool(np.all(fires >= totals))
    err = None
    if not done:
        blocked = [tp.inst.name for tp, f, t in zip(plan.tasks, fires,
                                                    totals) if f < t]
        err = (f"recoverable run stalled after {switches} sweeps; "
               f"blocked tasks: {blocked}")
    return _synth_report(engine, done, time.perf_counter() - t0, err,
                         result, switches, plan)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

@dataclass
class RestartPolicy:
    """Bounded-restart policy: at most ``max_restarts`` restarts, sleeping
    ``backoff_s * backoff_factor**k`` before the k-th one."""

    max_restarts: int = 3
    backoff_s: float = 0.01
    backoff_factor: float = 2.0


def run_supervised(engine: str, top: Callable, *args,
                   policy: Optional[RestartPolicy] = None,
                   store: Optional[SnapshotStore] = None,
                   snapshot_every: int = 8,
                   faults: Any = None, device: Any = None,
                   log: Optional[list] = None, **kwargs) -> SimReport:
    """Supervised execution: run, and on a :class:`CrashFault` restore the
    latest snapshot and restart — bounded restarts, exponential backoff.

    With ``store`` set and the graph inside the step subset, restarts
    resume from the last sweep-boundary snapshot (:func:`run_recoverable`,
    on ``device``: the card unless the caller asks for another).  With
    ``store`` unset, the run delegates *directly* to the plain engine
    (zero snapshot overhead) and a crash restarts from scratch.  Graphs
    outside the step subset (SynthesisError at elaboration) likewise fall
    back to restart-from-scratch supervision.  ``log``, a list, receives
    an :class:`AttemptLog` for each recoverable attempt.

    The fault injector is shared across attempts, so a ``FaultPlan.crash``
    site fires exactly once: the retried run sails past the crash point,
    which is precisely what the recovery parity tests assert.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"choose from {sorted(ENGINES)}")
    dev = resolve_device(device)
    policy = policy if policy is not None else RestartPolicy()
    inj = faults.injector() if isinstance(faults, FaultPlan) else faults
    use_chunks = store is not None
    restarts = 0
    delay = policy.backoff_s
    last_exc: Optional[BaseException] = None
    while True:
        try:
            if use_chunks:
                try:
                    return run_recoverable(
                        engine, top, *args, store=store,
                        snapshot_every=snapshot_every, faults=inj,
                        device=dev, log=log, **kwargs)
                except SynthesisError:
                    use_chunks = False      # outside the step subset
                    continue
            kw = {"device": dev} if engine == "compiled" else {}
            rep = ENGINES[engine](faults=inj, **kw).run(top, *args,
                                                        **kwargs)
            if rep.ok or not isinstance(rep.failure, CrashFault):
                return rep
            last_exc = rep.failure
        except CrashFault as e:
            last_exc = e
        restarts += 1
        if restarts > policy.max_restarts:
            raise CrashFault(
                f"supervised run still crashing after "
                f"{policy.max_restarts} restarts") from last_exc
        time.sleep(delay)
        delay *= policy.backoff_factor

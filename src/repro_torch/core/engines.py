"""Simulation engines (paper Section 3.2).

Three interchangeable engines run the same task bodies:

* :class:`SequentialEngine` — the Vivado-HLS-dataflow baseline: each task
  runs to completion at its invocation point.  Fast, but (a) channel
  capacity is not honored (writes never block — violations are *recorded*)
  and (b) a blocking read from a channel whose producer has not run yet
  fails.  This reproduces the paper's finding that sequential simulators
  cannot simulate feedback loops (cannon, page_rank).

* :class:`ThreadEngine` — the multi-thread baseline: one preemptive OS
  thread per task instance, condition-variable blocking.  Correct, but pays
  lock contention and OS/GIL context switches on every token.

* :class:`CoroutineEngine` — the paper's contribution: collaborative
  scheduling.  Exactly one task runs at a time; a task runs until *no
  progress can be made* (a channel op blocks), then control is handed to
  the next ready task (run-to-block).  Channel data structures need **no
  locking**, scheduling is deterministic (FIFO ready queue), and switches
  happen only at genuine dataflow stalls instead of at arbitrary
  preemption points.

All engines implement the runtime protocol used by streams::

    wait(chan, side)        block current task until side may be satisfiable
    push(chan, tok)         enqueue + wake readers
    pop(chan)               dequeue + wake writers
    push_burst(chan, toks)  enqueue a batch + one reader wake
    pop_burst(chan, n)      dequeue a batch + one writer wake
    spawn(inst)             launch a child task instance
    join(insts)             wait for non-detached children

plus two attributes streams read on the hot path:

    fast_path    True iff a stream op on a channel that can make progress
                 (and has no parked opposite-side waiter) may mutate the
                 deque directly, skipping engine dispatch entirely.  Safe
                 exactly when at most one task mutates channels at a time:
                 coroutine (one fiber runs) and sequential (one thread).
                 The thread engine must keep its lock, so never.
    track_stats  opt-in per-channel statistics (``total_written``/
                 ``total_read``/``max_occupancy``), aggregated at burst
                 granularity.  Enabling it disables ``fast_path`` so every
                 token is observed; the default leaves the hot path free of
                 bookkeeping.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .channel import Channel, READABLE, WRITABLE
from .context import clear_context, current_task, set_context
from .errors import (CrashFault, Deadlock, DeadlockError, DeadlockReport,
                     InjectedFault, SequentialSimulationError, TaskKilled)
from .faults import FaultInjector, FaultPlan
from .interface import AsyncMMap, MMap
from .task import (TaskInstance, bind_streams, builder_stack_depth,
                   join_pending_builders)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclass
class SimReport:
    """Outcome of one simulation run (consumed by benchmarks/sim_time.py).

    ``tokens`` and the per-channel tuples are only populated when the
    engine ran with ``track_stats=True``; the default run reports zeros.
    """
    engine: str
    ok: bool
    wall_s: float
    switches: int
    n_instances: int
    n_channels: int
    tokens: int
    capacity_violations: int = 0
    async_violations: int = 0   # sequential engine: sync-delivered requests
    error: Optional[str] = None
    instances: list = field(default_factory=list)
    channels: list = field(default_factory=list)
    # (name, kind, stats dict) per mmap/async_mmap interface; async_mmap
    # request counters (incl. max_outstanding_*) are always recorded, MMap
    # load/store counters only under track_stats
    interfaces: list = field(default_factory=list)
    result: Any = None      # return value of the top-level task body
    # structured no-progress diagnostic (DeadlockReport), populated whenever
    # the run failed with a deadlock / stall / watchdog trip; the legacy
    # ``error`` string is preserved unchanged for existing consumers
    deadlock: Any = None
    # the exception object behind a task-failure ``error`` string, when the
    # engine still holds it; lets supervisors (repro.ft.recovery) classify
    # failures — e.g. CrashFault vs. a genuine bug — without string matching
    failure: Optional[BaseException] = None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        s = "ok" if self.ok else f"FAILED({self.error})"
        return (f"<SimReport {self.engine} {s} wall={self.wall_s*1e3:.2f}ms "
                f"switches={self.switches} insts={self.n_instances} "
                f"tokens={self.tokens}>")


def _find_channels(obj: Any, acc: set,
                   ifaces: Optional[set] = None) -> None:
    if isinstance(obj, Channel):
        acc.add(obj)
    elif isinstance(obj, AsyncMMap):
        if ifaces is not None:
            ifaces.add(obj)
        acc.update(obj.channels())
    elif isinstance(obj, MMap):
        if ifaces is not None:
            ifaces.add(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _find_channels(v, acc, ifaces)
    elif isinstance(obj, dict):
        for v in obj.values():
            _find_channels(v, acc, ifaces)


class EngineBase:
    name = "base"

    def __init__(self, track_stats: bool = False,
                 faults: Optional[Any] = None,
                 watchdog_s: Optional[float] = None,
                 max_ticks: Optional[int] = None):
        self.instances: list[TaskInstance] = []
        self.channel_set: set[Channel] = set()
        self.interface_set: set = set()          # MMap/AsyncMMap objects
        self._ports: list[AsyncMMap] = []        # async ports needing pump
        self.switches = 0
        self.capacity_violations = 0
        self.async_violations = 0
        self.track_stats = track_stats
        self.fast_path = False
        # chaos harness (repro_torch.core.faults): accept a plan or an injector.
        # ``_chan_faults`` is non-None only when the plan actually targets
        # channel ops / task bodies, so the hot paths stay one `is None`
        # test (and subclasses keep fast_path) with a no-op injector.
        if isinstance(faults, FaultPlan):
            faults = faults.injector()
        self.faults: Optional[FaultInjector] = faults
        self._chan_faults = faults if (faults is not None and
                                       faults.affects_channels) else None
        # unified watchdog: wall-clock budget and/or logical-clock budget;
        # a trip raises DeadlockError with the same DeadlockReport payload
        # a genuine deadlock produces
        self.watchdog_s = watchdog_s
        self.max_ticks = max_ticks
        self._t0: Optional[float] = None
        self._deadlock_report: Optional[DeadlockReport] = None
        # async-response machinery (paper Table 2's async_mmap): a heap of
        # (due_tick, seq, deliver_fn) events over a logical clock that
        # advances with scheduling activity and fast-forwards when every
        # task is stalled waiting on memory
        self.clock = 0
        self._events: list = []
        self._event_seq = itertools.count()
        # sequential engine: responses must be delivered synchronously even
        # into a full response channel (it cannot wait) — the recorded
        # violation, mirroring its channel-capacity growth
        self.force_async = False
        # annotation-driven auto-wrap registry: one MMap wrapper per raw
        # buffer per run, so two tasks annotated `m: MMap` receiving the
        # same ndarray share a wrapper (one-writer enforceable) and the
        # wrapper shows up in interface_set like an explicit mmap
        self._adopted: dict[int, Any] = {}
        self._adopt_lock = threading.Lock()

    # -- runtime protocol (overridden) --------------------------------------
    def wait(self, chan: Channel, side: str) -> None:
        raise NotImplementedError

    def wait_many(self, keys: list) -> None:
        """Block until any (chan, side) in keys may be satisfiable —
        the engine-side primitive behind ``repro_torch.select`` (multi-port
        polling, Section 2.2's KPN extension)."""
        raise NotImplementedError

    def push(self, chan: Channel, tok: Any) -> None:
        raise NotImplementedError

    def pop(self, chan: Channel) -> Any:
        raise NotImplementedError

    def push_burst(self, chan: Channel, toks: list) -> None:
        raise NotImplementedError

    def pop_burst(self, chan: Channel, n: int) -> list:
        raise NotImplementedError

    def data_run(self, chan: Channel, limit: int) -> int:
        """How many head tokens a burst read may consume (see
        Channel._data_run).  Single-task engines read channel state
        directly; the thread engine overrides this to hold its lock, since
        the EoT-present path iterates the deque and a concurrent producer
        append would raise 'deque mutated during iteration'."""
        return chan._data_run(limit)

    def spawn(self, inst: TaskInstance) -> None:
        raise NotImplementedError

    def join(self, insts: list[TaskInstance]) -> None:
        raise NotImplementedError

    # -- async interface protocol (used by repro_torch.core.interface) -------------
    def schedule_async(self, delay: int, deliver: Callable) -> None:
        """Schedule ``deliver(engine)`` at ``clock + delay`` — the
        response half of an accepted async_mmap request.  ``deliver``
        returns False to be retried (response channel momentarily full)."""
        heapq.heappush(self._events,
                       (self.clock + delay, next(self._event_seq), deliver))

    def iface_pump(self, iface: AsyncMMap) -> None:
        """Offer queued requests to the memory model.  The thread engine
        overrides this to hold its lock; single-task engines go direct."""
        iface.pump(self)

    def adopt_mmap(self, data: Any, name: str) -> MMap:
        """Return this run's MMap wrapper for a raw buffer passed to an
        ``MMap``-annotated parameter, creating and registering it on first
        sight (keyed by buffer identity, which the registry entry pins)."""
        with self._adopt_lock:
            m = self._adopted.get(id(data))
            if m is None:
                m = MMap(data, name=name)
                self._adopted[id(data)] = m
                self.interface_set.add(m)
            return m

    def _iface_deliver(self, chan: Channel, tok: Any) -> None:
        """Memory-side push of a response token + reader wakeup."""
        raise NotImplementedError

    def _iface_pop(self, chan: Channel) -> Any:
        """Memory-side pop of an accepted request token + writer wakeup."""
        raise NotImplementedError

    def _deliver_due(self) -> int:
        """Run every event due at the current clock; returns how many
        actually delivered.  Deferred deliveries (full response channel)
        are requeued one tick ahead so a later pass retries them."""
        delivered = 0
        requeue = []
        while self._events and self._events[0][0] <= self.clock:
            _, _, fn = heapq.heappop(self._events)
            if fn(self):
                delivered += 1
            else:
                requeue.append((self.clock + 1, next(self._event_seq), fn))
        for ev in requeue:
            heapq.heappush(self._events, ev)
        return delivered

    def _fast_forward(self) -> bool:
        """No task can run: advance the clock through pending responses,
        in due order, until one delivers.  A deferred delivery (full
        response FIFO on a flooded port) must not mask a later-due event
        on a *different* port, so every event pending at entry gets one
        attempt.  Returns False only when none delivered — a genuine
        deadlock."""
        budget = len(self._events)      # each entry event tried at most once
        requeue = []
        delivered = False
        while self._events and budget > 0 and not delivered:
            due, _, fn = heapq.heappop(self._events)
            budget -= 1
            if due > self.clock:
                self.clock = due
            if fn(self):
                delivered = True
            else:
                requeue.append((self.clock + 1, next(self._event_seq), fn))
        for ev in requeue:
            heapq.heappush(self._events, ev)
        return delivered

    # -- shared helpers ------------------------------------------------------
    def _blocked_sites(self) -> list:
        return [(i.name, i.wait_site or "?") for i in self.instances
                if i.state == "blocked" and not i.detach]

    def _make_deadlock(self, reason: str,
                       blocked: Optional[list] = None) -> DeadlockReport:
        """Build (and remember) the structured no-progress report; the
        engine's failure path attaches it to ``SimReport.deadlock``."""
        occ = {c.name: c.size()
               for c in sorted(self.channel_set, key=lambda c: c.uid)}
        rep = DeadlockReport(
            engine=self.name, reason=reason,
            blocked=blocked if blocked is not None else self._blocked_sites(),
            occupancy=occ, clock=self.clock, switches=self.switches,
            wall_s=(time.perf_counter() - self._t0) if self._t0 else 0.0)
        self._deadlock_report = rep
        return rep

    def _watchdog_reason(self) -> Optional[str]:
        if self.max_ticks is not None and self.clock > self.max_ticks:
            return "tick-budget"
        if self.watchdog_s is not None and self._t0 is not None and \
                time.perf_counter() - self._t0 > self.watchdog_s:
            return "watchdog"
        return None

    def _stat_push(self, chan: Channel, k: int) -> None:
        """Burst-granular write statistics (one update per batch)."""
        chan.total_written += k
        occ = len(chan._q)
        if occ > chan.max_occupancy:
            chan.max_occupancy = occ

    def _check_spec(self, chan: Channel, toks) -> None:
        """Element-spec enforcement (``Channel(dtype=..., shape=...)``).

        Called by the engines' push paths under ``track_stats`` — the same
        opt-in that disables the fast path, so every token is observed.
        The error names the channel and the pushing task."""
        if chan.has_spec():
            inst = current_task()
            for t in toks:
                chan.check_token(t, inst)

    def _register(self, inst: TaskInstance) -> None:
        self.instances.append(inst)
        found_if: set = set()
        _find_channels(inst.args, self.channel_set, found_if)
        _find_channels(inst.kwargs, self.channel_set, found_if)
        for it in found_if:
            if it in self.interface_set:
                continue
            # first sighting under THIS engine: clear run-scoped binding
            # state so a host-created interface re-simulates cleanly
            it._reset_run()
            self.interface_set.add(it)
            if isinstance(it, AsyncMMap):
                self._ports.append(it)

    def _report(self, ok: bool, wall: float, err: Optional[str],
                result: Any = None,
                failure: Optional[BaseException] = None) -> SimReport:
        chans = sorted(self.channel_set, key=lambda c: c.uid)
        ifaces = sorted(self.interface_set, key=lambda i: i.uid)
        return SimReport(
            engine=self.name, ok=ok, wall_s=wall, switches=self.switches,
            n_instances=len(self.instances), n_channels=len(chans),
            tokens=sum(c.total_written for c in chans),
            capacity_violations=self.capacity_violations,
            async_violations=self.async_violations,
            error=err,
            instances=[(i.name, i.state) for i in self.instances],
            channels=[(c.name, c.total_written, c.max_occupancy)
                      for c in chans],
            interfaces=[(i.name, i.iface_kind, i.stats()) for i in ifaces],
            result=result,
            deadlock=self._deadlock_report,
            failure=failure,
        )

    def run(self, top: Callable, *args, **kwargs) -> SimReport:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# sequential engine (Vivado-HLS dataflow baseline)
# ---------------------------------------------------------------------------

class SequentialEngine(EngineBase):
    """Run each task to completion at its invocation point (paper S3.2)."""

    name = "sequential"

    def __init__(self, track_stats: bool = False, **kw):
        super().__init__(track_stats, **kw)
        # single thread, exclusive by construction: direct deque ops are
        # safe whenever stats don't need to observe every token; channel
        # faults need every op observed too
        self.fast_path = not track_stats and self._chan_faults is None
        self.force_async = True
        self._cur: Optional[TaskInstance] = None

    # async interfaces: a task runs to completion at its invocation point,
    # so a response can never be overlapped with other work — deliver it
    # synchronously at accept time and *record* the violation (the same
    # documented degradation as growing channel capacity above)
    def schedule_async(self, delay: int, deliver: Callable) -> None:
        self.async_violations += 1
        deliver(self)

    def _iface_deliver(self, chan: Channel, tok: Any) -> None:
        chan._push(tok)
        if self.track_stats:
            self._stat_push(chan, 1)

    def _iface_pop(self, chan: Channel) -> Any:
        if self.track_stats:
            chan.total_read += 1
        return chan._pop()

    # blocking ops ----------------------------------------------------------
    def wait(self, chan: Channel, side: str) -> None:
        self.clock += 1
        if self.watchdog_s is not None or self.max_ticks is not None:
            reason = self._watchdog_reason()
            if reason is not None:
                site = ("write " if side == WRITABLE else "read ") + chan.name
                name = self._cur.name if self._cur else "?"
                raise DeadlockError(
                    self._make_deadlock(reason, blocked=[(name, site)]))
        if side is WRITABLE or side == WRITABLE:
            # Sequential simulation cannot honor capacity: grow the channel
            # and record the violation (paper: "cannot correctly simulate
            # the capacity of channels").
            self.capacity_violations += 1
            chan.capacity = chan.size() + 1
            return
        # Blocking read from an empty channel: the producer either already
        # finished (true starvation) or is invoked later (the feedback /
        # invocation-order failure the paper documents).
        inst = self._cur
        if inst is not None and inst.detach:
            raise TaskKilled()
        name = inst.name if inst else "?"
        self._make_deadlock("sequential-read",
                            blocked=[(name, f"read {chan.name}")])
        raise SequentialSimulationError(
            f"sequential simulation cannot make progress: "
            f"{name} blocked reading "
            f"{chan.name!r} (feedback loop or invocation-order dependence)")

    def wait_many(self, keys: list) -> None:
        # Sequential execution cannot poll: nothing can change while this
        # task holds the (only) thread.  A writable side can be "satisfied"
        # by growing the channel (the capacity-violation fallback); a pure
        # read-wait is the documented failure mode.
        for chan, side in keys:
            if side == WRITABLE:
                return self.wait(chan, side)
        return self.wait(keys[0][0], keys[0][1])

    def _fault_op(self, chan: Channel, op: str) -> None:
        """Consult the chaos harness for one task-side op.  A stall is a
        pure logical-clock advance here (nothing to overlap with); wake
        delays are meaningless (no waiters ever park), but the consult
        keeps the per-site counters — and hence the injected *decisions* —
        identical to the concurrent engines."""
        stall, _ = self._chan_faults.chan_op(
            chan.name, op, self._cur.name if self._cur else "?")
        if stall:
            self.clock += stall

    def push(self, chan: Channel, tok: Any) -> None:
        if self._chan_faults is not None:
            self._fault_op(chan, "push")
        if self.track_stats:
            self._check_spec(chan, (tok,))
        chan._push(tok)
        if self.track_stats:
            self._stat_push(chan, 1)

    def pop(self, chan: Channel) -> Any:
        if self._chan_faults is not None:
            self._fault_op(chan, "pop")
        if self.track_stats:
            chan.total_read += 1
        return chan._pop()

    def push_burst(self, chan: Channel, toks: list) -> None:
        if self._chan_faults is not None:
            self._fault_op(chan, "push_burst")
        if self.track_stats:
            self._check_spec(chan, toks)
        chan._q.extend(toks)
        if self.track_stats:
            self._stat_push(chan, len(toks))

    def pop_burst(self, chan: Channel, n: int) -> list:
        if self._chan_faults is not None:
            self._fault_op(chan, "pop_burst")
        q = chan._q
        if self.track_stats:
            chan.total_read += n
        if n == len(q):
            out = list(q)
            q.clear()
            return out
        return [q.popleft() for _ in range(n)]

    # task management --------------------------------------------------------
    def spawn(self, inst: TaskInstance) -> None:
        self._register(inst)
        self._exec(inst)

    def join(self, insts: list[TaskInstance]) -> None:
        # children already ran to completion at spawn
        for i in insts:
            if i.state == "failed" and i.error is not None:
                raise i.error

    def _exec(self, inst: TaskInstance) -> Any:
        prev = self._cur
        self._cur = inst
        set_context(self, inst)
        self.switches += 1
        depth = builder_stack_depth()
        inst.state = "running"
        out = None
        try:
            a, k = bind_streams(inst)
            out = inst.fn(*a, **k)
            join_pending_builders(depth)
            inst.state = "finished"
        except TaskKilled:
            inst.state = "finished"   # detached task ran out of input
        except BaseException as e:
            inst.state = "failed"
            inst.error = e
            raise
        finally:
            self._cur = prev
            set_context(self, prev)
        return out

    def run(self, top: Callable, *args, **kwargs) -> SimReport:
        t0 = time.perf_counter()
        self._t0 = t0
        root = TaskInstance(top, args, kwargs, detach=False, parent=None,
                            name=getattr(top, "__name__", "top"))
        self._register(root)
        try:
            result = self._exec(root)
            return self._report(True, time.perf_counter() - t0, None, result)
        except (SequentialSimulationError, DeadlockError) as e:
            return self._report(False, time.perf_counter() - t0, str(e))
        except (InjectedFault, CrashFault) as e:
            # parity with the concurrent engines' task-failure reporting
            return self._report(False, time.perf_counter() - t0,
                                f"task error: {e!r}", failure=e)
        finally:
            clear_context()


# ---------------------------------------------------------------------------
# preemptive thread engine (multi-thread baseline)
# ---------------------------------------------------------------------------

class ThreadEngine(EngineBase):
    """One OS thread per task instance; preemptive scheduling (paper S3.2).

    ``fast_path`` stays False: preemption means two tasks can touch a
    channel concurrently, so every op must hold the engine lock — exactly
    the per-token synchronization cost the coroutine engine avoids.
    """

    name = "thread"

    def __init__(self, track_stats: bool = False, **kw):
        super().__init__(track_stats, **kw)
        # re-entrant: async_mmap request acceptance (iface_pump) nests
        # schedule_async/_iface_pop under the same lock
        self._lock = threading.RLock()
        self._conds: dict[tuple[int, str], threading.Condition] = {}
        self._finish_cond = threading.Condition(self._lock)
        self._threads: dict[int, threading.Thread] = {}
        self._started = 0          # threads whose body began executing
        self._blocked = 0          # tasks currently inside a wait
        self._chan_waiters: dict[tuple[int, str], Channel] = {}
        self._multi_waiters: dict[int, list] = {}     # uid -> [(chan, side)]
        self._any_cond = threading.Condition(self._lock)
        self._join_waiters: dict[int, list[TaskInstance]] = {}
        self._deadlocked = False
        self._stopping = False
        self._failure: Optional[BaseException] = None

    def _cond(self, chan: Channel, side: str) -> threading.Condition:
        key = (chan.uid, side)
        c = self._conds.get(key)
        if c is None:
            c = self._conds[key] = threading.Condition(self._lock)
        return c

    @staticmethod
    def _satisfied(chan: Channel, side: str) -> bool:
        return (not chan.is_empty()) if side == READABLE else \
               (not chan.is_full())

    def _live_unfinished(self) -> int:
        return sum(1 for i in self.instances
                   if i.state in ("running", "blocked"))

    def _any_nondetached_unfinished(self) -> bool:
        return any(i.state not in ("finished", "failed")
                   for i in self.instances if not i.detach)

    def _no_progress_possible(self) -> bool:
        """True iff every blocked task waits on an unsatisfiable condition.

        A task that was *notified* but has not yet re-acquired the lock is
        still counted blocked; checking condition satisfiability instead of
        raw counts avoids declaring a false deadlock in that window.
        """
        for (uid, side), chan in self._chan_waiters.items():
            if self._satisfied(chan, side):
                return False
        for keys in self._multi_waiters.values():
            if any(self._satisfied(c, s) for c, s in keys):
                return False
        for _, kids in self._join_waiters.items():
            if all(k.state in ("finished", "failed") for k in kids):
                return False
        return True

    def _maybe_end(self) -> None:
        """Called with the lock held whenever a task becomes blocked."""
        if self._blocked < self._live_unfinished() or \
                self._started < len(self.instances):
            return
        while self._no_progress_possible():
            # every task stalled: pending async memory responses are the
            # one legitimate way forward — fast-forward the clock and
            # deliver, repeating until some waiter becomes satisfiable
            # (the notifies wake it) or the event heap runs dry
            if self._events and self._fast_forward():
                continue
            if self._any_nondetached_unfinished():
                self._trigger_deadlock()
            else:
                self._trigger_stop()
            return

    # -- async interface protocol (lock-holding variants) --------------------
    def iface_pump(self, iface: AsyncMMap) -> None:
        with self._lock:
            iface.pump(self)

    def schedule_async(self, delay: int, deliver: Callable) -> None:
        with self._lock:
            super().schedule_async(delay, deliver)

    # lock already held on these paths (pump or _deliver_due); the RLock is
    # re-acquired re-entrantly.  These are memory-side ops, deliberately
    # not routed through push/pop: the chaos harness only perturbs
    # *task-side* channel ops (memory misbehaviour is mem_delay's job), and
    # a fault stall inside a lock-holding pump would block the whole run.
    def _iface_deliver(self, chan: Channel, tok: Any) -> None:
        with self._lock:
            chan._push(tok)
            if self.track_stats:
                self._stat_push(chan, 1)
            self._cond(chan, READABLE).notify()
            if self._multi_waiters:
                self._any_cond.notify_all()

    def _iface_pop(self, chan: Channel) -> Any:
        with self._lock:
            tok = chan._pop()
            if self.track_stats:
                chan.total_read += 1
            self._cond(chan, WRITABLE).notify()
            if self._multi_waiters:
                self._any_cond.notify_all()
            return tok

    # -- chaos-harness plumbing ---------------------------------------------
    def _fault_consult(self, chan: Channel, op: str):
        """Called outside the lock.  A stall becomes a real sleep (the
        preemptive analogue of yielding the processor) plus a logical-clock
        advance; the returned wake delay is applied by the caller."""
        inst = getattr(_thread_inst, "inst", None)
        stall, wake = self._chan_faults.chan_op(
            chan.name, op, inst.name if inst is not None else "?")
        if stall:
            time.sleep(stall * 1e-4)
            with self._lock:
                self.clock += stall
        return wake

    def _delayed_wake(self, chan: Channel, side: str):
        """Deliver fn for a fault-delayed wake-up: the token is already in
        the queue, only the notify travels through the event heap."""
        def deliver(eng, c=chan, s=side):
            eng._cond(c, s).notify()
            if eng._multi_waiters:
                eng._any_cond.notify_all()
            return True
        return deliver

    def wait(self, chan: Channel, side: str) -> None:
        cond = self._cond(chan, side)
        key = (chan.uid, side)
        with self._lock:
            self._check_abort()
            self.clock += 1
            if self.max_ticks is not None and not self._deadlocked and \
                    self._watchdog_reason() is not None:
                self._trigger_watchdog(self._watchdog_reason())
                self._check_abort()
            if self._events:
                self._deliver_due()
            if self._satisfied(chan, side):
                return                      # lost-wakeup guard
            inst = _thread_inst.inst
            inst.state = "blocked"
            inst.wait_site = \
                ("write " if side == WRITABLE else "read ") + chan.name
            self._blocked += 1
            self._chan_waiters[key] = chan
            try:
                self._maybe_end()
                self._check_abort()
                if self._satisfied(chan, side):
                    return      # _maybe_end's fast-forward delivered here
                self.switches += 1
                cond.wait()
                self._check_abort()
            finally:
                self._blocked -= 1
                self._chan_waiters.pop(key, None)
                if inst.state == "blocked":
                    inst.state = "running"

    def wait_many(self, keys: list) -> None:
        with self._lock:
            self._check_abort()
            self.clock += 1
            if self._events:
                self._deliver_due()
            if any(self._satisfied(c, s) for c, s in keys):
                return
            inst = _thread_inst.inst
            inst.state = "blocked"
            inst.wait_site = "select"
            self._blocked += 1
            self._multi_waiters[inst.uid] = keys
            try:
                self._maybe_end()
                self._check_abort()
                self.switches += 1
                while not any(self._satisfied(c, s) for c, s in keys):
                    self._any_cond.wait()
                    self._check_abort()
            finally:
                self._blocked -= 1
                self._multi_waiters.pop(inst.uid, None)
                if inst.state == "blocked":
                    inst.state = "running"

    def _check_abort(self) -> None:
        if self._deadlocked:
            if self._deadlock_report is not None:
                raise DeadlockError(self._deadlock_report)
            raise Deadlock("all tasks blocked; no progress possible")
        if self._stopping:
            raise TaskKilled()

    def _trigger_deadlock(self) -> None:
        if not self._deadlocked and self._failure is None and \
                self._deadlock_report is None:
            self._make_deadlock("deadlock")
        self._deadlocked = True
        self._notify_everything()

    def _trigger_watchdog(self, reason: str) -> None:
        """Lock held.  Same abort machinery as a deadlock, but the trip
        can fire while tasks are runnable (livelock / hang)."""
        self._make_deadlock(reason)
        self._deadlocked = True
        self._notify_everything()

    def _trigger_stop(self) -> None:
        self._stopping = True
        self._notify_everything()

    def _notify_everything(self) -> None:
        for c in self._conds.values():
            c.notify_all()
        self._any_cond.notify_all()
        self._finish_cond.notify_all()

    def push(self, chan: Channel, tok: Any) -> None:
        wake = self._fault_consult(chan, "push") \
            if self._chan_faults is not None else 0
        with self._lock:
            if self.track_stats:
                self._check_spec(chan, (tok,))
            chan._push(tok)
            if self.track_stats:
                self._stat_push(chan, 1)
            if wake:
                self.schedule_async(wake, self._delayed_wake(chan, READABLE))
            else:
                self._cond(chan, READABLE).notify()
                if self._multi_waiters:
                    self._any_cond.notify_all()

    def pop(self, chan: Channel) -> Any:
        wake = self._fault_consult(chan, "pop") \
            if self._chan_faults is not None else 0
        with self._lock:
            tok = chan._pop()
            if self.track_stats:
                chan.total_read += 1
            if wake:
                self.schedule_async(wake, self._delayed_wake(chan, WRITABLE))
            else:
                self._cond(chan, WRITABLE).notify()
                if self._multi_waiters:
                    self._any_cond.notify_all()
            return tok

    def push_burst(self, chan: Channel, toks: list) -> None:
        """Batch enqueue: one lock round-trip and one reader notify per
        burst instead of per token."""
        wake = self._fault_consult(chan, "push_burst") \
            if self._chan_faults is not None else 0
        with self._lock:
            if self.track_stats:
                self._check_spec(chan, toks)
            chan._q.extend(toks)
            if self.track_stats:
                self._stat_push(chan, len(toks))
            if wake:
                self.schedule_async(wake, self._delayed_wake(chan, READABLE))
            else:
                self._cond(chan, READABLE).notify()
                if self._multi_waiters:
                    self._any_cond.notify_all()

    def pop_burst(self, chan: Channel, n: int) -> list:
        wake = self._fault_consult(chan, "pop_burst") \
            if self._chan_faults is not None else 0
        with self._lock:
            q = chan._q
            if n == len(q):
                out = list(q)
                q.clear()
            else:
                out = [q.popleft() for _ in range(n)]
            if self.track_stats:
                chan.total_read += n
            if wake:
                self.schedule_async(wake, self._delayed_wake(chan, WRITABLE))
            else:
                self._cond(chan, WRITABLE).notify()
                if self._multi_waiters:
                    self._any_cond.notify_all()
            return out

    def data_run(self, chan: Channel, limit: int) -> int:
        with self._lock:
            return chan._data_run(limit)

    def spawn(self, inst: TaskInstance) -> None:
        with self._lock:
            self._register(inst)
        th = threading.Thread(target=self._body, args=(inst,),
                              name=inst.name, daemon=True)
        self._threads[inst.uid] = th
        th.start()

    def join(self, insts: list[TaskInstance]) -> None:
        with self._lock:
            inst = _thread_inst.inst
            while any(i.state not in ("finished", "failed") for i in insts):
                self._check_abort()
                inst.state = "blocked"
                inst.wait_site = "join"
                self._blocked += 1
                self._join_waiters[inst.uid] = insts
                try:
                    self._maybe_end()
                    self._check_abort()
                    self.switches += 1
                    self._finish_cond.wait()
                finally:
                    self._blocked -= 1
                    self._join_waiters.pop(inst.uid, None)
                    if inst.state == "blocked":
                        inst.state = "running"
            self._check_abort()
            for i in insts:
                if i.state == "failed" and i.error is not None and \
                        not isinstance(i.error, TaskKilled):
                    raise Deadlock(f"child task {i.name} failed: {i.error!r}")

    def _body(self, inst: TaskInstance) -> None:
        _thread_inst.inst = inst
        set_context(self, inst)
        with self._lock:
            self._started += 1
            inst.state = "running"
        depth = builder_stack_depth()
        try:
            a, k = bind_streams(inst)
            out = inst.fn(*a, **k)
            join_pending_builders(depth)
            with self._lock:
                inst.state = "finished"
                if inst.parent is None:
                    self._root_result = out
        except TaskKilled:
            with self._lock:
                inst.state = "finished"
        except Deadlock:
            with self._lock:
                inst.state = "failed"
        except BaseException as e:  # noqa: BLE001 - report any task failure
            with self._lock:
                inst.state = "failed"
                inst.error = e
                if self._failure is None:
                    self._failure = e
                self._trigger_deadlock()   # abort everything
        finally:
            with self._lock:
                if not self._any_nondetached_unfinished() and \
                        not self._deadlocked:
                    self._trigger_stop()
                else:
                    # a finishing producer may leave consumers permanently
                    # starved — re-run the end-state check
                    self._maybe_end()
                self._finish_cond.notify_all()
            clear_context()

    def run(self, top: Callable, *args, **kwargs) -> SimReport:
        t0 = time.perf_counter()
        self._t0 = t0
        self._root_result = None
        root = TaskInstance(top, args, kwargs, detach=False, parent=None,
                            name=getattr(top, "__name__", "top"))
        self.spawn(root)
        # wait for every non-detached task, then reap detached ones; the
        # run loop doubles as the wall-clock watchdog and — under channel
        # faults — as the pump that guarantees delayed wake-ups deliver
        # even when no task re-enters wait() (a satisfied-but-unnotified
        # waiter would otherwise strand: _no_progress_possible sees it as
        # satisfiable, so _maybe_end never fast-forwards for it)
        active = self.watchdog_s is not None or self._chan_faults is not None
        while True:
            with self._lock:
                if self._deadlocked or \
                        not self._any_nondetached_unfinished():
                    break
                if self._chan_faults is not None:
                    while self._events:
                        if not self._fast_forward():
                            break
                if self.watchdog_s is not None and not self._deadlocked:
                    reason = self._watchdog_reason()
                    if reason is not None:
                        self._trigger_watchdog(reason)
                        break
                self._finish_cond.wait(timeout=0.1 if active else 0.5)
        for uid, th in list(self._threads.items()):
            th.join(timeout=5.0)
        wall = time.perf_counter() - t0
        if self._failure is not None:
            return self._report(False, wall, f"task error: {self._failure!r}",
                                failure=self._failure)
        if self._deadlocked:
            rep = self._deadlock_report
            return self._report(False, wall,
                                rep.format() if rep is not None else "deadlock")
        return self._report(True, wall, None, self._root_result)


_thread_inst = threading.local()


# ---------------------------------------------------------------------------
# coroutine engine (the paper's contribution)
# ---------------------------------------------------------------------------

class _Fiber:
    """A cooperatively-scheduled execution context.

    Implemented over an OS thread that is *suspended at launch* and runs
    only when handed the baton — the pure-Python analogue of the paper's
    stackful coroutines ("a coroutine is launched but suspended
    immediately", S3.2).  Exactly one fiber (or the scheduler) is runnable
    at any instant, so channel state needs no locks.

    Switching is **symmetric**: a blocking fiber resumes the next ready
    fiber *directly* (one event signal per switch) instead of bouncing
    through the scheduler thread (two signals).  This is the user-level
    hand-off cost the paper contrasts with preemptive OS scheduling —
    the scheduler thread participates only at start, deadlock/termination
    detection and teardown.
    """

    __slots__ = ("inst", "engine", "sema", "thread", "killed", "done",
                 "wake_epoch")

    def __init__(self, inst: TaskInstance, engine: "CoroutineEngine"):
        self.inst = inst
        self.engine = engine
        # a counting semaphore is the cheapest exact-once baton in CPython
        # (C-level fast path, no condition-variable bookkeeping); the
        # epoch discipline in the engine guarantees single-resume, so the
        # count can never exceed one
        self.sema = threading.Semaphore(0)
        self.killed = False
        self.done = False
        self.wake_epoch = 0     # invalidates stale multi-wait queue entries
        self.thread = threading.Thread(target=self._main, name=inst.name,
                                       daemon=True)
        self.thread.start()

    # -- switching -----------------------------------------------------------
    def _handoff(self) -> None:
        """Pass the baton to the next ready fiber (or the scheduler when
        none is ready), without suspending self."""
        eng = self.engine
        nxt = eng._next_ready()
        if nxt is None:
            eng._sched_sema.release()  # scheduler: terminate/deadlock/kill
        else:
            eng.switches += 1
            nxt.sema.release()

    def _yield(self) -> None:
        """Block self: hand the baton off, then wait to be resumed."""
        self._handoff()
        self.sema.acquire()
        if self.killed:
            raise TaskKilled()

    def resume_from_scheduler(self) -> None:
        """Scheduler-side: run this fiber until control returns."""
        self.engine.switches += 1
        self.sema.release()
        self.engine._sched_sema.acquire()

    # -- body ----------------------------------------------------------------
    def _main(self) -> None:
        self.sema.acquire()      # suspended immediately at launch
        inst = self.inst
        set_context(self.engine, inst)
        _fiber_tls.fiber = self
        inst.state = "running"
        depth = builder_stack_depth()
        try:
            if self.killed:
                raise TaskKilled()
            a, k = bind_streams(inst)
            out = inst.fn(*a, **k)
            join_pending_builders(depth)
            inst.state = "finished"
            if inst.parent is None:
                self.engine._root_result = out
        except TaskKilled:
            inst.state = "finished"
        except BaseException as e:  # noqa: BLE001
            inst.state = "failed"
            inst.error = e
            if self.engine._failure is None:
                self.engine._failure = e
        finally:
            self.done = True
            clear_context()
            self.engine._on_fiber_finished(self)
            if self.engine._failure is not None:
                self.engine._sched_sema.release()  # abort: scheduler's baton
            else:
                self._handoff()                # pass baton; thread exits


_fiber_tls = threading.local()


class CoroutineEngine(EngineBase):
    """Collaborative run-to-block scheduler (paper Section 3.2).

    Determinism: the ready queue is FIFO over spawn/wake order, wake order
    is FIFO per channel side, and only one fiber runs at a time, so a given
    program produces the identical schedule on every run.

    Lock-free fast path: because exactly one fiber is runnable, a channel
    op that can make progress needs neither a lock nor engine dispatch —
    streams mutate the deque directly (``fast_path``).  The engine is
    entered only at genuine stalls (``wait``) and for wakeups, which are
    O(1): waiters park in per-channel deques (``Channel._rwait``/
    ``_wwait``), and the one-producer/one-consumer rule means each side
    holds at most one live entry.  Burst ops wake at most once per batch,
    and the wake epoch coalesces redundant wakes of an already-scheduled
    fiber, cutting the switch count to the dataflow-stall minimum.
    """

    name = "coroutine"

    def __init__(self, track_stats: bool = False, **kw):
        super().__init__(track_stats, **kw)
        # channel faults need every op observed, same as stats
        self.fast_path = not track_stats and self._chan_faults is None
        self._ready: deque[_Fiber] = deque()
        self._parked: set[Channel] = set()   # channels holding waiter entries
        self._fibers: dict[int, _Fiber] = {}
        self._join_pending: dict[int, int] = {}     # fiber uid -> #children
        self._child_to_joiner: dict[int, _Fiber] = {}
        self._sched_sema = threading.Semaphore(0)
        self._failure: Optional[BaseException] = None
        self._root_result: Any = None
        self._tearing = False

    def _next_ready(self) -> Optional["_Fiber"]:
        if self._tearing:
            return None                   # teardown: baton -> scheduler
        if not self._ports and not self._events:
            # no async interfaces in the program: zero-overhead path
            while self._ready:
                f = self._ready.popleft()
                if not f.done:
                    return f
            return None
        while True:
            # service step: the clock ticks once per scheduling decision,
            # queued requests are accepted, due responses delivered (their
            # wakes append to the ready queue)
            self.clock += 1
            for port in self._ports:
                port.pump(self)
            if self._events:
                self._deliver_due()
            while self._ready:
                f = self._ready.popleft()
                if not f.done:
                    return f
            # nothing runnable: fast-forward to the next memory response;
            # if that delivers nothing the stall is a genuine deadlock
            if not self._fast_forward():
                return None

    # -- async interface protocol --------------------------------------------
    def _iface_deliver(self, chan: Channel, tok: Any) -> None:
        chan._push(tok)
        if self.track_stats:
            self._stat_push(chan, 1)
        if chan._rwait:
            self._wake(chan._rwait)

    def _iface_pop(self, chan: Channel) -> Any:
        tok = chan._pop()
        if self.track_stats:
            chan.total_read += 1
        if chan._wwait:
            self._wake(chan._wwait)
        return tok

    # -- runtime protocol ----------------------------------------------------
    def wait(self, chan: Channel, side: str) -> None:
        fiber: _Fiber = _fiber_tls.fiber
        site = ("write " if side == WRITABLE else "read ") + chan.name
        if self.watchdog_s is not None or self.max_ticks is not None:
            self._watchdog_check(fiber, site)
        fiber.inst.state = "blocked"
        fiber.inst.wait_site = site
        wq = chan._rwait if side == READABLE else chan._wwait
        wq.append((fiber, fiber.wake_epoch))
        self._parked.add(chan)
        fiber._yield()
        fiber.inst.state = "running"

    def wait_many(self, keys: list) -> None:
        """Multi-port wait: register in every key's waiter queue; the first
        event on any of them wakes the fiber and the epoch stamp marks the
        other registrations stale."""
        fiber: _Fiber = _fiber_tls.fiber
        if self.watchdog_s is not None or self.max_ticks is not None:
            self._watchdog_check(fiber, "select")
        fiber.inst.state = "blocked"
        fiber.inst.wait_site = "select"
        e = fiber.wake_epoch
        for chan, side in keys:
            wq = chan._rwait if side == READABLE else chan._wwait
            wq.append((fiber, e))
            self._parked.add(chan)
        fiber._yield()
        fiber.inst.state = "running"

    def _watchdog_check(self, fiber: "_Fiber", site: str) -> None:
        """Raise DeadlockError inside the blocking fiber on a tripped
        budget — it surfaces as ``_failure`` and aborts the run with the
        structured report attached.  The tripping fiber is included in the
        blocked list (it is the task *about to* block)."""
        if self.max_ticks is not None:
            # the zero-overhead scheduling path never ticks the clock, so a
            # tick budget counts blocking waits instead (chaos runs only —
            # watchdog-less runs keep the clock untouched)
            self.clock += 1
        reason = self._watchdog_reason()
        if reason is None:
            return
        blocked = self._blocked_sites()
        blocked.append((fiber.inst.name, site))
        raise DeadlockError(self._make_deadlock(reason, blocked=blocked))

    # -- chaos-harness plumbing ---------------------------------------------
    def _fault_consult(self, chan: Channel, op: str):
        """Consult the injector *before* the op mutates anything, so an
        InjectedFault leaves the channel untouched."""
        fiber = getattr(_fiber_tls, "fiber", None)
        return self._chan_faults.chan_op(
            chan.name, op, fiber.inst.name if fiber is not None else "?")

    def _fault_stall(self, ticks: int) -> None:
        """Post-op stall: yield the baton ``ticks`` times (each round trips
        through the ready queue, letting other fibers run — the
        collaborative analogue of losing the processor)."""
        fiber = getattr(_fiber_tls, "fiber", None)
        if fiber is None:
            return
        for _ in range(ticks):
            self._schedule(fiber)
            fiber._yield()

    def _fault_wake(self, chan: Channel, side: str):
        """Deliver fn for a fault-delayed wake-up: the token is already in
        the queue, only the wake travels through the event heap (delivery
        is guaranteed — _next_ready fast-forwards pending events before
        ever declaring a deadlock)."""
        def deliver(eng, c=chan, s=side):
            wq = c._rwait if s == READABLE else c._wwait
            eng._wake(wq)
            return True
        return deliver

    def push(self, chan: Channel, tok: Any) -> None:
        stall = wake = 0
        if self._chan_faults is not None:
            stall, wake = self._fault_consult(chan, "push")
        if self.track_stats:
            self._check_spec(chan, (tok,))
        chan._push(tok)              # no lock: exclusivity by construction
        if self.track_stats:
            self._stat_push(chan, 1)
        if chan._rwait:
            if wake:
                self.schedule_async(wake, self._fault_wake(chan, READABLE))
            else:
                self._wake(chan._rwait)
        if stall:
            self._fault_stall(stall)

    def pop(self, chan: Channel) -> Any:
        stall = wake = 0
        if self._chan_faults is not None:
            stall, wake = self._fault_consult(chan, "pop")
        tok = chan._pop()
        if self.track_stats:
            chan.total_read += 1
        if chan._wwait:
            if wake:
                self.schedule_async(wake, self._fault_wake(chan, WRITABLE))
            else:
                self._wake(chan._wwait)
        if stall:
            self._fault_stall(stall)
        return tok

    def push_burst(self, chan: Channel, toks: list) -> None:
        """Batch enqueue: one deque.extend and at most one reader wake per
        burst — the per-token runtime cost is amortized away."""
        stall = wake = 0
        if self._chan_faults is not None:
            stall, wake = self._fault_consult(chan, "push_burst")
        if self.track_stats:
            self._check_spec(chan, toks)
        chan._q.extend(toks)
        if self.track_stats:
            self._stat_push(chan, len(toks))
        if chan._rwait:
            if wake:
                self.schedule_async(wake, self._fault_wake(chan, READABLE))
            else:
                self._wake(chan._rwait)
        if stall:
            self._fault_stall(stall)

    def pop_burst(self, chan: Channel, n: int) -> list:
        stall = wake = 0
        if self._chan_faults is not None:
            stall, wake = self._fault_consult(chan, "pop_burst")
        q = chan._q
        if n == len(q):
            out = list(q)
            q.clear()
        else:
            out = [q.popleft() for _ in range(n)]
        if self.track_stats:
            chan.total_read += n
        if chan._wwait:
            if wake:
                self.schedule_async(wake, self._fault_wake(chan, WRITABLE))
            else:
                self._wake(chan._wwait)
        if stall:
            self._fault_stall(stall)
        return out

    def _schedule(self, fiber: "_Fiber") -> None:
        """The single wake path: bumping the epoch here marks every other
        outstanding waiter-queue registration of this fiber stale, so a
        fiber can never be double-resumed (which would desynchronize the
        baton handshake) and consecutive wakes of the same fiber coalesce
        into one ready-queue entry."""
        fiber.wake_epoch += 1
        self._ready.append(fiber)

    def _wake(self, wq: deque) -> None:
        """Drain one per-channel waiter list: schedule live entries, drop
        stale ones.  The one-producer/one-consumer rule bounds live entries
        per side at one, so this is O(1) amortized."""
        while wq:
            fiber, epoch = wq.popleft()
            if fiber.wake_epoch == epoch and not fiber.done:
                self._schedule(fiber)

    def spawn(self, inst: TaskInstance) -> None:
        self._register(inst)
        fiber = _Fiber(inst, self)
        self._fibers[inst.uid] = fiber
        self._ready.append(fiber)

    def join(self, insts: list[TaskInstance]) -> None:
        fiber: _Fiber = _fiber_tls.fiber
        pending = [i for i in insts if i.state not in ("finished", "failed")]
        for i in insts:
            if i.state == "failed" and i.error is not None:
                raise Deadlock(f"child task {i.name} failed: {i.error!r}")
        if not pending:
            return
        self._join_pending[fiber.inst.uid] = len(pending)
        for c in pending:
            self._child_to_joiner[c.uid] = fiber
        fiber.inst.state = "blocked"
        fiber.inst.wait_site = "join"
        fiber._yield()
        fiber.inst.state = "running"
        for i in insts:
            if i.state == "failed" and i.error is not None:
                raise Deadlock(f"child task {i.name} failed: {i.error!r}")

    def _on_fiber_finished(self, fiber: _Fiber) -> None:
        joiner = self._child_to_joiner.pop(fiber.inst.uid, None)
        if joiner is not None:
            self._join_pending[joiner.inst.uid] -= 1
            if self._join_pending[joiner.inst.uid] == 0:
                del self._join_pending[joiner.inst.uid]
                self._schedule(joiner)

    # -- scheduler -----------------------------------------------------------
    def _any_nondetached_unfinished(self) -> bool:
        return any(i.state not in ("finished", "failed")
                   for i in self.instances if not i.detach)

    def _kill_blocked_fibers(self) -> None:
        """Tear down fibers that are permanently blocked (detached tasks at
        normal termination, or everything on deadlock)."""
        for chan in self._parked:
            for wq in (chan._rwait, chan._wwait):
                while wq:
                    f, epoch = wq.popleft()
                    if f.done or f.killed or f.wake_epoch != epoch:
                        continue
                    f.killed = True
                    f.resume_from_scheduler()
        for f in self._fibers.values():
            if not f.done and not f.killed and \
                    f.inst.state in ("created", "blocked"):
                f.killed = True
                f.resume_from_scheduler()

    def run(self, top: Callable, *args, **kwargs) -> SimReport:
        t0 = time.perf_counter()
        self._t0 = t0
        root = TaskInstance(top, args, kwargs, detach=False, parent=None,
                            name=getattr(top, "__name__", "top"))
        set_context(self, None)    # so top-level spawn() is routed at us
        self.spawn(root)
        deadlock = False
        # Direct-handoff scheduling: the scheduler thread starts the first
        # fiber and regains control only when no fiber is ready (normal
        # termination, deadlock) or on failure-abort; all other switches
        # are fiber-to-fiber.
        while True:
            if self._failure is not None:
                break
            nxt = self._next_ready()
            if nxt is not None:
                nxt.resume_from_scheduler()
                continue
            if self._any_nondetached_unfinished():
                deadlock = True
            break
        blocked_names = [i.name for i in self.instances
                         if i.state == "blocked" and not i.detach]
        if deadlock:
            # snapshot the structured report before teardown mutates states
            self._make_deadlock("deadlock")
        self._tearing = True
        self._kill_blocked_fibers()
        for f in self._fibers.values():
            f.thread.join(timeout=5.0)
        clear_context()
        wall = time.perf_counter() - t0
        if self._failure is not None:
            if isinstance(self._failure, DeadlockError):
                # watchdog trip inside a fiber: already carries the report
                return self._report(False, wall, str(self._failure))
            return self._report(False, wall,
                                f"task error: {self._failure!r}",
                                failure=self._failure)
        if deadlock:
            return self._report(
                False, wall, f"deadlock; blocked tasks: {blocked_names}")
        return self._report(True, wall, None, self._root_result)


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------

ENGINES = {
    "sequential": SequentialEngine,
    "thread": ThreadEngine,
    "coroutine": CoroutineEngine,
}


def run(top: Callable, *args, engine: str = "coroutine",
        track_stats: bool = False, faults: Any = None,
        watchdog_s: Optional[float] = None,
        max_ticks: Optional[int] = None, **kwargs) -> SimReport:
    """Simulate a task-parallel program.

    This is the software-simulation half of the paper's unified
    system-integration interface: the same top-level task function is later
    accepted by the compiled runners (``repro.launch``).

    ``track_stats=True`` records per-channel token counts and occupancy
    highwater marks (burst-granular) at the cost of disabling the
    run-to-block fast path.

    ``faults`` attaches a chaos harness (a ``FaultPlan`` or its injector,
    see :mod:`repro_torch.core.faults`); ``watchdog_s`` / ``max_ticks`` arm the
    unified wall-clock / logical-clock watchdog (docs/robustness.md).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"choose from {sorted(ENGINES)}")
    eng = ENGINES[engine](track_stats=track_stats, faults=faults,
                          watchdog_s=watchdog_s, max_ticks=max_ticks)
    return eng.run(top, *args, **kwargs)

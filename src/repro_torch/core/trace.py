"""One invocation's trace: host spans and counters, and the device's
intervals placed on the spans' clock.

:class:`CompiledEngine` keeps one :class:`Trace` a ``run`` (its ``trace``
attribute, replaced by each run) and its timing attributes (``lower_s``,
``capture_s``, ...) are views of it.  The trace holds

* spans: a name, the index of the enclosing span, a start and an end on
  ``time.perf_counter_ns`` and the trace's id, which every span of one run
  shares.  :meth:`Trace.span` opens one inside the span open at the time;
* counters: integers, recorded where the work happens (:meth:`Trace.count`);
* device intervals: a pair of timing CUDA events around work the program
  enqueues on the current stream (:meth:`Trace.on_device`: each block of
  sweep replays, and the copies outside the sweep graphs), placed on the
  spans' clock through one anchor (:meth:`Trace.anchor`: an event recorded
  on an idle device beside ``perf_counter_ns``) once the events have
  completed.  From them :meth:`Trace.table` gives, for each span, the
  device-busy and device-idle time while that span is the innermost one
  open;
* stamps (``CompiledEngine(trace=True)`` on the card only): the sweep
  graph's own clock readings, each region's device ns and count
  (:class:`~..kernels.ring.SweepStamps`) and each replay's first and last
  stamp on the spans' clock.

Nothing is exported: a trace lives on its engine.  :data:`RECENT` keeps
the :meth:`Trace.summary` of this process's last finished traces, newest
last, for a reader that sees only the run's timing attributes.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Optional

import torch

_ids = itertools.count(1)
RECENT: deque = deque(maxlen=256)


class Span:
    """One host interval of a trace: ``name``, ``parent`` (the index of the
    enclosing span in :attr:`Trace.spans`, or None), ``t0``/``t1``
    (``perf_counter_ns``; ``t1`` None while open) and ``inv``, the trace's
    id."""

    __slots__ = ("name", "parent", "t0", "t1", "inv")

    def __init__(self, name: str, parent: Optional[int], t0: int, inv: int):
        self.name, self.parent, self.t0, self.t1, self.inv = \
            name, parent, t0, None, inv

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Trace:
    """The spans, counters, device intervals and stamps of one run."""

    def __init__(self):
        self.id = next(_ids)
        self.spans: list = []
        self.counters: dict = {}
        self.stamps: Optional[dict] = None
        self._open: list = []
        self._pending: list = []        # (kind, k, e0, e1)
        self._anchor = None             # (host ns, event, pending before it)
        self._device: Optional[list] = None

    # -- recording -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A span named ``name`` inside the one open now."""
        sp = Span(name, self._open[-1] if self._open else None,
                  time.perf_counter_ns(), self.id)
        self._open.append(len(self.spans))
        self.spans.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter_ns()
            self._open.pop()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    @contextlib.contextmanager
    def on_device(self, kind: str, device: torch.device, k: int = 0):
        """Two timing events on the current stream around what the block
        enqueues there (on a CUDA ``device``; elsewhere nothing).  ``k``: the
        sweeps a block of replays holds."""
        if device.type != "cuda":
            yield
            return
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        yield
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        self._pending.append((kind, k, e0, e1))

    def anchor(self, device: torch.device) -> Optional[int]:
        """Pair the host clock with the device's: one event recorded now,
        beside ``perf_counter_ns``, which it returns (None off the card).
        The caller has left the device idle (nothing enqueued since its
        last synchronize), so the event completes as it is recorded."""
        if device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter_ns()
        e.record()
        self._anchor = (host, e, len(self._pending))
        return host

    # -- reading -------------------------------------------------------------
    def _named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.t1 is not None]

    def seconds(self, name: str) -> float:
        """Host seconds in the spans named ``name``, summed (0.0 if none)."""
        return sum(s.seconds for s in self._named(name))

    def last_seconds(self, name: str) -> float:
        spans = self._named(name)
        return spans[-1].seconds if spans else 0.0

    def first(self, name: str) -> Optional[Span]:
        spans = self._named(name)
        return spans[0] if spans else None

    def path(self, i: int) -> str:
        """Span ``i``'s name behind its ancestors', joined by ``/``."""
        names = []
        while i is not None:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))

    def device(self) -> list:
        """The device intervals ``(kind, k, t0, t1)`` on the spans' clock
        (ns), in the order enqueued; waits for the last event.  Empty
        without an anchor (on the CPU, or a run that never reached its
        loop)."""
        if self._device is None:
            out = []
            if self._anchor is not None and self._pending:
                host, a, before = self._anchor
                self._pending[-1][3].synchronize()
                for i, (kind, k, e0, e1) in enumerate(self._pending):
                    t0 = host + round((-e0.elapsed_time(a) if i < before
                                       else a.elapsed_time(e0)) * 1e6)
                    out.append((kind, k, t0,
                                t0 + round(e0.elapsed_time(e1) * 1e6)))
            self._device, self._pending = out, []
        return self._device

    def device_seconds(self, kind: str) -> float:
        """Device seconds in the intervals of ``kind``, summed."""
        return sum(t1 - t0 for kd, _, t0, t1 in self.device()
                   if kd == kind) / 1e9

    def blocks(self) -> list:
        """Each block of replays as ``(sweeps, device seconds)``."""
        return [(k, (t1 - t0) / 1e9) for kind, k, t0, t1 in self.device()
                if kind == "replays"]

    def table(self) -> dict:
        """``{path: (host_s, busy_s, idle_s)}`` a span, in the order opened:
        its host seconds, and of the time it is the innermost span open,
        the seconds the device spends in a recorded interval and those it
        does not.  A span's busy and idle sum to its host seconds less its
        children's."""
        busy = _union([(t0, t1) for _, _, t0, t1 in self.device()])
        kids: dict = {}
        for s in self.spans:
            if s.parent is not None and s.t1 is not None:
                kids.setdefault(s.parent, []).append((s.t0, s.t1))
        out = {}
        for i, s in enumerate(self.spans):
            if s.t1 is None:
                continue
            own = _minus([(s.t0, s.t1)], _union(kids.get(i, [])))
            total = sum(b - a for a, b in own)
            on = _overlap(own, busy)
            out[self.path(i)] = (s.seconds, on / 1e9, (total - on) / 1e9)
        return out

    def summary(self) -> dict:
        """``id``, ``spans`` (path -> host seconds, summed over repeats)
        and ``counters``: what :data:`RECENT` keeps."""
        spans: dict = {}
        for i, s in enumerate(self.spans):
            if s.t1 is not None:
                p = self.path(i)
                spans[p] = spans.get(p, 0.0) + s.seconds
        return dict(id=self.id, spans=spans, counters=dict(self.counters))

    def finish(self) -> None:
        """The run is over: keep its summary in :data:`RECENT`."""
        RECENT.append(self.summary())


def _union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _minus(iv: list, cut: list) -> list:
    """``iv`` less the sorted, disjoint intervals ``cut``."""
    out = []
    for a, b in iv:
        for c, d in cut:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
        if a < b:
            out.append((a, b))
    return out


def _overlap(xs: list, ys: list) -> int:
    """The length of the intersection of two sorted, disjoint lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        tot += max(0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot

"""Deterministic open-loop traffic generation for the serving stack.

The ROADMAP's serving arc asks for *production traffic shapes*: Poisson
arrivals, bursty on/off sources, multi-tenant mixes with a noisy
neighbor.  This module generates them as **seeded, replayable traces** —
the same ``(seed, tenants, duration)`` triple yields the identical
request list byte-for-byte, across processes and engines — by reusing
the FaultInjector's draw discipline (``repro_torch.core.faults._draw``): every
random decision is a pure blake2b hash of ``(seed, kind, site, counter)``,
never a stateful RNG.  That is what makes overload behavior something we
can regression-gate (``BENCH_serve_time.json``) and replay exactly
(the admit/shed/retire journal determinism test).

A trace is a list of :class:`~repro_torch.serve.engine.Request` objects with
``t_arrival`` (seconds from trace start) and ``tenant`` filled in,
sorted by arrival time.  Arrival processes per tenant:

* **Poisson** — exponential inter-arrivals at ``TenantSpec.rate``
  requests/sec.
* **Bursty (on/off MMPP)** — a two-phase Markov-modulated Poisson
  process: exponential on/off phase durations (``phases={"on_s", "off_s",
  "on_scale"}``), arrivals only during on-phases at ``rate * on_scale``.

The chaos harness composes with traffic: a :class:`~repro_torch.core.faults.
FaultPlan` with ``arrival_burst`` / ``tenant_flood`` entries overlays
extra arrivals (a rate spike in a window / a whole flooding tenant) onto
the trace, drawn from the *fault* seed so traffic shape and fault shape
vary independently.  See the reference's docs/serving.md (Overload section).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import List, Optional

from ..core.faults import _draw
from .engine import Request

__all__ = ["TenantSpec", "VirtualClock", "make_trace", "trace_digest",
           "noisy_neighbor_mix", "uniform_mix"]


@dataclasses.dataclass
class TenantSpec:
    """One traffic source: arrival process + request-shape distributions.

    ``rate`` is the mean arrival rate in requests/sec; ``weight`` and
    ``priority`` are consumed by the admission controller's fair queuing
    (weight scales the DRR quantum; lower ``priority`` value = served
    first).  ``prompt_len`` / ``max_new`` are inclusive uniform integer
    ranges.  ``phases`` switches the source from Poisson to on/off MMPP:
    ``{"on_s": mean_on, "off_s": mean_off, "on_scale": rate_multiplier}``
    — arrivals fire only during on-phases, at ``rate * on_scale``.
    """

    name: str
    rate: float = 4.0
    weight: float = 1.0
    priority: int = 0
    prompt_len: tuple = (4, 12)
    max_new: tuple = (4, 12)
    deadline_s: Optional[float] = None
    phases: Optional[dict] = None


class VirtualClock:
    """Monotone logical clock for deterministic (simulated-time) serving.

    The serving engine accepts any zero-arg callable as its clock; this
    one is advanced explicitly — by the traffic frontend to each arrival
    time and by the scheduler per decode step (``ServingEngine.step_dt``)
    — so a whole overload run is a deterministic function of (traffic
    seed, fault seed, config), never of host timing.  ``next_event`` is
    the frontend's declared next arrival; an idle scheduler fast-forwards
    to it instead of deadlocking on an empty queue.
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)
        self.next_event: Optional[float] = None

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt > 0:
            self.t += dt

    def advance_to(self, t: float) -> None:
        if t > self.t:
            self.t = t


def _uniform_int(u: float, lo: int, hi: int) -> int:
    """Map a [0,1) draw onto the inclusive integer range [lo, hi]."""
    return lo + min(int(u * (hi - lo + 1)), hi - lo)


def _arrival_times(seed: int, site: str, rate: float, t0: float,
                   t1: float, phases: Optional[dict]) -> List[float]:
    """Arrival instants in [t0, t1) for one source, purely hash-drawn.

    Poisson when ``phases`` is None; on/off MMPP otherwise.  Every draw
    is keyed by (seed, kind, site, counter) so the schedule is identical
    across processes.
    """
    if rate <= 0 or t1 <= t0:
        return []
    out: List[float] = []
    if phases is None:
        t, k = t0, 0
        while True:
            u = _draw(seed, "arr", site, k)
            t += -math.log(1.0 - u) / rate
            k += 1
            if t >= t1:
                return out
            out.append(t)
    on_s = float(phases.get("on_s", 0.5))
    off_s = float(phases.get("off_s", 0.5))
    on_rate = rate * float(phases.get("on_scale", 4.0))
    t, j, k = t0, 0, 0
    on = True                      # phase 0 is an on-phase
    while t < t1:
        mean = on_s if on else off_s
        dur = -math.log(1.0 - _draw(seed, "phase", site, j)) * mean
        j += 1
        end = min(t + dur, t1)
        if on:
            a = t
            while True:
                u = _draw(seed, "arr", site, k)
                a += -math.log(1.0 - u) / on_rate
                k += 1
                if a >= end:
                    break
                out.append(a)
        t = end
        on = not on
    return out


def _requests_for(seed: int, spec: TenantSpec, times: List[float],
                  vocab: int, site: Optional[str] = None) -> List[Request]:
    site = site or spec.name
    reqs = []
    for k, t in enumerate(times):
        plen = _uniform_int(_draw(seed, "plen", site, k), *spec.prompt_len)
        prompt = [_uniform_int(_draw(seed, "tok", site, k, i), 0, vocab - 1)
                  for i in range(plen)]
        max_new = _uniform_int(_draw(seed, "mn", site, k), *spec.max_new)
        reqs.append(Request(rid=-1, prompt=prompt, max_new=max_new,
                            deadline_s=spec.deadline_s, tenant=spec.name,
                            t_arrival=t))
    return reqs


def make_trace(tenants: List[TenantSpec], duration_s: float, *,
               seed: int = 0, vocab: int = 256, scale: float = 1.0,
               faults=None) -> List[Request]:
    """Generate one deterministic open-loop trace.

    ``scale`` multiplies every tenant's arrival rate (the 1x-vs-2x
    offered-load knob: the *same* seed at two scales keeps each tenant's
    request shapes aligned while the arrival schedule densifies).

    ``faults`` (a FaultPlan or FaultInjector) overlays chaos traffic:

    * ``arrival_burst = {tenant|"*": {"at_s", "dur_s", "rate"}}`` — extra
      Poisson arrivals for matching tenants inside the window;
    * ``tenant_flood = {name: {"rate", "start_s", "dur_s", ...}}`` — an
      entire extra flooding tenant (default: low priority, weight 1).

    Overlay draws are keyed by the *fault* seed, so (traffic seed, fault
    seed) vary independently; fired overlays land in ``injector.log``.

    Returns requests sorted by ``t_arrival`` with ``rid`` assigned in
    arrival order — replayable byte-for-byte (see :func:`trace_digest`).
    """
    if faults is not None and not hasattr(faults, "traffic_floods"):
        faults = faults.injector()
    reqs: List[Request] = []
    for spec in tenants:
        rate = spec.rate * scale
        times = _arrival_times(seed, spec.name, rate, 0.0, duration_s,
                               spec.phases)
        reqs.extend(_requests_for(seed, spec, times, vocab))
    if faults is not None:
        fseed = faults.plan.seed
        for spec in tenants:
            for burst in faults.traffic_bursts(spec.name):
                t0 = float(burst.get("at_s", 0.0))
                t1 = min(t0 + float(burst.get("dur_s", duration_s)),
                         duration_s)
                site = f"burst:{spec.name}"
                times = _arrival_times(fseed, site,
                                       float(burst.get("rate", spec.rate)),
                                       t0, t1, None)
                if times:
                    faults.record("arrival_burst", spec.name, len(times))
                reqs.extend(_requests_for(fseed, spec, times, vocab,
                                          site=site))
        for name, flood in faults.traffic_floods().items():
            spec = TenantSpec(
                name=name,
                rate=float(flood.get("rate", 50.0)),
                weight=float(flood.get("weight", 1.0)),
                priority=int(flood.get("priority", 9)),
                prompt_len=tuple(flood.get("prompt_len", (4, 8))),
                max_new=tuple(flood.get("max_new", (4, 8))),
                deadline_s=flood.get("deadline_s"))
            t0 = float(flood.get("start_s", 0.0))
            t1 = min(t0 + float(flood.get("dur_s", duration_s)), duration_s)
            times = _arrival_times(fseed, f"flood:{name}", spec.rate,
                                   t0, t1, None)
            if times:
                faults.record("tenant_flood", name, len(times))
            reqs.extend(_requests_for(fseed, spec, times, vocab,
                                      site=f"flood:{name}"))
    # arrival order with a deterministic tie-break; rids in arrival order
    reqs.sort(key=lambda r: (r.t_arrival, r.tenant))
    for rid, r in enumerate(reqs):
        r.rid = rid
    return reqs


def trace_digest(trace: List[Request]) -> str:
    """Content hash of a trace — the byte-for-byte replay check."""
    payload = [[r.rid, r.tenant, round(r.t_arrival, 9), r.prompt,
                r.max_new, r.deadline_s] for r in trace]
    blob = json.dumps(payload, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


# -- preset mixes ----------------------------------------------------------

def uniform_mix(n: int = 2, rate: float = 4.0,
                deadline_s: Optional[float] = None, **kw) -> List[TenantSpec]:
    """``n`` equal-weight Poisson tenants."""
    return [TenantSpec(name=f"t{i}", rate=rate, deadline_s=deadline_s, **kw)
            for i in range(n)]


def noisy_neighbor_mix(victim_rate: float = 4.0, flood_rate: float = 40.0,
                       deadline_s: Optional[float] = None) -> List[TenantSpec]:
    """A well-behaved interactive tenant next to a bursty flooder.

    The victim gets priority class 0; the flooder sits in class 1 with
    the same DRR weight — fair queuing must keep the victim's latency
    flat while the flooder absorbs the shedding.
    """
    return [
        TenantSpec(name="victim", rate=victim_rate, priority=0,
                   deadline_s=deadline_s),
        TenantSpec(name="flood", rate=flood_rate, priority=1,
                   prompt_len=(4, 8), max_new=(4, 8),
                   deadline_s=deadline_s,
                   phases={"on_s": 0.3, "off_s": 0.3, "on_scale": 2.0}),
    ]

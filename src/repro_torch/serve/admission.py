"""Admission control, load shedding, fair queuing, and the circuit breaker.

This is the overload layer of the serving stack: everything that decides
whether a request gets compute *before* any compute is spent on it.

* :class:`AdmissionController` sits between the traffic frontend and the
  bounded request channel.  Arrivals are queued per tenant; dispatch
  order is **priority classes first, weighted deficit-round-robin within
  a class** (the DRR quantum is in estimated tokens, so a tenant with
  weight 2 gets twice the token budget per round, not twice the request
  count).  Three shedding mechanisms bound the backlog:

  - ``reject-new`` — an arrival past ``queue_limit`` is shed on the spot;
  - ``drop-oldest`` — the arrival is queued and the oldest request of the
    *lowest-priority* backlogged tenant is shed instead (protects
    interactive tenants from a flooder);
  - **deadline-infeasible shed** — at offer *and* at dispatch, a request
    whose estimated completion (queued work ahead x measured per-token
    latency + its own service estimate) cannot meet its ``deadline_s``
    is shed immediately rather than wasting queue time and compute.

  Every shed produces a structured
  ``RequestError("overloaded", retry_after_s=...)`` — never a blocked
  producer — and is journaled through the
  :class:`~repro_torch.serve.journal.ServeJournal` (record type
  ``shed``) before the verdict is visible, so a crash-restart replays shed verdicts exactly-once and
  never re-admits a shed rid.

* :class:`CircuitBreaker` wraps the serving step calls: ``closed`` →
  ``open`` after ``fail_threshold`` consecutive step failures (the chaos
  fault kinds: exhausted transients, injected step exceptions),
  fast-fail with :class:`BreakerOpen` while open, then a half-open probe
  after ``cooldown_s`` — one real call is let through; success closes
  the breaker, failure re-opens it.  This extends the degradation ladder
  between "retry" and "fail everything" (the reference's
  docs/robustness.md).

* :class:`ServeMetrics` tracks per-tenant streaming TTFT and per-token
  latency (p50/p95/p99), goodput vs throughput, and the shed accounting
  invariant ``offered == admitted + shed``; the reference's
  ``benchmarks/serve_time.py`` persists the same summary.

Determinism: nothing here reads a wall clock directly — the controller,
breaker and metrics all take a ``clock`` callable (``time.perf_counter``
for production, :class:`~repro_torch.serve.traffic.VirtualClock` for
simulated time), so an overload run under the coroutine engine is a
pure function of (traffic seed, fault seed, config).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

from .engine import Request, RequestError

__all__ = ["AdmissionConfig", "AdmissionController", "BreakerOpen",
           "CircuitBreaker", "ServeMetrics", "percentile"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def percentile(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


class ServeMetrics:
    """Per-tenant streaming latency and goodput accounting.

    The engine funnels every request outcome through here: ``shed`` at
    admission, ``done``/``failed`` at retirement, with first-token and
    completion stamps taken from the shared serving clock.  ``summary()``
    folds the stream into the shape the benchmark persists.
    """

    def __init__(self, clock=None):
        self.clock = clock or time.perf_counter
        self.offered: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.shed_reasons: Dict[str, int] = {}
        self.done_rows: List[dict] = []     # completed requests
        self.failed: Dict[str, int] = {}    # structured non-shed errors
        self.deadline_violations = 0
        self.t_start: Optional[float] = None

    def _bump(self, table: Dict[str, int], tenant: str) -> None:
        table[tenant] = table.get(tenant, 0) + 1

    def note_offered(self, tenant: str) -> None:
        if self.t_start is None:
            self.t_start = self.clock()
        self._bump(self.offered, tenant)

    def note_admitted(self, tenant: str) -> None:
        self._bump(self.admitted, tenant)

    def note_shed(self, tenant: str, reason: str) -> None:
        self._bump(self.shed, tenant)
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1

    def note_done(self, tenant: str, t_arr: Optional[float],
                  t_first: Optional[float], n_tokens: int) -> None:
        now = self.clock()
        self.done_rows.append({
            "tenant": tenant, "n": n_tokens,
            "ttft": None if (t_arr is None or t_first is None)
            else t_first - t_arr,
            "tok_s": None if (t_first is None or n_tokens <= 1)
            else (now - t_first) / (n_tokens - 1),
            "t_done": now,
        })

    def note_failed(self, tenant: str, status: str) -> None:
        self._bump(self.failed, tenant)
        if status == "deadline":
            self.deadline_violations += 1

    # -- folding -----------------------------------------------------------

    def tenants(self) -> List[str]:
        names = set(self.offered) | set(self.admitted) | set(self.shed)
        names |= {r["tenant"] for r in self.done_rows}
        return sorted(names)

    def check_accounting(self) -> None:
        """The shed invariant: every offered request was either admitted
        or shed, per tenant.  Raises AssertionError on violation."""
        for t in self.tenants():
            off = self.offered.get(t, 0)
            adm = self.admitted.get(t, 0)
            shd = self.shed.get(t, 0)
            assert off == adm + shd, \
                f"tenant {t!r}: offered {off} != admitted {adm} + shed {shd}"

    def summary(self, wall_s: Optional[float] = None) -> dict:
        good_tokens = sum(r["n"] for r in self.done_rows)
        if wall_s is None:
            t0 = self.t_start
            t1 = max((r["t_done"] for r in self.done_rows), default=None)
            wall_s = (t1 - t0) if (t0 is not None and t1 is not None
                                   and t1 > t0) else None
        per_tenant = {}
        for t in self.tenants():
            rows = [r for r in self.done_rows if r["tenant"] == t]
            ttft = [r["ttft"] for r in rows if r["ttft"] is not None]
            toks = [r["tok_s"] for r in rows if r["tok_s"] is not None]
            per_tenant[t] = {
                "offered": self.offered.get(t, 0),
                "admitted": self.admitted.get(t, 0),
                "shed": self.shed.get(t, 0),
                "completed": len(rows),
                "failed": self.failed.get(t, 0),
                "ttft_p50_s": percentile(ttft, 50),
                "ttft_p95_s": percentile(ttft, 95),
                "ttft_p99_s": percentile(ttft, 99),
                "tok_latency_p50_s": percentile(toks, 50),
                "tok_latency_p99_s": percentile(toks, 99),
            }
        all_ttft = [r["ttft"] for r in self.done_rows
                    if r["ttft"] is not None]
        return {
            "offered": sum(self.offered.values()),
            "admitted": sum(self.admitted.values()),
            "shed": sum(self.shed.values()),
            "shed_reasons": dict(self.shed_reasons),
            "completed": len(self.done_rows),
            "deadline_violations": self.deadline_violations,
            "good_tokens": good_tokens,
            "goodput_tok_s": None if not wall_s
            else round(good_tokens / wall_s, 2),
            "wall_s": None if wall_s is None else round(wall_s, 4),
            "ttft_p50_s": percentile(all_ttft, 50),
            "ttft_p95_s": percentile(all_ttft, 95),
            "ttft_p99_s": percentile(all_ttft, 99),
            "tenants": per_tenant,
        }


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdmissionConfig:
    """Knobs for the admission controller (all static, journal-friendly).

    ``shed_policy``: ``"reject-new"`` | ``"drop-oldest"``.
    ``queue_limit``: max queued requests across all tenants (the DRR
    backlog bound; the request channel's ``queue_cap`` bounds the
    dispatched segment separately).
    ``est_token_s``: initial per-token latency estimate for the
    deadline-infeasible shed; refined online by an EWMA over measured
    decode-step latency (``observe_token_latency``).  ``0`` disables
    infeasibility shedding until a measurement arrives.
    ``quantum_tokens``: DRR quantum per round per unit weight, in
    estimated tokens.
    ``retry_after_s``: hint returned with every shed verdict.
    """

    shed_policy: str = "reject-new"
    queue_limit: int = 64
    deadline_shed: bool = True
    est_token_s: float = 0.0
    ewma: float = 0.25
    quantum_tokens: float = 32.0
    retry_after_s: float = 0.5

    def __post_init__(self):
        if self.shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(
                f"unknown shed_policy {self.shed_policy!r}; "
                f"expected 'reject-new' or 'drop-oldest'")


class _TenantQ:
    __slots__ = ("q", "deficit", "weight", "priority")

    def __init__(self, weight: float, priority: int):
        self.q: deque = deque()
        self.deficit = 0.0
        self.weight = weight
        self.priority = priority


def _cost(r: Request) -> float:
    """Estimated service cost in tokens (prefill amortized per token is
    cheap next to decode, so max_new dominates; the prompt still counts
    at a discount for long-context requests)."""
    return r.max_new + 0.25 * len(r.prompt)


class AdmissionController:
    """Per-tenant fair queuing + cost-aware load shedding.

    ``offer(request)`` returns ``None`` (queued), a
    :class:`RequestError` (shed verdict — the caller delivers it), or
    ``("replayed", result)`` when the journal already holds the rid's
    outcome (crash-restart exactly-once).  ``pop()`` returns the next
    request in fair-queue order, shedding any queued request that became
    deadline-infeasible while it waited (those verdicts accumulate in
    ``pending_errors`` for the caller to drain).
    """

    def __init__(self, cfg: AdmissionConfig = None, tenants=None,
                 journal=None, metrics: ServeMetrics = None, clock=None):
        self.cfg = cfg or AdmissionConfig()
        self.journal = journal
        self.metrics = metrics
        self.clock = clock or time.perf_counter
        self.token_s = self.cfg.est_token_s
        self._tq: Dict[str, _TenantQ] = {}
        self._rotation: List[str] = []       # tenant visit order (stable)
        self.pending_errors: List[RequestError] = []
        self.offered = 0
        self.admitted = 0                    # dispatched via pop()
        self.shed_total = 0

    # -- tenant registry ---------------------------------------------------

    def register(self, name: str, weight: float = 1.0,
                 priority: int = 0) -> None:
        if name not in self._tq:
            self._tq[name] = _TenantQ(weight, priority)
            self._rotation.append(name)
            # stable sort: priority classes first, registration/rotation
            # order within a class
            self._rotation.sort(key=lambda n: self._tq[n].priority)

    def register_tenants(self, specs) -> None:
        for s in specs:
            self.register(s.name, weight=s.weight, priority=s.priority)

    def _queue_for(self, tenant: str) -> _TenantQ:
        if tenant not in self._tq:
            self.register(tenant)
        return self._tq[tenant]

    # -- latency model -----------------------------------------------------

    def observe_token_latency(self, dt: float) -> None:
        """EWMA over measured per-token (decode step) latency."""
        if dt <= 0:
            return
        a = self.cfg.ewma
        self.token_s = dt if self.token_s <= 0 \
            else (1 - a) * self.token_s + a * dt

    def backlog(self) -> int:
        return sum(len(t.q) for t in self._tq.values())

    def backlog_cost(self) -> float:
        return sum(_cost(r) for t in self._tq.values() for r in t.q)

    def _backlog_cost_ahead(self, r: Request) -> float:
        """Estimated queued tokens dispatched *before* ``r`` would be:
        strictly-higher-priority classes in full plus ``r``'s own class
        (DRR interleaves within a class — counting peers is the
        conservative bound).  Lower-priority backlog does not make a
        high-priority arrival infeasible."""
        pr = self._queue_for(r.tenant).priority
        return sum(_cost(q) for t in self._tq.values()
                   if t.priority <= pr for q in t.q)

    def _infeasible(self, r: Request, now: float, queued_cost: float) -> bool:
        if not self.cfg.deadline_shed or r.deadline_s is None \
                or self.token_s <= 0:
            return False
        waited = 0.0 if r.t_arrival is None else max(0.0, now - r.t_arrival)
        est = waited + (queued_cost + _cost(r)) * self.token_s
        return est > r.deadline_s

    # -- verdicts ----------------------------------------------------------

    def _shed(self, r: Request, reason: str, detail: str) -> RequestError:
        self.shed_total += 1
        if self.metrics is not None:
            self.metrics.note_shed(r.tenant, reason)
        if self.journal is not None:
            # write-ahead: the verdict is durable before it is visible,
            # so a crash-restart replays it instead of re-admitting
            self.journal.shed(r.rid, detail=detail)
        return RequestError(r.rid, "overloaded", detail,
                            retry_after_s=self.cfg.retry_after_s)

    def offer(self, r: Request):
        """Admission verdict for one arrival (see class docstring)."""
        now = self.clock()
        self.offered += 1
        if self.metrics is not None:
            self.metrics.note_offered(r.tenant)
        if self.journal is not None:
            done = self.journal.completed.get(r.rid)
            if done is not None:
                # exactly-once across restart: shed and retired rids
                # answer straight from the journal, never recomputed.
                # note_offered above still counts it so accounting holds.
                if self.metrics is not None:
                    if isinstance(done, tuple) and done[0] == "overloaded":
                        self.metrics.note_shed(r.tenant, "replayed")
                    else:
                        self.metrics.note_admitted(r.tenant)
                return ("replayed", done)
        if self._infeasible(r, now, self._backlog_cost_ahead(r)):
            return self._shed(
                r, "deadline-infeasible",
                f"cannot meet deadline {r.deadline_s}s: "
                f"{self.backlog()} queued ahead at "
                f"~{self.token_s:.4f}s/token")
        if self.backlog() >= self.cfg.queue_limit:
            if self.cfg.shed_policy == "reject-new":
                return self._shed(
                    r, "reject-new",
                    f"queue full ({self.cfg.queue_limit} backlogged)")
            # drop-oldest: evict from the lowest-priority backlogged
            # tenant (ties: latest in rotation) so a flood sheds itself
            victim_name = max(
                (n for n, t in self._tq.items() if t.q),
                key=lambda n: (self._tq[n].priority,
                               self._rotation.index(n)))
            victim = self._tq[victim_name].q.popleft()
            err = self._shed(victim, "drop-oldest",
                             f"dropped for newer arrival {r.rid}")
            self.pending_errors.append(err)
        self._queue_for(r.tenant).q.append(r)
        return None

    def pop(self) -> Optional[Request]:
        """Next request in priority + weighted-DRR order, or None.

        Dispatch-time staleness check: a queued request that can no
        longer meet its deadline is shed here (verdict appended to
        ``pending_errors``) and the scan continues.
        """
        now = self.clock()
        while True:
            r = self._pop_drr()
            if r is None:
                return None
            # at dispatch the request is next in line: only its own
            # service time remains in the estimate
            if self._infeasible(r, now, 0.0):
                self.pending_errors.append(self._shed(
                    r, "deadline-infeasible",
                    f"deadline {r.deadline_s}s unreachable after queuing"))
                continue
            self.admitted += 1
            if self.metrics is not None:
                self.metrics.note_admitted(r.tenant)
            return r

    def _pop_drr(self) -> Optional[Request]:
        active = [n for n in self._rotation if self._tq[n].q]
        if not active:
            return None
        top = min(self._tq[n].priority for n in active)
        incls = {n for n in active if self._tq[n].priority == top}
        # classic DRR over the top priority class: the rotation head
        # keeps serving while its deficit covers its head-of-line cost;
        # when it cannot, it is topped up ONCE and sent to the back of
        # its class (its turn ends).  Topping up per-turn — not per-visit
        # — is what makes weight 2 worth twice the token share; a head
        # costlier than quantum*weight banks deficit across rounds.
        for _ in range(100000):
            name = next(n for n in self._rotation
                        if n in incls and self._tq[n].q)
            t = self._tq[name]
            if t.deficit >= _cost(t.q[0]):
                r = t.q.popleft()
                t.deficit -= _cost(r)
                if not t.q:
                    t.deficit = 0.0           # no banking while idle
                    self._to_back(name)
                return r
            t.deficit += self.cfg.quantum_tokens * t.weight
            self._to_back(name)
        raise RuntimeError("DRR dispatch failed to converge")

    def _to_back(self, name: str) -> None:
        """End a tenant's turn: move it behind its priority class (the
        sort is stable, so cross-class order is untouched)."""
        self._rotation.remove(name)
        self._rotation.append(name)
        self._rotation.sort(key=lambda n: self._tq[n].priority)

    def drain_errors(self) -> List[RequestError]:
        out, self.pending_errors = self.pending_errors, []
        return out

    def stats(self) -> dict:
        return {"offered": self.offered, "admitted": self.admitted,
                "shed": self.shed_total, "backlog": self.backlog(),
                "est_token_s": round(self.token_s, 6)}


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class BreakerOpen(RuntimeError):
    """Fast-fail raised instead of a step call while the breaker is open."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """closed -> open -> half-open circuit around the serving step calls.

    ``failure()`` counts *consecutive* final step failures (a retried
    transient that eventually succeeds never reaches it); at
    ``fail_threshold`` the breaker opens and ``check()`` raises
    :class:`BreakerOpen` without touching the backend.  After
    ``cooldown_s`` (on the injected ``clock``) one probe call is let
    through half-open: success closes, failure re-opens and restarts the
    cooldown.  All transitions append to ``log`` as
    ``(t, from_state, to_state, detail)``.
    """

    def __init__(self, fail_threshold: int = 3, cooldown_s: float = 1.0,
                 clock=None):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock or time.perf_counter
        self.state = "closed"
        self.consecutive = 0
        self.opened_at: Optional[float] = None
        self.log: List[tuple] = []

    def _move(self, to: str, detail: str = "") -> None:
        self.log.append((self.clock(), self.state, to, detail))
        self.state = to

    def retry_after(self) -> float:
        if self.opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (self.clock() - self.opened_at))

    def check(self) -> None:
        """Gate one step call: no-op when closed; raises when open;
        transitions open -> half-open (admitting this call as the probe)
        once the cooldown has elapsed."""
        if self.state == "closed" or self.state == "half-open":
            return
        left = self.retry_after()
        if left > 0:
            raise BreakerOpen(
                f"circuit open ({self.consecutive} consecutive failures); "
                f"retry in {left:.3f}s", retry_after_s=left)
        self._move("half-open", "cooldown elapsed; probing")

    def success(self) -> None:
        if self.state == "half-open":
            self._move("closed", "probe succeeded")
        self.consecutive = 0
        self.opened_at = None

    def failure(self, detail: str = "") -> None:
        self.consecutive += 1
        if self.state == "half-open":
            self.opened_at = self.clock()
            self._move("open", f"probe failed: {detail}"[:120])
        elif self.state == "closed" and \
                self.consecutive >= self.fail_threshold:
            self.opened_at = self.clock()
            self._move("open",
                       f"{self.consecutive} consecutive failures: "
                       f"{detail}"[:120])

"""Deterministic fault injection for the simulation runtime ("chaos harness").

The paper's productivity claim is that *software simulation* lets designers
verify task-parallel programs before hardware — which is only credible if the
simulator can exercise the unhappy paths too: stalled channels, slow memory
responses, dying tasks, corrupt artifacts, poisoned serving requests.  This
module provides a declarative :class:`FaultPlan` plus a stateful
:class:`FaultInjector` that the engines, interfaces, artifact stores and the
serving scheduler consult at well-defined points.

Design rules
------------
* **Deterministic and order-independent.**  Every probabilistic decision is a
  pure hash of ``(seed, kind, site, per-site counter)`` — blake2b, no global
  RNG — so the *decision for the k-th op at a given site* is identical under
  the sequential, thread and coroutine engines regardless of interleaving.
  That is what makes cross-engine fault-matrix parity tests possible.
* **Replayable.**  Every fired fault is appended to :attr:`FaultInjector.log`;
  the same plan (same seed) over the same program yields the same log.
* **Zero overhead when disabled.**  Engines keep a ``_chan_faults`` slot that
  is ``None`` unless the plan actually targets channels/tasks, so the hot
  push/pop paths stay a single ``is None`` test and ``fast_path`` stays on.
* **Legal faults only.**  Injected behaviours stay within the runtime's
  contract: stalls delay ops but never drop tokens; memory-latency spikes may
  reorder responses *across* ports/directions but never within one
  ``(port, direction)`` FIFO; artifact corruption is always detectable by the
  digests the stores now record.

Fault sites are *task-side* channel ops (``push``/``pop``/bursts issued by
task bodies); interface-internal deliveries are never perturbed directly —
memory misbehaviour is modelled by :meth:`FaultInjector.mem_delay` instead.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .errors import CrashFault, InjectedFault, PoisonError, TransientFault

__all__ = ["FaultPlan", "FaultInjector"]


def _draw(seed: int, *key) -> float:
    """Deterministic uniform draw in [0, 1) keyed by (seed, *key)."""
    h = hashlib.blake2b(repr((seed,) + key).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


@dataclass
class FaultPlan:
    """Declarative description of the faults to inject into one run.

    All fields default to "no fault"; an empty plan's injector is a no-op
    (and engines keep their fast paths).  Sites accept ``"*"`` as a
    wildcard where noted.

    chan_stall
        ``{channel_name | "*": {"p": prob, "stall": ticks, "wake": ticks}}``.
        With probability ``p`` per op, the issuing task stalls for ``stall``
        logical ticks after the op, and any wake-up it owes the opposite
        endpoint is delayed by ``wake`` ticks (delivered via the engine's
        event queue — the token itself is never lost).
    task_raise
        ``{task_name: n}`` — the task's n-th channel op (0-based, program
        order, engine-independent) raises :class:`InjectedFault`.
    crash
        ``{task_name | "chunk": n}`` — process-crash analogue for the
        recovery subsystem.  A task-name site raises :class:`CrashFault`
        at that task's n-th channel op (same 0-based, engine-independent
        counting as ``task_raise``); the reserved site ``"chunk"`` fires
        at the n-th chunk boundary consulted via
        :meth:`FaultInjector.crash_point` (how the compiled engine, which
        has no per-op hook, gets crashed).  Each site fires at most once
        per injector, so a supervisor that reuses the injector across
        restart attempts does not re-crash the recovered run.
    mem_spike
        ``{port_name | "*": {"p": prob, "extra": ticks}}`` — AsyncMMap
        requests take ``extra`` additional ticks with probability ``p``.
        Responses may legally overtake each other across ports/directions
        but stay FIFO within one ``(port, direction)``.
    cache_corrupt
        Number of compile-cache disk entries to corrupt immediately after a
        successful verified write (proves the delete+recompile path).
    cache_io_errors / ckpt_io_errors
        Budget of injected transient ``OSError`` s for compile-cache /
        checkpoint writes (each consumed failure is retried by the store).
    ckpt_truncate
        Step numbers whose published checkpoint directory gets one data file
        truncated after publish (proves the skip-incomplete-step path).
    poison
        ``{rid: "prefill" | "decode" | "any"}`` — serving requests whose
        compute step raises :class:`PoisonError` *before* the step function
        executes (so donated buffers stay valid); the scheduler quarantines
        the request.
    cancel
        ``{rid: n}`` — request ``rid`` is cancelled once it has generated
        ``n`` tokens.
    transient
        ``{site: count}`` — the first ``count`` calls through the serving
        retry wrapper at ``site`` ("prefill"/"decode") raise
        :class:`TransientFault` (recovered by retry-with-backoff).
    arrival_burst
        ``{tenant_name | "*": {"at_s": t, "dur_s": d, "rate": r}}`` —
        traffic-shape fault: matching tenants get *extra* Poisson
        arrivals at rate ``r`` inside the window ``[at_s, at_s + dur_s)``,
        overlaid onto the trace by :func:`repro.serve.traffic.make_trace`.
        Burst draws are keyed by this plan's seed, so traffic seed and
        fault seed vary independently.  A list of burst dicts per site is
        also accepted.
    tenant_flood
        ``{tenant_name: {"rate": r, "start_s": t, "dur_s": d, "weight",
        "priority", "prompt_len", "max_new", "deadline_s"}}`` — a whole
        extra flooding tenant injected into the trace (default priority 9,
        i.e. the lowest class: fair queuing should starve the flood, not
        the victims).
    """

    seed: int = 0
    chan_stall: Dict[str, dict] = field(default_factory=dict)
    task_raise: Dict[str, int] = field(default_factory=dict)
    crash: Dict[str, int] = field(default_factory=dict)
    mem_spike: Dict[str, dict] = field(default_factory=dict)
    cache_corrupt: int = 0
    cache_io_errors: int = 0
    ckpt_io_errors: int = 0
    ckpt_truncate: Tuple[int, ...] = ()
    poison: Dict[int, str] = field(default_factory=dict)
    cancel: Dict[int, int] = field(default_factory=dict)
    transient: Dict[str, int] = field(default_factory=dict)
    arrival_burst: Dict[str, dict] = field(default_factory=dict)
    tenant_flood: Dict[str, dict] = field(default_factory=dict)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Stateful consumer of a :class:`FaultPlan`: per-site counters + log.

    One injector should be attached to one run; reuse across runs would
    carry counters over and change which firings trip.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: list = []                     # replay record of fired faults
        self._chan_ops: Dict[tuple, int] = {}   # (chan, op) -> ops seen
        self._task_ops: Dict[str, int] = {}     # task -> ops seen
        self._mem_ops: Dict[tuple, int] = {}    # (port, dir) -> requests seen
        self._mem_last_due: Dict[tuple, int] = {}
        self._io_left = {"cache": plan.cache_io_errors,
                         "ckpt": plan.ckpt_io_errors}
        self._corrupt_left = plan.cache_corrupt
        self._transient_left = dict(plan.transient)
        self._truncated: set = set()
        self._cancel_fired: set = set()
        self._crash_fired: set = set()
        self._crash_points: Dict[str, int] = {}   # site -> boundaries seen

    # -- classification (lets engines skip consults entirely) ------------
    @property
    def affects_channels(self) -> bool:
        return (bool(self.plan.chan_stall) or bool(self.plan.task_raise)
                or any(site != "chunk" for site in self.plan.crash))

    @property
    def affects_memory(self) -> bool:
        return bool(self.plan.mem_spike)

    @property
    def affects_traffic(self) -> bool:
        return bool(self.plan.arrival_burst) or bool(self.plan.tenant_flood)

    def record(self, *event) -> None:
        self.log.append(event)

    # -- channel / task faults (engines' push/pop/burst paths) ------------
    @staticmethod
    def _site_target(table: Dict[str, int], task_name: str):
        """Plan lookup with bare-definition-name fallback (a key like
        ``"Relay"`` applies to every instance ``"Relay#k"``)."""
        target = table.get(task_name)
        if target is None and "#" in task_name:
            target = table.get(task_name.split("#", 1)[0])
        return target

    def chan_op(self, chan_name: str, op: str, task_name: str):
        """One task-side channel op.  Returns ``(stall, wake)`` tick delays;
        may raise :class:`InjectedFault` (``task_raise``) or
        :class:`CrashFault` (``crash``) at the task's chosen firing."""
        tr = self.plan.task_raise
        cr = self.plan.crash
        if tr or cr:
            # counters are per *instance* (task_name is unique, e.g.
            # "Relay#2"); plan keys may use the bare definition name,
            # which then applies to every instance of it
            n = self._task_ops.get(task_name, -1) + 1
            self._task_ops[task_name] = n
            if tr and self._site_target(tr, task_name) == n:
                self.record("task_raise", task_name, n)
                raise InjectedFault(
                    f"injected failure in task {task_name!r} at channel op {n}")
            if cr:
                # fired-ness is keyed by the *plan key* that matched, not
                # the instance name: restarts re-instantiate tasks with
                # fresh uids ("Relay#82" -> "Relay#96"), and a crash site
                # must fire exactly once per injector so the supervised
                # retry survives it
                key = task_name if task_name in cr else (
                    task_name.split("#", 1)[0] if "#" in task_name else None)
                if key is not None and key not in self._crash_fired and \
                        cr.get(key) == n:
                    self._crash_fired.add(key)
                    self.record("crash", task_name, n)
                    raise CrashFault(
                        f"injected crash in task {task_name!r} "
                        f"at channel op {n}")
        spec = (self.plan.chan_stall.get(chan_name)
                or self.plan.chan_stall.get("*"))
        if not spec:
            return 0, 0
        k = self._chan_ops.get((chan_name, op), 0)
        self._chan_ops[(chan_name, op)] = k + 1
        if _draw(self.plan.seed, "chan", chan_name, op, k) >= spec.get("p", 1.0):
            return 0, 0
        stall = int(spec.get("stall", 0))
        wake = int(spec.get("wake", 0))
        self.record("chan", chan_name, op, k, stall, wake)
        return stall, wake

    def crash_point(self, site: str = "chunk") -> None:
        """One non-channel crash site (e.g. a recovery chunk boundary).

        Consulted by the supervised chunk loop between chunks — this is
        how the compiled engine, whose execution is one opaque
        ``lax.while_loop``, gets crashed at a deterministic point.
        Raises :class:`CrashFault` at the site's n-th consultation (same
        0-based counting as channel-op sites); fires at most once per
        injector so the recovered attempt runs through.
        """
        target = self.plan.crash.get(site)
        if target is None:
            return
        n = self._crash_points.get(site, -1) + 1
        self._crash_points[site] = n
        if site not in self._crash_fired and target == n:
            self._crash_fired.add(site)
            self.record("crash", site, n)
            raise CrashFault(
                f"injected crash at {site!r} boundary {n}")

    # -- memory faults (AsyncMMap.pump) -----------------------------------
    def mem_delay(self, port: str, direction: str, base: int, clock: int) -> int:
        """Latency (ticks) for one accepted memory request.

        Clamped so due times within one ``(port, direction)`` are
        monotonically non-decreasing: the response FIFO order the runtime
        guarantees (and ``read_pipelined`` depends on) is preserved, while
        cross-port / cross-direction reordering emerges naturally.
        """
        spec = (self.plan.mem_spike.get(port)
                or self.plan.mem_spike.get("*"))
        extra = 0
        if spec:
            k = self._mem_ops.get((port, direction), 0)
            self._mem_ops[(port, direction)] = k + 1
            if _draw(self.plan.seed, "mem", port, direction, k) < spec.get("p", 1.0):
                extra = int(spec.get("extra", 0))
        due = clock + base + extra
        last = self._mem_last_due.get((port, direction), -1)
        if due < last:
            due = last
        self._mem_last_due[(port, direction)] = due
        if extra:
            self.record("mem", port, direction, extra)
        return due - clock

    # -- artifact faults (compile cache / checkpoints) ---------------------
    def io_error(self, kind: str) -> bool:
        """Consume one injected transient-IO failure for ``kind`` ("cache"
        or "ckpt"); the store raises ``OSError`` and retries."""
        left = self._io_left.get(kind, 0)
        if left <= 0:
            return False
        self._io_left[kind] = left - 1
        self.record("io_error", kind, left - 1)
        return True

    def corrupt_cache(self) -> bool:
        if self._corrupt_left <= 0:
            return False
        self._corrupt_left -= 1
        self.record("cache_corrupt", self._corrupt_left)
        return True

    def truncate_step(self, step: int) -> bool:
        if step not in self.plan.ckpt_truncate or step in self._truncated:
            return False
        self._truncated.add(step)
        self.record("ckpt_truncate", step)
        return True

    # -- serving faults ----------------------------------------------------
    def serving_check(self, site: str, rids) -> None:
        """Called by the serving retry wrapper *before* the step function
        runs.  Raises :class:`PoisonError` for a poisoned rid (donated
        buffers untouched) or :class:`TransientFault` while the site's
        transient budget lasts."""
        for rid in rids:
            phase = self.plan.poison.get(rid)
            if phase is not None and phase in ("any", site):
                self.record("poison", site, rid)
                raise PoisonError(rid, f"poisoned request {rid} at {site}")
        left = self._transient_left.get(site, 0)
        if left > 0:
            self._transient_left[site] = left - 1
            self.record("transient", site, left - 1)
            raise TransientFault(f"injected transient failure at {site}")

    # -- traffic faults (consumed by repro.serve.traffic.make_trace) -------
    def traffic_bursts(self, tenant: str) -> list:
        """Arrival-burst specs that apply to ``tenant`` (exact name or
        ``"*"``).  Each plan entry may be one dict or a list of dicts."""
        out = []
        for key in (tenant, "*"):
            spec = self.plan.arrival_burst.get(key)
            if spec is None:
                continue
            out.extend(spec if isinstance(spec, list) else [spec])
        return out

    def traffic_floods(self) -> Dict[str, dict]:
        return dict(self.plan.tenant_flood)

    def cancelled(self, rid: int, n_generated: int) -> bool:
        after = self.plan.cancel.get(rid)
        if after is None or n_generated < after:
            return False
        if rid not in self._cancel_fired:
            self._cancel_fired.add(rid)
            self.record("cancel", rid, n_generated)
        return True

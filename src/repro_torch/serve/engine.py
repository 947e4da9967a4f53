"""Serving engine: continuous batching built on TAPA channels.

The port's copy of the reference's ``serve/engine.py``.  What differs:
``warmup(cache=...)`` resolves the serving steps through the port's
compile cache as the reference's does (an AOTInductor package on the
card, the exported program on the CPU; the weights an input of each
executable, not a constant inside it; one prefill executable for every
batch size and bucket, its batch and length axes dynamic), while
``warmup()`` with no cache runs every shape once eagerly and logs its
source as ``"eager"`` (the reference's ``None`` means its default
cache); the engine moves tokens, lengths, indices and the step counter
to the device as tensors before a step function sees them; the packed
cache is updated in place by the step functions (compiled or eager), as
the reference's donation does; and step outputs come back as device
tensors, copied to the host once per call.

This subsystem uses the paper's two motivating APIs *as motivated*:

* **Transactions (EoT)** — one request's prompt tokens form one transaction
  on the request channel: the frontend writes the tokens then ``close()``s;
  the scheduler drains the stream until EoT.  Variable-length prompts need
  no length header and no sentinel values inside the token domain (paper
  Listing 2's exact argument).

* **Peek** — the admission scheduler ``peek``s the request channel to see
  the *next* request's header without consuming it, admitting it only if a
  batch slot is free — the network-switch pattern from the paper's
  introduction (forward based on content *and* availability, no manual
  buffer-and-state-machine).

Two decode paths share the scheduler:

* **Batched fast path** (``batched=`` a :class:`~repro_torch.models.lm.
  ServingAdapter`): ONE decode step call per iteration regardless of
  live slot count.  All slots live in one packed KV cache ``[.., slots,
  ..]`` with a per-slot ``len`` vector; admission runs bucketed batched
  prefill and writes rows into slots in place; retirement zeroes
  ``len``; sampling happens on device so the host fetches one
  ``[slots]`` int32 array per step.  ``warmup`` runs every shape once.

* **Per-slot path** (``prefill_fn``/``decode_fn`` closures): the seed
  path — one call per live slot per token, host argmax.  Kept for toy
  engines, recurrent families (whose prefill cannot pad), and as the
  baseline the fast path is measured against.

The reference's docs/serving.md describes the packed-cache layout and
bucket policy, and its docs/robustness.md the failure model.

Robustness (chaos-harness contract)
-----------------------------------

A serving process must degrade, not crash.  The failure surface and the
response to each, from least to most severe:

* **Transient step failure** —
  :class:`~repro_torch.core.errors.TransientFault`
  (injected by the chaos harness before the step executes): retried with
  exponential backoff up to ``ServeConfig.max_retries`` times; retries are
  recorded in :attr:`ServingEngine.retry_log`.
* **Poisoned request** — :class:`~repro_torch.core.errors.PoisonError`
  raised *before* the step function runs (caches untouched): only the
  poisoned request is quarantined — it gets a :class:`RequestError` result
  and its slot is retired; everything else keeps decoding.
* **Per-slot deadline / cancellation** — a request past its
  ``deadline_s`` or cancelled by the fault plan is retired with a
  structured :class:`RequestError`; its partial output is dropped, its
  slot freed.
* **Unattributable batched failure** — the one step call covers every
  slot and updates the packed cache in place, so a real exception from
  inside it cannot be pinned on one request and may leave the cache
  torn: every live request gets a :class:`RequestError` and the packed
  cache is rebuilt from scratch.
* **Batched path unavailable** — an eager warmup raises (a kernel that
  does not build or launch) and a compiled one returns ``{"ok":
  False}``: the engine does not switch to the per-slot path on its own;
  the per-slot path runs only when it is the one built
  (``launch/serve.py`` raises on a failed warmup).
* **Preemption** — a ``stop_flag`` (wired to
  :class:`~repro_torch.ft.PreemptionGuard` by ``launch/serve.py``) makes the
  scheduler reject all queued/future admissions with ``"preempted"``
  errors, finish the in-flight slots, flush results and exit clean.

Overload
--------

Sustained offered load above capacity is handled *before* compute is
spent on it:

* an :class:`~repro_torch.serve.admission.AdmissionController` (``admission=``)
  fronts the request channel with per-tenant fair queuing and cost-aware
  load shedding; every shed is a journaled, structured
  ``RequestError("overloaded", retry_after_s=...)`` deposited straight
  into ``results`` — the frontend never blocks indefinitely;
* without a controller, ``ServeConfig.admit_timeout_s`` bounds how long
  the direct frontend waits on a full request channel before failing
  fast the same way (thread engine; cooperative engines hand off);
* a :class:`~repro_torch.serve.admission.CircuitBreaker` (``breaker=``) gates
  every ``_call_step``: consecutive step failures open it, further calls
  fast-fail with ``"overloaded"`` results while open, a half-open probe
  closes it again;
* traffic-paced runs (requests carrying ``t_arrival``, from
  ``serve/traffic.py``) run in one of two pacing modes: ``pace="wall"``
  sleeps to real arrival times under the thread engine, while
  ``pace="virtual"`` couples a
  :class:`~repro_torch.serve.traffic.VirtualClock`
  to the decode loop through a capacity-1 tick channel — the scheduler
  advances time by ``step_dt`` per step and the frontend blocks on ticks
  until the next arrival is due, so the whole overload run (arrivals,
  queue dynamics, sheds, deadline violations) is a deterministic
  function of (traffic seed, fault seed, config).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from functools import partial
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import channel, task
from ..core.engines import ENGINES
from ..core.errors import PoisonError, TransientFault


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list          # token ids
    max_new: int = 8
    deadline_s: Optional[float] = None   # latency budget (see t_arrival)
    tenant: str = "default"              # fair-queuing / metrics key
    # arrival timestamp (trace-relative seconds) set by serve/traffic.py;
    # when present, deadlines anchor at arrival (queueing time counts),
    # otherwise at slot admission
    t_arrival: Optional[float] = None


@dataclasses.dataclass
class RequestError:
    """Structured failure result for one request (collector value).

    ``status`` is one of ``"poisoned"``, ``"deadline"``, ``"cancelled"``,
    ``"preempted"``, ``"overloaded"``, ``"error"``; ``detail`` is
    human-readable context.  ``retry_after_s`` is set on overload sheds
    and breaker fast-fails: the client's backoff hint.  A request either
    yields a token list or a RequestError — never a silent absence from
    ``results``.
    """
    rid: int
    status: str
    detail: str = ""
    retry_after_s: Optional[float] = None


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 4          # concurrent decode slots
    max_seq: int = 128
    eos_token: int = -1           # -1: only stop on max_new
    prefill_buckets: tuple = ()   # () = powers of two from 8 to max_seq
    queue_cap: int = 16           # bounded admission queue (channel capacity)
    max_retries: int = 2          # per step-call retry budget (transients)
    retry_base_s: float = 0.0     # exponential-backoff base (0: no sleep)
    retry_max_s: float = 1.0      # cap on TOTAL backoff per step call
    # direct-frontend bound on waiting for a full request channel before
    # failing fast with "overloaded" (None: block, the seed behaviour).
    # Honoured under the preemptive thread engine; cooperative engines
    # hand off on the blocking write instead.
    admit_timeout_s: Optional[float] = None


def _default_buckets(max_seq: int) -> tuple:
    out, b = [], 8
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def _host(x) -> np.ndarray:
    """A step output on the host: a tensor is copied once (bfloat16 by
    way of float32, which numpy can hold); anything else goes through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _int32(x, device) -> torch.Tensor:
    """A host value (numpy array, int) as an int32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(x, np.int32)).to(device)


def _unbind(fn: Callable) -> tuple:
    """``(f, bound)`` of a step function given as ``partial(f, *bound)``
    (how a model's per-slot steps take their weights): ``f`` is what is
    compiled, with ``bound`` as inputs, never as constants."""
    if isinstance(fn, partial) and not fn.keywords:
        return fn.func, fn.args
    return fn, ()


def _in_place(fn: Callable) -> Callable:
    """``fn`` run for its in-place update only: the form the engine
    compiles the slot write and retire in, so a compiled call returns
    nothing that aliases the packed cache (a copy of its last argument,
    the slot index: an exported program has an output)."""
    def run(*args):
        fn(*args)
        return args[-1].clone()
    return run


_MODEL_SOURCES = ("models/lm.py", "models/layers.py", "kernels/ops.py")


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


class ServingEngine:
    """Continuous-batching engine over a model's serving step functions.

    Per-slot mode: ``prefill_fn(tokens[B,S]) -> (logits[B,V], cache)`` and
    ``decode_fn(token[B], cache) -> (logits[B,V], cache)`` — typically the
    model steps; tests may pass toy closures.

    Their tokens arrive as int32 host arrays, and as int32 tensors on
    ``device`` (default: the CPU) where ``warmup(cache=...)`` compiled
    them; a model's steps given as ``functools.partial(f, params)``
    compile ``f`` with the weights as an input.

    Batched mode: pass ``batched=lm.serving_adapter(...)`` instead; the
    decode loop runs one step call per iteration for all slots, on the
    adapter's device.
    """

    def __init__(self, scfg: ServeConfig, prefill_fn: Callable = None,
                 decode_fn: Callable = None, pad_token: int = 0,
                 batched: Any = None, faults: Any = None,
                 stop_flag: Callable = None, journal: Any = None,
                 admission: Any = None, metrics: Any = None,
                 breaker: Any = None, clock: Callable = None,
                 pace: Optional[str] = None, step_dt: float = 0.0,
                 device: Any = None):
        self.scfg = scfg
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.pad = pad_token
        self.batched = batched
        if batched is None and (prefill_fn is None or decode_fn is None):
            raise ValueError("need prefill_fn/decode_fn or batched=adapter")
        self.device = torch.device(
            device if device is not None
            else batched.device if batched is not None else "cpu")
        # chaos harness (repro_torch.core.faults): poisoned/cancelled requests and
        # transient step failures; None in normal operation
        if faults is not None and not hasattr(faults, "serving_check"):
            faults = faults.injector()
        self.faults = faults
        # preemption: callable polled once per scheduler iteration; True ->
        # reject queued admissions, finish live slots, exit clean
        self.stop_flag = stop_flag
        # write-ahead serving journal (repro_torch.serve.journal.ServeJournal or
        # a path): admission/token/retire records, fsync'd before the
        # corresponding effect is externally visible.  A restarted process
        # answers already-retired rids straight from the journal and
        # re-admits in-flight rids at their last journaled position —
        # exactly-once results across SIGKILL.
        if journal is not None and not hasattr(journal, "retire"):
            from .journal import ServeJournal
            journal = ServeJournal(journal)
        self.journal = journal
        # -- overload layer ------------------------------------------------
        # one clock for the whole stack: time.perf_counter in production,
        # a traffic.VirtualClock for deterministic simulated-time runs
        self.clock = clock or time.perf_counter
        # pacing for traffic-timed runs: None (legacy frontend), "wall"
        # (sleep to real arrival times, thread engine), or "virtual"
        # (tick-channel coupling, cooperative engines)
        if pace not in (None, "wall", "virtual"):
            raise ValueError(f"unknown pace {pace!r}")
        self.pace = pace
        self.step_dt = step_dt             # simulated seconds per decode step
        self.metrics = metrics             # admission.ServeMetrics or None
        if metrics is not None:
            metrics.clock = self.clock
        self.admission = admission         # admission.AdmissionController
        if admission is not None:
            if admission.journal is None:
                admission.journal = self.journal
            if admission.metrics is None:
                admission.metrics = self.metrics
            admission.clock = self.clock
        self.breaker = breaker             # admission.CircuitBreaker
        self.retry_log: list = []          # (site, attempt, error) tuples
        # per-slot mode: the steps compiled at warmup, and every decode
        # that fell off the compiled path, (rid, reason)
        self._aot_prefill: dict = {}       # (B, S) -> callable
        self._aot_decode: Optional[tuple] = None   # (aval sig, callable)
        self.fall_offs: list = []
        # batched mode: step callables by shape key, and the shapes
        # resolved so far with where each came from ("compiled",
        # "memory", "disk": the compile cache; "eager": run once, at
        # warmup or at first use, when no cache was given)
        self._exe: dict = {}
        # kind -> (callable, source), once warmup compiled the steps
        self._compiled: dict = {}
        self.compile_log: list = []        # (kind, shape, source) tuples
        # the compiled steps' executables by kind (their artifact, bytes
        # and export/compile/load seconds)
        self.executables: dict = {}

    def buckets(self) -> tuple:
        return self.scfg.prefill_buckets or _default_buckets(
            self.scfg.max_seq)

    # -- warmup --------------------------------------------------------------

    def warmup(self, prompt_len: int = 8, cache=None,
               batch_sizes: tuple = (1,)) -> dict:
        """Resolve the serving steps before the first request.

        With ``cache`` (a :class:`~repro_torch.core.compile_cache.
        CompileCache`) every step resolves through the compile cache, as
        in the reference: a warm store (any earlier process that served
        the same model and shapes) loads it, otherwise it is exported and
        compiled once; the executables are pinned for the decode loop.
        Batched mode resolves one prefill for every (batch size, bucket)
        of ``batch_sizes`` x ``buckets()`` — one executable, dynamic in
        both — plus the packed decode step, the slot write (dynamic in
        the batch size) and the retire, and reports each (batch size,
        bucket)'s source and the decode step's (``"compiled"``,
        ``"memory"``, ``"disk"``).  Per-slot mode compiles a single
        ``(1, prompt_len)`` prefill and the decode step.  A step that
        cannot be exported (a toy closure over numpy) gives ``{"ok":
        False, "reason": ...}``: a per-slot engine then serves eagerly;
        a batched one has no such way round, and its caller should not
        serve.

        Without ``cache`` it runs every one of those shapes once, eagerly
        (so CUDA libraries and kernels load before the first request),
        and reports ``"eager"`` (``"pinned"`` where this engine already
        ran it); a failure raises.
        """
        toks = np.zeros((1, prompt_len), np.int32)
        tok = np.zeros((1,), np.int32)
        if cache is None:
            if self.batched is not None:
                return self._warmup_eager(batch_sizes)
            _, kv = self.prefill_fn(toks)
            self.decode_fn(tok, kv)
            return {"ok": True, "prefill": "eager", "decode": "eager"}
        if self.batched is not None:
            return self._warmup_batched(cache, batch_sizes)
        from ..core.compile_cache import aval_signature
        dev = self.device
        try:
            # the decode's example cache from one eager prefill (on the
            # tensor the compiled prefill takes), so the two compile
            # together
            _, kv = self.prefill_fn(_int32(toks, dev))
            got = self._compile_all({
                "prefill": (self.prefill_fn, (_int32(toks, dev),), None),
                "decode": (self.decode_fn, (_int32(tok, dev), kv), None)},
                cache)
        except Exception as e:  # noqa: BLE001 - non-exportable step fns
            return {"ok": False, "reason": repr(e)[:200]}
        (pre, src_p), (dec, src_d) = got["prefill"], got["decode"]
        # the per-slot loop hands its steps host arrays, as to the eager
        # closures; the compiled ones take them on the device
        self._aot_prefill[(1, prompt_len)] = \
            lambda toks: pre(_int32(toks, dev))
        self._aot_decode = (aval_signature((tok, kv), {}),
                            lambda tok, cache: dec(_int32(tok, dev), cache))
        return {"ok": True, "prefill": src_p, "decode": src_d}

    def _compile_all(self, jobs: dict, cc) -> dict:
        """``{kind: (fn, args, dynamic)}`` compiled through ``cc`` in one
        batch with the serving key salt: ``{kind: (callable of args,
        source)}`` (a ``partial``'s bound arguments, the weights, fed as
        inputs); each executable is kept in :attr:`executables`."""
        items, bound = [], []
        for fn, args, dynamic in jobs.values():
            f, b = _unbind(fn)
            bound.append(b)
            items.append((f, (*b, *args), None, self._key_salt(),
                          None if dynamic is None
                          else (None,) * len(b) + dynamic))
        got = cc.compile_many(items, device=self.device)
        out = {}
        for kind, b, (exe, src) in zip(jobs, bound, got):
            self.executables[kind] = exe
            out[kind] = (partial(exe, *b), src)
        return out

    def _warmup_batched(self, cc, batch_sizes: tuple) -> dict:
        report: dict = {"ok": True, "buckets": {}, "decode": None}
        try:
            self._compile_batched(cc)
            for L in self.buckets():
                for bk in batch_sizes:
                    _, src = self._resolve_prefill(bk, L)
                    report["buckets"][f"{bk}x{L}"] = src
            _, src = self._resolve_step()
            report["decode"] = src
            for bk in batch_sizes:
                self._resolve_write(bk)
            self._resolve_retire()
        except Exception as e:  # noqa: BLE001 - the caller decides
            return {"ok": False, "reason": repr(e)[:200]}
        return report

    def _compile_batched(self, cc) -> None:
        """The adapter's four graphs through ``cc`` in one batch (a cold
        store compiles their packages in parallel): the prefill, one
        executable for every (batch size, bucket) — tokens ``[bk, L]``
        and lengths ``[bk]`` dynamic in ``bk`` up to the slot count and
        ``L`` up to ``max_seq`` —, the decode step, the slot write (the
        prefill cache dynamic in ``bk``) and the retire, each wrapped to
        the adapter's eager protocol in :attr:`_compiled`."""
        from ..core.compile_cache import Dyn
        a = self.batched
        if a.prefill_graph is None:
            raise TypeError("the adapter has no exportable graphs")
        n, S = self.scfg.batch_slots, self.scfg.max_seq

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        def bk(axis):
            return Dyn(((axis, "bk", 1, n),)) if n > 1 else None
        packed, cache = a.init_slots(n), a.init_slots(n)
        got = self._compile_all({
            "prefill": (partial(a.prefill_graph, a.params),
                        (i32(n, S), i32(n), i32()),
                        (Dyn(((0, "bk", 1, n),) * (n > 1)
                             + ((1, "L", 1, S),)), bk(0), None)),
            "decode_step": (partial(a.step_graph, a.params),
                            (i32(n), packed, i32()), None),
            "write_slot": (_in_place(a.write_slot_fn),
                           (packed, cache, i32(), i32()),
                           (None, {k: bk(0 if k == "len" else 1)
                                   for k in cache}, None, None)),
            "retire": (_in_place(a.retire_fn), (packed, i32()), None)},
            cc)
        pre, step, write, retire = (got[k][0] for k in got)

        def prefill_fn(tokens, true_len, step_i):
            out, cache = pre(tokens, true_len, step_i)
            return a.draw(out, step_i), cache

        def step_fn(tokens, packed, step_i):
            out = step(tokens, packed, step_i)
            return a.draw(out, step_i, packed["len"]), packed

        def write_fn(packed, cache, row, slot):
            write(packed, cache, row, slot)
            return packed

        def retire_fn(packed, slot):
            retire(packed, slot)
            return packed
        self._compiled = {
            "prefill": (prefill_fn, got["prefill"][1]),
            "decode_step": (step_fn, got["decode_step"][1]),
            "write_slot": (write_fn, got["write_slot"][1]),
            "retire": (retire_fn, got["retire"][1])}

    def _warmup_eager(self, batch_sizes: tuple) -> dict:
        report: dict = {"ok": True, "buckets": {}, "decode": None}
        n, dev = self.scfg.batch_slots, self.device
        scratch = self.batched.init_slots(n)
        caches = {}
        zero = _int32(0, dev)
        for L in self.buckets():
            for bk in batch_sizes:
                fn, src = self._resolve_prefill(bk, L)
                _, caches[bk] = fn(_int32(np.zeros((bk, L)), dev),
                                   _int32(np.full(bk, L), dev), zero)
                report["buckets"][f"{bk}x{L}"] = src
        fn, src = self._resolve_step()
        fn(_int32(np.zeros(n), dev), scratch, zero)
        report["decode"] = src
        # the slot-maintenance steps, so the first admission wave runs
        # nothing for the first time
        for bk in batch_sizes:
            self._resolve_write(bk)(scratch, caches[bk], zero, zero)
        self._resolve_retire()(scratch, zero)
        del scratch, caches
        _synchronize()
        return report

    # -- batched-mode step resolution ----------------------------------------

    @staticmethod
    def _key_salt():
        """Salt of every serving executable's key.  The reference's is its
        env-selected decode-attention dispatch; the port's dispatch is the
        device's, already in the key, so its salt is a digest of the model
        code's sources: the structural digest follows a function's
        references only so deep, and a traced step depends on all of
        it."""
        h = hashlib.sha256()
        root = Path(__file__).resolve().parents[1]
        for rel in _MODEL_SOURCES:
            h.update((root / rel).read_bytes())
        return ("serve", h.hexdigest()[:16])

    def _resolve(self, key: tuple, kind: str, shape: tuple,
                 eager: Callable):
        """The callable for one serving shape and its source: the compiled
        one after ``warmup(cache=...)`` (one executable may serve many
        shapes), else ``eager``; logged in :attr:`compile_log` once an
        engine, ``"pinned"`` after."""
        if key in self._exe:
            return self._exe[key], "pinned"
        fn, src = self._compiled.get(kind, (eager, "eager"))
        self._exe[key] = fn
        self.compile_log.append((kind, shape, src))
        return fn, src

    def _resolve_prefill(self, bk: int, L: int):
        return self._resolve(("prefill", bk, L), "prefill", (bk, L),
                             self.batched.prefill_fn)

    def _resolve_step(self):
        return self._resolve(("step",), "decode_step",
                             (self.scfg.batch_slots,), self.batched.step_fn)

    def _resolve_write(self, bk: int):
        return self._resolve(("write", bk), "write_slot", (bk,),
                             self.batched.write_slot_fn)[0]

    def _resolve_retire(self):
        return self._resolve(("retire",), "retire", (),
                             self.batched.retire_fn)[0]

    # -- task bodies ---------------------------------------------------------

    def _write_req(self, req_out, r) -> None:
        """One request as one EoT-delimited transaction:
        [hdr(rid, max_new, deadline, tenant, t_arr), tok0, ...] <EoT>."""
        req_out.write(("hdr", r.rid, r.max_new,
                       getattr(r, "deadline_s", None),
                       getattr(r, "tenant", "default"),
                       getattr(r, "t_arrival", None)))
        req_out.write_burst([("tok", t) for t in r.prompt])
        req_out.close()

    def _offer_direct(self, req_out, r, results) -> bool:
        """Write one request transaction, failing fast on a full channel.

        With ``admit_timeout_s`` unset this is the seed behaviour: the
        write blocks until the scheduler drains (a cooperative hand-off
        under run-to-block engines).  With it set and the channel full,
        the frontend waits at most that long, then sheds the request with
        a journaled ``RequestError("overloaded")`` instead of blocking
        the producer indefinitely.  Returns True iff the request was
        written."""
        tmo = self.scfg.admit_timeout_s
        if tmo is not None and results is not None and req_out.full():
            give_up = time.monotonic() + tmo
            while req_out.full() and time.monotonic() < give_up:
                time.sleep(min(0.002, max(tmo * 0.25, 1e-4)))
            if req_out.full():
                detail = (f"request queue full "
                          f"(cap {self.scfg.queue_cap}) for {tmo}s")
                if self.journal is not None:
                    self.journal.shed(r.rid, detail=detail)
                if self.metrics is not None:
                    self.metrics.note_shed(
                        getattr(r, "tenant", "default"), "queue-full")
                results[r.rid] = RequestError(r.rid, "overloaded", detail,
                                              retry_after_s=tmo)
                return False
        self._write_req(req_out, r)
        return True

    def frontend(self, requests: list, req_out, results: dict = None) -> None:
        """Direct (un-paced) frontend: requests are offered back-to-back."""
        for r in requests:
            if self.metrics is not None:
                self.metrics.note_offered(getattr(r, "tenant", "default"))
            if self._offer_direct(req_out, r, results) \
                    and self.metrics is not None:
                self.metrics.note_admitted(getattr(r, "tenant", "default"))
        # final empty transaction marks shutdown
        req_out.close()

    # -- traffic-paced frontend (overload path) --------------------------------

    def _deliver(self, results: dict, rid: int, done) -> None:
        """Deposit a journal-replayed result (exactly-once, no recompute)."""
        if isinstance(done, tuple):
            results[rid] = RequestError(rid, done[0], done[1])
        else:
            results[rid] = list(done)

    @staticmethod
    def _drain_ticks(tick_in) -> None:
        """Consume pending ticks before a potentially-blocking request
        write.  This is the virtual-pacing deadlock guard: it guarantees
        an idle scheduler's blocking tick write (:meth:`_timed_idle`) has
        space to complete, so the scheduler is always runnable to consume
        whatever the frontend is about to write."""
        if tick_in is not None:
            while tick_in.try_read()[0]:
                pass

    def _pump(self, req_out, results: dict, tick_in=None,
              drain: bool = False) -> None:
        """Move dispatchable requests from the admission controller into
        the request channel, in fair-queue order.  Normally stops at a
        full channel (the backlog stays in the controller where it can
        still be shed); ``drain=True`` pushes everything through with
        blocking writes (end of trace — the scheduler is consuming)."""
        ctrl = self.admission
        if ctrl is None:
            return
        while True:
            for e in ctrl.drain_errors():      # dispatch-time sheds
                results[e.rid] = e
            if not drain and req_out.full():
                return
            r = ctrl.pop()
            if r is None:
                break
            self._drain_ticks(tick_in)
            self._write_req(req_out, r)
        for e in ctrl.drain_errors():
            results[e.rid] = e

    def _offer_timed(self, r, req_out, results: dict, tick_in=None) -> None:
        ctrl = self.admission
        if ctrl is None:
            if self.metrics is not None:
                self.metrics.note_offered(r.tenant)
            self._drain_ticks(tick_in)
            if self._offer_direct(req_out, r, results) \
                    and self.metrics is not None:
                self.metrics.note_admitted(r.tenant)
            return
        verdict = ctrl.offer(r)
        if verdict is None:
            return                             # queued; _pump dispatches
        if isinstance(verdict, RequestError):
            results[verdict.rid] = verdict     # shed at offer
        else:                                  # ("replayed", done)
            self._deliver(results, r.rid, verdict[1])

    def traffic_frontend(self, trace: list, req_out, tick_in,
                         results: dict) -> None:
        """Open-loop frontend: release each request at its ``t_arrival``.

        Wall pacing sleeps to real arrival times (thread engine).
        Virtual pacing blocks on the tick channel until the scheduler —
        which advances the shared VirtualClock by ``step_dt`` per decode
        step, or fast-forwards to ``clock.next_event`` when idle — has
        moved simulated time past the next arrival.  Arrival timestamps
        are rebased onto the engine clock (``t_start``), so deadlines and
        TTFT anchor at *arrival*, queueing time included.
        """
        virtual = self.pace == "virtual" and tick_in is not None
        t_start = self.clock()
        for r in trace:
            t_abs = t_start + (r.t_arrival or 0.0)
            if virtual:
                self.clock.next_event = t_abs
                while self.clock() < t_abs:
                    tick_in.read()             # cooperative hand-off
                self.clock.next_event = None
            else:
                wait = t_abs - self.clock()
                if wait > 0:
                    time.sleep(wait)
            self._offer_timed(dataclasses.replace(r, t_arrival=t_abs),
                              req_out, results, tick_in)
            self._pump(req_out, results, tick_in)
        self._pump(req_out, results, tick_in, drain=True)
        self._drain_ticks(tick_in)             # unblock a mid-write scheduler
        req_out.close()                        # shutdown transaction
        self._drain_ticks(tick_in)

    # -- admission (shared by both paths) -------------------------------------

    def _admit_one(self, req_in, can_wait: bool):
        """Try to consume one whole request transaction.

        The caller guarantees a free slot, so admission is the paper's
        switch pattern: ``peek`` the header to inspect the pending request,
        then consume it — the peeked value IS the header (no double read).
        Returns ``("req", rid, max_new, prompt)``, ``("shutdown",)``, or
        ``("none",)`` when nothing is pending and ``can_wait`` is False.

        With ``can_wait=True`` (no live slot, nothing else to do) this
        *blocks* on the channel — a cooperative engine hand-off, not a
        busy poll of ``try_*`` in a spin loop.
        """
        avail, is_eot = req_in.try_eot()
        if not avail:
            if not can_wait:
                return ("none",)
            is_eot = req_in.eot()          # block until the next transaction
        if is_eot:                          # empty transaction = shutdown
            req_in.open()
            return ("shutdown",)
        kind, rid, max_new, deadline, tenant, t_arr = req_in.peek()
        assert kind == "hdr", kind
        req_in.read()                       # consume the peeked header
        prompt = [t for (_, t) in req_in.read_transaction()]
        # normalize: empty prompts decode from a single pad token; overlong
        # prompts keep their most recent max_seq-1 tokens so one decode
        # position remains
        prompt = (prompt or [self.pad])[-(self.scfg.max_seq - 1):]
        return ("req", rid, max_new, prompt, deadline, tenant, t_arr)

    def _emit(self, out_chan, rid: int, new: list, slot: dict = None) -> None:
        if self.metrics is not None and slot is not None:
            self.metrics.note_done(slot.get("tenant", "default"),
                                   slot.get("t_arr"), slot.get("t_first"),
                                   len(new))
        if self.journal is not None:
            # write-ahead: the retire record hits disk before the result
            # transaction exists, so a crash in between re-delivers from
            # the journal instead of losing the finished request
            self.journal.retire(rid, toks=[int(t) for t in new])
        out_chan.write(("hdr", rid))
        out_chan.write_burst([("tok", int(t)) for t in new])
        out_chan.close()

    def _emit_err(self, out_chan, rid: int, status: str,
                  detail: str = "", slot: dict = None,
                  retry_after: Optional[float] = None) -> None:
        """One error transaction; the collector turns it into a
        :class:`RequestError` result."""
        if retry_after is None and status == "overloaded" \
                and self.breaker is not None:
            retry_after = self.breaker.retry_after()   # client backoff hint
        if self.metrics is not None and slot is not None:
            self.metrics.note_failed(slot.get("tenant", "default"), status)
        if self.journal is not None:
            self.journal.retire(rid, status=status, detail=detail)
        out_chan.write(("err", rid, status, detail, retry_after))
        out_chan.close()

    def _note_tok(self, s: dict, t: int) -> None:
        """Append one emitted token to a slot, journaling it first — the
        single funnel for every token either decode path produces."""
        if "t_first" not in s:
            s["t_first"] = self.clock()    # TTFT stamp (first real token)
        if self.journal is not None:
            self.journal.tok(s["rid"], t)
        s["new"].append(t)

    # -- hardening helpers -----------------------------------------------------

    def _backoff(self, attempt: int, slept: float, slots) -> float:
        """One retry backoff sleep; returns the seconds actually slept.

        The exponential term is clamped two ways: ``retry_max_s`` caps
        the *total* backoff for one step call (the seed's uncapped
        ``base * 2**attempt`` could stall the whole batched decode loop),
        and no sleep ever extends past the earliest remaining deadline
        among the live slots — backing off for one slot's transient must
        not blow every neighbour's budget."""
        dt = self.scfg.retry_base_s * 2 ** attempt
        dt = min(dt, max(0.0, self.scfg.retry_max_s - slept))
        if slots:
            now = self.clock()
            for s in slots:
                if s is None or s.get("deadline") is None:
                    continue
                anchor = s["t_arr"] if s.get("t_arr") is not None else s["t0"]
                dt = min(dt, max(0.0, s["deadline"] - (now - anchor)))
        if dt > 0:
            time.sleep(dt)
        return dt

    def _call_step(self, site: str, rids: list, fn, *args, slots=None):
        """Run one step function under the serving fault contract.

        Consults the circuit breaker and the fault injector *before*
        ``fn`` executes, so :class:`~repro_torch.serve.admission.BreakerOpen`
        (fast-fail while the backend is suspect), :class:`PoisonError`
        (re-raised for the caller to quarantine) and
        :class:`TransientFault` (retried here with capped,
        deadline-aware backoff) all fire while any caches in
        ``args`` are still valid.  Only *final* step outcomes reach the
        breaker: a retried transient that eventually succeeds counts as
        success.
        """
        if self.breaker is not None:
            self.breaker.check()           # may raise BreakerOpen
        slept = 0.0
        for attempt in range(self.scfg.max_retries + 1):
            try:
                if self.faults is not None:
                    self.faults.serving_check(site, rids)
                out = fn(*args)
            except PoisonError:
                raise                      # per-request, not a backend fault
            except TransientFault as e:
                self.retry_log.append((site, attempt, repr(e)))
                if attempt >= self.scfg.max_retries:
                    if self.breaker is not None:
                        self.breaker.failure(repr(e))
                    raise
                if self.scfg.retry_base_s > 0:
                    slept += self._backoff(attempt, slept, slots)
                continue
            except Exception as e:  # noqa: BLE001 - real backend failure
                if self.breaker is not None:
                    self.breaker.failure(repr(e))
                raise
            if self.breaker is not None:
                self.breaker.success()
            return out

    def _abnormal(self, s: dict) -> Optional[tuple]:
        """(status, detail) if the slot must be retired abnormally."""
        err = s.get("error")
        if err is not None:
            return err
        dl = s.get("deadline")
        # arrival-anchored when the request carries t_arrival (queueing
        # time counts against the budget), slot-admission-anchored (t0)
        # for legacy requests
        anchor = s["t_arr"] if s.get("t_arr") is not None else s["t0"]
        if dl is not None and self.clock() - anchor > dl:
            return ("deadline", f"deadline {dl}s exceeded after "
                                f"{len(s['new'])} tokens")
        if self.faults is not None and \
                self.faults.cancelled(s["rid"], len(s["new"])):
            return ("cancelled", f"cancelled after {len(s['new'])} tokens")
        return None

    def _stop_requested(self) -> bool:
        return self.stop_flag is not None and bool(self.stop_flag())

    def _drain_reject(self, req_in, out_chan) -> None:
        """Preemption path: consume every queued/future request transaction
        up to the frontend's shutdown marker, answering each with a
        ``"preempted"`` error — the frontend never blocks on a full channel
        and the collector still sees one result per request."""
        while True:
            r = self._admit_one(req_in, can_wait=True)
            if r[0] == "shutdown":
                return
            if r[0] == "none":      # unreachable with can_wait=True
                continue
            self._emit_err(out_chan, r[1], "preempted",
                           "serving preempted; request rejected")

    def _finished(self, s: dict) -> bool:
        if len(s["new"]) >= s["max_new"]:
            return True
        eos = self.scfg.eos_token
        if eos >= 0 and s["new"] and s["new"][-1] == eos:
            return True
        # cache-capacity stop: the next decode would scatter at
        # prompt_len + len(new) - 1; retire one step early.  Journal-seeded
        # tokens are counted once — they are part of the re-prefilled
        # prompt AND of ``new`` — so subtract the overlap.
        return s["plen"] + len(s["new"]) - s.get("seeded", 0) \
            >= self.scfg.max_seq

    # -- scheduler -------------------------------------------------------------

    def scheduler(self, req_in, out_chan, tick_out=None) -> None:
        """Admission + continuous batch decode."""
        if self.batched is not None:
            self._scheduler_batched(req_in, out_chan, tick_out)
        else:
            self._scheduler_per_slot(req_in, out_chan, tick_out)
        out_chan.close()                   # shutdown transaction

    def _timed_idle(self, tick_out) -> None:
        """Idle under virtual pacing: hand simulated time to the frontend.

        Nothing is decoding, so the only pending event is the frontend's
        next arrival (``clock.next_event``): fast-forward to it and tick.
        The second, *blocking* tick write is the cooperative yield — the
        run-to-block engine switches to the frontend there, which reads
        the tick, sees its arrival due, and writes the next request."""
        clk = self.clock
        ne = getattr(clk, "next_event", None)
        if ne is not None and hasattr(clk, "advance_to"):
            clk.advance_to(ne)
        tick_out.try_write(clk())      # fill the capacity-1 channel...
        tick_out.write(clk())          # ...then block until it drains

    def _after_step(self, tick_out, t_wall0) -> None:
        """Per-decode-step bookkeeping: advance virtual time + tick, and
        feed the measured (or simulated) per-token latency to the
        admission controller's deadline-infeasibility estimator."""
        if tick_out is not None:
            self.clock.advance(self.step_dt)
            tick_out.try_write(self.clock())   # lossy: frontend may lag
            dt = self.step_dt
        else:
            dt = (time.perf_counter() - t_wall0) \
                if t_wall0 is not None else None
        if self.admission is not None and dt:
            self.admission.observe_token_latency(dt)

    def _mk_slot(self, rid, max_new, prompt, deadline,
                 tenant: str = "default", t_arr: Optional[float] = None,
                 seeded: Optional[list] = None) -> dict:
        """One decode-slot record.  ``seeded`` (journal replay) pre-loads
        tokens the crashed process already emitted: they join the prompt
        for the re-prefill — greedy decoding of a causal model then
        continues exactly where the journal left off — and pre-fill
        ``new`` so ``max_new`` / result accounting stay unchanged."""
        seeded = list(seeded or [])
        prompt = (list(prompt) + seeded)[-(self.scfg.max_seq - 1):]
        return {"rid": rid, "prompt": prompt, "plen": len(prompt),
                "max_new": max_new, "new": seeded, "seeded": len(seeded),
                "deadline": deadline, "tenant": tenant, "t_arr": t_arr,
                "t0": self.clock()}

    def _slot_for(self, r, out_chan) -> Optional[dict]:
        """Journal-aware slot construction for one admitted request.

        Returns None when no slot is needed: the rid already retired (its
        result re-emits straight from the journal — never recomputed), or
        the request finishes inline (``max_new <= 0``, or a journal-seeded
        slot that was already at its last token when the process died).
        Fresh rids are journaled *before* any compute happens for them.
        """
        _, rid, max_new, prompt, deadline, tenant, t_arr = r
        j = self.journal
        if j is not None:
            done = j.completed.get(rid)
            if done is not None:
                if isinstance(done, tuple):
                    self._emit_err(out_chan, rid, done[0], done[1])
                else:
                    self._emit(out_chan, rid, done)
                return None
            rec = j.inflight.pop(rid, None)
            if rec is not None:
                s = self._mk_slot(rid, rec["max_new"], rec["prompt"],
                                  rec.get("deadline"), tenant, t_arr,
                                  seeded=rec["toks"])
                if s["new"] and self._finished(s):
                    self._emit(out_chan, rid, s["new"], slot=s)
                    return None
                return s
            j.admit(rid, prompt, max_new, deadline)
        if max_new <= 0:
            self._emit(out_chan, rid, [],
                       slot={"tenant": tenant, "t_arr": t_arr})
            return None
        return self._mk_slot(rid, max_new, prompt, deadline, tenant, t_arr)

    def _scheduler_per_slot(self, req_in, out_chan, tick_out=None) -> None:
        scfg = self.scfg
        coop = tick_out is not None        # virtual pacing (tick coupling)
        slots: list[Optional[dict]] = [None] * scfg.batch_slots
        shutdown = False
        while True:
            if not shutdown and self._stop_requested():
                self._drain_reject(req_in, out_chan)
                shutdown = True
            # Admit while a slot is free; block only when fully idle
            # (under virtual pacing never block here — _timed_idle is the
            # yield point, so the frontend can still advance time).
            while not shutdown:
                free = next((i for i, s in enumerate(slots) if s is None),
                            None)
                if free is None:
                    break
                r = self._admit_one(
                    req_in, can_wait=not coop and not any(
                        s is not None for s in slots))
                if r[0] == "shutdown":
                    shutdown = True
                    break
                if r[0] == "none":
                    break
                s = self._slot_for(r, out_chan)
                if s is not None:
                    slots[free] = s

            live = [s for s in slots if s is not None]
            if not live:
                if shutdown:
                    break
                if coop:
                    self._timed_idle(tick_out)
                continue

            t_wall0 = time.perf_counter() \
                if (self.admission is not None and not coop) else None
            self._step_batch(slots)
            self._after_step(tick_out, t_wall0)

            # retire finished/failed slots (one transaction per request)
            for i, s in enumerate(slots):
                if s is None:
                    continue
                ab = self._abnormal(s)
                if ab is not None:
                    self._emit_err(out_chan, s["rid"], *ab, slot=s)
                    slots[i] = None
                elif self._finished(s):
                    self._emit(out_chan, s["rid"], s["new"], slot=s)
                    slots[i] = None

    def _do_prefill(self, s: dict) -> None:
        toks = np.asarray(s["prompt"], np.int32)[None, :]
        prefill = self._aot_prefill.get(toks.shape, self.prefill_fn)
        logits, cache = prefill(toks)
        s["cache"] = cache
        s["next"] = int(np.argmax(_host(logits)[0]))
        self._note_tok(s, s["next"])
        # decide the compiled-vs-eager decode once per slot, not per
        # token (the cache's signature is fixed after prefill)
        if self._aot_decode is not None:
            from ..core.compile_cache import aval_signature
            sig, exe = self._aot_decode
            tok0 = np.zeros((1,), np.int32)
            s["aot_decode"] = exe if aval_signature(
                (tok0, cache), {}) == sig else None

    def _do_decode(self, s: dict) -> None:
        tok = np.asarray([s["next"]], np.int32)
        decode = s.get("aot_decode") or self.decode_fn
        try:
            logits, s["cache"] = decode(tok, s["cache"])
        except (TypeError, ValueError) as e:
            # a decode_fn that reshapes its cache mid-stream falls off
            # the compiled path instead of erroring; each fall-off is kept
            if decode is self.decode_fn:
                raise
            self.fall_offs.append((s["rid"], repr(e)[:200]))
            s["aot_decode"] = None
            logits, s["cache"] = self.decode_fn(tok, s["cache"])
        s["next"] = int(np.argmax(_host(logits)[0]))
        self._note_tok(s, s["next"])

    def _step_slot(self, site: str, s: dict, fn) -> None:
        """One per-slot step with quarantine: a failing request marks only
        its own slot (``s["error"]``); neighbours keep decoding."""
        from .admission import BreakerOpen
        try:
            self._call_step(site, [s["rid"]], fn, s, slots=[s])
        except PoisonError as e:
            s["error"] = ("poisoned", str(e))
        except BreakerOpen as e:
            s["error"] = ("overloaded", str(e))
        except Exception as e:  # noqa: BLE001 - incl. exhausted transients
            s["error"] = ("error", repr(e)[:200])

    def _step_batch(self, slots: list) -> None:
        """One prefill-or-decode step over the live slots (per-slot path)."""
        # prefill any slot that has no cache yet
        for s in slots:
            if s is not None and "cache" not in s and "error" not in s:
                self._step_slot("prefill", s, self._do_prefill)
        # decode all live slots, one call per slot (the seed hot loop the
        # batched path replaces)
        for s in slots:
            if s is None or "error" in s or self._finished(s):
                continue
            self._step_slot("decode", s, self._do_decode)

    # -- batched fast path -----------------------------------------------------

    def _scheduler_batched(self, req_in, out_chan, tick_out=None) -> None:
        from .admission import BreakerOpen
        scfg = self.scfg
        coop = tick_out is not None        # virtual pacing (tick coupling)
        n = scfg.batch_slots
        slots: list[Optional[dict]] = [None] * n
        packed = self.batched.init_slots(n)
        step_exe, _ = self._resolve_step()
        retire = self._resolve_retire()
        dev = self.device
        idx = [_int32(i, dev) for i in range(n)]  # slot indices, on device

        def retire_exe(packed, i):
            return retire(packed, idx[i])
        toks = np.zeros((n,), np.int32)    # reused host-side staging buffer
        shutdown = False
        step_i = 0

        while True:
            if not shutdown and self._stop_requested():
                self._drain_reject(req_in, out_chan)
                shutdown = True
            # -- admission: collect requests for every free slot ----------
            newly = []
            while not shutdown and sum(s is None for s in slots) > len(newly):
                r = self._admit_one(
                    req_in,
                    can_wait=not coop and not newly and not any(
                        s is not None for s in slots))
                if r[0] == "shutdown":
                    shutdown = True
                    break
                if r[0] == "none":
                    break
                s = self._slot_for(r, out_chan)
                if s is not None:
                    newly.append(s)
            if newly:
                packed, step_i = self._prefill_admit(newly, slots, packed,
                                                     step_i, out_chan)
                # a request can finish at prefill (max_new == 1 / eos)
                for i, s in enumerate(slots):
                    if s is not None and self._finished(s):
                        self._emit(out_chan, s["rid"], s["new"], slot=s)
                        packed = retire_exe(packed, i)
                        slots[i] = None

            # -- retire deadline-blown / cancelled slots before stepping --
            for i, s in enumerate(slots):
                if s is None:
                    continue
                ab = self._abnormal(s)
                if ab is not None:
                    self._emit_err(out_chan, s["rid"], *ab, slot=s)
                    packed = retire_exe(packed, i)
                    slots[i] = None

            if not any(s is not None for s in slots):
                if shutdown:
                    break
                if coop:
                    self._timed_idle(tick_out)
                continue

            # -- ONE decode step call for the whole slot array -----------
            toks.fill(0)
            for i, s in enumerate(slots):
                if s is not None:
                    toks[i] = s["next"]
            rids = [s["rid"] for s in slots if s is not None]
            t_wall0 = time.perf_counter() \
                if (self.admission is not None and not coop) else None
            try:
                nxt, packed = self._call_step("decode", rids, step_exe,
                                              _int32(toks, dev), packed,
                                              _int32(step_i, dev),
                                              slots=slots)
            except PoisonError as e:
                # raised before the step executed, so the packed cache is
                # untouched: retire only the poisoned slot
                for i, s in enumerate(slots):
                    if s is not None and s["rid"] == e.rid:
                        self._emit_err(out_chan, e.rid, "poisoned", str(e),
                                       slot=s)
                        packed = retire_exe(packed, i)
                        slots[i] = None
                continue
            except BreakerOpen as e:
                # also raised before the step executed (cache untouched):
                # fast-fail every live request with a structured
                # overload error — no compute is spent while the backend
                # is suspect; the half-open probe will test recovery
                for i, s in enumerate(slots):
                    if s is not None:
                        self._emit_err(out_chan, s["rid"], "overloaded",
                                       str(e), slot=s)
                        packed = retire_exe(packed, i)
                        slots[i] = None
                continue
            except Exception as e:  # noqa: BLE001 - unattributable failure
                # the one step call covers every slot and updates the
                # packed cache in place — the failure cannot be pinned on
                # a single request and the cache may be torn.  Fail all live
                # requests with structured errors and rebuild the cache:
                # the scheduler survives to serve what is still queued.
                for i, s in enumerate(slots):
                    if s is not None:
                        self._emit_err(out_chan, s["rid"], "error",
                                       repr(e)[:200], slot=s)
                        slots[i] = None
                packed = self.batched.init_slots(n)
                continue
            step_i += 1
            self._after_step(tick_out, t_wall0)
            nxt = _host(nxt)        # [slots] — the only per-step transfer

            for i, s in enumerate(slots):
                if s is None:
                    continue
                t = int(nxt[i])
                self._note_tok(s, t)
                s["next"] = t
                if self._finished(s):
                    self._emit(out_chan, s["rid"], s["new"], slot=s)
                    packed = retire_exe(packed, i)
                    slots[i] = None

    def _prefill_admit(self, newly: list, slots: list, packed,
                       step_i: int, out_chan):
        """Bucketed batched prefill for a group of admitted requests.

        Prompts are right-padded to the smallest power-of-two bucket and
        same-bucket requests share one prefill call whose batch dimension
        is itself padded to a power of two — so the shape space stays
        bounded and ``warmup`` can resolve every shape.  Returns
        ``(packed, step_i)``: the step counter advances once per prefill
        call so every sampler invocation draws from a distinct seed.

        A poisoned request is isolated here: it gets an error transaction
        and its group retries without it (PoisonError fires before the
        prefill executes, so nothing is torn).  A real prefill failure
        fails only the group sharing that call, never the whole wave.
        """
        buckets = self.buckets()
        groups: dict[int, list] = {}
        for s in newly:
            # a prompt longer than every configured bucket pads straight to
            # max_seq (admission already truncated it to max_seq - 1)
            L = next((b for b in buckets if b >= s["plen"]),
                     self.scfg.max_seq)
            groups.setdefault(L, []).append(s)
        free = iter(i for i, s in enumerate(slots) if s is None)
        dev = self.device
        for L, grp in sorted(groups.items()):
            while grp:
                bk = _pow2_at_least(len(grp), self.scfg.batch_slots)
                toks = np.full((bk, L), self.pad, np.int32)
                lens = np.zeros((bk,), np.int32)
                for row, s in enumerate(grp):
                    toks[row, :s["plen"]] = s["prompt"]
                    lens[row] = s["plen"]
                exe, _ = self._resolve_prefill(bk, L)
                rids = [s["rid"] for s in grp]
                try:
                    first, cache = self._call_step("prefill", rids, exe,
                                                   _int32(toks, dev),
                                                   _int32(lens, dev),
                                                   _int32(step_i, dev),
                                                   slots=grp)
                except PoisonError as e:
                    bad = next(s for s in grp if s["rid"] == e.rid)
                    self._emit_err(out_chan, e.rid, "poisoned", str(e),
                                   slot=bad)
                    grp = [s for s in grp if s["rid"] != e.rid]
                    continue                # retry the group without it
                except Exception as e:  # noqa: BLE001 - group-level failure
                    from .admission import BreakerOpen
                    st = "overloaded" if isinstance(e, BreakerOpen) \
                        else "error"
                    for s in grp:
                        self._emit_err(out_chan, s["rid"], st,
                                       str(e) if st == "overloaded"
                                       else repr(e)[:200], slot=s)
                    break
                step_i += 1
                first = _host(first)       # [bk] sampled on device
                write = self._resolve_write(bk)
                for row, s in enumerate(grp):
                    slot = next(free)
                    packed = write(packed, cache, _int32(row, dev),
                                   _int32(slot, dev))
                    s["next"] = int(first[row])
                    self._note_tok(s, s["next"])
                    slots[slot] = s
                break
        return packed, step_i

    def collector(self, out_in, results: dict) -> None:
        while True:
            if out_in.eot():               # shutdown transaction
                out_in.open()
                break
            hdr = out_in.read()
            if hdr[0] == "err":            # quarantined/rejected request
                _, rid, status, detail, retry_after = hdr
                for _ in out_in.read_transaction():
                    pass
                results[rid] = RequestError(rid, status, detail,
                                            retry_after_s=retry_after)
                continue
            kind, rid = hdr
            assert kind == "hdr"
            results[rid] = [t for (_, t) in out_in.read_transaction()]

    # -- top ------------------------------------------------------------------

    def top(self, requests: list, results: dict) -> None:
        cap = self.scfg.queue_cap          # bounded admission queue
        req = channel(capacity=cap, name="requests")
        out = channel(capacity=cap, name="outputs")
        # traffic-timed mode: requests carrying arrival times, an
        # admission controller, or an explicit pace select the paced
        # frontend; plain request lists keep the seed task graph
        timed = (self.admission is not None or self.pace is not None
                 or any(getattr(r, "t_arrival", None) is not None
                        for r in requests))
        if timed:
            tick = channel(capacity=1, name="ticks") \
                if self.pace == "virtual" else None
            task() \
                .invoke(self.traffic_frontend, requests, req, tick,
                        results) \
                .invoke(self.scheduler, req, out, tick) \
                .invoke(self.collector, out, results)
        else:
            task() \
                .invoke(self.frontend, requests, req, results) \
                .invoke(self.scheduler, req, out) \
                .invoke(self.collector, out, results)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def serve_requests(engine: ServingEngine, requests: list,
                   sim_engine: str = "coroutine", faults: Any = None,
                   watchdog_s: Optional[float] = None) -> dict:
    """One-call host API for serving (paper Section 3.1.4).

    ``faults`` (a FaultPlan or FaultInjector) arms BOTH the serving-level
    faults (poison/cancel/transient, via ``engine.faults``) and the
    channel/task-level faults of the simulation engine that hosts the
    serving task graph; ``watchdog_s`` bounds the whole run's wall clock
    with the unified deadlock watchdog.
    """
    results: dict = {}
    if faults is not None:
        if not hasattr(faults, "serving_check"):
            faults = faults.injector()
        engine.faults = faults
    rep = ENGINES[sim_engine](faults=faults,
                              watchdog_s=watchdog_s).run(
        engine.top, requests, results)
    if not rep.ok:
        raise RuntimeError(f"serving failed: {rep.error}")
    return results

"""Serving driver: continuous batching over TAPA channels, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch qwen3-0.6b                      # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch granite-moe-1b-a400m            # the moe family, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch zamba2-1.2b                     # hybrid, per slot, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 12                          # reduced config, on the CPU

The request stream, the admission scheduler (peek) and the per-request
transactions (EoT) run as a task graph under the coroutine engine; the
compute inside is the batched packed-slot decode of the selected model:
one decode step call per iteration for every slot (its attention through
the flash-decode kernel), on-device sampling, and length-bucketed
prefill (through the flash kernel), every shape resolved at warmup through the persistent compile
cache (``repro_torch.core.compile_cache.default_cache()``: AOTInductor
packages on the card, exported programs on the CPU), so a warm process
compiles nothing; a warmup that fails raises, and nothing then serves
eagerly or on another path.  ``--no-cache`` runs every shape once
eagerly instead.  ``--per-slot`` selects the
seed per-slot path instead: one prefill and one decode call a request
and token, greedy.  The attention-cache families (dense, vlm text-only
as the reference serves it, moe) take the batched path; the recurrent
families (ssm, hybrid) take the per-slot path, decided by family before
anything runs (a bucket's pads would enter their state).  The audio
family is refused: a request carries no encoder frames (the
reference's per-slot prefill passes none either and fails on each
request).  Weights are random, from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from functools import partial

import numpy as np
import torch

from ..configs import get_config
from ..core.compile_cache import default_cache
from ..core.synth import resolve_device
from ..ft import PreemptionGuard
from ..models import lm
from ..serve import (AdmissionConfig, AdmissionController, Request,
                     RequestError, ServeConfig, ServeMetrics, ServingEngine,
                     TenantSpec, make_trace, serve_requests)


def per_slot_engine(params, cfg, scfg: ServeConfig,
                    device: torch.device) -> ServingEngine:
    """The per-slot engine: one prefill call a request and one decode call
    a slot and token, greedy.  The model runs with
    ``attn_impl="kernel"`` and ``use_kernel``, so every kernel-backed op
    takes its kernel on the card (the SSD scan, flash attention,
    flash-decode over the scalar-length cache) and its plain version on
    the CPU.  The steps take the weights as their first argument (bound
    with ``partial``), so a compiled step holds none."""
    max_seq = scfg.max_seq
    cfg = dataclasses.replace(cfg, attn_impl="kernel")

    # tokens: the engine's host arrays (eager) or device tensors (the
    # compiled steps)
    def prefill_fn(params, tokens):
        return lm.prefill(params, cfg, torch.as_tensor(tokens, device=device),
                          max_seq=max_seq, use_kernel=True)

    def decode_fn(params, token, cache):
        return lm.decode_step(params, cfg,
                              torch.as_tensor(token, device=device), cache)

    return ServingEngine(scfg, partial(prefill_fn, params),
                         partial(decode_fn, params), device=device)


def _build_engine(cfg, params, scfg: ServeConfig, args,
                  device: torch.device) -> ServingEngine:
    if not args.per_slot:
        # the prefill's attention through the flash kernel (its plain
        # version on the CPU), as in the per-slot engine
        adapter = lm.serving_adapter(
            params, dataclasses.replace(cfg, attn_impl="kernel"),
            max_seq=scfg.max_seq,
            temperature=args.temperature, top_k=args.top_k,
            seed=args.seed, device=device)
        return ServingEngine(scfg, batched=adapter)
    if args.temperature > 0 or args.top_k:
        print("[serve] WARNING: the per-slot path is greedy-only; "
              "--temperature/--top-k are ignored")
    return per_slot_engine(params, cfg, scfg, device)


def _print_warmup(info: dict) -> None:
    if "buckets" in info and info["decode"] == "eager":
        print(f"[serve] warmup: ran prefill buckets "
              f"{list(info['buckets'])}; decode step: eager")
    elif "buckets" in info:
        hits = [k for k, v in info["buckets"].items() if v != "compiled"]
        fresh = [k for k, v in info["buckets"].items() if v == "compiled"]
        print(f"[serve] warmup: prefill buckets cached={hits or '-'} "
              f"fresh-compile={fresh or '-'}; "
              f"decode step: {info['decode']}")
    else:
        print(f"[serve] warmup: prefill={info['prefill']} "
              f"decode={info['decode']}")


def serve(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-slot", action="store_true",
                    help="seed path: one decode call per slot per token")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on device")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget from admission")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal (JSONL).  A restarted "
                         "process given the same flags replays it: retired "
                         "requests answer from the journal, in-flight ones "
                         "resume at their last journaled token — "
                         "exactly-once results across SIGKILL")
    ap.add_argument("--traffic", choices=("poisson", "burst"), default=None,
                    help="open-loop traffic mode: seeded Poisson or bursty "
                         "on/off (MMPP) arrivals paced in wall time under "
                         "the thread engine, instead of a back-to-back "
                         "request list")
    ap.add_argument("--tenants", type=int, default=2,
                    help="number of traffic tenants (fair-queued)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrival rate per tenant (requests/s)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="traffic trace duration (seconds)")
    ap.add_argument("--shed-policy",
                    choices=("none", "reject-new", "drop-oldest"),
                    default="reject-new",
                    help="admission-control shed policy under --traffic; "
                         "'none' disables the admission controller (the "
                         "frontend blocks on a full queue)")
    ap.add_argument("--queue-limit", type=int, default=32,
                    help="admission-controller backlog bound (requests)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; without one, pass --device cpu)")
    ap.add_argument("--no-cache", action="store_true",
                    help="warm up by running every shape once eagerly, "
                         "not through the compile cache")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.with_reduced()
    if cfg.family not in lm.BATCHED_FAMILIES + lm.PER_SLOT_FAMILIES:
        raise ValueError(
            f"launch.serve cannot serve the {cfg.family!r} family: a "
            f"request carries tokens only, and its encoder needs frames "
            f"(the reference's per-slot prefill passes none and fails on "
            f"each request with KeyError('frames')); run it through "
            f"launch.steps.make_prefill_step with batch['frames'] and "
            f"make_decode_step")
    if cfg.family in lm.PER_SLOT_FAMILIES and not args.per_slot:
        print(f"[serve] the {cfg.family} family serves per slot: its "
              f"recurrent state would absorb a bucket's pads")
        args.per_slot = True
    device = resolve_device(args.device)
    print(f"[serve] arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count()/1e6:.1f}M slots={args.slots} "
          f"device={device}")

    params = lm.init_params(cfg, args.seed, device=device)
    scfg = ServeConfig(batch_slots=args.slots, max_seq=args.max_seq)
    engine = _build_engine(cfg, params, scfg, args, device)

    t0 = time.perf_counter()
    cache = None if args.no_cache else default_cache()
    if engine.batched is not None:
        # warm every admission shape a serving process can meet: all
        # power-of-two prefill batch dims up to the slot count, plus the
        # slot count itself (a full wave pads to it when it is not pow2)
        sizes = tuple(sorted({min(2 ** k, args.slots)
                              for k in range(args.slots.bit_length())}
                             | {args.slots}))
        info = engine.warmup(batch_sizes=sizes, cache=cache)
    else:
        info = engine.warmup(cache=cache)
    if not info.get("ok"):
        # a step that cannot be compiled fails here: the batched path
        # never gives way to the per-slot one (--per-slot chooses it),
        # nor the compiled path to eager (--no-cache chooses it)
        raise RuntimeError(f"[serve] warmup through the compile cache "
                           f"failed: {info.get('reason')}")
    warm = time.perf_counter() - t0
    mode = "batched" if engine.batched is not None else "per-slot"
    _print_warmup(info)
    print(f"[serve] warmup took {warm:.2f}s mode={mode}")
    n_warm_log = len(engine.compile_log)

    sim_engine = "coroutine"
    metrics = None
    if args.traffic:
        # seeded open-loop traffic: the trace is a pure function of
        # (--seed, tenant mix, duration) — see serve/traffic.py
        phases = {"on_s": 0.4, "off_s": 0.4, "on_scale": 3.0} \
            if args.traffic == "burst" else None
        tenants = [TenantSpec(name=f"t{i}", rate=args.rate,
                              max_new=(args.max_new, args.max_new),
                              deadline_s=args.deadline_s, phases=phases)
                   for i in range(args.tenants)]
        reqs = make_trace(tenants, args.duration, seed=args.seed,
                          vocab=cfg.vocab)
        metrics = engine.metrics = ServeMetrics()
        if args.shed_policy != "none":
            ctrl = AdmissionController(
                AdmissionConfig(shed_policy=args.shed_policy,
                                queue_limit=args.queue_limit),
                metrics=metrics)
            ctrl.register_tenants(tenants)
            engine.admission = ctrl
            ctrl.journal = engine.journal
        engine.pace = "wall"
        sim_engine = "thread"     # wall pacing needs preemptive tasks
        print(f"[serve] traffic={args.traffic} tenants={args.tenants} "
              f"rate={args.rate}/s x {args.duration}s -> "
              f"{len(reqs)} requests, shed-policy={args.shed_policy}")
    else:
        rng = np.random.default_rng(args.seed)
        reqs = [Request(rid=i,
                        prompt=rng.integers(
                            0, cfg.vocab, rng.integers(4, 17)).tolist(),
                        max_new=args.max_new,
                        deadline_s=args.deadline_s)
                for i in range(args.requests)]

    # preemption-safe serving: SIGTERM/SIGINT flips the guard; the
    # scheduler then rejects queued admissions with "preempted" errors,
    # finishes the in-flight slots, flushes results and exits clean
    guard = PreemptionGuard()
    engine.stop_flag = lambda: guard.requested
    if args.journal:
        from ..serve import ServeJournal
        engine.journal = ServeJournal(args.journal)
        if engine.journal.completed or engine.journal.inflight:
            print(f"[serve] journal replay: "
                  f"{len(engine.journal.completed)} retired, "
                  f"{len(engine.journal.inflight)} in-flight")
    try:
        t0 = time.perf_counter()
        results = serve_requests(engine, reqs, sim_engine=sim_engine)
        wall = time.perf_counter() - t0
    finally:
        guard.uninstall()
    ok = {r: v for r, v in results.items() if not isinstance(v, RequestError)}
    failed = {r: v for r, v in results.items() if isinstance(v, RequestError)}
    n_new = sum(len(v) for v in ok.values())
    if not args.traffic:               # traffic mode prints a summary instead
        for rid in sorted(results):
            v = results[rid]
            if isinstance(v, RequestError):
                print(f"[serve] req {rid}: {v.status} ({v.detail})")
            else:
                print(f"[serve] req {rid}: prompt "
                      f"{len(reqs[rid].prompt):2d} tok -> {v}")
    lazy = engine.compile_log[n_warm_log:]
    if lazy:
        print(f"[serve] shapes first run during serving: "
              f"{[(k, s) for k, s, _ in lazy]}")
    if guard.requested:
        print(f"[serve] preempted: {len(ok)} completed, "
              f"{len(failed)} rejected")
    print(f"[serve] {len(ok)} requests, {n_new} tokens in {wall:.2f}s "
          f"({n_new/max(wall,1e-9):.1f} tok/s, {mode} decode)")
    if metrics is not None:
        metrics.check_accounting()
        summ = metrics.summary(wall_s=wall)

        def _ms(v):
            return "-" if v is None else f"{v * 1e3:.0f}ms"

        print(f"[serve] overload: offered={summ['offered']} "
              f"admitted={summ['admitted']} shed={summ['shed']} "
              f"completed={summ['completed']} "
              f"goodput={summ['goodput_tok_s'] or 0:.1f} tok/s "
              f"ttft p50={_ms(summ['ttft_p50_s'])} "
              f"p99={_ms(summ['ttft_p99_s'])}")
        for name, row in summ["tenants"].items():
            print(f"[serve]   tenant {name}: offered={row['offered']} "
                  f"admitted={row['admitted']} shed={row['shed']} "
                  f"ttft p50={_ms(row['ttft_p50_s'])} "
                  f"p99={_ms(row['ttft_p99_s'])}")
        # open-loop contract: every offered request gets an answer —
        # tokens or a structured error — never a silent absence
        return 0 if len(results) == len(reqs) else 1
    # a preempted run that answered every request (some with structured
    # rejections) still exits clean — that is the graceful-drain contract
    if guard.requested:
        return 0 if len(results) == args.requests else 1
    return 0 if len(ok) == args.requests else 1


if __name__ == "__main__":
    sys.exit(serve())

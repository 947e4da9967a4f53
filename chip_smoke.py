#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis, LM-serving and training paths on
one CUDA card and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device — the card's name and power limit (``nvidia-smi``), CUDA
   version; TF32 matmuls off.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` into
   ``build/kernels/``, one compiler process per source, all at once.
3. kernels — each ring kernel against its plain PyTorch version on the
   card, exactly, at the main path's shapes and at the edge cases
   (wraparound, ``n == cap``, ``cap == 1``, int32 and bool elements);
   CUDA-event times of kernel, plain version and one library call, each
   timed call starting from a head/size inside the op's contract.
4. main path — gemm, gaussian and page_rank through
   ``run_step(engine="compiled")`` at full size, with launch counts
   read just before and just after each app: every ring kernel must have
   launched in every app's run.  Then each app at full size once more,
   held against the reference and against the CPU lowering of the same
   graph, relative to the output's scale (``REF_REL_TOL``,
   ``CPU_REL_TOL``).
5. twin vs compiled — each app at a reduced size under the coroutine
   twin and under ``CompiledEngine``, both on the card: bit-identical
   outputs and equal token counts; the sweeps equal those of the CPU
   (plain-version) lowering of the same graph.
6. breakdown — each app at full size once more, under ``torch.profiler``:
   seconds in the app's build, the lowering (wiring + counting pass) and
   the sweep loop; the device's busy share of the sweep loop; each ring
   kernel's mean device time per launch.  Measurement only: the checks
   are phases 3-5.
7. attention kernels — flash attention forward and flash-decode against
   their plain versions on the card, in float32 and bfloat16, at the
   serving path's shapes (Qwen3-0.6B: 16 query heads, 8 KV heads of
   width 128; prefill buckets 8-2048, batch 1 and 8, causal, one
   windowed and one head-width-64 case; decode at 8 slots of a 2048-row
   cache with ragged lengths, 0 and 2048 included).  Limits, relative to
   the plain output's largest magnitude: ``ATTN_REL_TOL``; flash's
   ``lse`` within ``LSE_ABS_TOL``; exact zeros where ``kv_len == 0``.
   CUDA-event times of kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port), reading a different layer's tensors on each call as the model
   does, so the 50 MB L2 holds none of them.
8. serving — Qwen3-0.6B at full width (28 layers, bf16, random weights
   from a seed) through ``ServingEngine`` + ``lm.serving_adapter`` +
   ``serve_requests`` with ``attn_impl="kernel"``: 8 slots of 2048
   positions, 16 requests with prompts of 64-1500 tokens, 32 new tokens
   each.  Launch counts are zeroed just before the requests and read just
   after: flash attention launched once per layer per prefill call,
   flash-decode once per layer per decode step; no logit NaN.  Then
   ``repro_torch.launch.serve.serve(["--full"])`` at its defaults.
9. card vs CPU — Qwen3-0.6B at full width cut to 2 layers, float32, the
   same weights on both devices: bucketed prefill of 4 ragged prompts
   (37-512 tokens) and 8 ragged decode steps, logits within
   ``LOGIT_REL_TOL`` of their largest magnitude, equal greedy tokens.
10. serving breakdown — the first wave of phase 8 again under
   ``torch.profiler`` (device activity): its prefill and decode seconds,
   the device's busy share and each attention kernel's mean device time
   per launch; then the decode step alone, 32 times over that wave's 8
   live slots: host and device ms per step, the busy share, and the aten
   operations one step dispatches.

11. SSD scan — ``ops.ssd_scan`` (the kernel) against its plain version
   through the same wrapper and against a float64 evaluation, at the
   training shape (B=8, S=2048, 24 heads of P=64, N=128, chunk 256), B=1,
   S=1000 (the pad path), G=2, N=64 and the reduced 16x16, with the
   model's decays and small ones (``SSD_REL_TOL``; at small decays the
   inter-chunk term must be a visible part of y); CUDA-event times of
   kernel and plain version at the training shape, the bound, and the
   kernels' device time per call.
12. training — ``repro_torch.launch.train`` on Mamba2-130M at full width
   (bf16, 8 x 2048, 20 steps, ``--use-kernel``): rc 0 (the driver's own
   loss-decrease check), exactly 2 x 24 x 20 SSD launches (remat runs each
   layer's forward twice), finite losses and gradient norms, the step-20
   checkpoint restorable, and the same command again runs no step.
13. Qwen3-0.6B at full width, 3 ``make_train_step(use_kernel=True)``
   steps at 4 x 1024: flash launched 2 x 28 x 3 times, all finite.
14. card vs CPU — Mamba2-130M cut to 2 layers, float32, the same weights
   and tokens: loss, every gradient leaf and one AdamW step
   (``TRAIN_CPU_TOL``).
15. training breakdown — one step of phase 12's configuration under the
   profiler: the device's busy share, the SSD kernel's device time and
   share, the top device operations; the backward's recompute alone.

Each phase's seconds are printed.
The last four lines of standard output are the ``nvidia-smi`` line, the
JSON object of per-kernel numbers after the word ``kernels``, the same
object alone, and the result object ``{"ok": true, "device": {...}}``.
Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = f"{CSRC}/ring.cu"
SOURCES = {"ring": SOURCE,
           "flash_attention": f"{CSRC}/flash_attention.cu",
           "decode_attention": f"{CSRC}/decode_attention.cu",
           "ssd_scan": f"{CSRC}/ssd_scan.cu"}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# The guards' int32 compares run on the CUDA cores.  The data sheet gives
# no integer rate outside the tensor cores; its float32 CUDA-core rate
# stands in (an upper bound on the int32 rate, so the bound stays a bound).
CUDA_CORE_OPS_PER_S = 67e12
# Attention is bounded against the bf16 tensor-core rate: the least time
# the card could take, whatever the kernel does its products on.
TENSOR_BF16_FLOPS = 989e12
# Kernel vs plain version on the card, max |kernel - plain| / max |plain|.
# float32: both sum in float32, in other orders.  bfloat16: both compute
# in float32 from the same bf16 inputs and round the output once; one
# bf16 ulp of an output near its largest magnitude is ~4e-3.
ATTN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LSE_ABS_TOL = 1e-5
# Card (kernels, cuBLAS) vs CPU (plain versions) on the same float32
# weights: max |card - cpu| / max |cpu| over the logits.
LOGIT_REL_TOL = 1e-4
ARCH = "qwen3-0.6b"
DEV = "cuda"                # the LM phases' device
SERVE = dict(slots=8, max_seq=2048, requests=16, prompt=(64, 1500),
             max_new=32, seed=0)
# Full-size card run against the CPU (plain-version) lowering of the same
# graph: max |card - cpu| / max |cpu|.  gemm sums its 4096-long dot
# products in another order in cuBLAS than on the CPU; the other two run
# the same elementwise ops in the same order on both.
CPU_REL_TOL = {"gemm": 1e-5, "gaussian": 1e-6, "page_rank": 1e-6}
# max |card - reference| / max |reference|, for every app: well under the
# apps' own check() limits, which are set for the reference's toy sizes.
REF_REL_TOL = 1e-5
FULL = {
    "gemm": dict(P=8, n=256, K=16),
    "gaussian": dict(h=2048, w=2048, iters=4),
    "page_rank": dict(n_vertices=65536, n_edges=1048576, n_pe=4,
                      n_iters=10),
}
REDUCED = {
    "gemm": dict(P=2, n=32, K=4),
    "gaussian": dict(h=64, w=64, iters=2),
    "page_rank": dict(n_vertices=1024, n_edges=8192, n_pe=2, n_iters=4),
}
REPLACES = {
    "ring_pop": "src/repro/kernels/ring.py:84",
    "ring_push": "src/repro/kernels/ring.py:141",
    "eval_guards": "src/repro/kernels/ring.py:200",
}
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:45",
    "decode_attention": "src/repro/kernels/decode_attention.py:35",
}
# device kernels of each attention op, as the profiler names them
ATTN_KERNELS = {"flash_attention": ("flash_fwd_kernel",),
                "decode_attention": ("decode_split_kernel",
                                     "decode_combine_kernel")}


def log(*a) -> None:
    print(*a, flush=True)


REPS, WARM = 200, 20


def time_ms(fn, reps: int = REPS, warm: int = WARM) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls on the
    current stream, after ``warm`` calls; CUDA events, one sync.  ``fn``
    takes the call's index, ``0 .. warm + reps - 1``."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(warm, warm + reps):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    """The larger of bytes over HBM bandwidth and operations over the
    given peak rate, and which of the two it is."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class _Counters:
    """One fresh (head, size) pair per timed call: 0-d int32 views into two
    device vectors, so every call of a ring op starts from a state inside
    its contract (``0 <= size``, ``size + n <= cap`` for a push, ``n <=
    size`` for a pop) with no reset launched between calls."""

    def __init__(self, head: int, size: int, k: int = WARM + REPS):
        self.heads = torch.full((k,), head, dtype=torch.int32, device="cuda")
        self.sizes = torch.full((k,), size, dtype=torch.int32, device="cuda")
        self.h = self.heads.unbind()
        self.s = self.sizes.unbind()

    def expect(self, op: str, head: int, size: int) -> None:
        """Raise unless every call left the state the op's contract
        gives."""
        if not (bool((self.heads == head).all())
                and bool((self.sizes == size).all())):
            raise AssertionError(f"{op}: timed calls left head/size other "
                                 f"than ({head}, {size})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _ring(cap, elem, dtype, head, size, gen):
    shape = (cap,) + tuple(elem)
    if dtype == torch.bool:
        buf = torch.rand(shape, generator=gen) > 0.5
    elif dtype == torch.int32:
        buf = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                            dtype=torch.int32)
    else:
        buf = torch.randn(shape, generator=gen, dtype=dtype)
    mk = lambda v: torch.tensor(v, dtype=torch.int32)   # noqa: E731
    return buf.cuda(), mk(head).cuda(), mk(size).cuda()


def _max_err(*pairs) -> float:
    """Largest absolute difference over (kernel, plain) tensor pairs
    (bool and int compared as numbers)."""
    err = 0.0
    for a, b in pairs:
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, float(d))
    return err


def check_pop_push(case: dict, gen) -> tuple[float, float]:
    """One pop and one push case, kernel vs plain on the card; raises on
    any difference, returns the (pop, push) max abs differences."""
    from repro_torch.kernels import ring
    cap, elem, dt = case["cap"], case["elem"], case["dtype"]
    head, size, n, m = case["head"], case["size"], case["n"], case["push_n"]
    # pop n from a ring holding `size` tokens from `head`
    buf, h, s = _ring(cap, elem, dt, head, size, gen)
    kb, kh, ks = buf.clone(), h.clone(), s.clone()
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    ktoks, _, _ = ring.ring_pop(kb, kh, ks, n)
    ptoks, _, _ = ring.ring_pop_plain(pb, ph, ps, n)
    torch.cuda.synchronize()
    pairs = [(ktoks, ptoks), (kb, pb), (kh, ph), (ks, ps)]
    pop_err = _max_err(*pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"ring_pop differs from plain: {case}")
    # push m into a ring with exactly m free slots from the same head
    buf, h, s = _ring(cap, elem, dt, head, cap - m, gen)
    arr = _ring(max(m, 1), elem, dt, 0, 0, gen)[0][:m]
    kb, kh, ks = buf.clone(), h.clone(), s.clone()
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    ring.ring_push(kb, kh, ks, arr)
    ring.ring_push_plain(pb, ph, ps, arr)
    torch.cuda.synchronize()
    pairs = [(kb, pb), (kh, ph), (ks, ps)]
    push_err = _max_err(*pairs)
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"ring_push differs from plain: {case}")
    return pop_err, push_err


def check_guards(T: int, C: int, gen) -> float:
    from repro_torch.kernels import ring
    caps = torch.randint(1, 9, (C,), generator=gen, dtype=torch.int32)
    sizes = (torch.rand(C, generator=gen) * (caps + 1)).to(torch.int32)
    need_r = torch.randint(0, 3, (T, C), generator=gen, dtype=torch.int32)
    need_w = torch.randint(0, 3, (T, C), generator=gen, dtype=torch.int32)
    # most rows need nothing on most channels, as in a real graph
    need_r *= (torch.rand(T, C, generator=gen) < 0.02)
    need_w *= (torch.rand(T, C, generator=gen) < 0.02)
    live = torch.rand(T, generator=gen) < 0.9
    args = [x.cuda() for x in (sizes, caps, need_r, need_w, live)]
    kf = ring.eval_guards(*args)
    pf = ring.eval_guards_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(kf, pf):
        raise AssertionError(f"eval_guards differs from plain at T={T} "
                             f"C={C}")
    return _max_err((kf, pf))


def kernel_phase() -> tuple[dict, dict]:
    from repro_torch.kernels import ring
    gen = torch.Generator().manual_seed(0)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    cases = [
        # main-path shapes: gemm a/b rings, gemm c rings, gaussian rows,
        # page_rank rank vectors
        dict(tag="gemm a/b", cap=2, elem=(256, 256), dtype=f32, head=1,
             size=1, n=1, push_n=1),
        dict(tag="gemm c", cap=1, elem=(256, 256), dtype=f32, head=0,
             size=1, n=1, push_n=1),
        dict(tag="gaussian", cap=4096, elem=(), dtype=f32, head=2048,
             size=2048, n=2048, push_n=2048),
        dict(tag="page_rank", cap=1, elem=(65536,), dtype=f32, head=0,
             size=1, n=1, push_n=1),
        # edge cases the main path never reaches at these sizes
        dict(tag="wrap", cap=5, elem=(3,), dtype=f32, head=3, size=5, n=4,
             push_n=4),
        dict(tag="wrap int32", cap=7, elem=(2, 3), dtype=i32, head=5,
             size=6, n=6, push_n=6),
        dict(tag="wrap bool", cap=7, elem=(2, 3), dtype=b, head=6, size=7,
             n=7, push_n=7),
        dict(tag="n=cap", cap=8, elem=(5,), dtype=f32, head=0, size=8,
             n=8, push_n=8),
        dict(tag="cap=1", cap=1, elem=(), dtype=i32, head=0, size=1, n=1,
             push_n=1),
        dict(tag="bool scalar", cap=9, elem=(), dtype=b, head=4, size=9,
             n=9, push_n=9),
    ]
    errs = {"ring_pop": 0.0, "ring_push": 0.0, "eval_guards": 0.0}
    for c in cases:
        e_pop, e_push = check_pop_push(c, gen)
        errs["ring_pop"] = max(errs["ring_pop"], e_pop)
        errs["ring_push"] = max(errs["ring_push"], e_push)
    log(f"kernels: ring_pop/ring_push exact on {len(cases)} cases "
        f"({', '.join(c['tag'] for c in cases)})")
    n_tasks, n_chans = 8 + 8 + 64 + 8, 3 * 64     # gemm P=8
    for T, C in [(n_tasks, n_chans), (6, 5), (1, 1), (33, 70), (4, 0)]:
        errs["eval_guards"] = max(errs["eval_guards"],
                                  check_guards(T, C, gen))
    log(f"kernels: eval_guards exact at T x C = {n_tasks} x {n_chans}, "
        f"6x5, 1x1, 33x70, 4x0")

    # times at the main path's shapes; every timed call gets its own
    # in-contract head/size (a pop from `size` tokens, a push into exactly
    # n free slots), checked again after the timing
    timing = {"ring_pop": [], "ring_push": [], "eval_guards": []}
    for c in cases[:4]:
        cap, head, size, n = c["cap"], c["head"], c["size"], c["n"]
        buf = _ring(cap, c["elem"], c["dtype"], 0, 0, gen)[0]
        row = buf[0].numel() * buf.element_size()
        idx = ((head + torch.arange(n)) % cap).cuda()
        arr = buf[:n].clone()
        nb = 2 * n * row + 16           # rows in + out, head/size r+w
        bnd, by = bound_ms(nb)
        times = {}
        for op, fn in (("ring_pop", ring.ring_pop),
                       ("ring_pop_plain", ring.ring_pop_plain)):
            st = _Counters(head, size)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], n))
            st.expect(op, (head + n) % cap, size - n)
        for op, fn in (("ring_push", ring.ring_push),
                       ("ring_push_plain", ring.ring_push_plain)):
            st = _Counters(head, cap - n)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], arr))
            st.expect(op, head, cap)
        timing["ring_pop"].append(dict(
            shape=c["tag"], n=n, cap=cap, row_bytes=row,
            ms=times["ring_pop"], plain_ms=times["ring_pop_plain"],
            library_ms=time_ms(lambda i: buf.index_select(0, idx)),
            bound_ms=bnd, bound_by=by))
        timing["ring_push"].append(dict(
            shape=c["tag"], n=n, cap=cap, row_bytes=row,
            ms=times["ring_push"], plain_ms=times["ring_push_plain"],
            library_ms=time_ms(lambda i: buf.index_copy_(0, idx, arr)),
            bound_ms=bnd, bound_by=by))
    T, C = n_tasks, n_chans
    g = torch.Generator().manual_seed(1)
    caps = torch.full((C,), 2, dtype=torch.int32)
    args = [x.cuda() for x in (
        torch.randint(0, 3, (C,), generator=g, dtype=torch.int32), caps,
        torch.randint(0, 2, (T, C), generator=g, dtype=torch.int32),
        torch.randint(0, 2, (T, C), generator=g, dtype=torch.int32),
        torch.ones(T, dtype=torch.bool))]
    nb = 2 * T * C * 4 + 2 * C * 4 + 2 * T
    bnd, by = bound_ms(nb, ops=4 * T * C)
    timing["eval_guards"].append(dict(
        shape=f"gemm T x C = {T} x {C}",
        ms=time_ms(lambda i: ring.eval_guards(*args)),
        plain_ms=time_ms(lambda i: ring.eval_guards_plain(*args)),
        library_ms=None, bound_ms=bnd, bound_by=by))
    for k, rows in timing.items():
        for r in rows:
            log(f"time {k:11s} {r['shape']:24s} kernel {r['ms']*1e3:8.2f} us"
                f"  plain {r['plain_ms']*1e3:8.2f} us  library "
                + (f"{r['library_ms']*1e3:8.2f} us" if r["library_ms"]
                   is not None else "    none")
                + f"  bound {r['bound_ms']*1e3:7.3f} us ({r['bound_by']})")
    return timing, errs


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path, and twin vs compiled
# ---------------------------------------------------------------------------

def main_path() -> tuple[dict, dict]:
    from repro_torch.apps import APPS
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    per_app = {}
    reset_launches()
    for name, kw in FULL.items():
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = APPS[name].run_step("compiled", device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        launches = {k: after.get(k, 0) - before.get(k, 0)
                    for k in REPLACES}
        if not r.ok:
            raise AssertionError(f"{name}: run failed or check() failed: "
                                 f"{r.report.error} correct={r.correct} "
                                 f"err={r.max_err}")
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"{name}: its run never launched {k}: "
                                     f"{launches}")
        sweeps = r.report.switches
        per_app[name] = dict(params=kw, check=bool(r.correct),
                             max_err=r.max_err, sweeps=sweeps, wall_s=wall,
                             sweeps_per_s=sweeps / wall, launches=launches)
        log(f"main {name}: check {r.correct} max_err {r.max_err:.3e} "
            f"sweeps {sweeps} wall {wall:.3f} s "
            f"({sweeps / wall:.1f} sweeps/s) launches {launches}")
    return per_app, launch_counts()


def _outputs(name: str, args) -> torch.Tensor:
    if name == "gemm":
        return torch.cat([m.data for m in args[2]])
    return args[1].data


def full_size_vs_cpu() -> dict:
    """Each app at full size once more on the card, held tightly against
    the reference (relative to the output's scale) and against the CPU
    lowering of the same graph, whose ring ops take their plain
    versions."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL.items():
        ys = {}
        for dev in ("cuda", "cpu"):
            top, args, check = APPS[name].build_step(device=dev, **kw)
            rep = ENGINES["compiled"](device=dev).run(top, *args)
            if not rep.ok:
                raise AssertionError(f"{name} on {dev}: {rep.error}")
            ys[dev] = _outputs(name, args).cpu().double()
            if dev == "cuda":
                _, ref_err = check()
        scale = float(ys["cpu"].abs().max())
        rel_ref = ref_err / scale
        rel_cpu = float((ys["cuda"] - ys["cpu"]).abs().max()) / scale
        if not (rel_ref < REF_REL_TOL and rel_cpu <= CPU_REL_TOL[name]):
            raise AssertionError(
                f"{name}: max err / max |out| = {rel_ref:.3e} against the "
                f"reference (limit {REF_REL_TOL:g}), {rel_cpu:.3e} against "
                f"the CPU lowering (limit {CPU_REL_TOL[name]:g})")
        out[name] = dict(rel_err_ref=rel_ref, rel_err_cpu=rel_cpu,
                         max_abs_out=scale)
        log(f"full {name}: card vs reference {rel_ref:.3e}, card vs CPU "
            f"lowering {rel_cpu:.3e} of max |out| {scale:.4e} (limits "
            f"{REF_REL_TOL:g}, {CPU_REL_TOL[name]:g})")
    return out


def twin_vs_compiled() -> dict:
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in REDUCED.items():
        mod = APPS[name]
        top, args, _ = mod.build_step(device="cuda", **kw)
        twin = ENGINES["coroutine"](track_stats=True).run(top, *args)
        y_twin = _outputs(name, args).clone()
        top, args, _ = mod.build_step(device="cuda", **kw)
        comp = ENGINES["compiled"](track_stats=True, device="cuda") \
            .run(top, *args)
        y_comp = _outputs(name, args).clone()
        top, args, _ = mod.build_step(device="cpu", **kw)
        comp_cpu = ENGINES["compiled"](device="cpu").run(top, *args)
        if not (twin.ok and comp.ok and comp_cpu.ok):
            raise AssertionError(f"{name}: twin {twin.error} / compiled "
                                 f"{comp.error} / cpu {comp_cpu.error}")
        fires_twin = all(st == "finished" for _, st in twin.instances)
        fires_comp = all(st == "finished" for _, st in comp.instances)
        if not torch.equal(y_twin, y_comp):
            raise AssertionError(f"{name}: twin and compiled outputs differ "
                                 f"on the card")
        if twin.tokens != comp.tokens or not (fires_twin and fires_comp):
            raise AssertionError(f"{name}: tokens {twin.tokens} vs "
                                 f"{comp.tokens}, all fired {fires_twin} "
                                 f"{fires_comp}")
        if comp.switches != comp_cpu.switches:
            raise AssertionError(f"{name}: {comp.switches} sweeps on the "
                                 f"card vs {comp_cpu.switches} on the CPU")
        out[name] = dict(params=kw, bitwise=True, tokens=comp.tokens,
                         sweeps=comp.switches)
        log(f"twin {name}: twin == compiled bitwise on the card, tokens "
            f"{comp.tokens}, sweeps {comp.switches} (== CPU lowering)")
    return out


def _device_us(prof) -> tuple[float, dict]:
    """Total device microseconds in a profile, and per ring kernel
    (launches, total us)."""
    total, per = 0.0, {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        total += us
        for k in REPLACES:
            if f"{k}_kernel" in e.key:
                n, t = per.get(k, (0, 0.0))
                per[k] = (n + e.count, t + us)
    return total, per


def breakdown() -> tuple[dict, dict]:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out, kern = {}, {}
    for name, kw in FULL.items():
        t0 = time.perf_counter()
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        build_s = time.perf_counter() - t0
        eng = ENGINES["compiled"](device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rep = eng.run(top, *args)
            torch.cuda.synchronize()
        if not rep.ok:
            raise AssertionError(f"{name}: profiled run failed: {rep.error}")
        busy_us, per = _device_us(prof)
        for k, (n, t) in per.items():
            kn, kt = kern.get(k, (0, 0.0))
            kern[k] = (kn + n, kt + t)
        busy = busy_us / 1e6 / eng.program_s if busy_us else None
        out[name] = dict(build_s=build_s, lower_s=eng.lower_s,
                         program_s=eng.program_s, sweeps=eng.n_sweeps,
                         host_ms_per_sweep=eng.program_s / eng.n_sweeps * 1e3,
                         device_busy_s=busy_us / 1e6,
                         device_busy_share=busy, ring_device_us={
                             k: (t / n if n else None)
                             for k, (n, t) in per.items()})
        log(f"breakdown {name}: build {build_s:.3f} s, lower {eng.lower_s:.3f}"
            f" s, sweep loop {eng.program_s:.3f} s ({eng.n_sweeps} sweeps, "
            f"{eng.program_s / eng.n_sweeps * 1e3:.3f} ms each), device busy "
            + (f"{busy_us / 1e6:.3f} s = {busy:.1%} of the loop"
               if busy is not None else "not measured (profiler saw none)"))
    dev_ms = {k: t / n / 1e3 for k, (n, t) in kern.items() if n}
    log("breakdown ring kernels, mean device time per launch: "
        + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in dev_ms.items()))
    return out, dev_ms


# ---------------------------------------------------------------------------
# phase 7: attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_REPS, ATTN_WARM = 50, 5
LAYERS = 28                 # distinct tensors the timed calls cycle through

FLASH_CASES = [             # (B, S, nh, nkv, hd, causal, window)
    (1, 8, 16, 8, 128, True, None), (8, 8, 16, 8, 128, True, None),
    (1, 128, 16, 8, 128, True, None), (8, 128, 16, 8, 128, True, None),
    (1, 200, 16, 8, 128, True, None), (8, 200, 16, 8, 128, True, None),
    (1, 2048, 16, 8, 128, True, None), (8, 2048, 16, 8, 128, True, None),
    (2, 300, 16, 8, 128, True, 100),        # sliding window
    (2, 77, 8, 2, 64, False, None),         # head width 64, group 4
]
DECODE_CASES = [            # (B, S_max, nh, nkv, hd, kv_len)
    (8, 2048, 16, 8, 128, [0, 1, 255, 256, 257, 2048, 1000, 37]),
    (8, 2048, 16, 8, 128,
     np.random.default_rng(1).integers(0, 2049, 8).tolist()),
    (4, 512, 8, 2, 64, [0, 1, 255, 512]),   # head width 64, group 4
]


def _rand(gen, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _errs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, the same over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / scale if scale else err


def check_attention() -> tuple[list, dict]:
    """Each attention kernel against its plain version on the card; raises
    past a limit.  Returns the checked cases and each op's largest
    absolute difference."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows, worst = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_REL_TOL[dt]
        for B, S, nh, nkv, hd, causal, window in FLASH_CASES:
            q = _rand(gen, (B, S, nh, hd), dt)
            k = _rand(gen, (B, S, nkv, hd), dt)
            v = _rand(gen, (B, S, nkv, hd), dt)
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
            p_out, p_lse = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
            torch.cuda.synchronize()
            err, rel = _errs(out, p_out)
            lse_err = float((lse - p_lse).abs().max())
            rows.append(dict(op="flash_attention", dtype=str(dt), B=B, S=S,
                             nh=nh, nkv=nkv, hd=hd, causal=causal,
                             window=window, max_abs_err=err, rel_err=rel,
                             lse_abs_err=lse_err))
            log(f"attn flash  {str(dt):14s} B={B} S={S:4d} {nh}/{nkv}x{hd} "
                f"causal={causal} window={window}: rel {rel:.2e} "
                f"(limit {tol:g}), lse {lse_err:.2e} (limit {LSE_ABS_TOL:g})")
            if not (rel <= tol and lse_err <= LSE_ABS_TOL):
                raise AssertionError(f"flash_attention differs from plain: "
                                     f"{rows[-1]}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            del q, k, v, out, lse, p_out, p_lse
        for B, S, nh, nkv, hd, lens in DECODE_CASES:
            q = _rand(gen, (B, nh, hd), dt)
            k = _rand(gen, (B, S, nkv, hd), dt)
            v = _rand(gen, (B, S, nkv, hd), dt)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
            out = decode_attention_fwd(q, k, v, kv_len)
            p_out = decode_attention_plain(q, k, v, kv_len)
            torch.cuda.synchronize()
            err, rel = _errs(out, p_out)
            zeros = bool((out[kv_len == 0] == 0).all())
            rows.append(dict(op="decode_attention", dtype=str(dt), B=B,
                             S_max=S, nh=nh, nkv=nkv, hd=hd, kv_len=lens,
                             max_abs_err=err, rel_err=rel,
                             exact_zeros=zeros))
            log(f"attn decode {str(dt):14s} B={B} S_max={S} {nh}/{nkv}x{hd} "
                f"kv_len={lens}: rel {rel:.2e} (limit {tol:g}), exact "
                f"zeros at kv_len 0: {zeros}")
            if not (rel <= tol and zeros):
                raise AssertionError(f"decode_attention differs from plain: "
                                     f"{rows[-1]}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            del q, k, v, out, p_out
    torch.cuda.empty_cache()
    return rows, worst


def time_attention() -> dict:
    """CUDA-event times at the serving path's bf16 shapes.  Each call
    reads another of ``LAYERS`` layers' tensors, as a forward pass does,
    so no call finds its inputs in L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(2)
    bf16, L = torch.bfloat16, LAYERS
    nh, nkv, hd = 16, 8, 128
    out = {"flash_attention": [], "decode_attention": []}

    def timed(fn):
        return time_ms(fn, reps=ATTN_REPS, warm=ATTN_WARM)

    # flash: one prompt in the middle and the top prefill bucket, and a
    # batch of eight short prompts
    for B, S in ((1, 1024), (1, 2048), (8, 256)):
        qs = _rand(gen, (L, B, S, nh, hd), bf16)
        ks = _rand(gen, (L, B, S, nkv, hd), bf16)
        vs = _rand(gen, (L, B, S, nkv, hd), bf16)
        flops = 2 * B * nh * S * S * hd          # causal: half of 4 B nh S^2 hd
        nbytes = (qs[0].numel() * 2 + ks[0].numel() * 2) * 2 + 4 * B * nh * S
        bnd, by = bound_ms(nbytes, flops, TENSOR_BF16_FLOPS)
        out["flash_attention"].append(dict(
            shape=f"B={B} Sq=Sk={S} nh={nh} nkv={nkv} hd={hd} bf16 causal",
            ms=timed(lambda i: flash_attention_fwd(
                qs[i % L], ks[i % L], vs[i % L], causal=True)),
            plain_ms=timed(lambda i: flash_attention_plain(
                qs[i % L], ks[i % L], vs[i % L], causal=True, window=None)),
            library_ms=timed(lambda i: F.scaled_dot_product_attention(
                qs[i % L].transpose(1, 2), ks[i % L].transpose(1, 2),
                vs[i % L].transpose(1, 2), is_causal=True,
                enable_gqa=True)),
            bound_ms=bnd, bound_by=by, flops=flops, bytes=nbytes))
        del qs, ks, vs
    # decode: the packed cache of the serving run, 8 slots of 2048 rows,
    # at lengths such as that run's (prompt 64-1500 plus up to 32 new)
    B, S = SERVE["slots"], SERVE["max_seq"]
    lo, hi = SERVE["prompt"]
    lens = np.random.default_rng(3).integers(lo, hi + SERVE["max_new"] + 1, B)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
    qs = _rand(gen, (L, B, nh, hd), bf16)
    ks = _rand(gen, (L, B, S, nkv, hd), bf16)
    vs = _rand(gen, (L, B, S, nkv, hd), bf16)
    mask = (torch.arange(S, device=DEV)[None, :]
            < kv_len[:, None])[:, None, None, :]
    n_tok = int(lens.sum())
    nbytes = 2 * n_tok * nkv * hd * 2 + 2 * B * nh * hd * 2 + 4 * B
    bnd, by = bound_ms(nbytes, 4 * nh * n_tok * hd, TENSOR_BF16_FLOPS)
    out["decode_attention"].append(dict(
        shape=f"B={B} S_max={S} nh={nh} nkv={nkv} hd={hd} bf16 "
              f"kv_len={lens.tolist()}",
        ms=timed(lambda i: decode_attention_fwd(qs[i % L], ks[i % L],
                                                vs[i % L], kv_len)),
        plain_ms=timed(lambda i: decode_attention_plain(
            qs[i % L], ks[i % L], vs[i % L], kv_len)),
        library_ms=timed(lambda i: F.scaled_dot_product_attention(
            qs[i % L][:, :, None], ks[i % L].transpose(1, 2),
            vs[i % L].transpose(1, 2), attn_mask=mask, enable_gqa=True)),
        bound_ms=bnd, bound_by=by, bytes=nbytes))
    del qs, ks, vs
    torch.cuda.empty_cache()
    for op, rows in out.items():
        for r in rows:
            log(f"time {op:16s} {r['shape']}: kernel {r['ms']*1e3:9.2f} us  "
                f"plain {r['plain_ms']*1e3:9.2f} us  sdpa "
                f"{r['library_ms']*1e3:9.2f} us  bound "
                f"{r['bound_ms']*1e3:8.3f} us ({r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phases 8 and 10: serving Qwen3-0.6B at full width, and its breakdown
# ---------------------------------------------------------------------------

class _CallStats:
    """Calls and synchronised wall seconds of the adapter's prefill and
    decode-step functions."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.n = {"prefill": 0, "decode": 0}
        self.s = {"prefill": 0.0, "decode": 0.0}

    def wrap(self, kind: str, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.n[kind] += 1
            self.s[kind] += time.perf_counter() - t0
            return out
        return call


def _watch_nan(lm):
    """Route the model's prefill and decode step through a check that
    ORs "any logit is NaN" into a device flag (no host sync); returns
    the flag and a function that undoes the routing."""
    flag = torch.zeros((), dtype=torch.bool, device=DEV)
    prefill, decode_step = lm.prefill, lm.decode_step

    def watched(fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            flag.logical_or_(torch.isnan(logits).any())
            return logits, cache
        return call

    lm.prefill, lm.decode_step = watched(prefill), watched(decode_step)

    def restore():
        lm.prefill, lm.decode_step = prefill, decode_step
    return flag, restore


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def serving_phase():
    """Phase 8.  Returns (report, engine, requests, call stats)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                                   serve_requests)
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="kernel")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SERVE["seed"])        # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.param_count()}")
    stats = _CallStats()
    adapter = lm.serving_adapter(params, cfg, max_seq=SERVE["max_seq"])
    adapter = dataclasses.replace(
        adapter, prefill_fn=stats.wrap("prefill", adapter.prefill_fn),
        step_fn=stats.wrap("decode", adapter.step_fn))
    eng = ServingEngine(ServeConfig(batch_slots=SERVE["slots"],
                                    max_seq=SERVE["max_seq"]),
                        batched=adapter)
    t0 = time.perf_counter()
    info = eng.warmup(batch_sizes=(1, 2, 4, 8))
    warm_s = time.perf_counter() - t0
    if not info["ok"]:
        raise AssertionError(f"serving warmup failed: {info}")
    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    plens = rng.integers(lo, hi + 1, SERVE["requests"])
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).tolist(),
                    max_new=SERVE["max_new"]) for i, n in enumerate(plens)]

    nan, restore = _watch_nan(lm)
    stats.reset()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = serve_requests(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = {r.rid: res.get(r.rid) for r in reqs
           if not (isinstance(res.get(r.rid), list)
                   and len(res[r.rid]) == SERVE["max_new"])}
    if bad:
        raise AssertionError(f"requests without {SERVE['max_new']} tokens: "
                             f"{bad}")
    if bool(nan):
        raise AssertionError("a logit of the serving run is NaN")
    n_prefill, n_decode = stats.n["prefill"], stats.n["decode"]
    want = {"flash_attention": cfg.n_layers * n_prefill,
            "decode_attention": cfg.n_layers * n_decode}
    for op, n in want.items():
        if n == 0 or counts.get(op, 0) != n:
            raise AssertionError(f"{op}: {counts.get(op, 0)} launches in the "
                                 f"serving run, expected {n} ({cfg.n_layers}"
                                 f" layers x calls)")
    n_tok = sum(len(v) for v in res.values())
    report = dict(
        arch=ARCH, params=n_params, dtype=cfg.dtype, attn_impl="kernel",
        **SERVE, prompt_tokens=int(plens.sum()), init_s=init_s,
        warmup_s=warm_s, wall_s=wall, tokens=n_tok, tok_per_s=n_tok / wall,
        prefill_calls=n_prefill, prefill_s=stats.s["prefill"],
        decode_steps=n_decode, decode_s=stats.s["decode"],
        decode_ms_per_step=stats.s["decode"] / n_decode * 1e3,
        launches=counts, peak_gb=peak_gb)
    log(f"serve {ARCH}: {n_params} params {cfg.dtype}, init {init_s:.2f} s, warmup "
        f"{warm_s:.2f} s; {len(reqs)} requests ({int(plens.sum())} prompt "
        f"tokens) -> {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} "
        f"tok/s); prefill {n_prefill} calls {stats.s['prefill']:.3f} s, "
        f"decode {n_decode} steps {stats.s['decode']:.3f} s "
        f"({report['decode_ms_per_step']:.2f} ms/step); launches {counts}; "
        f"peak {peak_gb:.2f} GB")
    return report, eng, reqs, stats


def _device_times(prof) -> tuple[float, dict]:
    """Total device microseconds in a profile, and per attention op
    (launches, device us); one launch of an op is one launch of its first
    kernel."""
    total, per = 0.0, {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        total += us
        for op, names in ATTN_KERNELS.items():
            for i, nm in enumerate(names):
                if nm in e.key:
                    n, t = per.get(op, (0, 0.0))
                    per[op] = (n + (e.count if i == 0 else 0), t + us)
    return total, per


class _OpCount:
    """Counts the aten operations dispatched inside a ``with`` block (views
    included; each is a trip through PyTorch's dispatcher, most of the
    rest a kernel launch)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self._mode = 0, _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _decode_loop(adapter, wave: list, steps: int = 32) -> dict:
    """The adapter's decode step alone, ``steps`` times on a packed cache
    whose slots hold ``wave``'s prompts, as the serving loop calls it (one
    ``[slots]`` copy to the host per step), under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    n, bucket = len(wave), SERVE["max_seq"]
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(r.prompt) for r in wave], np.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = r.prompt
    packed = adapter.init_slots(n)
    first, cache = adapter.prefill_fn(toks, lens, 0)
    for i in range(n):
        packed = adapter.write_slot_fn(packed, cache, i, i)
    del cache
    tok = first.cpu().numpy()
    for s in range(2):                       # warm
        nxt, packed = adapter.step_fn(tok, packed, s)
        tok = nxt.cpu().numpy()
    with _OpCount() as ops:                  # what one step dispatches
        nxt, packed = adapter.step_fn(tok, packed, 2)
    tok = nxt.cpu().numpy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            nxt, packed = adapter.step_fn(tok, packed, s)
            tok = nxt.cpu().numpy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, _ = _device_times(prof)
    return dict(steps=steps, slots=n, kv_len_start=(lens + 3).tolist(),
                aten_ops_per_step=ops.n,
                host_ms_per_step=wall / steps * 1e3,
                device_ms_per_step=busy_us / steps / 1e3,
                busy_share=busy_us / 1e6 / wall if busy_us else None)


def serving_breakdown(eng, reqs, stats) -> dict:
    """Phase 10: the first wave of requests again under the profiler
    (device activity only), then the decode step alone on that wave."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import serve_requests
    wave = reqs[:SERVE["slots"]]
    stats.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve_requests(eng, wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if any(len(res[r.rid]) != SERVE["max_new"] for r in wave):
        raise AssertionError("profiled wave: a request is short of tokens")
    busy_us, kern = _device_times(prof)
    dev_ms = {op: t / n / 1e3 for op, (n, t) in kern.items() if n}
    n_call, s_call = dict(stats.n), dict(stats.s)
    loop = _decode_loop(eng.batched, wave)
    out = dict(requests=len(wave), wall_s=wall,
               prefill_calls=n_call["prefill"], prefill_s=s_call["prefill"],
               decode_steps=n_call["decode"], decode_s=s_call["decode"],
               device_busy_s=busy_us / 1e6,
               busy_share=busy_us / 1e6 / wall if busy_us else None,
               kernel_device_ms=dev_ms, kernel_launches={
                   op: n for op, (n, _) in kern.items()},
               decode_loop=loop)
    share = out["busy_share"]
    log(f"breakdown serve: wave of {len(wave)} in {wall:.3f} s (prefill "
        f"{s_call['prefill']:.3f} s in {n_call['prefill']} calls, decode "
        f"{s_call['decode']:.3f} s in {n_call['decode']} steps), device "
        + (f"busy {busy_us / 1e6:.3f} s = {share:.1%}" if share is not None
           else "time not measured (profiler saw none)")
        + "; decode step alone: "
        + (f"{loop['device_ms_per_step']:.3f} ms device of "
           f"{loop['host_ms_per_step']:.3f} ms = {loop['busy_share']:.1%}"
           if loop["busy_share"] is not None else "not measured")
        + f", {loop['aten_ops_per_step']} aten ops a step"
        + "; per launch: " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                       for k, v in dev_ms.items()))
    return out


def cli_phase() -> dict:
    """``python -m repro_torch.launch.serve --full`` at its defaults, in
    this process (its output goes to this script's).  Its decode steps
    must have gone through the flash-decode kernel, every layer of every
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    n_layers = get_config(ARCH).n_layers
    reset_launches()
    t0 = time.perf_counter()
    rc = serve(["--full", "--arch", ARCH])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0:
        raise AssertionError(f"launch.serve --full returned {rc}")
    dec = counts.get("decode_attention", 0)
    if dec == 0 or dec % n_layers:
        raise AssertionError(f"launch.serve --full did not decode through "
                             f"the flash-decode kernel at every layer: "
                             f"{counts}")
    log(f"cli: repro_torch.launch.serve --full --arch {ARCH} returned 0 in "
        f"{wall:.1f} s; launches {counts}")
    return dict(rc=rc, wall_s=wall, launches=counts)


# ---------------------------------------------------------------------------
# phase 9: the card against the CPU on the same weights
# ---------------------------------------------------------------------------

def card_vs_cpu() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32",
                              attn_impl="kernel")
    p_cpu = lm.init_params(cfg, 1, device="cpu")

    def to_card(t):
        return {k: to_card(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.to(DEV)
    p_card = to_card(p_cpu)
    rng = np.random.default_rng(1)
    lens = np.array([37, 512, *rng.integers(38, 512, 2)], np.int32)
    bucket, max_seq = 512, 1024
    toks = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    reset_launches()
    logits, caches = {}, {}
    for dev, p in (("cpu", p_cpu), (DEV, p_card)):
        logits[dev], caches[dev] = lm.prefill(
            p, cfg, torch.from_numpy(toks).to(dev), max_seq=max_seq,
            true_len=torch.from_numpy(lens).to(dev))
    steps = []

    def compare(what: str) -> int:
        want = logits["cpu"].double()
        got = logits[DEV].cpu().double()
        rel = float((got - want).abs().max() / want.abs().max())
        tok_c, tok_g = want.argmax(-1), got.argmax(-1)
        steps.append(dict(what=what, rel_err=rel,
                          greedy_equal=bool(torch.equal(tok_c, tok_g))))
        if rel > LOGIT_REL_TOL or not torch.equal(tok_c, tok_g):
            raise AssertionError(f"card vs CPU at {what}: rel {rel:.3e} "
                                 f"(limit {LOGIT_REL_TOL:g}), greedy "
                                 f"{tok_g.tolist()} vs {tok_c.tolist()}")
        return tok_c.to(torch.int32)

    tok = compare("prefill")
    for s in range(8):
        for dev, p in (("cpu", p_cpu), (DEV, p_card)):
            logits[dev], caches[dev] = lm.decode_step(
                p, cfg, tok.to(dev), caches[dev])
        tok = compare(f"decode {s}")
    counts = launch_counts()
    if counts.get("flash_attention", 0) != cfg.n_layers or \
            counts.get("decode_attention", 0) != 8 * cfg.n_layers:
        raise AssertionError(f"card side did not go through the kernels: "
                             f"{counts}")
    worst = max(s["rel_err"] for s in steps)
    log(f"card vs cpu: {ARCH} at 2 layers, float32, prompts {lens.tolist()} "
        f"in a {bucket} bucket + 8 ragged decode steps: logits within "
        f"{worst:.2e} of max |logit| (limit {LOGIT_REL_TOL:g}), greedy "
        f"tokens equal; launches {counts}")
    return dict(layers=cfg.n_layers, prompt_lens=lens.tolist(),
                bucket=bucket, steps=steps, max_rel_err=worst,
                launches=counts)


# ---------------------------------------------------------------------------
# phases 11-15: training — Mamba2-130M through the SSD kernel, Qwen3-0.6B
# through flash attention and its backward
# ---------------------------------------------------------------------------

TRAIN_ARCH = "mamba2-130m"
TRAIN = dict(batch=8, seq=2048, steps=20)
QWEN_TRAIN = dict(batch=4, seq=1024, steps=3)
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:43"
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
# SSD cases of phase 11: (tag, B, S, H, G, P, N, chunk, decays, s0 scale).
# "model" decays are Mamba2's own (A = -linspace(1, 16, H), dt =
# softplus(N(0, 1))): the running sum of dt * A reaches ~-1e3 within a
# chunk and exp(cum_end) underflows, so the state pass carries ~nothing;
# "small" decays (dt in [1e-3, 1e-1], the published Mamba-2 dt range, A in
# [-1, -0.1]) make the inter-chunk term a visible part of y.
SSD_CASES = [
    ("train", 8, 2048, 24, 1, 64, 128, 256, "model", 0.0),
    ("train small", 8, 2048, 24, 1, 64, 128, 256, "small", 1.0),
    ("B=1", 1, 2048, 24, 1, 64, 128, 256, "model", 1.0),
    ("S=1000 pad", 2, 1000, 24, 1, 64, 128, 256, "small", 1.0),
    ("G=2", 2, 1024, 24, 2, 64, 128, 256, "small", 1.0),
    ("N=64 Q=128", 2, 1024, 8, 1, 64, 64, 128, "small", 1.0),
    ("reduced 16x16 Q=16", 2, 64, 8, 1, 16, 16, 16, "small", 1.0),
]
# Kernel vs plain version, max |kernel - plain| / max |y64|, where y64 is
# the plain version evaluated in float64 on the card from the same inputs;
# the kernel against y64 is held to the same limit, and both errors
# against y64 are printed.  The plain version forms the running sum of dA
# in float32 (the kernel in double); at the model's decays (|cum| up to
# ~3e3) that rounding reaches y only through the terms near the diagonal,
# whose exponents are short differences: it measured 1.1e-5 of max |y|
# against float64, the kernel 4.3e-7 (on an H100 80GB HBM3 at 700 W).  At
# small decays both measured ~1e-6 (float32 summation order).  The limits
# are 5x those.
SSD_REL_TOL = {"model": 5e-5, "small": 5e-6}
SSD_MIN_INTER = 1e-2        # small decays: inter-chunk share of max |y|
# Card vs CPU (phase 14), same float32 weights and tokens: loss relative;
# each gradient leaf relative to its largest magnitude; each parameter's
# change after one AdamW step relative to its largest change.  Both sides
# take the SSD's torch-ops recompute in the backward, in float32, summed in
# other orders; the largest difference is A_log's gradient, a sum of
# B * S * P * N terms of both signs (measured 4.1e-4, the step's 7.8e-4,
# on the card above).  AdamW with eps 1e-5, so no gradient element
# sits near eps (Adam's first step moves an element by lr * g / (|g| +
# eps), which turns float32 differences of elements near eps into
# differences of lr size).
TRAIN_CPU_TOL = dict(loss=1e-5, grad=1e-3, step=5e-3)


def _ssd_inputs(gen, B, S, H, G, P, N, decays, s0_scale) -> tuple:
    def r(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEV)
    x, Bm, Cm = r(B, S, H, P), r(B, S, G, N), r(B, S, G, N)
    if decays == "model":
        dt = torch.nn.functional.softplus(r(B, S, H))
        A = -torch.linspace(1.0, 16.0, H, device=DEV)
    else:
        dt, A = u(1e-3, 1e-1, B, S, H), -u(0.1, 1.0, H)
    return x, dt, A, Bm, Cm, r(B, H, P, N) * s0_scale


def _ssd_f64(x, dt, A, Bm, Cm, chunk, s0) -> tuple:
    """The model-layout SSD (no D skip) through the plain version in
    float64: padded with dt = 0 to a whole number of chunks, trimmed."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    S = x.shape[1]
    pad = (-S) % chunk
    x, dt, Bm, Cm = (t.double() for t in (x, dt, Bm, Cm))
    if pad:
        x, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                     for t in (x, Bm, Cm))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    y, s = ssd_scan_plain(x * dt[..., None], dt * A.double(), Bm, Cm,
                          s0.double(), chunk=chunk)
    return y[:, :S], s


def check_ssd() -> tuple[list, float]:
    """Phase 11, checks: ``ops.ssd_scan`` (the kernel on the card) against
    the plain version through the same wrapper, both against float64;
    raises past a limit.  Returns the cases and the largest absolute
    difference."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain, ssd_sequence
    gen = torch.Generator(device=DEV).manual_seed(11)
    rows, worst = [], 0.0
    for tag, B, S, H, G, P, N, Q, decays, s0s in SSD_CASES:
        x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, B, S, H, G, P, N, decays,
                                           s0s)
        D = torch.zeros(H, device=DEV)       # y is the scan alone
        y, s = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=Q, init_state=s0)
        yp, sp = ssd_sequence(ssd_scan_plain, x, dt, A, Bm, Cm, D, Q, s0)
        y64, s64 = _ssd_f64(x, dt, A, Bm, Cm, Q, s0)
        torch.cuda.synchronize()
        ys, ss = float(y64.abs().max()), float(s64.abs().max())

        def rel(a, b, scale):
            return float((a.double() - b.double()).abs().max()) / scale
        row = dict(case=tag, B=B, S=S, H=H, G=G, P=P, N=N, chunk=Q,
                   decays=decays, s0_scale=s0s, max_abs_y=ys,
                   y_kernel_vs_plain=rel(y, yp, ys),
                   y_kernel_vs_f64=rel(y, y64, ys),
                   y_plain_vs_f64=rel(yp, y64, ys),
                   state_kernel_vs_plain=rel(s, sp, ss),
                   state_kernel_vs_f64=rel(s, s64, ss),
                   state_plain_vs_f64=rel(sp, s64, ss),
                   max_abs_err=max(float((y - yp).abs().max()),
                                   float((s - sp).abs().max())))
        if decays == "small" and S % Q == 0:
            # the same chunks with the state pass cut: each chunk alone
            nb = B * S // Q
            yi, _ = ssd_scan_plain(
                (x * dt[..., None]).reshape(nb, Q, H, P),
                (dt * A).reshape(nb, Q, H), Bm.reshape(nb, Q, G, N),
                Cm.reshape(nb, Q, G, N),
                torch.zeros((nb, H, P, N), device=DEV), chunk=Q)
            row["inter_share"] = rel(yp, yi.reshape(B, S, H, P), ys)
        tol = SSD_REL_TOL[decays]
        log(f"ssd {tag:20s} B={B} S={S} H={H} G={G} P={P} N={N} Q={Q} "
            f"{decays:5s}: y kernel-plain {row['y_kernel_vs_plain']:.2e} "
            f"kernel-f64 {row['y_kernel_vs_f64']:.2e} plain-f64 "
            f"{row['y_plain_vs_f64']:.2e}; state {row['state_kernel_vs_plain']:.2e}"
            f" / {row['state_kernel_vs_f64']:.2e} / "
            f"{row['state_plain_vs_f64']:.2e} (limit {tol:g})"
            + (f"; inter-chunk share {row['inter_share']:.3e}"
               if "inter_share" in row else ""))
        rows.append(row)
        bad = [k for k in ("y_kernel_vs_plain", "y_kernel_vs_f64",
                           "state_kernel_vs_plain", "state_kernel_vs_f64")
               if not row[k] <= tol]
        if bad or not (np.isfinite(ys) and np.isfinite(ss)):
            raise AssertionError(f"ssd_scan differs from plain: {bad} {row}")
        if row.get("inter_share", 1.0) < SSD_MIN_INTER:
            raise AssertionError(f"ssd {tag}: the inter-chunk term is not "
                                 f"visible ({row['inter_share']:.2e})")
        worst = max(worst, row["max_abs_err"])
        del x, dt, Bm, Cm, s0, y, s, yp, sp, y64, s64
    torch.cuda.empty_cache()
    return rows, worst


def _ssd_work(B, S, H, G, P, N, Q) -> tuple[int, int]:
    """(bytes, flops) the SSD scan needs at a shape: inputs read once,
    outputs written once; the causal half of C B^T and of its product
    with xdt, the state read, each chunk's own state and the state
    pass."""
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N
                  + 2 * B * H * P * N)
    tri = Q * (Q + 1) // 2
    per_chunk = tri * 2 * (N + P) + 2 * Q * 2 * P * N + 2 * P * N
    return nbytes, B * H * (S // Q) * per_chunk


def time_ssd() -> dict:
    """Phase 11, times at the training shape: kernel, plain version and
    bound by CUDA events, and the kernels' device time per call from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
    tag, B, S, H, G, P, N, Q, decays, _ = SSD_CASES[0]
    gen = torch.Generator(device=DEV).manual_seed(12)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, B, S, H, G, P, N, decays, 0.0)
    xdt, dA = x * dt[..., None], dt * A
    del x
    nbytes, flops = _ssd_work(B, S, H, G, P, N, Q)
    bnd, by = bound_ms(nbytes, flops, CUDA_CORE_OPS_PER_S)

    def kern(i):
        return ssd_scan_fwd(xdt, dA, Bm, Cm, s0, chunk=Q)
    ms = time_ms(kern, reps=10, warm=2)
    plain_ms = time_ms(lambda i: ssd_scan_plain(xdt, dA, Bm, Cm, s0,
                                                chunk=Q), reps=3, warm=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            kern(i)
        torch.cuda.synchronize()
    # each kernel's mean over the launches the profiler kept (it may keep
    # more of one kernel's than of another's in a short window)
    tot = {}
    for e in prof.key_averages():
        for nm in SSD_KERNELS:
            if nm in e.key and e.count:
                t, n = tot.get(nm, (0.0, 0))
                tot[nm] = (t + float(getattr(e, "self_device_time_total",
                                             0.0) or 0.0), n + e.count)
    per = {k: t / n for k, (t, n) in tot.items()}
    dev_ms = sum(per.values()) / 1e3 if len(per) == len(SSD_KERNELS) \
        else None
    out = dict(shape=f"B={B} S={S} H={H} G={G} P={P} N={N} chunk={Q} f32",
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
               bound_by=by, bound_peak="float32 CUDA cores, 67 TFLOP/s",
               bound_tf32_ms=max(nbytes / HBM_BYTES_PER_S, flops / 495e12)
               * 1e3, bytes=nbytes, flops=flops, device_ms=dev_ms,
               device_us_by_kernel=per, tflops=flops / ms / 1e9)
    log(f"time ssd_scan {out['shape']}: kernel {ms * 1e3:9.2f} us "
        f"({out['tflops']:.1f} TFLOP/s), device "
        + (f"{dev_ms * 1e3:.2f} us (" + ", ".join(
            f"{k} {v:.2f}" for k, v in per.items()) + " us)"
           if dev_ms is not None else "not measured")
        + f"; plain {plain_ms * 1e3:9.2f} us; library none; bound "
        f"{bnd * 1e3:.3f} us ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s fp32; TF32 tensor cores "
        f"{out['bound_tf32_ms'] * 1e3:.3f} us)")
    del xdt, dA, Bm, Cm, s0
    torch.cuda.empty_cache()
    return out


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in _leaves(tree)
               if t.is_floating_point())


def train_phase() -> dict:
    """Phase 12: ``repro_torch.launch.train`` at full width, then the same
    command again, which must resume at the last step and run none."""
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        ck, mpath = str(Path(tmp) / "ckpt"), Path(tmp) / "metrics.jsonl"
        args = ["--arch", TRAIN_ARCH, "--use-kernel", "--batch", str(B),
                "--seq", str(S), "--steps", str(steps), "--ckpt-dir", ck,
                "--metrics", str(mpath), "--log-every", "5"]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(x) for x in mpath.read_text().splitlines()]
        want = {"ssd_scan": 2 * cfg.n_layers * steps}
        if rc != 0 or counts != want:
            raise AssertionError(f"train returned {rc}; launches {counts}, "
                                 f"expected {want} (2 x {cfg.n_layers} "
                                 f"layers x {steps} steps: remat runs each "
                                 f"layer's forward twice)")
        if len(rows) != steps or not all(
                np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                for r in rows):
            raise AssertionError(f"metrics: {rows}")
        like = lm.init_params(cfg, device="meta")
        got = CheckpointManager(ck).restore_latest(
            like, adamw_init(like, AdamWConfig()), device=DEV)
        if got is None or got[0] != steps or not (
                _finite_tree(got[1]) and _finite_tree(got[2])):
            raise AssertionError(f"checkpoint at step {steps} not restorable"
                                 f" ({None if got is None else got[0]})")
        n_params = sum(t.numel() for t in _leaves(got[1]))
        del got
        reset_launches()
        rc2 = train(args)
        again = launch_counts()
        n_rows = len(mpath.read_text().splitlines())
        if rc2 != 0 or again or n_rows != steps:
            raise AssertionError(f"rerun: rc {rc2}, launches {again}, "
                                 f"{n_rows} metric rows (expected 0 steps)")
    dts = [r["dt"] for r in rows]
    step_ms = float(np.median(dts[1:])) * 1e3
    out = dict(arch=TRAIN_ARCH, params=n_params, dtype=cfg.dtype, **TRAIN,
               use_kernel=True, remat=True, rc=rc, wall_s=wall,
               launches=counts, loss_first=rows[0]["loss"],
               loss_last=rows[-1]["loss"],
               losses=[r["loss"] for r in rows],
               grad_norms=[r["grad_norm"] for r in rows],
               first_step_ms=dts[0] * 1e3, median_step_ms=step_ms,
               mean_step_ms=float(np.mean(dts[1:])) * 1e3,
               tok_per_s=B * S / (step_ms / 1e3), peak_gb=peak_gb,
               rerun_rc=rc2)
    log(f"train {TRAIN_ARCH}: {n_params} params {cfg.dtype}, batch {B} x "
        f"seq {S}, {steps} steps in {wall:.1f} s (final save and checks "
        f"included); step 1 {dts[0] * 1e3:.0f} ms, then median "
        f"{step_ms:.1f} ms ({out['tok_per_s']:,.0f} tokens/s); loss "
        f"{rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}; launches "
        f"{counts}; peak {peak_gb:.2f} GB; checkpoint {steps} restored; "
        f"rerun ran 0 steps")
    return out


def qwen_train_phase() -> dict:
    """Phase 13: Qwen3-0.6B at full width, ``make_train_step`` with the
    flash kernel forward and its autograd backward."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(ARCH)
    B, S, steps = QWEN_TRAIN["batch"], QWEN_TRAIN["seq"], QWEN_TRAIN["steps"]
    params = lm.init_params(cfg, 0)
    opt = AdamWConfig(total_steps=steps, warmup_steps=1)
    state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, gnorms, dts = [], [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in data.next_batch().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": 2 * cfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"qwen train: launches {counts}, expected "
                             f"{want}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and _finite_tree(params)):
        raise AssertionError(f"qwen train: losses {losses}, grad norms "
                             f"{gnorms}")
    del params, state
    torch.cuda.empty_cache()
    out = dict(arch=ARCH, dtype=cfg.dtype, **QWEN_TRAIN, losses=losses,
               grad_norms=gnorms, step_ms=[d * 1e3 for d in dts],
               launches=counts, peak_gb=peak_gb)
    log(f"train {ARCH}: batch {B} x seq {S}, {steps} steps of "
        f"make_train_step(use_kernel=True): "
        + ", ".join(f"{d * 1e3:.0f}" for d in dts) + " ms; losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; grad norms "
        + ", ".join(f"{v:.3f}" for v in gnorms)
        + f"; launches {counts}; peak {peak_gb:.2f} GB")
    return out


def train_vs_cpu() -> dict:
    """Phase 14: Mamba2-130M at full width cut to 2 layers, float32, the
    same weights and tokens on the card (kernel) and the CPU (plain
    versions): loss, every gradient leaf, and one AdamW step."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import leaves, named_leaves, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              dtype="float32")
    p_cpu = lm.init_params(cfg, 1, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-5)
    batch = make_pipeline(cfg.vocab, 512, 2, seed=1).next_batch()
    res = {}
    reset_launches()
    for dev in ("cpu", DEV):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = lm.loss_fn(live, cfg, {k: torch.from_numpy(v).to(dev)
                                      for k, v in batch.items()},
                          remat=True, use_kernel=True)
        grads = torch.autograd.grad(loss, leaves(live))
        it = iter(grads)
        g_tree = tree_map(lambda _: next(it), p)
        new_p, _, _ = adamw_update(g_tree, adamw_init(p, opt), p, opt)
        res[dev] = dict(loss=float(loss.detach()),
                        grads=dict(named_leaves(g_tree)),
                        step=dict(named_leaves(tree_map(
                            lambda a, b: (a - b).cpu().double(), new_p, p))))
    counts = launch_counts()
    if counts != {"ssd_scan": 2 * cfg.n_layers}:
        raise AssertionError(f"card vs cpu (train): launches {counts}")
    loss_rel = abs(res[DEV]["loss"] - res["cpu"]["loss"]) / \
        abs(res["cpu"]["loss"])

    def worst(key):
        out = {}
        for name, want in res["cpu"][key].items():
            want = want.cpu().double()
            got = res[DEV][key][name].cpu().double()
            out[name] = float((got - want).abs().max()) / \
                max(float(want.abs().max()), 1e-30)
        return out
    grad_rel, step_rel = worst("grads"), worst("step")
    g_name = max(grad_rel, key=grad_rel.get)
    s_name = max(step_rel, key=step_rel.get)
    tol = TRAIN_CPU_TOL
    log(f"card vs cpu (train): {TRAIN_ARCH} at 2 layers, float32, B=2 S=512"
        f" (2 chunks): loss {res['cpu']['loss']:.6f}, rel {loss_rel:.2e} "
        f"(limit {tol['loss']:g}); gradients worst {grad_rel[g_name]:.2e} "
        f"({g_name}; limit {tol['grad']:g}); AdamW step worst "
        f"{step_rel[s_name]:.2e} ({s_name}; limit {tol['step']:g}); "
        f"launches {counts}")
    if not (loss_rel <= tol["loss"] and grad_rel[g_name] <= tol["grad"]
            and step_rel[s_name] <= tol["step"]):
        raise AssertionError("card vs cpu (train) past a limit")
    return dict(layers=cfg.n_layers, batch=2, seq=512, loss=res["cpu"]["loss"],
                loss_rel=loss_rel, grad_rel=grad_rel, step_rel=step_rel,
                launches=counts)


def train_breakdown() -> dict:
    """Phase 15: one step of phase 12's configuration under the profiler:
    the device's busy share of the unprofiled step, the SSD kernel's
    device time per launch and share, the top device operations; then the
    backward's recompute (``ssd_chunked`` in torch ops, forward and
    backward) alone at one layer's shape, times the layers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.layers import ssd_chunked
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN["batch"], TRAIN["seq"]
    params = lm.init_params(cfg, 0)
    opt = AdamWConfig(total_steps=TRAIN["steps"], warmup_steps=1)
    state = adamw_init(params, opt)
    step_fn = make_train_step(cfg, opt, use_kernel=True)
    data = make_pipeline(cfg.vocab, S, B, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in data.next_batch().items()} for _ in range(4)]
    params, state, _ = step_fn(params, state, batches[0])     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:3]:
        params, state, _ = step_fn(params, state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, state, _ = step_fn(params, state, batches[3])
        torch.cuda.synchronize()
    total, ssd_us, ssd_n, ops = 0.0, 0.0, 0, []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        total += us
        if any(nm in e.key for nm in SSD_KERNELS):
            ssd_us += us
            if SSD_KERNELS[0] in e.key:
                ssd_n += e.count
        if us:
            ops.append((us, e.key, e.count))
    ops.sort(reverse=True)
    del params, state, batches
    torch.cuda.empty_cache()

    # the backward's recompute alone, at one layer's shapes
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    gen = torch.Generator(device=DEV).manual_seed(15)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(gen, B, S, H, s.n_groups, P, N,
                                      "model", 0.0)
    x = x.to(torch.bfloat16)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm.to(torch.bfloat16),
                                        Cm.to(torch.bfloat16),
                                        torch.ones(H, device=DEV))]

    def recompute(i):
        y, fin = ssd_chunked(*ins, s.chunk)
        torch.autograd.grad((y, fin), ins, (torch.ones_like(y),
                                            torch.zeros_like(fin)))
    rec_ms = time_ms(recompute, reps=3, warm=1)
    del x, dt, A, Bm, Cm, ins
    torch.cuda.empty_cache()
    busy = total / 1e6 / step_s if total else None
    out = dict(step_s=step_s, device_busy_s=total / 1e6, busy_share=busy,
               ssd_launches=ssd_n,
               ssd_device_ms_per_launch=ssd_us / ssd_n / 1e3 if ssd_n else
               None, ssd_share_of_step=ssd_us / 1e6 / step_s,
               recompute_ms_per_layer=rec_ms,
               recompute_s_per_step=rec_ms * cfg.n_layers / 1e3,
               top_device_ops=[dict(name=k[:80], us=us, count=n)
                               for us, k, n in ops[:12]])
    log(f"breakdown train {TRAIN_ARCH}: step {step_s * 1e3:.1f} ms, device "
        + (f"busy {total / 1e3:.1f} ms = {busy:.1%}" if busy is not None
           else "time not measured (profiler saw none)")
        + f"; ssd_scan {ssd_n} launches, "
        + (f"{out['ssd_device_ms_per_launch'] * 1e3:.1f} us each, "
           f"{out['ssd_share_of_step']:.1%} of the step"
           if ssd_n else "device time not measured")
        + f"; backward recompute (ssd_chunked fwd+bwd) {rec_ms:.2f} ms a "
        f"layer, {out['recompute_s_per_step'] * 1e3:.0f} ms a step; top "
        "device ops: " + "; ".join(f"{k[:48]} {us / 1e3:.1f} ms x{n}"
                                   for us, k, n in ops[:6]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    missing = [src for src in SOURCES.values() if not (ROOT / src).is_file()]
    if missing:
        print(f"chip_smoke: {missing} not found next to this script; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # 2. build: one nvcc per source, all started together
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(f"build: {', '.join(SOURCES.values())} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    seconds = {}

    def phase(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    # 3-6: the synthesis path
    timing, errs = phase("3 kernels", kernel_phase)
    per_app, counts = phase("4 main path", main_path)
    full = phase("4 full size vs cpu", full_size_vs_cpu)
    twin = phase("5 twin vs compiled", twin_vs_compiled)
    brk, dev_ms = phase("6 breakdown", breakdown)

    # 7-10: the LM serving path
    attn_checks, attn_errs = phase("7 attention checks", check_attention)
    attn_timing = phase("7 attention times", time_attention)
    serving, eng, reqs, stats = phase("8 serving", serving_phase)
    serve_brk = phase("10 serving breakdown", serving_breakdown, eng, reqs,
                      stats)
    del eng, reqs, stats
    torch.cuda.empty_cache()
    cli = phase("8 serve cli", cli_phase)
    vs_cpu = phase("9 card vs cpu", card_vs_cpu)

    # 11-15: the training path
    ssd_checks, ssd_err = phase("11 ssd checks", check_ssd)
    ssd_time = phase("11 ssd times", time_ssd)
    training = phase("12 train mamba2", train_phase)
    qwen = phase("13 train qwen3", qwen_train_phase)
    train_cpu = phase("14 train card vs cpu", train_vs_cpu)
    train_brk = phase("15 train breakdown", train_breakdown)

    kernels = []
    for name, rows in timing.items():
        head = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=counts.get(name, 0), max_abs_err=errs[name],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            device_ms=dev_ms.get(name),
            shape=head["shape"], by_shape=rows))
    for name, rows in attn_timing.items():
        head = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=ATTN_REPLACES[name],
            launches=serving["launches"].get(name, 0),
            max_abs_err=attn_errs[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            device_ms=serve_brk["kernel_device_ms"].get(name),
            shape=head["shape"], by_shape=rows,
            train_launches=qwen["launches"].get(name, 0)))
    kernels.append(dict(
        name="ssd_scan", route="cuda", source=SOURCES["ssd_scan"],
        replaces=SSD_REPLACES, launches=training["launches"]["ssd_scan"],
        max_abs_err=ssd_err, ms=ssd_time["ms"],
        plain_ms=ssd_time["plain_ms"], bound_ms=ssd_time["bound_ms"],
        bound_by=ssd_time["bound_by"], library_ms=None,
        device_ms=ssd_time["device_ms"], shape=ssd_time["shape"],
        timing=ssd_time))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernels=kernels, main_path=per_app, full_size_vs_cpu=full,
        twin_vs_compiled=twin, breakdown=brk, attention_checks=attn_checks,
        serving=serving, serving_breakdown=serve_brk, serve_cli=cli,
        card_vs_cpu=vs_cpu, ssd_checks=ssd_checks, training=training,
        qwen_training=qwen, train_card_vs_cpu=train_cpu,
        train_breakdown=train_brk, phase_seconds=seconds), indent=1))
    print(smi)
    line = json.dumps({"kernels": kernels})
    print(f"kernels {line}")
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

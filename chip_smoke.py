#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis path on one CUDA card and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device — the card's name and power limit (``nvidia-smi``), CUDA
   version; TF32 matmuls off.
2. build — ``src/repro_torch/kernels/csrc/ring.cu`` with ``nvcc`` into
   ``build/kernels/``.
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

The last four lines of standard output are the ``nvidia-smi`` line, the
JSON object of per-kernel numbers after the word ``kernels``, the same
object alone, and the result object ``{"ok": true, "device": {...}}``.
Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/ring.cu"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# The guards' int32 compares run on the CUDA cores.  The data sheet gives
# no integer rate outside the tensor cores; its float32 CUDA-core rate
# stands in (an upper bound on the int32 rate, so the bound stays a bound).
CUDA_CORE_OPS_PER_S = 67e12
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


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over HBM bandwidth and operations over the
    CUDA-core rate, and which of the two it is."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / CUDA_CORE_OPS_PER_S * 1e3
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / SOURCE).is_file():
        print(f"chip_smoke: {SOURCE} not found next to this script; run it "
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

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("ring")
    log(f"build: {SOURCE} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3-5
    timing, errs = kernel_phase()
    per_app, counts = main_path()
    full = full_size_vs_cpu()
    twin = twin_vs_compiled()
    brk, dev_ms = breakdown()

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
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        kernels=kernels, main_path=per_app, full_size_vs_cpu=full,
        twin_vs_compiled=twin, breakdown=brk),
        indent=1))
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

#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis, LM-serving and training paths on
one CUDA card and check them.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device — the card's name and power limit (``nvidia-smi``), CUDA
   version; TF32 matmuls off.
2. build — every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` into
   ``build/kernels/``, one compiler process per source, all at once; each
   kernel's registers, shared memory (static, and the dynamic share a
   flash, SSD or flash-decode block asks for; the last two must equal what
   their wrappers' ``launch_args`` compute on the host) and spills as
   ``ptxas -v`` reported them.
3. kernels — each ring kernel against its plain PyTorch version on the
   card, exactly.  ``sweep_guards`` (the sweep's control) at the main
   path's tables (gemm at full size: 88 tasks, 192 channels, 2 phases;
   gaussian's 3-phase stencils), with every task dead, with the done flag
   set, at T = 1 and T = 1000, and with the flags a graph with async ports
   gives it, ``SWEEP_STATES`` random carries each and 40
   launches back to back on one carry; its times at gemm's tables (per
   call through a prepared handle, device time a launch, plain version)
   beside its bound.  ``service_ports`` (the async ports' latency queues
   and the sweep's commit) bit for bit on ``SERVICE_STATES`` random port
   carries a case and 40 chained launches (``SERVICE_CASES``: depths 1, 4
   and 8; rows of 8 B, 7 B, 60 B, 39 KiB and 256 KiB; response rings full;
   addresses far out of range; write addresses with no value token; dues
   past and ahead; the done flag set), and its times at gemm's 16 ports of
   256 KiB rows beside its bound.  ``eval_guards`` (the reference API's
   counterpart) at its shapes.  Pop and push at the main path's shapes
   and at the edge cases (wraparound, ``n == cap``, ``cap == 1``, int32
   and bool elements; the bursts that spread over a cluster of blocks: a
   wrap of 2 MiB rows, odd
   row bytes, ``n == cap`` of 256 KiB rows); two chained sequences of
   ``CHAINED_OPS`` pops and pushes on one ring with no sync between
   them, against the same sequence through the plain versions; CUDA-event
   times of an eager call through a prepared ``RingHandle`` that has run
   the op once (the sweep's bodies call it so at capture; the replays
   launch the captured kernels with no host path) in ``TIMING_TURNS``
   turns with one library call (the median of each), the kernels' device
   time a launch under the profiler (profiled again once if it shows
   none, then a failure; every timed call must also show on the kernel's
   own launch counter), through ``ring_pop``/``ring_push`` (a handle
   built a call) and of the plain version, each timed call starting from
   a head/size inside the op's contract.
4. main path — gemm, gaussian and page_rank through ``build_step`` and
   the compiled engine at full size (what ``run_step`` runs), with launch
   counts read just before and just after each app.  The ring kernels
   count their launches on the card, where they run (replayed ones
   included): every ring kernel, ``sweep_guards`` included, must have
   launched in every app's run, ``sweep_guards`` once a replay, and
   ``ring_pop``/``ring_push`` exactly as often as the run's firings
   popped and pushed (``CompiledEngine.ring_ops``: each phase's ring ops
   from the counting pass times its firings); the run must have gone
   through the captured sweep (replays, at most one host sync a block and
   one final read), and its sweep graph must hold the guards, one node a
   (task, phase) body and, with async ports, the port service.  The same
   for the async-port graphs (``FULL_ASYNC``: gemm at full width, 96
   tasks over 280 channels and 16 ports; page_rank cut to 4,096 vertices),
   where ``service_ports`` must also launch once a replay (and never in a
   graph without ports).  Then each app at full size once more,
   held against the reference and against the CPU lowering of the same
   graph, relative to the output's scale (``REF_REL_TOL``,
   ``CPU_REL_TOL``); each async graph again on the card, with CUDA events
   around each block of replays (device time a sweep), and on the CPU:
   sweeps, fires, channel statistics and port counters equal, outputs
   within the same limits.
5. twin vs compiled — each app at a reduced size under the coroutine
   twin and under ``CompiledEngine``, both on the card: bit-identical
   outputs and equal token counts; the sweeps equal those of the CPU
   (plain-version) lowering of the same graph.  The async-port gemm and
   page_rank at the test sizes, at depths 1 and 4: bit-identical to the
   twin, and sweeps, fires, channel statistics and port counters equal
   to the CPU lowering's.
6. breakdown — each app at full size twice more: seconds in the app's
   build, the lowering (wiring + counting pass), the sweep loop and its
   capture, replays and host syncs, host ms a sweep; then with CUDA events
   around every block of replays, the device time in the sweep's graphs
   a replay (over the blocks of 64, where the host runs ahead of the
   card) and the share of the loop (the profiler does not report the
   kernels inside the graph's conditional nodes faithfully on this card,
   so none runs over them); each ring kernel's device time a launch from
   phase 3; the sweep graph's own cost: a graph of 14 and of 152
   one-kernel bodies, all firing and none firing, against a plain graph
   of the same kernels.
   Measurement only: the checks are phases 3-5.
7. attention kernels — flash attention forward and flash-decode against
   their plain versions on the card, in float32 and bfloat16, at the
   serving path's shapes (Qwen3-0.6B: 16 query heads, 8 KV heads of
   width 128; prefill buckets 8-2048, batch 1 and 8, causal, windowed
   and head-width-64 cases; the bf16 kernel's tile edges: Sq < Sk and
   Sq > Sk, a 1,500-token prompt, window 0 (every row hidden: exact
   zeros, lse -1e30), S=2048 with window 100, hd 64 with group 4; decode
   at 8 slots of a 2048-row cache with ragged lengths, 0 and 2048
   included, the edges of its 64-row splits (kv_len and S_max at 63, 64
   and 65) and groups 1, 4 and 8).  Limits, relative to the plain
   output's largest magnitude: ``ATTN_REL_TOL``; flash's ``lse`` within
   ``LSE_ABS_TOL``; exact zeros where ``kv_len == 0``.  CUDA-event times
   (B=1 S=1024 and 2048, B=8 S=256, B=4 S=1024 for flash) of kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port), each kernel's device time a call, reading a different layer's
   tensors on each call as the model does, so the 50 MB L2 holds none of them.
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
   per launch; every bf16 flash launch of the wave must show in the
   profile as the tensor-core kernel and none as the float32 one, and
   every flash-decode launch as ``decode_partial_kernel`` (by kernel
   name; the profiler on the card now and then loses kernel records, so
   here and in phases 13 and 15 a profile that misses launches is taken
   again on a new run, ``PROFILE_TRIES`` in all); then the decode step
   alone, 32 times over that wave's 8
   live slots: host and device ms per step, the busy share, and the aten
   operations one step dispatches.

11. SSD scan — ``ops.ssd_scan`` (the kernel) against its plain version
   through the same wrapper and against a float64 evaluation, at the
   training shape (B=8, S=2048, 24 heads of P=64, N=128, chunk 256), B=1,
   S=1000 (the pad path), G=2, N=64 and the reduced 16x16, with the
   model's decays and small ones (``SSD_REL_TOL``; at small decays the
   inter-chunk term must be a visible part of y); CUDA-event times of
   kernel and plain version at the training shape, the bound (3xTF32 on
   the tensor cores; the float32 CUDA cores' beside it), and each of the
   three kernels' device time per call.
12. training — ``repro_torch.launch.train`` on Mamba2-130M at full width
   (bf16, 8 x 2048, 20 steps, ``--use-kernel``): rc 0 (the driver's own
   loss-decrease check), exactly 2 x 24 x 20 SSD launches (remat runs each
   layer's forward twice), finite losses and gradient norms, the step-20
   checkpoint restorable, and the same command again runs no step.
13. Qwen3-0.6B at full width, 3 ``make_train_step(use_kernel=True)``
   steps at 4 x 1024: flash launched 2 x 28 x 3 times, all finite; then
   a fourth step under the profiler, whose 56 flash launches must all be
   the tensor-core kernel (flash's device time per launch and per step).
14. card vs CPU — Mamba2-130M cut to 2 layers, float32, the same weights
   and tokens: loss, every gradient leaf and one AdamW step
   (``TRAIN_CPU_TOL``).
15. training breakdown — one step of phase 12's configuration under the
   profiler: the device's busy share, the SSD kernel's device time and
   share (every SSD launch of the step must show as ``ssd_state_mma``, by
   kernel name), the top device operations; the backward's recompute
   alone.

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
# the async-port graphs (build_step_async) through the captured sweep:
# gemm at phase 4's widths, page_rank cut, since its fetcher moves one 8-byte
# edge row a firing (>= 16,384 sweeps here, >= 2.6 M at phase 4's graph)
FULL_ASYNC = {
    "gemm": dict(P=8, n=256, K=16, mem_latency=4, depth=4),
    "page_rank": dict(n_vertices=4096, n_edges=16384, n_pe=4, n_iters=4,
                      edge_latency=4, edge_depth=4),
}
# phase 5's async graphs: the test sizes, at depths 1 and 4
REDUCED_ASYNC = {
    "gemm": dict(P=2, n=4, K=4),
    "page_rank": dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=4),
}
REDUCED = {
    "gemm": dict(P=2, n=32, K=4),
    "gaussian": dict(h=64, w=64, iters=2),
    "page_rank": dict(n_vertices=1024, n_edges=8192, n_pe=2, n_iters=4),
}
# the ring kernels of the synthesis path; sweep_guards is the guards
# kernel the sweep loop runs, eval_guards (phase 3 only) its counterpart
# of the reference's eval_guards API
REPLACES = {
    "ring_pop": "src/repro/kernels/ring.py:84",
    "ring_push": "src/repro/kernels/ring.py:141",
    "sweep_guards": "src/repro/kernels/ring.py:200",
    # no Pallas kernel: the reference's per-sweep port service in XLA ops
    "service_ports": "src/repro/core/synth.py:951",
}
SWEEP_STATES = 100          # random carries a sweep_guards case checks
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:45",
    "decode_attention": "src/repro/kernels/decode_attention.py:35",
}
# device kernels of each attention op, as the profiler names them; a bf16
# flash launch runs the tensor-core kernel, and the float32 one (the
# checks' dtype) must never appear on the bf16 serving or training paths
ATTN_KERNELS = {"flash_attention": ("flash_wgmma_kernel",),
                "flash_attention_fp32": ("flash_fwd_kernel",),
                "decode_attention": ("decode_partial_kernel",
                                     "decode_merge_kernel")}


def log(*a) -> None:
    print(*a, flush=True)


REPS, WARM = 200, 20
PROFILE_TRIES = 3            # profiles of one run before a lost record fails


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
        self.head, self.size = head, size
        self.heads = torch.full((k,), head, dtype=torch.int32, device="cuda")
        self.sizes = torch.full((k,), size, dtype=torch.int32, device="cuda")
        self.h = self.heads.unbind()
        self.s = self.sizes.unbind()

    def handles(self, buf: torch.Tensor, prime) -> list:
        """One prepared ring handle per timed call, over ``buf`` and that
        call's (head, size): what the sweep's stream views call.  Each has
        run ``prime`` (the timed op) once, as a view's handle has after
        its ring's first firing (a handle keeps per-burst-size launch
        arguments); the counters are then reset."""
        from repro_torch.kernels.ring import RingHandle
        hs = [RingHandle(buf, h, s) for h, s in zip(self.h, self.s)]
        for h in hs:
            prime(h)
        self.heads.fill_(self.head)
        self.sizes.fill_(self.size)
        return hs

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


CHAINED_OPS = 1200
TIMING_TURNS = 3


def check_chained(cap: int, elem: tuple, dtype, seed: int) -> dict:
    """A seeded sequence of ``CHAINED_OPS`` pops and pushes of mixed sizes
    back to back on ONE ring (the same head/size tensors, no sync in
    between) through the kernels, and the same sequence through the plain
    versions on a copy; tokens, buffer, head and size must be equal.  A
    block of one launch reading a head that another block (or the launch
    before) had not yet settled would show here, and only here: the timed
    calls give every call fresh counters.  Half the pushes read rows at a
    4-byte offset, so the kernel narrows its copy word by the pointer."""
    from repro_torch.kernels import ring
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    buf, h, s = _ring(cap, elem, dtype, 0, 0, gen)
    pb, ph, ps = buf.clone(), h.clone(), s.clone()
    handle = ring.RingHandle(buf, h, s)
    row = handle.row_bytes
    # pushed rows come from a pool, whole or through a view one element
    # (4 bytes at most) past the pool's start
    pool = _ring(2 * cap + 1, elem, dtype, 0, 0, gen)[0]
    flat = pool.reshape(-1)
    row_elems = flat.numel() // pool.shape[0]
    size, got, want, blocks, narrowed = 0, [], [], set(), 0
    for _ in range(CHAINED_OPS):
        free = cap - size
        if size and (free == 0 or rng.random() < 0.5):
            n = int(rng.integers(1, size + 1))
            got.append(handle.pop(n))
            want.append(ring.ring_pop_plain(pb, ph, ps, n)[0])
            size -= n
        else:
            n = int(rng.integers(1, free + 1))
            j = int(rng.integers(0, cap + 1))
            if rng.random() < 0.5:
                arr = pool[j:j + n]
            else:
                arr = flat[j * row_elems + 1:(j + n) * row_elems + 1] \
                    .view((n,) + tuple(elem))
                narrowed += ring.copy_word(row, buf.data_ptr(),
                                           arr.data_ptr()) < \
                    ring.copy_word(row, buf.data_ptr())
            handle.push(arr)
            ring.ring_push_plain(pb, ph, ps, arr)
            size += n
        blocks.add(ring.cluster_blocks(n * row))
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) + [(buf, pb), (h, ph), (s, ps)]
    if not all(torch.equal(a, b) for a, b in pairs) or int(s) != size:
        raise AssertionError(f"chained ring ops differ from plain: cap={cap} "
                             f"elem={elem} {dtype}")
    return dict(cap=cap, elem=list(elem), dtype=str(dtype), ops=CHAINED_OPS,
                pops=len(got), row_bytes=row, cluster_sizes=sorted(blocks),
                narrowed_pushes=narrowed, max_abs_err=_max_err(*pairs))


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


def _counted_device_ms(fn, kernel: str, op: str, n: int) -> float:
    """:func:`_kernel_device_ms` of ``n`` calls of ``fn``, each of which
    must launch ``op``'s kernel once: its launch counter, which the
    kernel advances on the card, must read ``n`` after the calls.  If the
    profiler shows no launch the calls are profiled once more, and a
    second miss fails the run (the counter says the launches ran)."""
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    for attempt in (1, 2):
        reset_launches()
        try:
            ms = _kernel_device_ms(fn, kernel, n=n, tries=1)
        except AssertionError as e:
            launched = launch_counts().get(op, 0)
            if attempt == 2 or launched != n:
                raise AssertionError(f"{e} in {n} timed calls (the launch "
                                     f"counter read {launched}), attempt "
                                     f"{attempt}") from e
            log(f"kernels: the profiler saw none of {n} {kernel} launches "
                f"(the counter saw them); profiling them again")
            continue
        launched = launch_counts().get(op, 0)
        if launched != n:
            raise AssertionError(f"{n} timed {op} calls launched its "
                                 f"kernel {launched} times")
        return ms


def _random_plan(rng, n_tasks: int, n_chans: int, n_ph_max: int):
    """A plan-shaped table of ``n_tasks`` tasks of 1..``n_ph_max`` phases,
    each phase reading or writing up to 5 of ``n_chans`` channels (what
    ``_guard_tables`` reads)."""
    from types import SimpleNamespace
    caps = rng.integers(1, 9, n_chans)
    tasks = []
    for _ in range(n_tasks):
        phases = []
        for _ in range(int(rng.integers(1, n_ph_max + 1))):
            reads, writes = {}, {}
            for c in rng.choice(n_chans, size=int(rng.integers(
                    0, min(n_chans, 5) + 1)), replace=False):
                side = reads if rng.random() < 0.5 else writes
                side[int(c)] = int(rng.integers(1, caps[c] + 1))
            phases.append(SimpleNamespace(count=int(rng.integers(1, 5)),
                                          reads=reads, writes=writes))
        bounds = list(np.cumsum([p.count for p in phases]))
        tasks.append(SimpleNamespace(phases=phases, bounds=bounds,
                                     total=int(bounds[-1])))
    return SimpleNamespace(tasks=tasks, channels=[
        SimpleNamespace(capacity=int(c)) for c in caps])


def _sweep_tables(plan) -> dict:
    """The sweep program's tables of a plan, as numpy: what
    ``_SweepProgram`` hands ``SweepGuards``."""
    from repro_torch.core.synth import _guard_tables
    from repro_torch.kernels.ring import sparse_needs
    need_r, need_w, bounds, n_ph = _guard_tables(plan)
    n_tasks = len(plan.tasks)
    if bounds is None:
        bounds = np.zeros((n_tasks, 0), np.int32)
    caps = np.asarray([c.capacity for c in plan.channels], np.int32)
    row_ptr, entries = sparse_needs(need_r, need_w, caps)
    return dict(totals=np.asarray([tp.total for tp in plan.tasks], np.int32),
                bounds=bounds, row_ptr=row_ptr, entries=entries, caps=caps,
                n_ph=n_ph)


def _guard_carry(tab: dict, fires, sizes, state) -> list:
    """``SweepGuards``' arguments on the card: the tables, then a carry
    of its own (sizes, fires, state) and fresh outputs."""
    n_tasks = len(tab["totals"])
    on = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()  # noqa
    return [on(tab[k]) for k in ("totals", "bounds", "row_ptr",
                                 "entries")] + [
        on(sizes), on(fires), on(state),
        torch.zeros((n_tasks, tab["n_ph"]), dtype=torch.bool, device="cuda"),
        torch.zeros(n_tasks, dtype=torch.bool, device="cuda"),
        torch.zeros(n_tasks, dtype=torch.int32, device="cuda")]


def _guard_state(rng, tab: dict, how: str) -> tuple:
    how = how.split("+")[0]
    totals, caps = tab["totals"], tab["caps"]
    fires = totals.copy() if how == "dead" else rng.integers(0, totals + 1)
    sizes = rng.integers(0, caps + 1)
    if rng.random() < 0.5:              # rings empty or full, as a run has
        sizes = np.where(rng.random(len(caps)) < 0.5, 0, caps)
    return fires, sizes, [int(how == "done"), int(rng.integers(0, 100))]


def check_sweep_guards(tag: str, tab: dict, how: str, seed: int) -> dict:
    """``SWEEP_STATES`` random carries through the kernel and through the
    plain version on the card, every output and the carry compared
    exactly; then one carry through 40 launches back to back (the kernel
    reading what it wrote, no sync between) against 40 plain calls."""
    from repro_torch.kernels import ring
    rng = np.random.default_rng(seed)
    fired = 0
    flags = lambda: [torch.zeros(2, dtype=torch.int32, device="cuda")] \
        if how.endswith("+flags") else []     # noqa: E731
    for _ in range(SWEEP_STATES):
        st = _guard_state(rng, tab, how)
        k, p = _guard_carry(tab, *st) + flags(), _guard_carry(tab, *st) + \
            flags()
        ring.sweep_guards(*k)
        ring.sweep_guards_plain(*p)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k, p)):
            raise AssertionError(f"sweep_guards differs from plain: {tag}, "
                                 f"{how}")
        fired += int(k[8].sum())
    st = _guard_state(rng, tab, how)
    k, p = _guard_carry(tab, *st) + flags(), _guard_carry(tab, *st) + flags()
    handle = ring.SweepGuards(*k)
    for _ in range(40):
        handle()
        ring.sweep_guards_plain(*p)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, p)):
        raise AssertionError(f"40 chained sweep_guards launches differ from "
                             f"plain: {tag}, {how}")
    n_tasks, n_ph = len(tab["totals"]), tab["n_ph"]
    return dict(case=tag, carries=how, tasks=n_tasks, phases=n_ph,
                channels=len(tab["caps"]), nnz=len(tab["entries"]),
                fired=fired, chained_sweeps=int(k[6][1]), max_abs_err=0.0)


def _guard_work(tab: dict, fires, sizes) -> tuple[int, int]:
    """Bytes and integer operations one ``sweep_guards`` call needs on
    this carry: each live task reads its counter, total, bounds, its
    row's two offsets, entries and the sizes they name; every task writes
    its fire, phase and run row, a fired one its counter."""
    n_tasks, n_ph = len(tab["totals"]), tab["n_ph"]
    ph = (fires[:, None] >= tab["bounds"]).sum(1)
    rows = np.arange(n_tasks) * n_ph + ph
    live = fires < tab["totals"]
    nnz = int((tab["row_ptr"][rows + 1] - tab["row_ptr"][rows])[live].sum())
    nbytes = (n_tasks * (4 + 4 + 4 * (n_ph - 1) + 8) + 20 * nnz + 4
              + n_tasks * (n_ph + 1 + 4) + 4 * n_tasks + 8)
    return nbytes, n_tasks * (n_ph - 1) + 3 * nnz + 3 * n_tasks


def sweep_guard_phase(timing: dict) -> list:
    """Phase 3's sweep_guards part: the kernel against its plain version
    at the main path's tables (gemm at full size: 88 tasks, 192 channels,
    2 phases; gaussian's 3-phase stencils), with every task dead, with
    the done flag set, at T = 1 and T = 1000; its times at gemm's tables
    (per call through a prepared handle, device time a launch, plain
    version), each timed call on a carry of its own."""
    from repro_torch.apps import APPS
    from repro_torch.core.synth import elaborate_step_graph
    from repro_torch.kernels import ring
    tabs = {}
    for name in ("gemm", "gaussian"):
        top, args, _ = APPS[name].build_step(device="cuda", **FULL[name])
        tabs[name] = _sweep_tables(elaborate_step_graph(top, *args)[0])
    rng = np.random.default_rng(7)
    tabs["T=1"] = _sweep_tables(_random_plan(rng, 1, 3, 3))
    tabs["T=1000"] = _sweep_tables(_random_plan(rng, 1000, 600, 3))
    checks = [check_sweep_guards(tag, tabs[tag], how, seed)
              for seed, (tag, how) in enumerate([
                  ("gemm", "random"), ("gaussian", "random"),
                  ("gemm", "dead"), ("gemm", "done"), ("T=1", "random"),
                  ("T=1000", "random"), ("T=1000", "done"),
                  ("gemm", "random+flags"), ("gemm", "done+flags")])]
    for c in checks:
        log(f"kernels: sweep_guards exact at {c['case']} ({c['tasks']} tasks "
            f"x {c['phases']} phases, {c['channels']} channels, {c['nnz']} "
            f"entries), {c['carries']} carries: {SWEEP_STATES} carries "
            f"({c['fired']} firings) and 40 chained launches")
    tab = tabs["gemm"]
    st = _guard_state(np.random.default_rng(11), tab, "random")
    n = WARM + REPS
    hs = [ring.SweepGuards(*_guard_carry(tab, *st)) for _ in range(n)]
    ms = time_ms(lambda i: hs[i]())
    hs = [ring.SweepGuards(*_guard_carry(tab, *st)) for _ in range(n)]
    dev = _counted_device_ms(lambda i: hs[i](), "sweep_guards_kernel",
                             "sweep_guards", n)
    ps = [_guard_carry(tab, *st) for _ in range(60)]
    plain = time_ms(lambda i: ring.sweep_guards_plain(*ps[i]), reps=50,
                    warm=10)
    nb, ops = _guard_work(tab, st[0], st[1])
    bnd, by = bound_ms(nb, ops)
    timing["sweep_guards"] = [dict(
        shape=f"gemm {len(tab['totals'])} tasks x {tab['n_ph']} phases, "
              f"{len(tab['caps'])} channels", ms=ms, device_ms=dev,
        plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
        bytes=nb, ops=ops)]
    return checks


# (tag, ports as (depth, row shape, dtype, rows), what the carries stress)
SERVICE_CASES = [
    ("8 B rows, depths 1/4/8", [(1, (2,), torch.int32, 32),
                                (4, (2,), torch.int32, 32),
                                (8, (2,), torch.int32, 32)], "random"),
    ("256 KiB rows", [(4, (256, 256), torch.float32, 4),
                      (8, (256, 256), torch.float32, 3)], "random"),
    ("responses full", [(1, (2,), torch.int32, 8),
                        (4, (5, 3), torch.float32, 6),
                        (8, (256, 256), torch.float32, 2)], "full"),
    ("clipped addresses", [(4, (2,), torch.int32, 5),
                           (8, (7,), torch.bool, 9)], "clip"),
    ("no value tokens", [(4, (2,), torch.int32, 8),
                         (1, (256, 256), torch.float32, 2)], "novalue"),
    ("odd rows", [(8, (7,), torch.bool, 9), (1, (5, 3), torch.float32, 6),
                  (4, (3, 13001), torch.bool, 3)], "random"),
    ("done", [(4, (2,), torch.int32, 8), (4, (256, 256), torch.float32, 2)],
     "done"),
]
SERVICE_STATES = 40         # random carries a service_ports case checks
SERVICE_EXTRA_CHANNELS = 3  # channels no port owns (the maxocc sample)


def _rows(rng, shape, dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, shape,
                                             dtype=np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _service_carry(rng, ports: list, how: str) -> dict:
    """A random carry of ``ports`` ((depth, row, dtype, rows) each) on the
    CPU: the rings of port k are channels 5k .. 5k + 4, then
    ``SERVICE_EXTRA_CHANNELS`` of no port; windows of any size with dues
    from 3 sweeps past to 5 ahead of the counter, addresses a few rows out
    of range (``clip``: a thousand), response rings full (``full``), write
    addresses with no value token (``novalue``), the done flag set
    (``done``)."""
    n_ch = 5 * len(ports) + SERVICE_EXTRA_CHANNELS
    caps = rng.integers(1, 7, n_ch)
    heads = rng.integers(0, caps)
    sizes = rng.integers(0, caps + 1)
    bufs = {c: torch.zeros(int(caps[c]), dtype=torch.int32)
            for c in range(len(ports) * 5, n_ch)}
    sweeps = int(rng.integers(0, 60))
    far = 1000 if how == "clip" else 3
    out = []
    for k, (d, row, dt, nrow) in enumerate(ports):
        ra, rd, wa, wd, wr = range(5 * k, 5 * k + 5)
        if how == "full":
            sizes[rd], sizes[wr] = caps[rd], caps[wr]
        if how == "novalue":
            sizes[wd], sizes[wa] = 0, max(1, sizes[wa])
        addr = lambda *n: torch.from_numpy(   # noqa: E731
            rng.integers(-far, nrow + far, n).astype(np.int32))
        bufs[ra], bufs[wa] = addr(int(caps[ra])), addr(int(caps[wa]))
        bufs[rd] = _rows(rng, (int(caps[rd]), *row), dt)
        bufs[wd] = _rows(rng, (int(caps[wd]), *row), dt)
        bufs[wr] = torch.from_numpy(rng.random(int(caps[wr])) < 0.5)
        st = rng.integers(0, 100, 10).astype(np.int32)
        st[[0, 2]] = rng.integers(0, d, 2)              # heads
        st[[1, 3]] = rng.integers(0, d + 1, 2)          # sizes
        st[[8, 9]] = rng.integers(0, d + 1, 2)          # highwater marks
        win = np.stack([rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d),
                        rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d)]).astype(np.int32)
        out.append(dict(depth=d, latency=int(rng.integers(0, 6)),
                        chans=(ra, rd, wa, wd, wr),
                        data=_rows(rng, (nrow, *row), dt),
                        wval=_rows(rng, (d, *row), dt),
                        st=torch.from_numpy(st), win=torch.from_numpy(win)))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return dict(ports=out, bufs=bufs, heads=i32(heads), sizes=i32(sizes),
                maxocc=i32(rng.integers(0, 8, n_ch)),
                state=i32([int(how == "done"), sweeps]),
                flags=i32(rng.integers(0, 2, 2)))


def _service_on(carry: dict, device: str = "cuda"):
    """``ServicePorts`` over a copy of ``carry`` on ``device``, and every
    tensor it reads or writes."""
    from repro_torch.kernels import ring
    on = lambda t: t.clone().to(device)  # noqa: E731
    pint = torch.stack([q["st"] for q in carry["ports"]]).to(device)
    qs = []
    for k, q in enumerate(carry["ports"]):
        pq = ring.PortQueue(on(q["data"]), pint[k], q["chans"], q["depth"],
                            q["latency"])
        pq.win.copy_(q["win"])
        pq.wval.copy_(q["wval"])
        qs.append(pq)
    bufs = {c: on(b) for c, b in carry["bufs"].items()}
    args = [on(carry[k]) for k in ("heads", "sizes", "maxocc", "state",
                                   "flags")]
    svc = ring.ServicePorts(qs, bufs, *args)
    tensors = [pint, *args] + [bufs[c] for c in sorted(bufs)] + \
        [x for q in qs for x in (q.data, q.win, q.wval)]
    return svc, tensors


def check_service_ports(tag: str, ports: list, how: str, seed: int) -> dict:
    """``SERVICE_STATES`` random carries through the kernel and through the
    plain version on the card, every tensor compared exactly (and the
    kernel's scratch back at zero); then one carry through 40 launches
    back to back, the kernel reading what it wrote, against 40 plain
    calls."""
    from repro_torch.kernels.ring import service_ports_plain
    rng = np.random.default_rng(seed)
    moved = 0
    for k in range(SERVICE_STATES + 1):
        carry = _service_carry(rng, ports, how)
        chain = k == SERVICE_STATES
        if chain:                           # every sweep fires: no end
            carry["flags"].fill_(1)
        kern, kt = _service_on(carry)
        plain, pt = _service_on(carry)
        for _ in range(40 if chain else 1):
            kern()
            service_ports_plain(plain.ports, plain.bufs, *plain.args)
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(kt, pt))
               if not torch.equal(a, b)]
        if bad or kern.scratch.any():
            raise AssertionError(f"service_ports differs from plain: {tag}, "
                                 f"{how}, carry {k}, tensors {bad}, scratch "
                                 f"{kern.scratch.tolist()}")
        moved += int(not torch.equal(kt[0].cpu(), torch.stack(
            [q["st"] for q in carry["ports"]])))
    return dict(case=tag, carries=how, ports=len(ports),
                depths=[d for d, *_ in ports],
                rows=[f"{tuple(r)} {str(dt).split('.')[-1]}"
                      for _, r, dt, _ in ports],
                carries_that_moved=moved, blocks=kern.blocks,
                max_abs_err=0.0)


def _gemm_service_carries(n: int):
    """``n`` carries of gemm's 16 ports at full width (P=8, n=256, K=16,
    depth 4, latency 4; 280 channels), each in the steady state of a
    sweep: every read window full with one request due, one address
    queued; every write window full with one due, one address and one
    value queued.  The buffers are shared, the counters are each call's
    own.  Returns the ``ServicePorts`` and the bytes a call moves."""
    from repro_torch.kernels import ring
    P, nb, K, d, C = 8, 256, 16, 4, 280
    f32, i32 = torch.float32, dict(dtype=torch.int32, device="cuda")
    blk = (nb, nb)
    datas = [torch.randn((K, *blk), device="cuda") for _ in range(P)] + \
        [torch.zeros((P, *blk), device="cuda") for _ in range(P)]
    rows = {5 * k + r: torch.zeros((d, *blk), dtype=f32, device="cuda")
            for k in range(2 * P) for r in (1, 3)}
    toks = {5 * k + r: torch.zeros(d, **i32) for k in range(2 * P)
            for r in (0, 2)}
    acks = {5 * k + 4: torch.zeros(d, dtype=torch.bool, device="cuda")
            for k in range(2 * P)}
    bufs = {**rows, **toks, **acks}
    bufs.update({c: torch.zeros(2, **i32) for c in range(5 * 2 * P, C)})
    wvals = [torch.zeros((d, *blk), dtype=f32, device="cuda")
             for _ in range(2 * P)]
    sweeps = 100
    out = []
    for _ in range(n):
        sizes = torch.zeros(C, **i32)
        pint = torch.zeros((2 * P, ring.PORT_WORDS), **i32)
        qs = []
        for k in range(2 * P):
            q = ring.PortQueue(datas[k], pint[k], range(5 * k, 5 * k + 5), d,
                               4)
            q.wval = wvals[k]
            due = sweeps + torch.arange(d, **i32)
            if k < P:                       # A ports: reads
                pint[k, ring.P_RSIZE] = d
                q.win[0] = torch.arange(d, **i32)
                q.win[1] = due
                sizes[5 * k] = 1
            else:                           # C ports: writes
                pint[k, ring.P_WSIZE] = d
                q.win[2] = torch.arange(d, **i32)
                q.win[3] = due
                sizes[5 * k + 2] = sizes[5 * k + 3] = 1
            qs.append(q)
        out.append(ring.ServicePorts(
            qs, bufs, torch.zeros(C, **i32), sizes, torch.zeros(C, **i32),
            torch.tensor([0, sweeps], **i32), torch.ones(2, **i32)))
    row = nb * nb * 4
    copies = P * 1 + P * 2          # a read delivery; a write delivery and
    #                                 an acceptance
    words = 2 * P * (2 * 10 + 2 * 4 * d + 2 * 2 * 5) + 3 * C + 2 * 2 + 2
    return out, copies * 2 * row + 4 * words


def service_ports_phase(timing: dict) -> list:
    """Phase 3's service_ports part: the kernel against its plain version
    on random carries (``SERVICE_CASES``), and its times at gemm's full
    width (a call through a prepared handle, device time a launch, plain
    version) beside its bound."""
    checks = [check_service_ports(tag, ports, how, seed)
              for seed, (tag, ports, how) in enumerate(SERVICE_CASES)]
    for c in checks:
        log(f"kernels: service_ports exact at {c['case']} ({c['ports']} "
            f"ports, depths {c['depths']}, rows {c['rows']}, clusters of "
            f"{c['blocks']}), {c['carries']} carries: {SERVICE_STATES} "
            f"carries and 40 chained launches")
    n = WARM + REPS
    hs, nb = _gemm_service_carries(n)
    ms = time_ms(lambda i: hs[i]())
    hs, _ = _gemm_service_carries(n)
    dev = _counted_device_ms(lambda i: hs[i](), "service_ports_kernel",
                             "service_ports", n)
    hs, _ = _gemm_service_carries(30)
    from repro_torch.kernels.ring import service_ports_plain
    plain = time_ms(lambda i: service_ports_plain(hs[i].ports, hs[i].bufs,
                                                  *hs[i].args),
                    reps=20, warm=10)
    if not all(int(h.args[3][1]) == 101 for h in hs):
        raise AssertionError("service_ports: a timed call did not count its "
                             "sweep")
    bnd, by = bound_ms(nb)
    timing["service_ports"] = [dict(
        shape="gemm 16 ports of 256 KiB rows, depth 4, 280 channels",
        ms=ms, device_ms=dev, plain_ms=plain, library_ms=None, bound_ms=bnd,
        bound_by=by, bytes=nb)]
    return checks


def kernel_phase() -> tuple[dict, dict, list]:
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
        # bursts that make the blocks of a cluster share the copy: a wrap
        # of 2 MiB rows (8 blocks, many passes), odd row bytes (byte
        # words over 5 blocks), n == cap with 256 KiB rows
        dict(tag="wrap wide", cap=3, elem=(512, 1024), dtype=f32, head=2,
             size=3, n=3, push_n=3),
        dict(tag="odd rows", cap=5, elem=(3, 13001), dtype=b, head=3,
             size=5, n=4, push_n=4),
        dict(tag="n=cap 256K", cap=4, elem=(256, 256), dtype=f32, head=3,
             size=4, n=4, push_n=4),
    ]
    errs = {"ring_pop": 0.0, "ring_push": 0.0, "sweep_guards": 0.0,
            "service_ports": 0.0, "eval_guards": 0.0}
    for c in cases:
        e_pop, e_push = check_pop_push(c, gen)
        errs["ring_pop"] = max(errs["ring_pop"], e_pop)
        errs["ring_push"] = max(errs["ring_push"], e_push)
    log(f"kernels: ring_pop/ring_push exact on {len(cases)} cases "
        f"({', '.join(c['tag'] for c in cases)})")
    chained = [check_chained(8, (64, 256), f32, seed=3),   # 64 KiB rows
               check_chained(6, (7, 1111), b, seed=4)]     # 7,777-byte rows
    for r in chained:
        for op in ("ring_pop", "ring_push"):
            errs[op] = max(errs[op], r["max_abs_err"])
        log(f"kernels: {r['ops']} chained ring ops ({r['pops']} pops) on one "
            f"ring, cap {r['cap']} x {r['elem']} {r['dtype']} "
            f"({r['row_bytes']} B rows; clusters of {r['cluster_sizes']} "
            f"blocks; {r['narrowed_pushes']} pushes at a narrower word): "
            f"exact")
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
    guard_checks = sweep_guard_phase(timing)
    service_checks = service_ports_phase(timing)
    for c in cases[:4]:
        cap, head, size, n = c["cap"], c["head"], c["size"], c["n"]
        buf = _ring(cap, c["elem"], c["dtype"], 0, 0, gen)[0]
        row = buf[0].numel() * buf.element_size()
        idx = ((head + torch.arange(n)) % cap).cuda()
        arr = buf[:n].clone()
        nb = 2 * n * row + 16           # rows in + out, head/size r+w
        bnd, by = bound_ms(nb)
        # ring_pop / ring_push eager: a prepared handle per timed call, as
        # the sweep's stream views call them at capture, in turns with the
        # library call (the host's clock drifts within a run: the median of
        # TIMING_TURNS each); *_public: the functions, a handle built a call
        turns = {k: [] for k in ("ring_pop", "index_select", "ring_push",
                                 "index_copy_")}
        for _ in range(TIMING_TURNS):
            st = _Counters(head, size)
            hs = st.handles(buf, lambda h: h.pop(n))
            turns["ring_pop"].append(time_ms(lambda i: hs[i].pop(n)))
            st.expect("ring_pop", (head + n) % cap, size - n)
            turns["index_select"].append(
                time_ms(lambda i: buf.index_select(0, idx)))
            st = _Counters(head, cap - n)
            hs = st.handles(buf, lambda h: h.push(arr))
            turns["ring_push"].append(time_ms(lambda i: hs[i].push(arr)))
            st.expect("ring_push", head, cap)
            turns["index_copy_"].append(
                time_ms(lambda i: buf.index_copy_(0, idx, arr)))
            del hs
        times = {k: float(np.median(v)) for k, v in turns.items()}
        st = _Counters(head, size)
        hs = st.handles(buf, lambda h: h.pop(n))
        times["ring_pop_device"] = _counted_device_ms(
            lambda i: hs[i].pop(n), "ring_pop_kernel", "ring_pop",
            WARM + REPS)
        st = _Counters(head, cap - n)
        hs = st.handles(buf, lambda h: h.push(arr))
        times["ring_push_device"] = _counted_device_ms(
            lambda i: hs[i].push(arr), "ring_push_kernel", "ring_push",
            WARM + REPS)
        del hs
        for op, fn in (("ring_pop_public", ring.ring_pop),
                       ("ring_pop_plain", ring.ring_pop_plain)):
            st = _Counters(head, size)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], n))
            st.expect(op, (head + n) % cap, size - n)
        for op, fn in (("ring_push_public", ring.ring_push),
                       ("ring_push_plain", ring.ring_push_plain)):
            st = _Counters(head, cap - n)
            times[op] = time_ms(lambda i: fn(buf, st.h[i], st.s[i], arr))
            st.expect(op, head, cap)
        blocks = ring.cluster_blocks(n * row)
        for op, lib in (("ring_pop", "index_select"),
                        ("ring_push", "index_copy_")):
            timing[op].append(dict(
                shape=c["tag"], n=n, cap=cap, row_bytes=row, blocks=blocks,
                ms=times[op], device_ms=times[f"{op}_device"],
                public_ms=times[f"{op}_public"],
                plain_ms=times[f"{op}_plain"], library_ms=times[lib],
                turns_ms=turns[op], library_turns_ms=turns[lib],
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
            log(f"time {k:11s} {r['shape']:24s} eager {r['ms']*1e3:8.2f} us"
                + (f" (device {r['device_ms']*1e3:.3f} us)"
                   if r.get("device_ms") is not None else "")
                + f"  plain {r['plain_ms']*1e3:8.2f} us  library "
                + (f"{r['library_ms']*1e3:8.2f} us" if r["library_ms"]
                   is not None else "    none")
                + f"  bound {r['bound_ms']*1e3:7.3f} us ({r['bound_by']})"
                + (f"  public fn {r['public_ms']*1e3:8.2f} us, "
                   f"{r['blocks']} block(s)" if "public_ms" in r else ""))
    return timing, errs, dict(chained_ring_ops=chained,
                              sweep_guards=guard_checks,
                              service_ports=service_checks)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path, and twin vs compiled
# ---------------------------------------------------------------------------

def _graphs() -> list:
    """(tag, app, builder, parameters) of every graph phase 4 runs: the
    step-form apps, then the async-port ones."""
    return [(name, name, "build_step", kw) for name, kw in FULL.items()] + \
        [(f"{name}_async", name, "build_step_async", kw)
         for name, kw in FULL_ASYNC.items()]


def _port_stats(rep) -> list:
    return [(name, stats) for name, kind, stats in rep.interfaces
            if kind == "async_mmap"]


def main_path() -> tuple[dict, dict]:
    """Each graph at full size (the async page_rank cut) through its
    builder and the compiled engine, as ``run_step`` runs it (build, run,
    ``check()``), with the engine kept for its counts: the run must go
    through the captured sweep (replays, at most one host sync a block and
    one final read).  The ring kernels count their own launches on the
    card: ``sweep_guards`` must have launched once a replay,
    ``ring_pop``/``ring_push`` as often as the run's firings popped and
    pushed (``eng.ring_ops``), each at least once, and ``service_ports``
    once a replay in a graph with ports and never in one without."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    per_app = {}
    reset_launches()
    for tag, name, builder, kw in _graphs():
        ports = builder == "build_step_async"
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top, args, check = getattr(APPS[name], builder)(device="cuda", **kw)
        eng = ENGINES["compiled"](device="cuda")
        rep = eng.run(top, *args)
        correct, max_err = check() if rep.ok else (False, float("nan"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        launches = {k: after.get(k, 0) - before.get(k, 0)
                    for k in REPLACES}
        if not (rep.ok and correct):
            raise AssertionError(f"{tag}: run failed or check() failed: "
                                 f"{rep.error} correct={correct} "
                                 f"err={max_err}")
        for k, v in launches.items():
            if v <= 0 and (ports or k != "service_ports"):
                raise AssertionError(f"{tag}: its run never launched {k}: "
                                     f"{launches}")
        if not (eng.n_replays > 0 and eng.n_host_syncs <= eng.n_blocks + 1):
            raise AssertionError(
                f"{tag}: not the captured sweep: {eng.n_replays} replays, "
                f"{eng.n_blocks} blocks, {eng.n_host_syncs} host syncs")
        steps = [inst.fn for inst in eng.instances
                 if getattr(inst.fn, "is_step_task", False)]
        bodies = sum(len(fn.phases()) for fn in steps)
        if eng.n_graph_nodes != 1 + bodies + ports:
            raise AssertionError(f"{tag}: a sweep graph of {eng.n_graph_nodes}"
                                 f" nodes; the guards, {bodies} bodies and "
                                 f"{int(ports)} port service make "
                                 f"{1 + bodies + ports}")
        want = dict(eng.ring_ops, sweep_guards=eng.n_replays,
                    service_ports=eng.n_replays if ports else 0)
        if launches != want:
            raise AssertionError(
                f"{tag}: the kernels counted {launches} launches on the "
                f"card; the run's replays and firings make {want}")
        sweeps = rep.switches
        per_app[tag] = dict(params=kw, check=bool(correct),
                            max_err=max_err, sweeps=sweeps, wall_s=wall,
                            sweeps_per_s=sweeps / wall, launches=launches,
                            capture_s=eng.capture_s, program_s=eng.program_s,
                            host_ms_per_sweep=eng.program_s / sweeps * 1e3,
                            tasks=len(steps), channels=rep.n_channels,
                            replays=eng.n_replays, blocks=eng.n_blocks,
                            host_syncs=eng.n_host_syncs,
                            graph_nodes=eng.n_graph_nodes,
                            port_stats=_port_stats(rep))
        log(f"main {tag}: check {correct} max_err {max_err:.3e} "
            f"sweeps {sweeps} wall {wall:.3f} s "
            f"({sweeps / wall:.1f} sweeps/s; "
            f"{eng.program_s / sweeps * 1e3:.3f} host ms a sweep) capture "
            f"{eng.capture_s:.3f} s, "
            f"{eng.n_replays} replays in {eng.n_blocks} blocks, "
            f"{eng.n_host_syncs} host syncs, a graph of {eng.n_graph_nodes} "
            f"nodes ({len(steps)} tasks, {rep.n_channels} channels); "
            f"launches {launches} (counted on the card; == replays and the "
            f"firings' ring ops)")
    return per_app, launch_counts()


def _async_outputs(name: str, args) -> torch.Tensor:
    if name == "gemm":
        return torch.stack([p.data for p in args[2]])
    return args[1].data


def _schedule(rep, eng) -> tuple:
    """What a compiled run's schedule must equal exactly across devices:
    sweeps, each task's end state, channel tokens and highwater marks, the
    ports' request counters."""
    import re
    return (rep.switches, re.sub(r"#\d+", "", repr(rep.instances)),
            rep.channels, sorted(
        (c.name, c.total_read, c.total_written, c.max_occupancy)
        for c in eng.channel_set), _port_stats(rep))


def async_vs_cpu() -> dict:
    """Each async-port graph of phase 4 again on the card, with CUDA events
    around each block of replays (device time a sweep in the sweep's
    graphs), and on the CPU (the plain versions): the schedule (sweeps,
    fires, channel stats, port counters) equal, the outputs within
    ``CPU_REL_TOL`` of the CPU's and ``REF_REL_TOL`` of the reference
    (relative to max |out|)."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL_ASYNC.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            top, args, check = APPS[name].build_step_async(device=dev, **kw)
            eng = ENGINES["compiled"](device=dev)
            with _TimedReplays() as tr:
                rep = eng.run(top, *args)
            if not rep.ok:
                raise AssertionError(f"{name} async on {dev}: {rep.error}")
            runs[dev] = dict(y=_async_outputs(name, args).cpu().double(),
                             schedule=_schedule(rep, eng), eng=eng,
                             err=check()[1])
            if dev == "cuda":
                graph_s = tr.device_s()[0]
        c, g = runs["cpu"], runs["cuda"]
        if g["schedule"] != c["schedule"]:
            raise AssertionError(f"{name} async: the card's schedule "
                                 f"{g['schedule'][0]} sweeps, ports "
                                 f"{g['schedule'][4]} differs from the CPU "
                                 f"lowering's {c['schedule'][0]}, "
                                 f"{c['schedule'][4]}")
        scale = float(c["y"].abs().max())
        rel_ref = g["err"] / scale
        rel_cpu = float((g["y"] - c["y"]).abs().max()) / scale
        if not (rel_ref < REF_REL_TOL and rel_cpu <= CPU_REL_TOL[name]):
            raise AssertionError(
                f"{name} async: max err / max |out| = {rel_ref:.3e} against "
                f"the reference (limit {REF_REL_TOL:g}), {rel_cpu:.3e} "
                f"against the CPU lowering (limit {CPU_REL_TOL[name]:g})")
        sweeps, eng = g["schedule"][0], g["eng"]
        out[name] = dict(params=kw, sweeps=sweeps, rel_err_ref=rel_ref,
                         rel_err_cpu=rel_cpu, graph_device_s=graph_s,
                         graph_us_per_sweep=graph_s / sweeps * 1e6,
                         timed_program_s=eng.program_s,
                         timed_capture_s=eng.capture_s,
                         cpu_program_s=c["eng"].program_s,
                         port_stats=g["schedule"][4])
        log(f"async {name}: schedule == CPU lowering ({sweeps} sweeps, "
            f"port counters {g['schedule'][4][0]} ...), card vs reference "
            f"{rel_ref:.3e}, vs CPU {rel_cpu:.3e} of max |out|; device in "
            f"the sweep's graphs {graph_s:.4f} s = "
            f"{graph_s / sweeps * 1e6:.1f} us a sweep (events a block; this "
            f"run's loop {eng.program_s - eng.capture_s:.3f} s)")
    return out


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
    for name, kw in REDUCED_ASYNC.items():
        mod = APPS[name]
        for depth in (1, 4):
            k = dict(kw, **({"depth": depth} if name == "gemm"
                            else {"edge_depth": depth}))
            top, args, _ = mod.build_step_async(device="cuda", **k)
            twin = ENGINES["coroutine"](track_stats=True).run(top, *args)
            y_twin = _async_outputs(name, args).clone()
            runs = {}
            for dev in ("cuda", "cpu"):
                top, args, check = mod.build_step_async(device=dev, **k)
                eng = ENGINES["compiled"](device=dev)
                rep = eng.run(top, *args)
                if not (rep.ok and check()[0]):
                    raise AssertionError(f"{name} async depth {depth} on "
                                         f"{dev}: {rep.error}")
                runs[dev] = (_async_outputs(name, args).clone(),
                             _schedule(rep, eng), rep.tokens)
            tag = f"{name}_async depth {depth}"
            if not twin.ok or not torch.equal(y_twin, runs["cuda"][0]):
                raise AssertionError(f"{tag}: twin and compiled outputs "
                                     f"differ on the card ({twin.error})")
            if runs["cuda"][1] != runs["cpu"][1] or \
                    twin.tokens != runs["cuda"][2]:
                raise AssertionError(f"{tag}: the card's schedule "
                                     f"{runs['cuda'][1]} vs the CPU "
                                     f"lowering's {runs['cpu'][1]}")
            sched = runs["cuda"][1]
            out[f"{name}_async_d{depth}"] = dict(
                params=k, bitwise=True, sweeps=sched[0], port_stats=sched[4])
            log(f"twin {tag}: twin == compiled bitwise on the card; sweeps "
                f"{sched[0]}, fires, channel stats and port counters == CPU "
                f"lowering")
    return out


class _TimedReplays:
    """Inside the block, every block of replays of a sweep's graph
    (``SweepGraph.replay(k)``) is bracketed by two CUDA events on its
    stream.  Inside a block the host submits the replays back to back and
    runs ahead of the card; only a block's first replay may wait for the
    host's submission, so the blocks of :data:`TIMED_BLOCK` replays
    before the run's last block (which replays past the run's end) give
    the device time a replay of a sweep that runs."""

    def __enter__(self):
        from repro_torch.kernels.ring import SweepGraph
        self.events, self._orig = [], SweepGraph.replay
        events, orig = self.events, self._orig

        def replay(graph, k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig(graph, k)
            e1.record()
            events.append((k, e0, e1))

        SweepGraph.replay = replay
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ring import SweepGraph
        SweepGraph.replay = self._orig

    def device_s(self) -> tuple[float, float, int]:
        """Seconds in all the blocks, seconds in the blocks of
        :data:`TIMED_BLOCK` replays but the last block, and their
        replays."""
        torch.cuda.synchronize()
        ms = [(k, a.elapsed_time(b)) for k, a, b in self.events]
        full = [(k, t) for k, t in ms[:-1] if k == TIMED_BLOCK]
        return (sum(t for _, t in ms) / 1e3, sum(t for _, t in full) / 1e3,
                sum(k for k, _ in full))


TIMED_BLOCK = 64            # the sweep program's largest block


def _graph_time_us(replay, n: int = 200) -> float:
    replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n * 1e3


def graph_node_costs() -> list:
    """The device cost of the sweep graph's structure, apart from any
    app: a ``SweepGraph`` of ``T`` bodies of one small kernel each (as
    many bodies as gaussian's and gemm's sweeps have), every body firing
    and none firing (the done flag set), against one plain graph of the
    same ``T`` kernels; CUDA events over 200 replays."""
    from repro_torch.kernels import ring
    out = []
    i32 = dict(dtype=torch.int32, device="cuda")
    for n in (14, 152):
        x = torch.zeros(1024, device="cuda")
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        bodies = []
        for _ in range(n):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.stream(stream):
                g.capture_begin(pool=pool)
                x.add_(1)
                g.capture_end()
            bodies.append(g)
        row = dict(bodies=n)
        for done in (0, 1):
            guards = ring.SweepGuards(
                torch.full((n,), 1 << 30, **i32), torch.zeros((n, 0), **i32),
                torch.zeros(n + 1, **i32), torch.zeros((0, 4), **i32),
                torch.zeros(0, **i32), torch.zeros(n, **i32),
                torch.tensor([done, 0], **i32),
                torch.zeros((n, 1), dtype=torch.bool, device="cuda"),
                torch.zeros(n, dtype=torch.bool, device="cuda"),
                torch.zeros(n, **i32))
            sweep = ring.SweepGraph(guards, [(t, g.raw_cuda_graph())
                                             for t, g in enumerate(bodies)])
            row["none_fire_us" if done else "all_fire_us"] = _graph_time_us(
                lambda: sweep.replay(1))
            sweep.close()
        plain = torch.cuda.CUDAGraph()
        with torch.cuda.graph(plain, stream=stream):
            for _ in range(n):
                x.add_(1)
        row["plain_graph_us"] = _graph_time_us(plain.replay)
        out.append(row)
        log(f"breakdown graph nodes: {n} one-kernel bodies, a sweep graph "
            f"{row['all_fire_us']:.1f} us all firing, {row['none_fire_us']:.1f}"
            f" us none firing; a plain graph of the {n} kernels "
            f"{row['plain_graph_us']:.1f} us")
    return out


def breakdown(device_ms: dict) -> dict:
    """Phase 6: each app at full size, twice more.  Uninstrumented: host
    ms a sweep two ways (``program_s`` over the sweeps: the sweep loop
    with its capture and the write-back, as earlier trees measured it;
    and without the capture).  With CUDA events around every block of
    replays: the device time spent in the sweep's graphs, over the sweeps
    and as a share of that run's loop, and a replay's over the blocks of
    :data:`TIMED_BLOCK` (gaussian's; gemm's and page_rank's runs end in
    shorter blocks).  Not under the profiler: on this card it does not
    report the kernels inside the graph's conditional nodes faithfully
    (it both drops and adds records), so the kernels' device times a
    launch come from phase 3 (``device_ms``: eager launches at the main
    path's shapes, each held against the kernel's launch counter)."""
    from repro_torch import ENGINES
    from repro_torch.apps import APPS
    out = {}
    for name, kw in FULL.items():
        t0 = time.perf_counter()
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        build_s = time.perf_counter() - t0
        eng = ENGINES["compiled"](device="cuda")
        if not eng.run(top, *args).ok:
            raise AssertionError(f"{name}: the run failed")
        sweeps, loop_s = eng.n_sweeps, eng.program_s - eng.capture_s
        top, args, _ = APPS[name].build_step(device="cuda", **kw)
        timed = ENGINES["compiled"](device="cuda")
        with _TimedReplays() as tr:
            if not timed.run(top, *args).ok:
                raise AssertionError(f"{name}: the timed run failed")
        graph_s, full_s, full_replays = tr.device_s()
        per_replay = full_s / full_replays * 1e6 if full_replays else None
        timed_loop_s = timed.program_s - timed.capture_s
        out[name] = dict(build_s=build_s, lower_s=eng.lower_s,
                         program_s=eng.program_s, capture_s=eng.capture_s,
                         sweeps=sweeps, replays=eng.n_replays,
                         blocks=eng.n_blocks, host_syncs=eng.n_host_syncs,
                         host_ms_per_sweep=eng.program_s / sweeps * 1e3,
                         host_ms_per_sweep_uncaptured=loop_s / sweeps * 1e3,
                         graph_device_s=graph_s,
                         graph_us_per_sweep=graph_s / sweeps * 1e6,
                         graph_share_of_loop=graph_s / timed_loop_s,
                         graph_us_per_replay_in_blocks_of_64=per_replay,
                         replays_in_blocks_of_64=full_replays,
                         timed_program_s=timed.program_s,
                         timed_capture_s=timed.capture_s,
                         kernel_device_us={
                             k: v * 1e3 for k, v in device_ms.items()})
        log(f"breakdown {name}: build {build_s:.3f} s, lower {eng.lower_s:.3f}"
            f" s, sweep loop {eng.program_s:.3f} s ({sweeps} sweeps, "
            f"{eng.program_s / sweeps * 1e3:.3f} ms each; capture "
            f"{eng.capture_s:.3f} s, {loop_s / sweeps * 1e3:.3f} ms a sweep "
            f"without it; {eng.n_replays} replays, {eng.n_host_syncs} host "
            f"syncs); device in the sweep's graphs (events a block, another "
            f"run) {graph_s:.4f} s = {graph_s / sweeps * 1e6:.1f} us a sweep, "
            f"{graph_s / timed_loop_s:.1%} of its {timed_loop_s:.3f} s loop"
            + (f"; {per_replay:.1f} us a replay in {full_replays} replays in "
               f"blocks of {TIMED_BLOCK}" if per_replay is not None else ""))
    log("breakdown kernels, device time a launch (phase 3): " + ", ".join(
        f"{k} {v * 1e3:.3f} us" for k, v in device_ms.items()))
    out["graph_nodes"] = graph_node_costs()
    return out



# ---------------------------------------------------------------------------
# phase 7: attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_REPS, ATTN_WARM = 50, 5
LAYERS = 28                 # distinct tensors the timed calls cycle through

FLASH_CASES = [             # (B, Sq, Sk, nh, nkv, hd, causal, window)
    (1, 8, 8, 16, 8, 128, True, None), (8, 8, 8, 16, 8, 128, True, None),
    (1, 128, 128, 16, 8, 128, True, None),
    (8, 128, 128, 16, 8, 128, True, None),
    (1, 200, 200, 16, 8, 128, True, None),
    (8, 200, 200, 16, 8, 128, True, None),
    (1, 2048, 2048, 16, 8, 128, True, None),
    (8, 2048, 2048, 16, 8, 128, True, None),
    (2, 300, 300, 16, 8, 128, True, 100),   # sliding window
    (2, 77, 77, 8, 2, 64, False, None),     # head width 64, group 4
    # the edges of the bf16 kernel's 128-row and 128-key tiles
    (1, 100, 300, 16, 8, 128, True, None),  # Sq < Sk (top-left causal)
    (1, 300, 100, 16, 8, 128, True, None),  # Sq > Sk: rows past Sk
    (1, 1500, 1500, 16, 8, 128, True, None),   # not a tile multiple
    (1, 64, 64, 16, 8, 128, True, 0),       # window 0: every row hidden
    (1, 2048, 2048, 16, 8, 128, True, 100),    # tiles skipped both sides
    (2, 333, 333, 8, 2, 64, True, 100),     # hd 64, group 4, window
    (4, 1024, 1024, 16, 8, 128, True, None),   # Qwen3 training shape
]
DECODE_CASES = [            # (B, S_max, nh, nkv, hd, kv_len)
    (8, 2048, 16, 8, 128, [0, 1, 255, 256, 257, 2048, 1000, 37]),
    (8, 2048, 16, 8, 128,
     np.random.default_rng(1).integers(0, 2049, 8).tolist()),
    (4, 512, 8, 2, 64, [0, 1, 255, 512]),   # head width 64, group 4
    # the edges of the kernel's 64-row splits: kv_len and S_max at split
    # - 1, split and split + 1
    (8, 2048, 16, 8, 128, [0, 63, 64, 65, 127, 128, 129, 2047]),
    (4, 65, 16, 8, 128, [0, 63, 64, 65]),
    (3, 63, 16, 8, 128, [1, 62, 63]),
    (2, 300, 16, 2, 64, [65, 300]),         # group 8
    (2, 200, 8, 8, 128, [64, 200]),         # group 1
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
        NEG_INF, flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows, worst = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_REL_TOL[dt]
        for B, Sq, Sk, nh, nkv, hd, causal, window in FLASH_CASES:
            q = _rand(gen, (B, Sq, nh, hd), dt)
            k = _rand(gen, (B, Sk, nkv, hd), dt)
            v = _rand(gen, (B, Sk, nkv, hd), dt)
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
            p_out, p_lse = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
            torch.cuda.synchronize()
            err, rel = _errs(out, p_out)
            lse_err = float((lse - p_lse).abs().max())
            # window 0 hides every key: exact zeros and lse -1e30
            zeros_missing = window == 0 and not (
                bool((out == 0).all()) and bool((lse == NEG_INF).all()))
            rows.append(dict(op="flash_attention", dtype=str(dt), B=B, Sq=Sq,
                             Sk=Sk, nh=nh, nkv=nkv, hd=hd, causal=causal,
                             window=window, max_abs_err=err, rel_err=rel,
                             lse_abs_err=lse_err))
            log(f"attn flash  {str(dt):14s} B={B} Sq={Sq:4d} Sk={Sk:4d} "
                f"{nh}/{nkv}x{hd} causal={causal} window={window}: rel "
                f"{rel:.2e} (limit {tol:g}), lse {lse_err:.2e} (limit "
                f"{LSE_ABS_TOL:g})" + ("; exact zeros, lse -1e30"
                                        if window == 0 and not
                                        zeros_missing else ""))
            if not (rel <= tol and lse_err <= LSE_ABS_TOL) or zeros_missing:
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

    # flash: one prompt in the middle and the top prefill bucket, a batch
    # of eight short prompts, and the Qwen3 training shape (phase 13)
    for B, S in ((1, 1024), (1, 2048), (8, 256), (4, 1024)):
        qs = _rand(gen, (L, B, S, nh, hd), bf16)
        ks = _rand(gen, (L, B, S, nkv, hd), bf16)
        vs = _rand(gen, (L, B, S, nkv, hd), bf16)
        flops = 2 * B * nh * S * S * hd          # causal: half of 4 B nh S^2 hd
        nbytes = (qs[0].numel() * 2 + ks[0].numel() * 2) * 2 + 4 * B * nh * S
        bnd, by = bound_ms(nbytes, flops, TENSOR_BF16_FLOPS)

        def flash(i):
            return flash_attention_fwd(qs[i % L], ks[i % L], vs[i % L],
                                       causal=True)
        out["flash_attention"].append(dict(
            shape=f"B={B} Sq=Sk={S} nh={nh} nkv={nkv} hd={hd} bf16 causal",
            ms=timed(flash), device_ms=_kernel_device_ms(
                flash, ATTN_KERNELS["flash_attention"][0]),
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
    def decode(i):
        return decode_attention_fwd(qs[i % L], ks[i % L], vs[i % L], kv_len)
    out["decode_attention"].append(dict(
        shape=f"B={B} S_max={S} nh={nh} nkv={nkv} hd={hd} bf16 "
              f"kv_len={lens.tolist()}",
        ms=timed(decode), device_ms=_kernel_device_ms(
            decode, ATTN_KERNELS["decode_attention"]),
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
                + (f"(device {r['device_ms']*1e3:.2f} us)  "
                   if r.get("device_ms") else "")
                + f"plain {r['plain_ms']*1e3:9.2f} us  sdpa "
                f"{r['library_ms']*1e3:9.2f} us  bound "
                f"{r['bound_ms']*1e3:8.3f} us ({r['bound_by']})")
    return out


def _kernel_device_ms(fn, kernels, n: int = 2 * LAYERS,
                      tries: int = PROFILE_TRIES) -> float:
    """Mean device ms a call of the kernels named in ``kernels`` (one name,
    or a tuple whose first kernel runs once a call) over ``n`` calls of
    ``fn`` (the profiler's kernel time: no host path).  The profiler on
    the card now and then loses kernel records, so a profile that shows
    no launch is taken again on ``n`` new calls, ``tries`` profiles in
    all, and the last miss fails."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        total, calls = 0.0, 0
        for e in prof.key_averages():
            for j, nm in enumerate(names):
                if nm in e.key:
                    total += e.self_device_time_total
                    calls += e.count if j == 0 else 0
        if calls:
            return total / calls / 1e3
        if attempt == tries:
            raise AssertionError(f"the profiler saw no {names[0]} launch")
        log(f"the profiler saw none of {n} calls' {names[0]} launches; "
            f"profiling new calls ({attempt} of {tries} profiles)")


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


def _profiled(run, check, where: str):
    """``run()`` under ``torch.profiler`` (device activity), then
    ``check(prof, out)`` on the profile and what ``run`` returned, which
    raises AssertionError unless the profile shows every launch the run
    made.  The profiler on the card now and then loses kernel records
    (one serving wave showed 779 of its 868 flash-decode launches, in the
    runs of two trees), so a profile that fails the check is taken again
    on a new run, up to ``PROFILE_TRIES`` in all, and the last failure
    fails.  Returns ``(prof, out, check's result)``."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        try:
            return prof, out, check(prof, out)
        except AssertionError as e:
            if attempt == PROFILE_TRIES:
                raise
            log(f"{where}: {e}; profiling a new run ({attempt} of "
                f"{PROFILE_TRIES} lost records)")


def _check_flash_route(kern: dict, launches: int, where: str) -> None:
    """Raise unless the profile shows every one of ``launches`` bf16 flash
    launches as the tensor-core kernel and no float32 FMA kernel."""
    tc = kern.get("flash_attention", (0, 0.0))[0]
    fma = kern.get("flash_attention_fp32", (0, 0.0))[0]
    if launches == 0 or tc != launches or fma:
        raise AssertionError(
            f"{where}: {launches} flash launches, the profiler saw "
            f"{tc} {ATTN_KERNELS['flash_attention'][0]} and {fma} "
            f"{ATTN_KERNELS['flash_attention_fp32'][0]}")
    log(f"{where}: all {launches} flash launches ran "
        f"{ATTN_KERNELS['flash_attention'][0]}, none the float32 kernel")


def _check_decode_route(kern: dict, launches: int, where: str) -> None:
    """Raise unless the profile shows each of ``launches`` flash-decode
    launches as one ``decode_partial_kernel`` and one
    ``decode_merge_kernel``."""
    names = ATTN_KERNELS["decode_attention"]
    seen = kern.get("decode_attention", (0, 0.0))[0]
    if launches == 0 or seen != launches:
        raise AssertionError(f"{where}: {launches} flash-decode launches, the "
                             f"profiler saw {seen} {names[0]}")
    log(f"{where}: all {launches} flash-decode launches ran {names[0]} + "
        f"{names[1]}")


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
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.serve import serve_requests
    wave = reqs[:SERVE["slots"]]

    def run():
        stats.reset()
        reset_launches()
        t0 = time.perf_counter()
        res = serve_requests(eng, wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(len(res[r.rid]) != SERVE["max_new"] for r in wave):
            raise AssertionError("profiled wave: a request is short of "
                                 "tokens")
        return wall, launch_counts()

    def check(prof, out):
        counts = out[1]
        busy_us, kern = _device_times(prof)
        _check_flash_route(kern, counts.get("flash_attention", 0),
                           "breakdown serve")
        _check_decode_route(kern, counts.get("decode_attention", 0),
                            "breakdown serve")
        return busy_us, kern

    _, (wall, _), (busy_us, kern) = _profiled(run, check, "breakdown serve")
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
# the SSD's device kernels, as the profiler names them; the first is
# launched once a call (phase 15 counts calls by it)
SSD_KERNELS = ("ssd_state_mma", "ssd_state_pass", "ssd_scan_mma")
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
    outputs written once; the causal half of C B^T once per (batch row,
    chunk, group), which the heads of the group share, and per head the
    causal half of its decayed product with xdt, the state read, the
    chunk's own state and the state pass."""
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N
                  + 2 * B * H * P * N)
    tri = Q * (Q + 1) // 2
    per_group = tri * 2 * N
    per_head = tri * 2 * P + 2 * Q * 2 * P * N + 2 * P * N
    return nbytes, B * (S // Q) * (G * per_group + H * per_head)


# the tensor cores' TF32 rate; 3xTF32 (float32 accuracy) takes a third
TF32_FLOPS = 495e12
SSD_3XTF32_FLOPS = TF32_FLOPS / 3


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
    # the kernel's products run in 3xTF32 (float32 accuracy): its bound;
    # the float32 CUDA cores' bound beside it
    bnd, by = bound_ms(nbytes, flops, SSD_3XTF32_FLOPS)
    bnd_fp32, _ = bound_ms(nbytes, flops, CUDA_CORE_OPS_PER_S)

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
               bound_by=by, bound_peak="3xTF32 tensor cores, 495 / 3 "
               "TFLOP/s", bound_fp32_ms=bnd_fp32,
               bound_tf32_ms=max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS)
               * 1e3, bytes=nbytes, flops=flops, device_ms=dev_ms,
               device_us_by_kernel=per, tflops=flops / ms / 1e9)
    log(f"time ssd_scan {out['shape']}: kernel {ms * 1e3:9.2f} us "
        f"({out['tflops']:.1f} TFLOP/s), device "
        + (f"{dev_ms * 1e3:.2f} us (" + ", ".join(
            f"{k} {v:.2f}" for k, v in per.items()) + " us)"
           if dev_ms is not None else "not measured")
        + f"; plain {plain_ms * 1e3:9.2f} us; library none; bound "
        f"{bnd * 1e3:.3f} us ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP at 495 / 3 TFLOP/s 3xTF32; fp32 CUDA "
        f"cores {bnd_fp32 * 1e3:.3f} us; single TF32 "
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
    flash kernel forward and its autograd backward; then one step under
    the profiler."""
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
    # one more step, under the profiler and outside the counted run: every
    # flash launch must be the tensor-core kernel; flash's device time
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.next_batch().items()}
    torch.cuda.synchronize()

    def run():
        nonlocal params, state
        reset_launches()
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def check(prof, _):
        busy_us, kern = _device_times(prof)
        _check_flash_route(kern, launch_counts().get("flash_attention", 0),
                           f"train {ARCH}")
        return busy_us, kern

    _, prof_s, (busy_us, kern) = _profiled(run, check, f"train {ARCH}")
    n_flash, flash_us = kern["flash_attention"]
    del params, state
    torch.cuda.empty_cache()
    out = dict(arch=ARCH, dtype=cfg.dtype, **QWEN_TRAIN, losses=losses,
               grad_norms=gnorms, step_ms=[d * 1e3 for d in dts],
               launches=counts, peak_gb=peak_gb,
               profiled_step=dict(
                   wall_ms=prof_s * 1e3, device_busy_ms=busy_us / 1e3,
                   flash_launches=n_flash, flash_device_ms=flash_us / 1e3,
                   flash_device_us_per_launch=flash_us / n_flash))
    log(f"train {ARCH}: batch {B} x seq {S}, {steps} steps of "
        f"make_train_step(use_kernel=True): "
        + ", ".join(f"{d * 1e3:.0f}" for d in dts) + " ms; losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; grad norms "
        + ", ".join(f"{v:.3f}" for v in gnorms)
        + f"; launches {counts}; peak {peak_gb:.2f} GB; a profiled step: "
        f"{prof_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, flash "
        f"{n_flash} launches {flash_us / 1e3:.2f} ms "
        f"({flash_us / n_flash:.2f} us each)")
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
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
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
    def run():
        nonlocal params, state
        reset_launches()
        params, state, _ = step_fn(params, state, batches[3])

    def check(prof, _):
        launches = launch_counts().get("ssd_scan", 0)
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
        if launches == 0 or ssd_n != launches:
            raise AssertionError(f"breakdown train: {launches} SSD launches, "
                                 f"the profiler saw {ssd_n} {SSD_KERNELS[0]}")
        return launches, total, ssd_us, ssd_n, ops

    launches, total, ssd_us, ssd_n, ops = _profiled(run, check,
                                                     "breakdown train")[2]
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


def kernel_resources() -> list:
    """Phase 2: each kernel's registers, shared memory and spills as
    ``ptxas -v`` reported them, and the dynamic shared memory a block asks
    for: a flash block's (``flash_attention_smem_bytes``), an SSD block's
    at the training shape's chunk and heads a block, a flash-decode
    partial block's; the last two must equal what the wrappers'
    ``launch_args`` compute on the host."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.flash_attention import _SIGNATURES
    flash = _build.bind("flash_attention", _SIGNATURES)
    ssd_lib = _build.bind("ssd_scan", ssd._SIGNATURES)
    dec_lib = _build.bind("decode_attention", dec._SIGNATURES)
    _, B, S, H, G, _, _, Q, _, _ = SSD_CASES[0]
    nc = S // Q
    heads = {"ssd_state_mma": ssd.heads_per_block(H // G, H, nc * B,
                                                  ssd.MAX_STATE_HEADS),
             "ssd_scan_mma": ssd.heads_per_block(
                 H // G, H, nc * -(-Q // ssd.ROWS) * B)}
    dtypes = {"f": (0, torch.float32), "13__nv_bfloat16": (1, torch.bfloat16)}
    rows = []
    for name in SOURCES:
        for r in _build.resources(name):
            k = r["kernel"]
            dyn, host = None, None
            m = re.search(r"flash_(wgmma|fwd)_kernelIf?Li(\d+)E", k)
            if m:
                dyn = flash.flash_attention_smem_bytes(
                    int(m.group(1) == "wgmma"), int(m.group(2)))
            m = re.search(r"(ssd_state_mma|ssd_scan_mma)ILi(\d+)ELi(\d+)E", k)
            if m:
                P, N, hb = int(m.group(2)), int(m.group(3)), heads[m.group(1)]
                which = int(m.group(1) == "ssd_scan_mma")
                dyn = ssd_lib.ssd_scan_smem_bytes(which, P, N, Q, hb)
                host = ssd.smem_bytes(P, N, Q, hb)[which]
            m = re.search(r"decode_partial_kernelI(f|13__nv_bfloat16)Li(\d+)"
                          r"ELi(\d+)E", k)
            if m:
                code, dt = dtypes[m.group(1)]
                hd, grp = int(m.group(2)), int(m.group(3))
                dyn = dec_lib.decode_attention_smem_bytes(code, hd, grp)
                host = dec.smem_bytes(dt, hd, grp)
            if host is not None and host != dyn:
                raise AssertionError(f"{k}: the host computes {host} B of "
                                     f"dynamic shared memory, the kernel "
                                     f"asks {dyn}")
            rows.append(dict(source=name, **r, smem_dynamic=dyn))
            log(f"build: {k}: {r['registers']} registers, smem "
                f"{r['smem_static']} B static"
                + (f" + {dyn} B dynamic" if dyn is not None else "")
                + f", stack {r['stack']} B, spills {r['spill_stores']} B "
                f"stored / {r['spill_loads']} B loaded")
    return rows


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
    resources = kernel_resources()

    seconds = {}

    def phase(name: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    # 3-6: the synthesis path
    timing, errs, kernel_checks = phase("3 kernels", kernel_phase)
    per_app, counts = phase("4 main path", main_path)
    full = phase("4 full size vs cpu", full_size_vs_cpu)
    full_async = phase("4 async vs cpu", async_vs_cpu)
    twin = phase("5 twin vs compiled", twin_vs_compiled)
    dev_ms = {k: timing[k][0]["device_ms"] for k in REPLACES}
    brk = phase("6 breakdown", breakdown, dev_ms)

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
    for name in REPLACES:
        rows = timing[name]
        head = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=counts.get(name, 0), max_abs_err=errs[name],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            device_ms=head["device_ms"], shape=head["shape"], by_shape=rows))
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
        kernels=kernels, kernel_checks=kernel_checks,
        eval_guards=dict(replaces=REPLACES["sweep_guards"],
                         max_abs_err=errs["eval_guards"],
                         timing=timing["eval_guards"]),
        main_path=per_app, full_size_vs_cpu=full,
        async_vs_cpu=full_async,
        twin_vs_compiled=twin, breakdown=brk, attention_checks=attn_checks,
        serving=serving, serving_breakdown=serve_brk, serve_cli=cli,
        card_vs_cpu=vs_cpu, ssd_checks=ssd_checks, training=training,
        qwen_training=qwen, train_card_vs_cpu=train_cpu,
        train_breakdown=train_brk, kernel_resources=resources,
        phase_seconds=seconds), indent=1))
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

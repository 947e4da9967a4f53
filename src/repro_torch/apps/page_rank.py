"""PageRank (the paper's motivating example, Sections 2.3/4.1),
step-function form.

Ctrl broadcasts the rank vector to the scatter PEs each iteration and
reads their contributions back, so the dataflow graph has a cycle: the
sequential engine must fail on it (paper Fig. 7), while the thread and
coroutine engines and ``CompiledEngine`` run it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import MMap, StepTask, channel, mmap, task
from ..core.synth import resolve_device, to_torch_state
from .base import AppResult, simulate

DAMPING = 0.85


def build_step(n_vertices: int = 32, n_edges: int = 128, n_pe: int = 2,
               n_iters: int = 5, seed: int = 0, device=None):
    """PageRank in step-function form — the mmap-fed **feedback loop**
    case.  Each PE's edge list, its gather plan and the shared out-degree
    vector live behind read-only mmaps; the initial ranks enter through
    an mmap and the converged ranks leave through one (float32 throughout,
    the reference's canonical dtype).  Tokens are whole rank/contribution
    vectors — one token per PE per iteration.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    out_deg = np.maximum(np.bincount(src, minlength=n_vertices), 1)

    part = (n_vertices + n_pe - 1) // n_pe
    pe_edges = [np.array([(int(s), int(d)) for s, d in zip(src, dst)
                          if d // part == p], np.int32).reshape(-1, 2)
                for p in range(n_pe)]

    # Build-time gather plan per PE: pad each vertex's incoming-edge list
    # to the partition's max in-degree; slot (v, k) holds the edge index
    # whose weight feeds vertex v (or the one-past-the-end sentinel, a
    # zero weight).  The per-firing accumulation is then a fixed-order
    # chain of elementwise adds in the reference's edge order, so both
    # packages sum each vertex's weights in the same order.
    def _gather_plan(e):
        by_v: dict[int, list] = {}
        for k, (_, d) in enumerate(e):
            by_v.setdefault(int(d), []).append(k)
        width = max((len(v) for v in by_v.values()), default=1)
        idx = np.full((n_vertices, width), len(e), np.int32)   # sentinel
        for v, ks in by_v.items():
            idx[v, :len(ks)] = ks
        return idx

    gather_plans = [_gather_plan(pe_edges[p]) for p in range(n_pe)]

    r0 = np.full(n_vertices, 1.0 / n_vertices, np.float32)
    ranks = torch.zeros(n_vertices, dtype=torch.float32, device=dev)

    r0_mm = mmap(to_torch_state(r0, dev), "ranks0")
    out_mm = mmap(ranks, "ranks")
    deg_mm = mmap(to_torch_state(out_deg.astype(np.float32), dev), "out_deg")
    edge_mms = [mmap(to_torch_state(pe_edges[p], dev), f"edges{p}")
                for p in range(n_pe)]
    plan_mms = [mmap(to_torch_state(gather_plans[p], dev), f"gather{p}")
                for p in range(n_pe)]

    def scatter_step(state, edges: MMap, plan: MMap, deg: MMap, ranks_in,
                     upd_out):
        r = ranks_in.read()
        e = edges.read_burst(0, len(edges)).long()
        idx = plan.read_burst(0, n_vertices).long()
        degv = deg.read_burst(0, n_vertices)
        w = r[e[:, 0]] / degv[e[:, 0]]
        wext = torch.cat([w, torch.zeros(1, dtype=w.dtype, device=w.device)])
        contrib = wext[idx[:, 0]]
        for k in range(1, idx.shape[1]):        # static, fixed-order sum
            contrib = contrib + wext[idx[:, k]]
        upd_out.write(contrib)
        return state

    def _combine(upd_ins):
        total = upd_ins[0].read()
        for ci in upd_ins[1:]:
            total = total + ci.read()
        return ((1 - DAMPING) / n_vertices + DAMPING * total) \
            .to(torch.float32)

    def ctrl_warmup(r, ranks0: MMap, out: MMap, rank_outs, upd_ins):
        r = ranks0.read_burst(0, n_vertices)
        for o in rank_outs:
            o.write(r)
        return r

    def ctrl_step(r, ranks0: MMap, out: MMap, rank_outs, upd_ins):
        r = _combine(upd_ins)
        for o in rank_outs:
            o.write(r)
        return r

    def ctrl_flush(r, ranks0: MMap, out: MMap, rank_outs, upd_ins):
        r = _combine(upd_ins)
        out.write_burst(0, r)
        return r

    ScatterS = StepTask(scatter_step, steps=n_iters, name="Scatter")
    CtrlS = StepTask(ctrl_step, steps=n_iters - 1, warmup=ctrl_warmup,
                     flush=ctrl_flush,
                     init=torch.zeros(n_vertices, dtype=torch.float32,
                                      device=dev),
                     name="Ctrl")

    def Top(r0m: MMap, outm: MMap, degm: MMap, eports, plans):
        vec = dict(dtype=np.float32, shape=(n_vertices,))
        rank_ch = [channel(1, f"rank{p}", **vec) for p in range(n_pe)]
        upd_ch = [channel(1, f"upd{p}", **vec) for p in range(n_pe)]
        t = task()
        for p in range(n_pe):
            t = t.invoke(ScatterS, eports[p], plans[p], degm, rank_ch[p],
                         upd_ch[p], name=f"Scatter{p}")
        t.invoke(CtrlS, r0m, outm, rank_ch, upd_ch)

    def check():
        ref = np.full(n_vertices, 1.0 / n_vertices, np.float64)
        for _ in range(n_iters):
            contrib = np.zeros(n_vertices, np.float64)
            np.add.at(contrib, dst, ref[src] / out_deg[src])
            ref = (1 - DAMPING) / n_vertices + DAMPING * contrib
        err = float(np.max(np.abs(ranks.cpu().numpy() - ref)))
        return err < 1e-5, err

    return Top, (r0_mm, out_mm, deg_mm, edge_mms, plan_mms), check


def run_step(engine: str = "coroutine", device=None, **kw) -> AppResult:
    """Run the step-form graph — ``engine="compiled"`` synthesizes it on
    ``device``."""
    dev = resolve_device(device)
    top, args, check = build_step(device=dev, **kw)
    ekw = {"device": dev} if engine == "compiled" else None
    return simulate("page_rank_step", top, args, engine, check,
                    engine_kwargs=ekw)

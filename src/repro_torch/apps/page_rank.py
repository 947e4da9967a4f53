"""PageRank (the paper's motivating example, Sections 2.3/4.1).

``build``/``run`` (the reference's, copied) is the paper's Figure 3 on
host numpy buffers for the simulation engines: a Ctrl task coordinates
iterations, detached VertexHandlers serve rank requests, ComputeUnits
fetch their edge lists through an ``async_mmap`` port with the addresses
pipelined ahead of the data (``read_pipelined``), and UpdateHandlers
accumulate EoT-delimited update transactions.

``build_step`` is the step-function form: Ctrl broadcasts the rank vector
to the scatter PEs each iteration and reads their contributions back, so
the dataflow graph has a cycle: the sequential engine must fail on it
(paper Fig. 7), while the thread and coroutine engines and
``CompiledEngine`` run it.  ``build_step_async`` feeds the edges through
``async_mmap`` ports, which ``CompiledEngine`` lowers to latency queues.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import (AsyncMMap, MMap, StepTask, async_mmap, channel, mmap,
                     task)
from ..core.synth import resolve_device, to_torch_state
from .base import AppResult, simulate

DAMPING = 0.85


def VertexHandler(ranks: MMap, out_deg: MMap, req, resp):
    """Serve rank reads and apply rank writes; never terminates
    (invoked with detach=True, paper Listing 5)."""
    while True:
        kind, payload = req.read()
        if kind == "read":
            resp.write(ranks[payload] / out_deg[payload])
        else:                       # ("write", (vertex, value))
            v, val = payload
            ranks[v] = val


def ComputeUnit(edges: AsyncMMap, ctrl_in, upd_out, vreq, vresp):
    """Scatter phase for one partition: one update transaction per
    iteration.  Edge fetches go through the async memory port with the
    addresses pipelined ahead of the data (request/response overlap);
    vertex lookups are pipelined in bursts bounded by the response
    channel's capacity, so the handler round-trip cost is amortized
    across each batch."""
    n_edges = len(edges)
    burst = vresp.channel.capacity
    while True:
        go = ctrl_in.read()
        if go is None:              # shutdown
            break
        for base in range(0, n_edges, burst):
            hi = min(base + burst, n_edges)
            chunk = edges.read_pipelined(range(base, hi))
            vreq.write_burst([("read", int(s)) for s, _ in chunk])
            ws = vresp.read_burst(len(chunk))
            upd_out.write_burst([(int(d), w)
                                 for (_, d), w in zip(chunk, ws)])
        upd_out.close()             # end of this iteration's transaction


def UpdateHandler(upd_in, commit_out, p: int, part: int, n_vertices: int):
    """Gather phase: accumulate one iteration's update transaction
    (EoT-delimited, Listing 2) in a local register file, then report
    the partition's aggregate to Ctrl for commit."""
    lo = p * part
    hi = min(lo + part, n_vertices)
    while True:
        acc = np.zeros(hi - lo, np.float64)
        for d, w in upd_in.read_transaction():
            acc[d - lo] += w        # register accumulate (Listing 1)
        commit_out.write((p, acc))


def Ctrl(cu_outs, commit_ins, vreq, vresp, n_iters: int, part: int,
         n_vertices: int):
    for it in range(n_iters):
        for o in cu_outs:
            o.write(True)           # start scatter on every PE
        # barrier: collect EVERY partition's commit before writing any
        # rank back — scatter must see a consistent iteration-i view
        commits = [ci.read() for ci in commit_ins]
        for p, acc in commits:
            lo = p * part
            # rank write-back is fire-and-forget: a single burst moves
            # the whole partition (chunked by channel capacity)
            vreq.write_burst(
                [("write",
                  (lo + i, (1 - DAMPING) / n_vertices + DAMPING * val))
                 for i, val in enumerate(acc)])
        # read-as-fence: the handler serves FIFO, so a round-trip read
        # proves every prior write of this iteration has been applied
        # before the next iteration's scatter starts
        vreq.write(("read", 0))
        vresp.read()
    for o in cu_outs:
        o.write(None)               # shutdown compute units


def build(n_vertices: int = 32, n_edges: int = 128, n_pe: int = 2,
          n_iters: int = 5, seed: int = 0, edge_latency: int = 4,
          edge_depth: int = 4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.int64)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.int64)
    out_deg = np.maximum(np.bincount(src, minlength=n_vertices), 1)

    ranks = np.full(n_vertices, 1.0 / n_vertices, np.float64)
    part = (n_vertices + n_pe - 1) // n_pe
    # edges assigned to PEs by destination partition (gather locality),
    # each partition's (src, dst) rows behind its own async memory port
    pe_edges = [np.array([(int(s), int(d)) for s, d in zip(src, dst)
                          if d // part == p], np.int64).reshape(-1, 2)
                for p in range(n_pe)]

    ranks_mm = mmap(ranks, "ranks")
    deg_mm = mmap(out_deg, "out_deg")
    edge_ports = [async_mmap(pe_edges[p], latency=edge_latency,
                             depth=edge_depth, name=f"edges{p}")
                  for p in range(n_pe)]

    def Top(rk: MMap, deg: MMap, eports):
        vreq = channel(8, "vertex_req")
        vresp = channel(8, "vertex_resp")
        cu_go = [channel(2, f"go{p}") for p in range(n_pe)]
        upd = [channel(16, f"updates{p}") for p in range(n_pe)]
        commit = [channel(2, f"commit{p}") for p in range(n_pe)]
        # per-CU private request channels would shard the handler; the
        # paper's design muxes through one handler — we serialize CU reads
        # through per-CU req/resp pairs served by dedicated handlers to
        # honor one-producer/one-consumer.
        cu_vreq = [channel(8, f"cu_vreq{p}") for p in range(n_pe)]
        cu_vresp = [channel(8, f"cu_vresp{p}") for p in range(n_pe)]

        t = task()
        t = t.invoke(VertexHandler, rk, deg, vreq, vresp, detach=True)
        for p in range(n_pe):
            t = t.invoke(VertexHandler, rk, deg, cu_vreq[p], cu_vresp[p],
                         detach=True, name=f"VertexHandler{p}")
            t = t.invoke(ComputeUnit, eports[p], cu_go[p], upd[p],
                         cu_vreq[p], cu_vresp[p], name=f"ComputeUnit{p}")
            t = t.invoke(UpdateHandler, upd[p], commit[p], p, part,
                         n_vertices, name=f"UpdateHandler{p}", detach=True)
        t.invoke(Ctrl, cu_go, commit, vreq, vresp, n_iters, part,
                 n_vertices)

    def check():
        ref = np.full(n_vertices, 1.0 / n_vertices, np.float64)
        for _ in range(n_iters):
            contrib = np.zeros(n_vertices, np.float64)
            np.add.at(contrib, dst, ref[src] / out_deg[src])
            ref = (1 - DAMPING) / n_vertices + DAMPING * contrib
        err = float(np.max(np.abs(ranks - ref)))
        return err < 1e-9, err

    return Top, (ranks_mm, deg_mm, edge_ports), check


def run(engine: str = "coroutine", **kw) -> AppResult:
    top, args, check = build(**kw)
    return simulate("page_rank", top, args, engine, check)


# ---------------------------------------------------------------------------
# step-function form (whole-graph synthesis)
# ---------------------------------------------------------------------------

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


def build_step_async(n_vertices: int = 32, n_edges: int = 128, n_pe: int = 2,
                     n_iters: int = 5, seed: int = 0, edge_latency: int = 4,
                     edge_depth: int = 4, device=None):
    """The step-form feedback loop with **async-fed edges**: each PE's edge
    list sits behind an ``async_mmap`` port and a per-PE EdgeFetcher task
    streams the rows in through the port's latency queue, issuing
    addresses up to ``edge_depth`` ahead of the returning data.  A warmup
    phase primes ``depth`` requests, the steady phase retires one row and
    issues the next address a firing, and a flush phase drains the
    window.  Scatter then bursts the whole row batch out of an ordinary
    channel, so the rank feedback cycle of ``build_step`` is unchanged.
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
    for p, e in enumerate(pe_edges):
        if not len(e):
            raise ValueError(f"partition {p} has no edges; pick a denser "
                             f"graph or fewer PEs")

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
    edge_ports = [async_mmap(to_torch_state(pe_edges[p], dev),
                             latency=edge_latency, depth=edge_depth,
                             name=f"edges{p}")
                  for p in range(n_pe)]
    plan_mms = [mmap(to_torch_state(gather_plans[p], dev), f"gather{p}")
                for p in range(n_pe)]

    def _mk_fetcher(p: int, n_e: int):
        """Issue-ahead row fetcher: addresses cycle 0..n_e-1, n_iters
        passes over the table, with ``d`` requests in flight."""
        d = min(edge_depth, n_e)
        total = n_iters * n_e

        def warm(k, port, erows):
            port.read_addr.write(torch.remainder(k, n_e))
            return k + 1

        def step(k, port, erows):
            erows.write(port.read_data.read())
            port.read_addr.write(torch.remainder(k, n_e))
            return k + 1

        def flush(k, port, erows):
            erows.write(port.read_data.read())
            return k + 1

        return StepTask(step, steps=total - d,
                        init=torch.zeros((), dtype=torch.int32, device=dev),
                        warmup=warm, n_warmup=d, flush=flush, n_flush=d,
                        name=f"EdgeFetch{p}")

    def scatter_step(state, plan: MMap, deg: MMap, erows, ranks_in,
                     upd_out, n_e: int):
        r = ranks_in.read()
        e = erows.read_burst(n_e).long()
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

    fetchers = [_mk_fetcher(p, len(pe_edges[p])) for p in range(n_pe)]
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
            n_e = len(pe_edges[p])
            erow = channel(n_e, f"erow{p}", dtype=np.int32, shape=(2,))
            t = t.invoke(fetchers[p], eports[p], erow)
            t = t.invoke(ScatterS, plans[p], degm, erow, rank_ch[p],
                         upd_ch[p], n_e, name=f"Scatter{p}")
        t.invoke(CtrlS, r0m, outm, rank_ch, upd_ch)

    def check():
        ref = np.full(n_vertices, 1.0 / n_vertices, np.float64)
        for _ in range(n_iters):
            contrib = np.zeros(n_vertices, np.float64)
            np.add.at(contrib, dst, ref[src] / out_deg[src])
            ref = (1 - DAMPING) / n_vertices + DAMPING * contrib
        err = float(np.max(np.abs(ranks.cpu().numpy() - ref)))
        return err < 1e-5, err

    return Top, (r0_mm, out_mm, deg_mm, edge_ports, plan_mms), check


def run_step_async(engine: str = "coroutine", device=None,
                   **kw) -> AppResult:
    """Run the async-fed step-form graph — ``engine="compiled"``
    synthesizes it on ``device``."""
    dev = resolve_device(device)
    top, args, check = build_step_async(device=dev, **kw)
    ekw = {"device": dev} if engine == "compiled" else None
    return simulate("page_rank_step_async", top, args, engine, check,
                    engine_kwargs=ekw)

"""Edge-centric GCN forward layer (paper Section 4.1).

One graph-convolution layer  H' = ReLU(Ã H W)  on a synthetic Cora-like
graph, decomposed the way the paper's accelerator is: an EdgeStream task
reads the (src, dst) list, a Gather task accumulates degree-normalized
neighbour features per destination vertex, a Dense task applies the weight
matrix, and a Sink collects rows.  Vertex feature vectors cross channels as
whole tokens; the per-partition update streams are EoT-delimited
transactions (the UpdateHandler pattern from the paper's Listing 2).
``torch_stages``/``compile_app`` lower the same decomposition to stage
programs compiled hierarchically through the compile cache.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import channel, task
from .base import AppResult, simulate


def build(n_vertices: int = 64, n_edges: int = 256, fin: int = 16,
          fout: int = 8, n_parts: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    H = rng.standard_normal((n_vertices, fin)).astype(np.float32)
    W = (rng.standard_normal((fin, fout)) / np.sqrt(fin)).astype(np.float32)
    # symmetric-normalized adjacency with self loops (GCN, Kipf&Welling)
    deg = np.bincount(dst, minlength=n_vertices) + 1.0
    OUT = np.zeros((n_vertices, fout), np.float32)

    part = n_vertices // n_parts

    def EdgeStream(outs):
        """Scatter phase: route each edge's message to its dst partition;
        one transaction per partition round."""
        for e in range(n_edges):
            p = int(dst[e]) // part
            outs[min(p, n_parts - 1)].write((int(dst[e]), int(src[e])))
        for o in outs:
            o.close()

    def Gather(inp, out, p: int):
        """Gather phase: accumulate normalized neighbour features for this
        partition's vertices, then stream the aggregate rows."""
        lo = p * part
        hi = n_vertices if p == n_parts - 1 else lo + part
        acc = H[lo:hi].copy()                      # self loop
        for (d, s) in inp:
            acc[d - lo] += H[s]
        acc /= deg[lo:hi, None]
        for i in range(hi - lo):
            out.write((lo + i, acc[i]))
        out.close()

    def Dense(inp, out):
        for (v, row) in inp:
            out.write((v, np.maximum(row @ W, 0.0)))
        out.close()

    def Sink(ins):
        for ch in ins:
            for (v, row) in ch:
                OUT[v] = row

    def Top():
        e_ch = [channel(8, f"edges{p}") for p in range(n_parts)]
        g_ch = [channel(8, f"agg{p}") for p in range(n_parts)]
        d_ch = [channel(8, f"dense{p}") for p in range(n_parts)]
        t = task().invoke(EdgeStream, e_ch)
        for p in range(n_parts):
            t = t.invoke(Gather, e_ch[p], g_ch[p], p, name=f"Gather{p}")
            t = t.invoke(Dense, g_ch[p], d_ch[p], name=f"Dense{p}")
        t.invoke(Sink, d_ch)

    def check():
        A = np.zeros((n_vertices, n_vertices), np.float32)
        A[dst, src] = 0.0                      # build unnormalized adj
        for s, d in zip(src, dst):
            A[d, s] += 1.0
        A += np.eye(n_vertices, dtype=np.float32)
        ref = np.maximum((A / deg[:, None]) @ H @ W, 0.0)
        err = float(np.max(np.abs(OUT - ref)))
        return err < 1e-3, err

    return Top, (), check


def run(engine: str = "coroutine", **kw) -> AppResult:
    top, args, check = build(**kw)
    return simulate("gcn", top, args, engine, check)


def torch_stages(n_vertices: int = 64, n_edges: int = 256, fin: int = 16,
                 fout: int = 8, n_parts: int = 4, seed: int = 0,
                 device=None):
    """The GCN layer as torch stages (the counterpart of the reference's
    ``jax_stages``): per-partition Gather and Dense instances (one
    definition each) plus a concatenating sink — the same decomposition
    the streaming version simulates, with the adjacency slice bound per
    Gather instance as a tensor on the device (an input of the compiled
    stage)."""
    from ..core.hier_compile import StageInstance
    from ..core.synth import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    H = rng.standard_normal((n_vertices, fin)).astype(np.float32)
    W = (rng.standard_normal((fin, fout)) / np.sqrt(fin)).astype(np.float32)
    deg = np.bincount(dst, minlength=n_vertices) + 1.0
    A = np.zeros((n_vertices, n_vertices), np.float32)
    for s, d in zip(src, dst):
        A[d, s] += 1.0
    A += np.eye(n_vertices, dtype=np.float32)
    A /= deg[:, None].astype(np.float32)
    part = n_vertices // n_parts

    def gather(a_rows, feats):
        return a_rows @ feats

    def dense(agg, w):
        return torch.clamp_min(agg @ w, 0.0)

    def concat(*rows):
        return torch.cat(rows, dim=0)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def aval(rows, cols):
        return torch.empty((rows, cols), dtype=torch.float32, device="meta")

    bounds = [(p * part,
               n_vertices if p == n_parts - 1 else (p + 1) * part)
              for p in range(n_parts)]
    Ht, Wt = on_dev(H), on_dev(W)
    insts = [StageInstance(fn=gather, args=(on_dev(A[lo:hi]), Ht),
                           name=f"Gather{p}")
             for p, (lo, hi) in enumerate(bounds)]
    insts += [StageInstance(fn=dense, args=(aval(hi - lo, fin), Wt),
                            name=f"Dense{p}")
              for p, (lo, hi) in enumerate(bounds)]
    insts.append(StageInstance(
        fn=concat, args=tuple(aval(hi - lo, fout) for lo, hi in bounds),
        name="Concat"))
    wiring = {n_parts + p: [p] for p in range(n_parts)}
    wiring[2 * n_parts] = [n_parts + p for p in range(n_parts)]
    ref = np.maximum(A @ H @ W, 0.0)
    return insts, wiring, ref


def compile_app(n_vertices: int = 64, n_parts: int = 4, *, cache=None,
                prev=None, device=None, **kw):
    """Hierarchically compile the GCN layer on ``device`` (the card unless
    the caller names another) through the compile cache and return
    ``(report, program, ref)``."""
    from ..core.hier_compile import build_dataflow, compile_stages

    insts, wiring, ref = torch_stages(n_vertices=n_vertices,
                                      n_parts=n_parts, device=device, **kw)
    report = compile_stages(insts, mode="hierarchical", cache=cache,
                            prev=prev, device=device)
    program = build_dataflow(insts, wiring, source_indices=[])
    return report, program, ref

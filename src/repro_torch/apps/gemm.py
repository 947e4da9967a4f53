"""PolySA-style systolic GEMM (paper Section 4.1).

A blocks stream left->right through each row of a PxP array of PEs, B
blocks stream top->bottom through each column, and each PE keeps its C
block resident (output-stationary).  The graph is a DAG, so every
simulation engine runs it.

Three forms: ``build``/``run``, free-form tasks on host numpy buffers for
the simulation engines (the reference's, copied); ``build_step``, the
step-function form that ``CompiledEngine`` synthesizes; and
``build_step_async``, the step form with ``async_mmap`` ports on both
ends, which ``CompiledEngine`` lowers to latency queues.  The MAC
``acc + a @ b`` stays ``torch.matmul``: the reference leaves it to XLA,
outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import (MMap, OStream, StepTask, async_mmap, channel, mmap,
                     task)
from ..core.synth import dynamic_slice, resolve_device, to_torch_state
from .base import AppResult, simulate


def AFeeder(a: MMap, out: OStream, i: int, n: int, K: int):
    # burst write: row i's K blocks move in capacity-sized batches, one
    # runtime interaction per batch instead of per block; the mmap load is
    # one burst-tracked block per k
    out.write_burst([a[i * n:(i + 1) * n, k * n:(k + 1) * n]
                     for k in range(K)])
    out.close()


def BFeeder(b: MMap, out: OStream, j: int, n: int, K: int):
    out.write_burst([b[k * n:(k + 1) * n, j * n:(j + 1) * n]
                     for k in range(K)])
    out.close()


def PE(a_in, b_in, a_out, b_out, c_out, burst: int = 2):
    acc = None
    while True:
        a_blks = a_in.read_burst(burst)
        if not a_blks:
            break
        # the B stream carries exactly as many blocks as the A stream,
        # so a same-sized burst keeps the pair in lockstep
        b_blks = b_in.read_burst(len(a_blks))
        for a, b in zip(a_blks, b_blks):
            acc = a @ b if acc is None else acc + a @ b
        if a_out is not None:
            a_out.write_burst(a_blks)
        if b_out is not None:
            b_out.write_burst(b_blks)
        if len(a_blks) < burst:
            break
    a_in.open()
    b_in.open()
    if a_out is not None:
        a_out.close()
    if b_out is not None:
        b_out.close()
    c_out.write(acc)


def Collector(c_row: MMap, c_ins, i: int, n: int):
    for j, ch in enumerate(c_ins):
        c_row[:, j * n:(j + 1) * n] = ch.read()


def build(P: int = 4, n: int = 8, K: int = 4, seed: int = 0):
    """(P*n x K*n) @ (K*n x P*n) on a PxP output-stationary array."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P * n, K * n)).astype(np.float32)
    B = rng.standard_normal((K * n, P * n)).astype(np.float32)
    C = np.zeros((P * n, P * n), np.float32)

    a_mm = mmap(A, "A")
    b_mm = mmap(B, "B")
    # one writable view of C per collector: the one-writer rule holds per
    # mmap object, and numpy views write through to the same buffer
    c_rows = [mmap(C[i * n:(i + 1) * n, :], f"C{i}") for i in range(P)]

    def Top(a: MMap, b: MMap, c_views):
        a_ch = [[channel(2, f"a{i}_{j}") for j in range(P)] for i in range(P)]
        b_ch = [[channel(2, f"b{i}_{j}") for j in range(P)] for i in range(P)]
        c_ch = [[channel(1, f"c{i}_{j}") for j in range(P)] for i in range(P)]
        t = task()
        for i in range(P):
            t = t.invoke(AFeeder, a, a_ch[i][0], i, n, K, name=f"AFeeder{i}")
            t = t.invoke(BFeeder, b, b_ch[0][i], i, n, K, name=f"BFeeder{i}")
        for i in range(P):
            for j in range(P):
                t = t.invoke(
                    PE, a_ch[i][j], b_ch[i][j],
                    a_ch[i][j + 1] if j + 1 < P else None,
                    b_ch[i + 1][j] if i + 1 < P else None,
                    c_ch[i][j], name=f"PE{i}_{j}")
        for i in range(P):
            t = t.invoke(Collector, c_views[i], c_ch[i], i, n,
                         name=f"Collector{i}")

    def check():
        ref = A @ B
        err = float(np.max(np.abs(C - ref)))
        return err < 1e-3 * K * n, err

    return Top, (a_mm, b_mm, c_rows), check


def run(engine: str = "coroutine", P: int = 4, n: int = 8, K: int = 4,
        seed: int = 0) -> AppResult:
    top, args, check = build(P=P, n=n, K=K, seed=seed)
    return simulate("gemm", top, args, engine, check)


# ---------------------------------------------------------------------------
# step-function form (whole-graph synthesis)
# ---------------------------------------------------------------------------

def build_step(P: int = 4, n: int = 8, K: int = 4, seed: int = 0,
               device=None):
    """(P*n x K*n) @ (K*n x P*n) on a PxP output-stationary array.

    Feeders fire K times emitting one (n, n) block per firing (the A
    column / B row selected by a slice on the firing counter), PEs fire K
    times (read a+b, forward, accumulate) then flush their resident C
    block once, and each row's collector fires once, draining its P result
    channels into its C-row mmap view.  Array tokens make the channels
    wide: the a/b rings hold (capacity, n, n) blocks.

    The buffers live on ``device`` (the card unless the caller asks for
    another); ``check()`` compares C with a numpy product.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P * n, K * n)).astype(np.float32)
    B = rng.standard_normal((K * n, P * n)).astype(np.float32)
    C = torch.zeros((P * n, P * n), dtype=torch.float32, device=dev)

    a_mm = mmap(to_torch_state(A, dev), "A")
    b_mm = mmap(to_torch_state(B, dev), "B")
    # one writable view of C per collector: the one-writer rule holds per
    # mmap object, and tensor views write through to the same buffer
    c_rows = [mmap(C[i * n:(i + 1) * n, :], f"C{i}") for i in range(P)]

    def afeeder_step(k, a: MMap, out, i: int):
        rows = a.read_burst(i * n, n)                   # (n, K*n), static i
        out.write(dynamic_slice(rows, k * n, n, dim=1))
        return k + 1

    def bfeeder_step(k, b: MMap, out, j: int):
        rows = b.read_burst(k * n, n)                   # (n, P*n), dynamic k
        out.write(rows[:, j * n:(j + 1) * n].contiguous())
        return k + 1

    def pe_step(acc, a_in, b_in, a_out, b_out, c_out):
        a = a_in.read()
        b = b_in.read()
        if a_out is not None:
            a_out.write(a)
        if b_out is not None:
            b_out.write(b)
        return acc + a @ b

    def pe_flush(acc, a_in, b_in, a_out, b_out, c_out):
        c_out.write(acc)
        return acc

    def collector_step(state, c_row: MMap, c_ins, i: int):
        for j, ch in enumerate(c_ins):
            c_row[:, j * n:(j + 1) * n] = ch.read()
        return state

    counter = torch.zeros((), dtype=torch.int32, device=dev)
    AFeederS = StepTask(afeeder_step, steps=K, init=counter, name="AFeeder")
    BFeederS = StepTask(bfeeder_step, steps=K, init=counter, name="BFeeder")
    PES = StepTask(pe_step, steps=K, flush=pe_flush,
                   init=torch.zeros((n, n), dtype=torch.float32, device=dev),
                   name="PE")
    CollectorS = StepTask(collector_step, steps=1, name="Collector")

    def Top(a: MMap, b: MMap, c_views):
        blk = dict(dtype=np.float32, shape=(n, n))
        a_ch = [[channel(2, f"a{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        b_ch = [[channel(2, f"b{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        c_ch = [[channel(1, f"c{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        t = task()
        for i in range(P):
            t = t.invoke(AFeederS, a, a_ch[i][0], i, name=f"AFeeder{i}")
            t = t.invoke(BFeederS, b, b_ch[0][i], i, name=f"BFeeder{i}")
        for i in range(P):
            for j in range(P):
                t = t.invoke(
                    PES, a_ch[i][j], b_ch[i][j],
                    a_ch[i][j + 1] if j + 1 < P else None,
                    b_ch[i + 1][j] if i + 1 < P else None,
                    c_ch[i][j], name=f"PE{i}_{j}")
        for i in range(P):
            t = t.invoke(CollectorS, c_views[i], c_ch[i], i,
                         name=f"Collector{i}")

    def check():
        ref = A @ B
        err = float(np.max(np.abs(C.cpu().numpy() - ref)))
        return err < 1e-3 * K * n, err

    return Top, (a_mm, b_mm, c_rows), check


def run_step(engine: str = "coroutine", P: int = 4, n: int = 8, K: int = 4,
             seed: int = 0, device=None) -> AppResult:
    """Run the step-form graph — ``engine="compiled"`` synthesizes it on
    ``device``."""
    dev = resolve_device(device)
    top, args, check = build_step(P=P, n=n, K=K, seed=seed, device=dev)
    kw = {"device": dev} if engine == "compiled" else None
    return simulate("gemm_step", top, args, engine, check, engine_kwargs=kw)


def build_step_async(P: int = 4, n: int = 8, K: int = 4, seed: int = 0,
                     mem_latency: int = 4, depth: int = 4, device=None):
    """The systolic array with **async memory ports** on both ends: each
    row's A blocks arrive through an ``async_mmap`` read port (an AFetch
    task keeps up to ``depth`` block fetches in flight) and each row's C
    blocks leave through an ``async_mmap`` write port (a CStore task
    issues stores ahead of the returning write acks).  ``CompiledEngine``
    lowers the ports to latency queues serviced once a sweep.

    Because per-firing channel *selection* must be static, the row's P
    result channels are funneled through a RowMux task into one
    capacity-P channel that CStore drains block by block; B keeps its
    plain mmap feeders, so the graph mixes sync and async interfaces.
    The ports' buffers live on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P * n, K * n)).astype(np.float32)
    B = rng.standard_normal((K * n, P * n)).astype(np.float32)

    # row i's K blocks, block-indexed: a_blocks[i][k] == A block (i, k)
    a_blocks = [np.ascontiguousarray(
        A[i * n:(i + 1) * n, :].reshape(n, K, n).swapaxes(0, 1))
        for i in range(P)]
    a_ports = [async_mmap(to_torch_state(a_blocks[i], dev),
                          latency=mem_latency, depth=depth, name=f"Ablk{i}")
               for i in range(P)]
    c_ports = [async_mmap(torch.zeros((P, n, n), dtype=torch.float32,
                                      device=dev),
                          latency=mem_latency, depth=depth, name=f"Crow{i}")
               for i in range(P)]
    b_mm = mmap(to_torch_state(B, dev), "B")

    dA = min(depth, K)
    dC = min(depth, P)

    def afetch_warm(k, port, out):
        port.read_addr.write(k)
        return k + 1

    def afetch_step(k, port, out):
        out.write(port.read_data.read())
        port.read_addr.write(k)
        return k + 1

    def afetch_flush(k, port, out):
        out.write(port.read_data.read())
        return k + 1

    def bfeeder_step(k, b: MMap, out, j: int):
        rows = b.read_burst(k * n, n)                   # (n, P*n), dynamic k
        out.write(rows[:, j * n:(j + 1) * n].contiguous())
        return k + 1

    def pe_step(acc, a_in, b_in, a_out, b_out, c_out):
        a = a_in.read()
        b = b_in.read()
        if a_out is not None:
            a_out.write(a)
        if b_out is not None:
            b_out.write(b)
        return acc + a @ b

    def pe_flush(acc, a_in, b_in, a_out, b_out, c_out):
        c_out.write(acc)
        return acc

    def rowmux_step(state, c_ins, crow):
        crow.write_burst(torch.stack([ch.read() for ch in c_ins]))
        return state

    def cstore_warm(k, port, crow):
        port.write_addr.write(k)
        port.write_data.write(crow.read())
        return k + 1

    def cstore_step(k, port, crow):
        port.write_resp.read()
        port.write_addr.write(k)
        port.write_data.write(crow.read())
        return k + 1

    def cstore_flush(k, port, crow):
        port.write_resp.read()
        return k + 1

    counter = torch.zeros((), dtype=torch.int32, device=dev)
    AFetchS = StepTask(afetch_step, steps=K - dA, init=counter,
                       warmup=afetch_warm, n_warmup=dA,
                       flush=afetch_flush, n_flush=dA, name="AFetch")
    BFeederS = StepTask(bfeeder_step, steps=K, init=counter, name="BFeeder")
    PES = StepTask(pe_step, steps=K, flush=pe_flush,
                   init=torch.zeros((n, n), dtype=torch.float32, device=dev),
                   name="PE")
    RowMuxS = StepTask(rowmux_step, steps=1, name="RowMux")
    CStoreS = StepTask(cstore_step, steps=P - dC, init=counter,
                       warmup=cstore_warm, n_warmup=dC,
                       flush=cstore_flush, n_flush=dC, name="CStore")

    def Top(b: MMap, aports, cports):
        blk = dict(dtype=np.float32, shape=(n, n))
        a_ch = [[channel(2, f"a{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        b_ch = [[channel(2, f"b{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        c_ch = [[channel(1, f"c{i}_{j}", **blk) for j in range(P)]
                for i in range(P)]
        crow_ch = [channel(P, f"crow{i}", **blk) for i in range(P)]
        t = task()
        for i in range(P):
            t = t.invoke(AFetchS, aports[i], a_ch[i][0], name=f"AFetch{i}")
            t = t.invoke(BFeederS, b, b_ch[0][i], i, name=f"BFeeder{i}")
        for i in range(P):
            for j in range(P):
                t = t.invoke(
                    PES, a_ch[i][j], b_ch[i][j],
                    a_ch[i][j + 1] if j + 1 < P else None,
                    b_ch[i + 1][j] if i + 1 < P else None,
                    c_ch[i][j], name=f"PE{i}_{j}")
        for i in range(P):
            t = t.invoke(RowMuxS, c_ch[i], crow_ch[i], name=f"RowMux{i}")
            t = t.invoke(CStoreS, cports[i], crow_ch[i], name=f"CStore{i}")

    def check():
        ref = A @ B
        got = np.concatenate(
            [np.concatenate(list(c_ports[i].data.cpu().numpy()), axis=1)
             for i in range(P)], axis=0)
        err = float(np.max(np.abs(got - ref)))
        return err < 1e-3 * K * n, err

    return Top, (b_mm, a_ports, c_ports), check


def run_step_async(engine: str = "coroutine", P: int = 4, n: int = 8,
                   K: int = 4, seed: int = 0, mem_latency: int = 4,
                   depth: int = 4, device=None) -> AppResult:
    """Run the async-port step-form graph — ``engine="compiled"``
    synthesizes it on ``device``."""
    dev = resolve_device(device)
    top, args, check = build_step_async(P=P, n=n, K=K, seed=seed,
                                        mem_latency=mem_latency, depth=depth,
                                        device=dev)
    kw = {"device": dev} if engine == "compiled" else None
    return simulate("gemm_step_async", top, args, engine, check,
                    engine_kwargs=kw)

"""PolySA-style systolic GEMM (paper Section 4.1), step-function form.

A blocks stream left->right through each row of a PxP array of PEs, B
blocks stream top->bottom through each column, and each PE keeps its C
block resident (output-stationary).  The graph is a DAG, so every
simulation engine runs it, and ``CompiledEngine`` synthesizes it.

The matrices enter through ``mmap`` arguments; each row's collector
stores into its own view of C (one-writer rule).  The MAC ``acc + a @ b``
stays ``torch.matmul``: the reference leaves it to XLA, outside any
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import MMap, StepTask, channel, mmap, task
from ..core.synth import dynamic_slice, resolve_device, to_torch_state
from .base import AppResult, simulate


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

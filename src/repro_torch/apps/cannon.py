"""Cannon's algorithm on a PxP toroidal PE mesh (paper Section 4.1).

The defining property: every PE forwards its A block left and its B block
up on a *torus* — the wrap-around links make the dataflow graph cyclic,
which is exactly why the paper reports sequential simulators cannot handle
this benchmark (Fig. 7).  The coroutine and thread engines simulate it; the
sequential engine must fail with SequentialSimulationError.

Graph shape (paper Table 3: 5 task defs / 91 instances / 344 channels at
8x8): ADistrib/BDistrib feeders write each PE's initially-skewed resident
block on a dedicated init channel (one-producer rule); the rotation rings
run PE->PE with wrap-around, so the cycles are genuine.  At P=8 this build
has 88 instances and 320 channels — same shape, same task definitions.

Interface migration: A and B enter through read ``mmap`` arguments, each
collector row stores through its own writable view of C (one-writer per
mmap), and the definitions are module-level — no closure-captured arrays.

Burst note: cannon is the anti-burst benchmark.  Every rotation token is
data-dependent on the previous round (the block a PE forwards is the block
it just received), so the rings are inherently one-token-deep and the
burst channel API cannot batch them — unlike gemm/gaussian whose DAG
pipelines burst freely.  Cannon still benefits from the coroutine engine's
run-to-block fast path (rotation pushes/pops on non-full/non-empty rings
skip engine dispatch), which is exactly the per-token overhead the paper's
collaborative scheduling minimizes.
"""

from __future__ import annotations

import numpy as np

from ..core import MMap, channel, mmap, task
from .base import AppResult, simulate


def ADistrib(a: MMap, inits, i: int, n: int, P: int):
    # initial Cannon skew: PE(i,j) holds A(i, (i+j) mod P)
    for j, ch in enumerate(inits):
        k = (i + j) % P
        ch.write(a[i * n:(i + 1) * n, k * n:(k + 1) * n])


def BDistrib(b: MMap, inits, j: int, n: int, P: int):
    # initial Cannon skew: PE(i,j) holds B((i+j) mod P, j)
    for i, ch in enumerate(inits):
        k = (i + j) % P
        ch.write(b[k * n:(k + 1) * n, j * n:(j + 1) * n])


def PE(a_init, b_init, a_in, b_in, a_out, b_out, c_out, rounds: int):
    acc = None
    for r in range(rounds):
        a = a_init.read() if r == 0 else a_in.read()
        b = b_init.read() if r == 0 else b_in.read()
        acc = a @ b if acc is None else acc + a @ b
        if r < rounds - 1:            # rotate: A left, B up (torus)
            a_out.write(a)
            b_out.write(b)
    c_out.write(acc)


def Collector(c_row: MMap, c_ins, i: int, n: int):
    for j, ch in enumerate(c_ins):
        c_row[:, j * n:(j + 1) * n] = ch.read()


def build(P: int = 4, n: int = 8, seed: int = 0):
    """PxP PE mesh multiplying (P*n x P*n) matrices in n x n blocks."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P * n, P * n)).astype(np.float32)
    B = rng.standard_normal((P * n, P * n)).astype(np.float32)
    C = np.zeros_like(A)

    a_mm = mmap(A, "A")
    b_mm = mmap(B, "B")
    c_rows = [mmap(C[i * n:(i + 1) * n, :], f"C{i}") for i in range(P)]

    def Top(a: MMap, b: MMap, c_views):
        ai = [[channel(2, f"ai{i}_{j}") for j in range(P)] for i in range(P)]
        bi = [[channel(2, f"bi{i}_{j}") for j in range(P)] for i in range(P)]
        a_ch = [[channel(2, f"a{i}_{j}") for j in range(P)] for i in range(P)]
        b_ch = [[channel(2, f"b{i}_{j}") for j in range(P)] for i in range(P)]
        c_ch = [[channel(1, f"c{i}_{j}") for j in range(P)] for i in range(P)]
        t = task()
        for i in range(P):
            t = t.invoke(ADistrib, a, ai[i], i, n, P, name=f"ADistrib{i}")
            t = t.invoke(BDistrib, b, [bi[r][i] for r in range(P)], i, n, P,
                         name=f"BDistrib{i}")
        for i in range(P):
            for j in range(P):
                t = t.invoke(
                    PE, ai[i][j], bi[i][j],
                    a_ch[i][j], b_ch[i][j],
                    a_ch[i][(j - 1) % P],      # forward A left
                    b_ch[(i - 1) % P][j],      # forward B up
                    c_ch[i][j], P, name=f"PE{i}_{j}")
        for i in range(P):
            t = t.invoke(Collector, c_views[i], c_ch[i], i, n,
                         name=f"Collector{i}")

    def check():
        ref = A @ B
        err = float(np.max(np.abs(C - ref)))
        return err < 1e-3 * P * n, err

    return Top, (a_mm, b_mm, c_rows), check


def run(engine: str = "coroutine", P: int = 4, n: int = 8,
        seed: int = 0) -> AppResult:
    top, args, check = build(P=P, n=n, seed=seed)
    return simulate("cannon", top, args, engine, check)

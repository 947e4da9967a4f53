"""SODA-style iterative Gaussian-filter dataflow (paper Section 4.1),
step-function form.

A chain of ``iters`` stencil stages; each stage holds a line buffer (two
rows of reuse) and applies the 3x3 Gaussian kernel as soon as its window
is full — the communication-optimal reuse-buffer microarchitecture SODA
generates.  The image enters through a read ``mmap`` and the result
leaves through a write ``mmap``, one row per firing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import MMap, StepTask, channel, mmap, task
from ..core.synth import resolve_device, to_torch_state
from .base import AppResult, simulate

K = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
_KF = K.tolist()        # exact: the weights are dyadic


def _stencil_ref(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    out = img.copy()
    acc = np.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            acc[1:h-1, 1:w-1] += K[dy, dx] * img[dy:h-2+dy, dx:w-2+dx]
    out[1:h-1, 1:w-1] = acc[1:h-1, 1:w-1]
    return out


def build_step(h: int = 12, w: int = 12, iters: int = 4, seed: int = 0,
               device=None):
    """The stencil chain in step-function form — the **burst-heavy** case:
    every firing moves a whole image row as one ``read_burst(w)``/
    ``write_burst`` over a scalar-token channel, which synthesis lowers to
    a w-token ring transfer.

    Each stencil stage keeps two rows of state (the SODA reuse buffer)
    across three phases: a 1-firing warmup fills the window, the h-1
    steady-state firings read row i and emit output row i-1, and a
    1-firing flush drains the final boundary row.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    result = torch.zeros((h, w), dtype=torch.float32, device=dev)

    img_mm = mmap(to_torch_state(img, dev), "img")
    res_mm = mmap(result, "result")

    def source_step(k, img_m: MMap, out):
        row = img_m.read_burst(k, 1)[0]
        out.write_burst(row)
        return k + 1

    def _out_row(i, pp, p, cur):
        (k00, k01, k02), (k10, k11, k12), (k20, k21, k22) = _KF
        win = (k00 * pp[:-2] + k01 * pp[1:-1] + k02 * pp[2:] +
               k10 * p[:-2] + k11 * p[1:-1] + k12 * p[2:] +
               k20 * cur[:-2] + k21 * cur[1:-1] + k22 * cur[2:])
        # row 0 is a boundary: emitted as-is (and so are the edge columns)
        mid = torch.where(i - 1 == 0, p[1:-1], win)
        return torch.cat([p[:1], mid, p[-1:]])

    def stencil_warmup(state, inp, out):
        i, pp, p = state
        row = inp.read_burst(w)
        return (i + 1, row, row)

    def stencil_step(state, inp, out):
        i, pp, p = state            # reading row i; emitting row i-1
        cur = inp.read_burst(w)
        out.write_burst(_out_row(i, pp, p, cur))
        return (i + 1, p, cur)

    def stencil_flush(state, inp, out):
        i, pp, p = state
        out.write_burst(p)          # last row: boundary copy
        return state

    def sink_step(k, inp, res: MMap):
        row = inp.read_burst(w)
        res.write_burst(k, row[None, :])
        return k + 1

    counter = torch.zeros((), dtype=torch.int32, device=dev)
    row0 = torch.zeros(w, dtype=torch.float32, device=dev)
    SourceS = StepTask(source_step, steps=h, init=counter, name="Source")
    StencilS = StepTask(stencil_step, steps=h - 1, warmup=stencil_warmup,
                        flush=stencil_flush, init=(counter, row0, row0),
                        name="Stencil")
    SinkS = StepTask(sink_step, steps=h, init=counter, name="Sink")

    def Top(src: MMap, dst: MMap):
        chans = [channel(2 * w, f"s{i}", dtype=np.float32, shape=())
                 for i in range(iters + 1)]
        t = task().invoke(SourceS, src, chans[0])
        for i in range(iters):
            t = t.invoke(StencilS, chans[i], chans[i + 1],
                         name=f"Stencil{i}")
        t.invoke(SinkS, chans[iters], dst)

    def check():
        ref = img
        for _ in range(iters):
            ref = _stencil_ref(ref)
        err = float(np.max(np.abs(result.cpu().numpy() - ref)))
        return err < 1e-4, err

    return Top, (img_mm, res_mm), check


def run_step(engine: str = "coroutine", device=None, **kw) -> AppResult:
    """Run the step-form graph — ``engine="compiled"`` synthesizes it on
    ``device``."""
    dev = resolve_device(device)
    top, args, check = build_step(device=dev, **kw)
    ekw = {"device": dev} if engine == "compiled" else None
    return simulate("gaussian_step", top, args, engine, check,
                    engine_kwargs=ekw)

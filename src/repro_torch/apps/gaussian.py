"""SODA-style iterative Gaussian-filter dataflow (paper Section 4.1).

A chain of ``iters`` stencil stages; each stage holds a line buffer and
applies the 3x3 Gaussian kernel as soon as its window is full — the
communication-optimal reuse-buffer microarchitecture SODA generates.  The
image enters through a read ``mmap`` and the result leaves through a
write ``mmap``.  ``build``/``run`` (the reference's, copied) streams
pixels through free-form tasks on host numpy buffers for the simulation
engines; ``build_step`` is the step-function form that ``CompiledEngine``
synthesizes, one row per firing.
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


def Source(img: MMap, out, h: int, w: int):
    # one mmap burst loads the frame; rows then stream in bursts (the
    # line buffers downstream consume in row-sized chunks anyway)
    frame = img.read_burst(0, h)
    out.write_burst([float(px) for px in np.asarray(frame).reshape(-1)])
    out.close()


def Stencil(inp, out, h: int, w: int):
    """Line-buffered 3x3 stencil over a row-major pixel stream.

    A centre pixel's window completes when its south-east neighbour
    (linear index centre + w + 1) arrives, so the stage emits with a
    fixed latency of w+2 pixels — the SODA reuse-buffer schedule.
    Pixels move in row-sized bursts; emitted pixels are staged in a
    local list and flushed with one ``write_burst`` per input burst.
    """
    buf: list[float] = []
    pending: list[float] = []

    def emit(cy: int) -> None:
        y, x = divmod(cy, w)
        if 1 <= y < h - 1 and 1 <= x < w - 1:
            win = (K[0, 0] * buf[cy-w-1] + K[0, 1] * buf[cy-w] +
                   K[0, 2] * buf[cy-w+1] +
                   K[1, 0] * buf[cy-1] + K[1, 1] * buf[cy] +
                   K[1, 2] * buf[cy+1] +
                   K[2, 0] * buf[cy+w-1] + K[2, 1] * buf[cy+w] +
                   K[2, 2] * buf[cy+w+1])
            pending.append(float(win))
        else:
            pending.append(buf[cy])

    while True:
        chunk = inp.read_burst(w)
        for px in chunk:
            buf.append(px)
            cy = len(buf) - w - 2   # centre whose window just completed
            if cy >= 0:
                emit(cy)
        if pending:
            out.write_burst(pending)
            pending.clear()
        if len(chunk) < w:          # EoT reached
            break
    inp.open()
    for cy in range(max(len(buf) - w - 1, 0), len(buf)):
        emit(cy)                    # tail pixels (all boundary)
    if pending:
        out.write_burst(pending)
    out.close()


def Sink(inp, result: MMap, h: int, w: int):
    flat = inp.read_transaction()
    result.write_burst(0, np.asarray(flat, np.float32).reshape(h, w))


def build(h: int = 12, w: int = 12, iters: int = 4, lanes: int = 1,
          seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    result = np.zeros_like(img)

    img_mm = mmap(img, "img")
    res_mm = mmap(result, "result")

    def Top(src: MMap, dst: MMap):
        chans = [channel(capacity=2 * w + 4, name=f"s{i}")
                 for i in range(iters + 1)]
        t = task().invoke(Source, src, chans[0], h, w)
        for i in range(iters):
            t = t.invoke(Stencil, chans[i], chans[i + 1], h, w,
                         name=f"Stencil{i}")
        t.invoke(Sink, chans[iters], dst, h, w)

    def check():
        ref = img
        for _ in range(iters):
            ref = _stencil_ref(ref)
        err = float(np.max(np.abs(result - ref)))
        return err < 1e-4, err

    return Top, (img_mm, res_mm), check


def run(engine: str = "coroutine", **kw) -> AppResult:
    top, args, check = build(**kw)
    return simulate("gaussian", top, args, engine, check)


# ---------------------------------------------------------------------------
# step-function form (whole-graph synthesis)
# ---------------------------------------------------------------------------

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

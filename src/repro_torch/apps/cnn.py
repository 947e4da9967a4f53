"""Systolic convolution layer (PolySA CNN, paper Section 4.1).

One VGG-style conv layer lowered to an output-stationary systolic matmul
over the im2col matrix: weight tiles stream down columns, input-patch
tiles stream across rows, each PE accumulates one (out-channel tile x
pixel tile) block of the output feature map.  Feed-forward DAG like gemm;
the knobs (i, o, h, w, p, q) default to a scaled-down VGG conv3 so the
simulation stays in milliseconds — paper-scale dims are a parameter, not a
code change.

The reference's ``jax_stages``/``compile_app`` (hierarchical compilation
through the compile cache) are not ported: they wait for the port's
compile cache.
"""

from __future__ import annotations

import numpy as np

from ..core import channel, task
from .base import AppResult, simulate


def build(ci: int = 8, co: int = 8, hw: int = 6, k: int = 3,
          P: int = 2, seed: int = 0):
    """conv(ci -> co, k x k, 'same') on a hw x hw image, PxP PE array."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((ci, hw, hw)).astype(np.float32)
    wgt = (rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)) \
        .astype(np.float32)

    # im2col: X [ci*k*k, hw*hw]; W [co, ci*k*k]; out = W @ X
    pad = k // 2
    xpad = np.pad(img, ((0, 0), (pad, pad), (pad, pad)))
    cols = np.stack([
        xpad[:, dy:dy + hw, dx:dx + hw].reshape(ci, -1)
        for dy in range(k) for dx in range(k)], axis=1)
    X = cols.reshape(ci * k * k, hw * hw)
    W = wgt.reshape(co, ci * k * k)
    OUT = np.zeros((co, hw * hw), np.float32)

    ko = co // P                       # out-channel tile per PE row
    kp = (hw * hw) // P                # pixel tile per PE column
    red = ci * k * k                   # reduction length

    def WFeeder(out, i: int):
        out.write(W[i * ko:(i + 1) * ko].copy())
        out.close()

    def XFeeder(out, j: int):
        out.write(X[:, j * kp:(j + 1) * kp].copy())
        out.close()

    def PE(w_in, x_in, w_out, x_out, c_out):
        acc = None
        while not w_in.eot():
            wt = w_in.read()
            xt = x_in.read()
            acc = wt @ xt if acc is None else acc + wt @ xt
            if w_out is not None:
                w_out.write(wt)
            if x_out is not None:
                x_out.write(xt)
        w_in.open()
        x_in.open()
        if w_out is not None:
            w_out.close()
        if x_out is not None:
            x_out.close()
        c_out.write(acc)

    def Collector(c_ins, i: int):
        for j, ch in enumerate(c_ins):
            OUT[i * ko:(i + 1) * ko, j * kp:(j + 1) * kp] = ch.read()

    def Top():
        w_ch = [[channel(2, f"w{i}_{j}") for j in range(P)] for i in range(P)]
        x_ch = [[channel(2, f"x{i}_{j}") for j in range(P)] for i in range(P)]
        c_ch = [[channel(1, f"c{i}_{j}") for j in range(P)] for i in range(P)]
        t = task()
        for i in range(P):
            t = t.invoke(WFeeder, w_ch[i][0], i, name=f"WFeeder{i}")
            t = t.invoke(XFeeder, x_ch[0][i], i, name=f"XFeeder{i}")
        for i in range(P):
            for j in range(P):
                t = t.invoke(
                    PE, w_ch[i][j], x_ch[i][j],
                    w_ch[i][j + 1] if j + 1 < P else None,
                    x_ch[i + 1][j] if i + 1 < P else None,
                    c_ch[i][j], name=f"PE{i}_{j}")
        for i in range(P):
            t = t.invoke(Collector, c_ch[i], i, name=f"Collector{i}")

    def check():
        ref = W @ X
        err = float(np.max(np.abs(OUT - ref)))
        return err < 1e-3 * red, err

    return Top, (), check


def run(engine: str = "coroutine", **kw) -> AppResult:
    top, args, check = build(**kw)
    return simulate("cnn", top, args, engine, check)

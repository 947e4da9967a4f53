"""The port's SSD scan and flash-attention gradients against the reference,
on the CPU.

Same numpy inputs through both packages.  The reference runs its Pallas
kernels under the interpreter (``repro.kernels.ops`` does so off a TPU)
and its ``jax.custom_vjp`` gradients; the port's wrappers take their
plain versions on CPU tensors, and its gradients come from
``torch.autograd``.  The reference kernel's layout is head-major, the
port's is the model's: the test transposes the reference side.

Tolerances, relative to the largest magnitude of the reference's tensor:
``REL`` (1e-5) for float32 outputs — both compute in float32 and differ
in summation order only; ``REL_BF16`` (1e-2) for a bf16 output, which
both round once from float32 (one bf16 ulp is 2**-8 ~ 4e-3 of a value);
``GRAD_REL`` (1e-4) for gradients — the reference's SSD backward runs
the sequential recurrence, the port's the chunked form, which sum the
same terms in different orders and with different decay factorisations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ssd_scan import ssd_scan_fwd as jax_ssd_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import launch_counts, reset_launches
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain

REL, REL_BF16, GRAD_REL = 1e-5, 1e-2, 1e-4

# B, S, H, P, G, N, chunk, dtype (the reference's tests/test_kernels.py)
SSD_CASES = [
    (2, 128, 4, 16, 2, 32, 32, "float32"),
    (1, 64, 2, 64, 1, 128, 16, "float32"),
    (2, 100, 4, 16, 2, 32, 32, "float32"),   # pad path (100 % 32 != 0)
    (1, 128, 4, 64, 1, 64, 64, "bfloat16"),
    (1, 256, 8, 32, 4, 32, 128, "float32"),
]


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _ssd_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((B, S, H, P)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f),
        A=-np.exp(0.5 * rng.standard_normal(H)).astype(f),
        Bm=(0.3 * rng.standard_normal((B, S, G, N))).astype(f),
        Cm=(0.3 * rng.standard_normal((B, S, G, N))).astype(f),
        D=np.ones(H, f),
        s0=(0.3 * rng.standard_normal((B, H, P, N))).astype(f))


def _jax(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_plain_matches_pallas_interpret(B, S, H, P, G, N, chunk,
                                                 dtype):
    """The kernel entry: the plain version against the Pallas kernel, on
    the inputs the reference's wrapper forms (padded with dt = 0)."""
    a = _ssd_inputs(0, B, S, H, P, G, N)
    pad = (-S) % chunk
    padded = lambda v: np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] *  # noqa
                              (v.ndim - 2))
    xdt = padded(a["x"] * a["dt"][..., None])
    dA = padded(a["dt"] * a["A"])
    Bm, Cm = padded(a["Bm"]), padded(a["Cm"])
    y_j, s_j = jax_ssd_fwd(
        jnp.asarray(xdt.transpose(0, 2, 1, 3)),
        jnp.asarray(dA.transpose(0, 2, 1)[:, :, None, :]),
        jnp.asarray(Bm.transpose(0, 2, 1, 3)),
        jnp.asarray(Cm.transpose(0, 2, 1, 3)), jnp.asarray(a["s0"]),
        chunk=chunk, interpret=True)
    y, s = ssd_scan_plain(_torch(xdt), _torch(dA), _torch(Bm), _torch(Cm),
                          _torch(a["s0"]), chunk=chunk)
    _close(y, np.asarray(y_j).transpose(0, 2, 1, 3))
    _close(s, s_j)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", SSD_CASES)
def test_ssd_scan_ops_matches_reference_ops(B, S, H, P, G, N, chunk, dtype):
    """The model-layout wrapper (padding, D skip, dtype) against the
    reference's ``ops.ssd_scan``, with an initial state."""
    a = _ssd_inputs(1, B, S, H, P, G, N)
    y_j, s_j = jax_ops.ssd_scan(
        _jax(a["x"], dtype), _jax(a["dt"]), _jax(a["A"]),
        _jax(a["Bm"], dtype), _jax(a["Cm"], dtype), _jax(a["D"]),
        chunk=chunk, init_state=_jax(a["s0"]))
    reset_launches()
    y, s = ops.ssd_scan(
        _torch(a["x"], dtype), _torch(a["dt"]), _torch(a["A"]),
        _torch(a["Bm"], dtype), _torch(a["Cm"], dtype), _torch(a["D"]),
        chunk=chunk, init_state=_torch(a["s0"]))
    assert launch_counts() == {}          # the CPU takes the plain version
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    _close(y.float(), np.asarray(y_j, np.float32),
           REL_BF16 if dtype == "bfloat16" else REL)
    _close(s, s_j)


def test_ssd_scan_init_state_chaining():
    """Processing [x1; x2] at once == processing x1 then x2 with the
    carried state (the chunked-prefill invariant)."""
    a = {k: _torch(v) for k, v in _ssd_inputs(2, 1, 64, 2, 16, 1, 32)
         .items()}
    args = lambda sl: (a["x"][:, sl], a["dt"][:, sl], a["A"],  # noqa
                       a["Bm"][:, sl], a["Cm"][:, sl], a["D"])
    y_all, s_all = ops.ssd_scan(*args(slice(None)), chunk=16)
    y1, s1 = ops.ssd_scan(*args(slice(0, 24)), chunk=16)    # pads 24 -> 32
    y2, s2 = ops.ssd_scan(*args(slice(24, None)), chunk=16, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_all)
    _close(s2, s_all)


@pytest.mark.parametrize("S,G,chunk", [(64, 1, 16), (40, 2, 16)])
def test_ssd_scan_grads_match_reference(S, G, chunk):
    """Gradients of every input, ``init_state`` included, through a loss
    that reads both outputs, against ``jax.grad`` through the reference's
    ``custom_vjp``."""
    B, H, P, N = 1, 4, 16, 32
    a = _ssd_inputs(3, B, S, H, P, G, N)
    w = np.random.default_rng(4).standard_normal((B, H, P, N)) \
        .astype(np.float32)
    names = ("x", "dt", "A", "Bm", "Cm", "D", "s0")

    def f_j(x, dt, A, Bm, Cm, D, s0):
        y, s = jax_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                                init_state=s0)
        return jnp.sum(y ** 2) + jnp.sum(s * w)

    want = jax.grad(f_j, argnums=tuple(range(7)))(
        *(jnp.asarray(a[k]) for k in names))
    ins = [_torch(a[k]).requires_grad_() for k in names]
    y, s = ops.ssd_scan(*ins[:6], chunk=chunk, init_state=ins[6])
    (y.square().sum() + (s * _torch(w)).sum()).backward()
    for name, t, g in zip(names, ins, want):
        assert t.grad is not None, name
        _close(t.grad, g, GRAD_REL)


@pytest.mark.parametrize("nh,nkv,S,causal,window", [
    (4, 4, 64, True, None),       # causal
    (4, 2, 64, True, 24),         # windowed, GQA group 2
    (8, 2, 64, True, None),       # GQA group 4
    (4, 2, 64, False, None),      # no mask
])
def test_flash_backward_matches_reference(nh, nkv, S, causal, window):
    """The port's autograd backward against ``jax.grad`` through the
    reference's ``ops.flash_attention`` (Pallas forward under the
    interpreter, ``_flash_bwd``)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, S, nh, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, nkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, nkv, 16)).astype(np.float32)
    w = rng.standard_normal((2, S, nh, 16)).astype(np.float32)

    def f_j(q, k, v):
        out = jax_ops.flash_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * w)

    want = jax.grad(f_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    ins = [_torch(t).requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    (out * _torch(w)).sum().backward()
    for t, g in zip(ins, want):
        _close(t.grad, g, REL)


def test_kernel_rejects_what_it_was_not_built_for(monkeypatch):
    """A CUDA tensor launches the kernel or raises; the checks before the
    launch are reached without a card (device routing mocked)."""
    import repro_torch.kernels.ssd_scan as mod
    monkeypatch.setattr(mod, "uses_kernel", lambda *a: True)
    a = {k: _torch(v) for k, v in _ssd_inputs(6, 1, 32, 2, 32, 1, 32)
         .items()}
    xdt, dA = a["x"], a["dt"] * a["A"]
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ssd_scan_fwd(xdt, dA, a["Bm"], a["Cm"], a["s0"], chunk=16)
    with pytest.raises(ValueError, match="multiple of"):
        ssd_scan_fwd(xdt, dA, a["Bm"], a["Cm"], a["s0"], chunk=24)

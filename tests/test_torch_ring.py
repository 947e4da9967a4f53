"""The port's ring ops (repro_torch.kernels.ring) on the CPU.

Here, with no card, every op takes its plain PyTorch version: the same
function the CUDA kernel computes, and the one ``chip_smoke.py`` holds
the kernel against on the card.  A Python deque is the oracle, as in
``tests/test_ring_kernels.py``; the same op sequences also run through
the reference package's ``repro.kernels.ring`` (``xla`` and ``interpret``)
and must agree bit for bit: tokens, buffer, head and size.
"""

from collections import deque

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ring as ref_ring

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels import ring

_NP_TO_TORCH = {np.int32: torch.int32, np.float32: torch.float32,
                np.bool_: torch.bool}


def _mk(counter, n, elem, dtype):
    """n fresh tokens with distinct values (rows counter..counter+n-1)."""
    base = counter + np.arange(n)
    flat = (base[:, None] * 100 +
            np.arange(max(1, int(np.prod(elem, dtype=int))))[None, :])
    arr = flat.reshape((n,) + elem) if elem else flat[:, 0]
    if dtype == np.bool_:
        return (arr % 2).astype(np.bool_)
    return arr.astype(dtype)


def _ops(cap, n_ops, seed):
    """A seeded op sequence: ("pop", n) / ("push", n), always legal."""
    rng = np.random.default_rng(seed)
    size, out = 0, []
    for _ in range(n_ops):
        free = cap - size
        if size and (free == 0 or rng.random() < 0.5):
            n = int(rng.integers(1, size + 1))
            out.append(("pop", n))
            size -= n
        else:
            n = int(rng.integers(1, free + 1))
            out.append(("push", n))
            size += n
    return out


def _state(cap, elem, dtype):
    buf = torch.zeros((cap,) + elem, dtype=_NP_TO_TORCH[dtype])
    return buf, torch.tensor(0, dtype=torch.int32), \
        torch.tensor(0, dtype=torch.int32)


_CASES = [
    (1, (), np.int32),               # capacity-1 ring: every push wraps
    (5, (), np.int32),
    (5, (3,), np.int32),
    (4, (2, 2), np.float32),
    (3, (), np.bool_),
    (7, (3,), np.float32),
    (6, (2, 3), np.float32),
    (6, (2, 3), np.int32),
    (6, (2, 3), np.bool_),
    (2, (), np.float32),
]


@pytest.mark.parametrize("cap,elem,dtype", _CASES)
def test_plain_matches_deque_oracle(cap, elem, dtype):
    buf, head, size = _state(cap, elem, dtype)
    oracle, counter = deque(), 0
    saw_full = saw_empty_after_pop = saw_wrap = False
    for op, n in _ops(cap, 40, seed=cap):
        if op == "pop":
            saw_wrap |= int(head) + n > cap
            toks, h2, s2 = ring.ring_pop(buf, head, size, n)
            assert h2 is head and s2 is size          # advanced in place
            want = np.stack([oracle.popleft() for _ in range(n)])
            assert np.array_equal(toks.numpy(), want)
        else:
            arr = _mk(counter, n, elem, dtype)
            counter += n
            b2, _, _ = ring.ring_push(buf, head, size, torch.from_numpy(arr))
            assert b2 is buf                          # written in place
            oracle.extend(arr)
        saw_full |= len(oracle) == cap
        saw_empty_after_pop |= op == "pop" and not oracle
        assert int(size) == len(oracle)
        assert int(head) == (counter - len(oracle)) % cap
    assert saw_full and saw_empty_after_pop and (saw_wrap or cap == 1)


def _ref_state(cap, elem, dtype):
    return jnp.zeros((cap,) + elem, dtype=dtype), jnp.int32(0), jnp.int32(0)


def _parity_params():
    out = [pytest.param(cap, elem, dtype, "xla", 24)
           for cap, elem, dtype in _CASES]
    # the Pallas interpreter costs ~0.1 s an op: two short sequences
    # (capacity-1 wraparound and a 2-D bool element) keep it tier-1
    out += [pytest.param(1, (), np.int32, "interpret", 8),
            pytest.param(6, (2, 3), np.bool_, "interpret", 8)]
    return out


@pytest.mark.parametrize("cap,elem,dtype,impl,n_ops", _parity_params())
def test_ring_bitwise_equal_to_reference(cap, elem, dtype, impl, n_ops):
    buf, head, size = _state(cap, elem, dtype)
    rbuf, rhead, rsize = _ref_state(cap, elem, dtype)
    counter = 0
    for op, n in _ops(cap, n_ops, seed=cap + 100):
        if op == "pop":
            toks, _, _ = ring.ring_pop(buf, head, size, n)
            rtoks, rhead, rsize = ref_ring.ring_pop(rbuf, rhead, rsize, n,
                                                    impl=impl)
            assert toks.numpy().tobytes() == np.asarray(rtoks).tobytes()
        else:
            arr = _mk(counter, n, elem, dtype)
            counter += n
            ring.ring_push(buf, head, size, torch.from_numpy(arr))
            rbuf, rhead, rsize = ref_ring.ring_push(
                rbuf, rhead, rsize, jnp.asarray(arr), impl=impl)
        assert buf.numpy().tobytes() == np.asarray(rbuf).tobytes()
        assert int(head) == int(rhead) and int(size) == int(rsize)


def test_ring_preserves_sentinel_bits():
    # NaN, infinities and signed zero round-trip bit-exactly (no
    # arithmetic on the payload), across the wrap at head 3 of 5
    vals = np.array([np.nan, -np.inf, np.inf, -0.0, 1.5e-38], np.float32)
    buf = torch.zeros(5, dtype=torch.float32)
    head = torch.tensor(3, dtype=torch.int32)
    size = torch.tensor(0, dtype=torch.int32)
    ring.ring_push(buf, head, size, torch.from_numpy(vals.copy()))
    toks, _, _ = ring.ring_pop(buf, head, size, 5)
    assert toks.numpy().tobytes() == vals.tobytes()
    assert int(size) == 0 and int(head) == 3


def test_ring_ops_on_meta_are_shape_only():
    # synthesis's counting pass runs every firing on meta tensors
    buf = torch.empty((4, 2, 3), dtype=torch.float32, device="meta")
    head = torch.zeros((), dtype=torch.int32, device="meta")
    size = torch.zeros((), dtype=torch.int32, device="meta")
    ring.ring_push(buf, head, size,
                   torch.empty((3, 2, 3), device="meta"))
    toks, _, _ = ring.ring_pop(buf, head, size, 2)
    assert toks.shape == (2, 2, 3) and toks.device.type == "meta"
    fire = ring.eval_guards(
        *(torch.zeros(s, dtype=torch.int32, device="meta")
          for s in [(3,), (3,), (2, 3), (2, 3)]),
        torch.ones(2, dtype=torch.bool, device="meta"))
    assert fire.shape == (2,) and fire.device.type == "meta"


def _guards_ref(sizes, caps, need_r, need_w, live):
    t = need_r.shape[0]
    out = np.zeros(t, bool)
    for ti in range(t):
        out[ti] = bool(live[ti]) and \
            all(need_r[ti, c] <= sizes[c] for c in range(len(caps))) and \
            all(need_w[ti, c] <= caps[c] - sizes[c]
                for c in range(len(caps)))
    return out


@pytest.mark.parametrize("impl,t,c,seed", [
    ("xla", 1, 1, 0), ("xla", 3, 2, 1), ("xla", 17, 9, 2),
    ("xla", 8, 130, 3), ("xla", 88, 192, 4), ("xla", 5, 0, 5),
    ("interpret", 17, 9, 2), ("interpret", 3, 0, 6)])
def test_eval_guards_equal_to_reference(impl, t, c, seed):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, 6, c).astype(np.int32)
    sizes = np.array([rng.integers(0, k + 1) for k in caps], np.int32)
    need_r = rng.integers(0, 4, (t, c)).astype(np.int32)
    need_w = rng.integers(0, 4, (t, c)).astype(np.int32)
    live = rng.integers(0, 2, t).astype(bool)
    got = ring.eval_guards(*(torch.from_numpy(x) for x in
                             (sizes, caps, need_r, need_w, live)))
    want = np.asarray(ref_ring.eval_guards(
        jnp.asarray(sizes), jnp.asarray(caps), jnp.asarray(need_r),
        jnp.asarray(need_w), jnp.asarray(live), impl=impl))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, _guards_ref(sizes, caps, need_r, need_w,
                                            live))


def test_cpu_ops_never_touch_the_cuda_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU op tried to build/load {name!r}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    dispatch.reset_launches()
    buf, head, size = _state(4, (2,), np.float32)
    ring.ring_push(buf, head, size, torch.ones(3, 2))
    ring.ring_pop(buf, head, size, 2)
    ring.eval_guards(size[None].clone(), torch.tensor([4], dtype=torch.int32),
                     torch.zeros(2, 1, dtype=torch.int32),
                     torch.zeros(2, 1, dtype=torch.int32),
                     torch.ones(2, dtype=torch.bool))
    assert dispatch.launch_counts() == {}


def test_device_rule():
    cpu = torch.zeros(1)
    assert not dispatch.uses_kernel("op", cpu, cpu)
    assert not dispatch.uses_kernel("op", torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        dispatch.uses_kernel("op", cpu, torch.zeros(1, device="meta"))


def test_ring_ops_validate_their_inputs():
    buf, head, size = _state(4, (2,), np.float32)
    with pytest.raises(ValueError, match="n=5"):
        ring.ring_pop(buf, head, size, 5)
    with pytest.raises(ValueError, match="head must be a 0-d int32"):
        ring.ring_pop(buf, head.long(), size, 1)
    with pytest.raises(ValueError, match="does not match"):
        ring.ring_push(buf, head, size, torch.ones(1, 3))
    with pytest.raises(ValueError, match="does not match"):
        ring.ring_push(buf, head, size, torch.ones(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="live must be"):
        ring.eval_guards(torch.zeros(1, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32),
                         torch.zeros(2, 1, dtype=torch.int32),
                         torch.zeros(2, 1, dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))

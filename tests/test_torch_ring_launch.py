"""The ring ops' launch path (repro_torch.kernels.ring.RingHandle) on CPU
tensors: the launch arguments prepared once per ring (copy word, row
bytes, the struct the C entry reads), the cluster size chosen by bytes,
the checks a handle makes, and that a CPU ring takes the plain versions
with unchanged results.  The kernels run only on the card
(``chip_smoke.py`` phase 3 holds them against the plain versions there);
the plain versions are held against the reference in
``tests/test_torch_ring.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, dispatch, ring

I32 = torch.int32


def _counters(head=0, size=0):
    return torch.tensor(head, dtype=I32), torch.tensor(size, dtype=I32)


@pytest.mark.parametrize("elem,dtype,row_bytes,word", [
    ((256, 256), torch.float32, 262144, 16),    # gemm's tokens
    ((), torch.float32, 4, 4),                  # gaussian's scalars
    ((3,), torch.float32, 12, 4),
    ((2, 3), torch.int32, 24, 4),
    ((16,), torch.bool, 16, 16),
    ((4,), torch.bool, 4, 4),
    ((3,), torch.bool, 3, 1),                   # odd rows: byte words
    ((), torch.bool, 1, 1),
    ((8,), torch.float16, 16, 16),
    ((5,), torch.float16, 10, 1),
])
def test_ring_args_by_row_bytes(elem, dtype, row_bytes, word):
    buf = torch.zeros((4,) + elem, dtype=dtype)
    a = ring.ring_args(buf, *_counters())
    assert a == ring.RingArgs(4, elem, row_bytes, word)


@pytest.mark.parametrize("offset,word", [(0, 16), (4, 4), (8, 4), (1, 1),
                                         (2, 1)])
def test_copy_word_by_buffer_alignment(offset, word):
    """A contiguous ring cut from a larger buffer at a byte offset: the
    word also divides the buffer's address."""
    base = torch.zeros(64 + 32, dtype=torch.uint8)
    assert base.data_ptr() % 16 == 0
    buf = base[offset:offset + 64].view(4, 16)
    assert buf.is_contiguous()
    assert ring.ring_args(buf, *_counters()).word == word


@pytest.mark.parametrize("row_bytes,ptrs,word", [
    (32, (0, 16), 16), (32, (0, 4), 4), (32, (0, 8), 4), (32, (0, 2), 1),
    (12, (0, 0), 4), (12, (0, 3), 1), (7, (0, 0), 1), (16, (), 16),
])
def test_copy_word_narrows_by_every_pointer(row_bytes, ptrs, word):
    assert ring.copy_word(row_bytes, *ptrs) == word


@pytest.mark.parametrize("nbytes,blocks", [
    (0, 1), (1, 1), (8192, 1),                  # gaussian's 8 KiB rows
    (ring.BLOCK_BYTES, 1), (ring.BLOCK_BYTES + 1, 2), (65536, 2),
    (7 * ring.BLOCK_BYTES + 1, 8),
    (262144, 8),                                # a gemm / page_rank token
    (6 << 20, 8),                               # past 8 blocks: 8
])
def test_cluster_blocks_by_bytes(nbytes, blocks):
    assert ring.cluster_blocks(nbytes) == blocks
    assert ring.BLOCK_BYTES == ring.COPY_THREADS * ring.UNROLL * 16


@pytest.mark.parametrize("n,row_bytes,burst", [
    (1, 262144, 16 + 8),                        # a gemm token: 8 blocks
    (2048, 4, 2048 * 16 + 1),                   # a gaussian row: 1 block
    (3, 2 << 20, 3 * 16 + 8), (4, 1, 64 + 1),
])
def test_burst_arg_packs_n_and_the_cluster_size(n, row_bytes, burst):
    # csrc/ring.cu unpacks n = burst >> 4, blocks = burst & 15
    assert ring.burst_arg(n, row_bytes) == burst
    assert (burst >> 4, burst & 15) == (
        n, ring.cluster_blocks(n * row_bytes))


@pytest.mark.parametrize("n,one,shape", [(3, False, (3, 2, 2)),
                                          (1, True, (2, 2)),
                                          (4, False, (4, 2, 2))])
def test_popped_tokens_are_new_tensors(n, one, shape):
    """Each pop returns a tensor of its own elements: no ring and no
    earlier token shares them, so a later op cannot overwrite it."""
    buf = torch.arange(16.0).reshape(4, 2, 2)
    h = ring.RingHandle(buf, *_counters(0, 4))
    a = h.pop_one() if one else h.pop(n)
    h.push(torch.full((n, 2, 2), -1.0))
    b = h.pop_one() if one else h.pop(n)
    assert a.shape == b.shape == shape
    ptrs = {buf.untyped_storage().data_ptr(), a.untyped_storage().data_ptr(),
            b.untyped_storage().data_ptr()}
    assert len(ptrs) == 3
    assert torch.equal(a.reshape(-1, 2, 2), torch.arange(16.0)
                       .reshape(4, 2, 2)[:n])


def test_launch_struct_matches_the_c_layout():
    # csrc/ring.cu's struct RingLaunch: four pointers, a long long, two
    # ints; the C entry reads it by reference
    f = ring._RingLaunch
    assert [(n, getattr(f, n).offset) for n, _ in f._fields_] == [
        ("buf", 0), ("head", 8), ("size", 16), ("stream", 24),
        ("row_bytes", 32), ("cap", 40), ("word", 44)]
    assert ctypes.sizeof(f) == 48
    assert ring._ARGTYPES["ring_pop"] == ring._ARGTYPES["ring_push"] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(4, 6)[:, ::2], *_counters()), "contiguous"),
    (lambda: (torch.zeros(4, 3), torch.zeros(1, dtype=I32),
              torch.tensor(0, dtype=I32)), "head must be a 0-d int32"),
    (lambda: (torch.zeros(4, 3), torch.tensor(0, dtype=I32),
              torch.tensor(0)), "size must be a 0-d int32"),
    (lambda: (torch.zeros(4, 3), torch.tensor(0.0),
              torch.tensor(0, dtype=I32)),
     "head must be a 0-d int32"),
    (lambda: (torch.zeros(0, 3), *_counters()), r"cap >= 1"),
    (lambda: (torch.zeros(()), *_counters()), r"cap >= 1"),
])
def test_handle_refuses_a_bad_ring(make, match):
    with pytest.raises(ValueError, match=match):
        ring.RingHandle(*make())


def test_handle_refuses_n_outside_cap():
    h = ring.RingHandle(torch.zeros(4, 3), *_counters(0, 4))
    for n in (-1, 5):
        with pytest.raises(ValueError, match=rf"n={n} outside \[0, cap=4\]"):
            h.pop(n)
    assert h.pop(0).shape == (0, 3)
    with pytest.raises(ValueError, match=r"n=5 outside \[0, cap=4\]"):
        h.push(torch.zeros(5, 3))
    assert int(h.head) == 0 and int(h.size) == 4      # nothing moved


@pytest.mark.parametrize("arr,match", [
    (torch.zeros(2, 3, dtype=I32), "is not whole rows"),   # dtype
    (torch.zeros(2, 4), "is not whole rows"),              # 8 / 3 rows
    (torch.zeros(()), "is not whole rows"),                # 1 / 3 row
    (torch.zeros(2, 3, device="meta"), "arr on meta, ring on cpu"),
])
def test_handle_push_checks_memory_safety(arr, match):
    h = ring.RingHandle(torch.zeros(4, 3), *_counters())
    with pytest.raises(ValueError, match=match):
        h.push(arr)


def _plain_twin(cap, elem, dtype, head, size, seed):
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((cap,) + elem)
                           .astype(np.float32)).to(dtype)
    return ((buf.clone(), *_counters(head, size)),
            (buf.clone(), *_counters(head, size)))


@pytest.mark.parametrize("cap,elem,dtype,head,size,ops", [
    (5, (3,), torch.float32, 3, 5, [("pop", 4), ("push", 3), ("pop", 1)]),
    (7, (2, 3), torch.int32, 6, 2, [("push", 5), ("pop", 7)]),
    (3, (), torch.bool, 2, 3, [("pop", 3), ("push", 3), ("pop", 0)]),
    (1, (4,), torch.float32, 0, 0, [("push", 1), ("pop", 1), ("push", 1)]),
])
def test_cpu_handle_takes_the_plain_version(monkeypatch, cap, elem, dtype,
                                            head, size, ops):
    def no_build(name):
        raise AssertionError(f"a CPU ring tried to build/load {name!r}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    dispatch.reset_launches()
    (b, h, s), (pb, ph, ps) = _plain_twin(cap, elem, dtype, head, size,
                                          seed=cap)
    handle = ring.RingHandle(b, h, s)
    rng = np.random.default_rng(cap + 1)
    for op, n in ops:
        if op == "pop":
            got = handle.pop(n)
            want, _, _ = ring.ring_pop_plain(pb, ph, ps, n)
            assert got.shape == (n,) + elem and torch.equal(got, want)
        else:
            arr = torch.from_numpy(rng.standard_normal((n,) + elem)
                                   .astype(np.float32)).to(dtype)
            handle.push(arr)
            ring.ring_push_plain(pb, ph, ps, arr)
        assert torch.equal(b, pb) and int(h) == int(ph) and int(s) == int(ps)
    assert handle.head is h and handle.size is s and handle.buf is b
    assert dispatch.launch_counts() == {}


def test_cpu_handle_one_token_ops():
    (b, h, s), _ = _plain_twin(3, (2, 2), torch.float32, 2, 0, seed=0)
    handle = ring.RingHandle(b, h, s)
    tok = torch.arange(4, dtype=torch.float32).view(2, 2)
    handle.push(tok)                            # one elem-shaped token
    handle.push(tok[None] + 4)
    assert int(s) == 2 and torch.equal(b[2], tok) and torch.equal(b[0],
                                                                  tok + 4)
    got = handle.pop_one()
    assert got.shape == (2, 2) and torch.equal(got, tok)
    assert handle.pop(1).shape == (1, 2, 2)
    assert int(h) == 1 and int(s) == 0
    with pytest.raises(ValueError, match="is not whole rows"):
        handle.push(torch.zeros(2, 3))


def test_public_ops_build_a_handle_per_call():
    """ring_pop/ring_push keep their signatures and return the argument
    counters advanced in place, through a handle built for the call."""
    buf = torch.zeros(4, 2)
    head, size = _counters(3, 0)
    b2, h2, s2 = ring.ring_push(buf, head, size,
                                torch.arange(6.0).view(3, 2))
    assert b2 is buf and h2 is head and s2 is size and int(size) == 3
    toks, h3, s3 = ring.ring_pop(buf, head, size, np.int64(2))
    assert h3 is head and s3 is size
    assert torch.equal(toks, torch.arange(4.0).view(2, 2))
    assert int(head) == 1 and int(size) == 1
    with pytest.raises(ValueError, match="contiguous"):
        ring.ring_pop(torch.zeros(4, 6)[:, ::2], head, size, 1)

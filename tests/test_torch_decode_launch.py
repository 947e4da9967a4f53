"""The flash-decode kernel's host side, on CPU tensors: the split count
(from ``S_max`` alone: ``kv_len`` stays on the device), the grids, the
partial kernel's instantiation by group and its shared memory, the
scratch layout, the strides of the cache views, and what the kernel
refuses.  The kernels run only on the card (``chip_smoke.py`` phases 2, 7
and 10, which also check that the library's shared-memory sizes equal
the host's); their plain version is held against the Pallas kernel in
``tests/test_torch_attention.py``.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.decode_attention import (
    MAX_GROUP, SPLIT, _by_chunks, decode_attention_fwd,
    decode_attention_plain, group_bound, head_chunks, launch_args, padded,
    smem_bytes)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF16, F32 = torch.bfloat16, torch.float32
SMEM_LIMIT = 232448          # bytes of shared memory a block may use (H100)


def _qkv(B, S, nh, nkv, hd, dtype=BF16):
    return (torch.zeros(B, nh, hd, dtype=dtype),
            torch.zeros(B, S, nkv, hd, dtype=dtype),
            torch.zeros(B, S, nkv, hd, dtype=dtype))


def _lens(B, n=1):
    return torch.full((B,), n, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("B,S,nh,nkv,hd,lens", chip_smoke.DECODE_CASES)
def test_launch_args_at_every_case(B, S, nh, nkv, hd, lens, dtype):
    q, k, v = _qkv(B, S, nh, nkv, hd, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    a = launch_args(q, k, v, kv_len)
    group, n_split = nh // nkv, -(-S // SPLIT)
    assert a.dims == (B, S, nkv, group, hd) and a.n_split == n_split
    assert a.dtype == {F32: 0, BF16: 1}[dtype]
    assert a.grid_partial == (n_split, nkv, B) and a.grid_merge == (nkv, B)
    slots = B * nkv * n_split * group
    assert a.n_stat % 4 == 0 and slots <= a.n_stat < slots + 4
    assert a.part_numel == 2 * a.n_stat + hd * slots
    assert a.smem_partial == smem_bytes(dtype, hd, group) <= SMEM_LIMIT
    assert a.strides == (nh * hd, hd, S * nkv * hd, nkv * hd, hd,
                         S * nkv * hd, nkv * hd, hd)
    assert a.scale == 1.0 / math.sqrt(hd)
    assert a.q is q and a.k is k and a.v is v


@pytest.mark.parametrize("S,n_split", [
    (1, 1), (SPLIT - 1, 1), (SPLIT, 1), (SPLIT + 1, 2),
    (2 * SPLIT, 2), (2048, 32)])
def test_split_count_comes_from_s_max_alone(S, n_split):
    q, k, v = _qkv(2, S, 16, 8, 128)
    for n in (0, 1, S):
        a = launch_args(q, k, v, _lens(2, n))
        assert a.n_split == n_split and a.grid_partial == (n_split, 8, 2)


@pytest.mark.parametrize("group,bound", [(1, 2), (2, 2), (3, 4), (4, 4),
                                         (5, 8), (8, 8), (9, 16), (12, 16),
                                         (16, 16)])
def test_group_picks_its_instantiation(group, bound):
    assert group_bound(group) == bound
    for dtype in (BF16, F32):
        for hd, width in ((64, 64), (96, 128), (128, 128)):
            assert padded(hd) == width
            assert smem_bytes(dtype, hd, group) == \
                2 * SPLIT * width * dtype.itemsize + 4 * bound * SPLIT
            assert smem_bytes(dtype, hd, group) <= SMEM_LIMIT


def test_serving_shape():
    """Qwen3-0.6B's cache: 8 slots x 2048 rows, 8 KV heads of 128, group
    2, bf16: 32 splits of 64 rows, 34 KB of shared memory a block."""
    a = launch_args(*_qkv(8, 2048, 16, 8, 128), _lens(8))
    assert a.grid_partial == (32, 8, 8) and a.smem_partial == 33280
    assert a.part_numel == 2 * 4096 + 128 * 4096


def test_phi3_serving_shape():
    """Phi-3-vision's cache: 8 slots x 2048 rows, 32 KV heads of 96, group
    1, bf16: tiles 128 wide (33 KB a block), scratch of 96 columns a
    slot, scale 1/sqrt(96)."""
    a = launch_args(*_qkv(8, 2048, 32, 32, 96), _lens(8))
    assert a.grid_partial == (32, 32, 8) and a.grid_merge == (32, 8)
    assert a.smem_partial == 2 * SPLIT * 128 * 2 + 4 * 2 * SPLIT == 33280
    slots = 8 * 32 * 32
    assert a.n_stat == slots and a.part_numel == 2 * slots + 96 * slots
    assert a.scale == 1.0 / math.sqrt(96)


def test_cache_views_keep_their_strides():
    """k and v cut from one packed [B, S, 2, nkv, hd] cache: read in place."""
    B, S, nkv, hd = 2, 100, 4, 64
    kv = torch.zeros(B, S, 2, nkv, hd, dtype=BF16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    q = torch.zeros(B, 8, hd, dtype=BF16)
    a = launch_args(q, k, v, _lens(B))
    assert a.k is k and a.v is v
    assert a.strides[2:] == (S * 2 * nkv * hd, 2 * nkv * hd, hd) * 2


def test_unaligned_cache_is_copied():
    B, S, nkv, hd = 1, 10, 2, 64
    base = torch.zeros(B * S * nkv * hd + 1, dtype=BF16)
    k = base[1:].view(B, S, nkv, hd)             # 2-byte offset
    v = torch.zeros(B, S, nkv, hd, dtype=BF16)
    a = launch_args(torch.zeros(B, 4, hd, dtype=BF16), k, v, _lens(B))
    assert a.k is not k and a.k.data_ptr() % 16 == 0 and a.v is v


@pytest.mark.parametrize("q_dt,kv_dt,hd,nh,nkv,match", [
    (torch.float16, torch.float16, 128, 16, 8, "float32 or bfloat16"),
    (BF16, F32, 128, 16, 8, "one dtype"),
    (BF16, BF16, 80, 16, 8, "head_dim 64, 96 or 128"),
    (F32, F32, 80, 32, 32, "head_dim 64, 96 or 128"),
    (BF16, BF16, 128, 24, 16, r"nkv \| nh"),
])
def test_refuses_what_no_kernel_takes(q_dt, kv_dt, hd, nh, nkv, match):
    q = torch.zeros(2, nh, hd, dtype=q_dt)
    k = torch.zeros(2, 64, nkv, hd, dtype=kv_dt)
    with pytest.raises(ValueError, match=match):
        launch_args(q, k, k.clone(), _lens(2))


@pytest.mark.parametrize("group,chunks", [
    (12, (12,)), (16, (16,)), (17, (9, 8)), (24, (12, 12)),
    (48, (16, 16, 16))])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_large_groups_take_one_launch_a_chunk(group, chunks, dtype):
    """A group up to MAX_GROUP (16) is one launch of the 16-head
    instantiation (starcoder2-3b's 12); a larger one, which the
    reference's kernel also takes, one launch a chunk of at most 16 heads
    of each KV head, each with the 16-head block's shared memory."""
    B, S, nkv, hd = 8, 2048, 2, 128
    a = launch_args(*_qkv(B, S, group * nkv, nkv, hd, dtype), _lens(B))
    assert head_chunks(group) == a.chunks == chunks
    assert sum(chunks) == group and max(chunks) <= MAX_GROUP
    assert a.dims == (B, S, nkv, group, hd)
    assert a.grid_partial == (S // SPLIT, nkv, B)
    want = 2 * SPLIT * 128 * dtype.itemsize + 4 * 16 * SPLIT
    assert a.smem_partial == smem_bytes(dtype, hd, group) == want
    assert want <= SMEM_LIMIT
    slots = B * nkv * (S // SPLIT) * max(chunks)
    assert a.n_stat == slots and a.part_numel == 2 * slots + hd * slots


@pytest.mark.parametrize("chunks", [(12, 12), (9, 8, 7)])
def test_chunked_launches_assemble_the_whole_group(chunks):
    """The chunked call's assembly: each chunk's heads of every KV head
    through the wrapper (its plain version here) land at their heads of
    ``out`` and ``lse``: bitwise the plain version on the whole group."""
    g = torch.Generator().manual_seed(1)
    B, S, nkv, hd = 3, SPLIT + 7, 2, 64
    nh = sum(chunks) * nkv
    q = torch.randn(B, nh, hd, generator=g)
    k = torch.randn(B, S, nkv, hd, generator=g)
    v = torch.randn(B, S, nkv, hd, generator=g)
    kv_len = torch.tensor([0, 9, S], dtype=torch.int32)
    out, lse = _by_chunks(q, k, v, kv_len, chunks, torch.empty(B, nh, hd),
                          torch.empty(B, nh))
    want, want_lse = decode_attention_plain(q, k, v, kv_len, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    out = _by_chunks(q, k, v, kv_len, chunks, torch.empty(B, nh, hd), None)
    assert torch.equal(out, decode_attention_plain(q, k, v, kv_len))


@pytest.mark.parametrize("kv_len,match", [
    (torch.zeros(2, dtype=torch.int64), "int32"),
    (torch.zeros(3, dtype=torch.int32), "int32"),
])
def test_refuses_bad_lengths(kv_len, match):
    with pytest.raises(ValueError, match=match):
        launch_args(*_qkv(2, 64, 16, 8, 128), kv_len)


def test_cpu_call_takes_the_plain_version_at_the_split_edges():
    """On the CPU the wrapper is the plain version: exact zeros at
    kv_len 0, the same values as a direct plain call at split - 1, split
    and split + 1."""
    g = torch.Generator().manual_seed(0)
    B, S, nh, nkv, hd = 4, SPLIT + 1, 16, 8, 128
    q = torch.randn(B, nh, hd, generator=g)
    k = torch.randn(B, S, nkv, hd, generator=g)
    v = torch.randn(B, S, nkv, hd, generator=g)
    kv_len = torch.tensor([0, SPLIT - 1, SPLIT, SPLIT + 1], dtype=torch.int32)
    out = decode_attention_fwd(q, k, v, kv_len)
    assert torch.equal(out, decode_attention_plain(q, k, v, kv_len))
    assert bool((out[0] == 0).all())
    assert bool(out[1:].abs().sum(-1).gt(0).all())

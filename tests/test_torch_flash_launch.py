"""The flash-attention wrapper's host side, on CPU tensors: which kernel a
dtype routes to, which q/k/v views reach the kernel as they are and which
are copied, and the integer arguments a launch passes (strides, dims,
group, masks).  The kernels themselves run only on the card
(``chip_smoke.py`` phase 7); their plain version is held against the
Pallas kernel in ``tests/test_torch_attention.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (ENTRIES, launch_args,
                                                 flash_attention_fwd)

BF16, F32 = torch.bfloat16, torch.float32


def _qkv(B, Sq, Sk, nh, nkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return t(B, Sq, nh, hd), t(B, Sk, nkv, hd), t(B, Sk, nkv, hd)


@pytest.mark.parametrize("dtype,entry,code", [
    (BF16, "flash_attention_fwd_wgmma", 1),
    (F32, "flash_attention_fwd_fma", 0),
])
def test_dtype_routes_to_its_kernel(dtype, entry, code):
    q, k, v = _qkv(2, 16, 16, 4, 2, 128, dtype)
    a = launch_args(q, k, v, causal=True, window=None)
    assert (a.entry, a.dtype) == (entry, code) == ENTRIES[dtype]


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_projection_views_keep_their_strides(dtype):
    """q/k/v cut from one [B, S, (nh + 2 nkv) hd] projection, as the model
    cuts them: read in place through their strides, no copy."""
    B, S, nh, nkv, hd = 2, 33, 8, 2, 64
    width = (nh + 2 * nkv) * hd
    x = torch.randn(B, S, width).to(dtype)
    q = x[..., :nh * hd].view(B, S, nh, hd)
    k = x[..., nh * hd:(nh + nkv) * hd].view(B, S, nkv, hd)
    v = x[..., (nh + nkv) * hd:].view(B, S, nkv, hd)
    a = launch_args(q, k, v, causal=True, window=None)
    assert a.q is q and a.k is k and a.v is v
    assert a.strides == (S * width, width, hd) * 3
    assert a.dims == (B, S, S, nh, nh // nkv, hd)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("cut", ["offset", "stride"])
def test_unaligned_views_are_copied(dtype, cut):
    """A view whose base or row stride is not 16-byte aligned (what the
    kernels' vector loads and tensor maps need) reaches the kernel as an
    aligned contiguous copy of the same values."""
    B, S, nh, hd = 2, 9, 4, 64
    if cut == "offset":      # starts one element into its buffer
        q = torch.randn(B * S * nh * hd + 1).to(dtype)[1:].view(B, S, nh, hd)
    else:                    # rows 1 element apart beyond hd
        q = torch.randn(B, S, nh, hd + 1).to(dtype)[..., :hd]
    k, v = _qkv(B, S, S, nh, 2, hd, dtype)[1:]
    a = launch_args(q, k, v, causal=False, window=None)
    assert a.q is not q and a.q.is_contiguous()
    assert a.q.data_ptr() % 16 == 0 and torch.equal(a.q, q)
    assert a.k is k and a.v is v
    assert a.strides[:3] == (S * nh * hd, nh * hd, hd)


@pytest.mark.parametrize("Sq,Sk,nh,nkv,hd,causal,window", [
    (100, 300, 16, 8, 128, True, None),     # Sq < Sk
    (300, 100, 16, 8, 128, True, None),     # Sq > Sk
    (2048, 2048, 16, 8, 128, True, 100),    # window
    (77, 77, 8, 2, 64, False, None),        # hd 64, group 4
    (64, 64, 4, 4, 128, True, 0),           # window 0: every key hidden
    (1024, 1024, 32, 32, 96, True, None),   # Phi-3: hd 96, MHA
    (333, 333, 16, 2, 96, True, 100),       # hd 96, group 8, window
])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_launch_arguments(Sq, Sk, nh, nkv, hd, causal, window, dtype):
    B = 2
    q = torch.empty(B, Sq, nh, hd, dtype=dtype)
    k = torch.empty(B, Sk, nkv, hd, dtype=dtype)
    a = launch_args(q, k, k, causal=causal, window=window)
    assert a.dims == (B, Sq, Sk, nh, nh // nkv, hd)
    assert a.strides == ((Sq * nh * hd, nh * hd, hd)
                         + (Sk * nkv * hd, nkv * hd, hd) * 2)
    assert (a.causal, a.has_window, a.window) == (
        int(causal), int(window is not None), window or 0)
    assert a.scale == pytest.approx(1 / math.sqrt(hd), rel=1e-12)


def test_size_one_dimensions_get_the_span_inside_them():
    """A dimension of size 1 is never stepped along; whatever stride it
    reports, the launch passes the span of the dimensions inside it."""
    q = torch.empty(1, 5, 4, 64, dtype=BF16)
    # aligned strides that are not the natural ones on the size-1 dims
    k = torch.empty(2048, dtype=BF16).as_strided(
        (1, 5, 1, 64), (4096, 64, 1024, 1))
    a = launch_args(q, k, k, causal=True, window=None)
    assert a.k is k and a.v is k            # aligned: not copied
    assert a.strides == (5 * 4 * 64, 4 * 64, 64, 5 * 64, 64, 64,
                         5 * 64, 64, 64)


@pytest.mark.parametrize("dtypes,hd", [
    ((torch.float16,) * 3, 128),            # no kernel for fp16
    ((torch.float64,) * 3, 64),
    ((BF16, F32, BF16), 128),               # mixed
    ((BF16,) * 3, 80),                      # head width
    ((F32,) * 3, 80),
    ((F32,) * 3, 32),
])
def test_unsupported_dtype_or_head_dim_raises(dtypes, hd):
    q = torch.empty(1, 8, 4, hd, dtype=dtypes[0])
    k = torch.empty(1, 8, 2, hd, dtype=dtypes[1])
    v = torch.empty(1, 8, 2, hd, dtype=dtypes[2])
    with pytest.raises(ValueError, match="head_dim 64, 96 or 128"):
        launch_args(q, k, v, causal=True, window=None)


def test_cpu_tensors_take_the_plain_version_whatever_the_dtype():
    """No kernel takes fp16 or hd 80, but the CPU path is the plain
    version, which does; only a launch checks what a kernel takes."""
    q, k, v = _qkv(1, 8, 8, 4, 2, 80, torch.float16)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == torch.float16
    assert lse.shape == (1, 4, 8) and lse.dtype == F32


def test_ptxas_report_is_read_per_kernel(tmp_path, monkeypatch):
    """``_build.resources`` reads the ``-Xptxas -v`` report kept beside a
    library: each kernel's registers, static shared memory, stack and
    spills, a missing field as 0."""
    from repro_torch.kernels import _build
    lib = tmp_path / "libx-0.so"
    lib.with_suffix(".ptxas").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 800 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 12288 bytes "
        "smem, 360 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "build", lambda name: lib)
    assert _build.resources("x") == [
        dict(kernel="_Z1av", registers=168, smem_static=0, stack=0,
             spill_stores=0, spill_loads=0),
        dict(kernel="_Z1bv", registers=40, smem_static=12288, stack=8,
             spill_stores=4, spill_loads=12)]

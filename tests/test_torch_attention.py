"""The port's attention kernels' plain versions against the reference's
Pallas kernels (run under the Pallas interpreter on the CPU).

Same numpy inputs through both packages; the port's head layout is the
model's ([B, S, heads, hd]), the reference kernels' is head-major, so the
test transposes the reference side.  Tolerance: 1e-5 absolute on outputs
of magnitude ~1 and on ``lse`` — both sides compute in float32 and differ
only in summation order.  On the CPU the port's wrappers take their plain
versions and never load a CUDA library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_fwd as jax_decode
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.dispatch import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.layers import sdpa

TOL = 1e-5


def _qkv(seed, B, Sq, Sk, nh, nkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("nh,nkv,Sq,Sk,causal,window", [
    (4, 4, 64, 64, True, None),      # MHA, causal
    (4, 2, 64, 64, True, None),      # group 2
    (8, 2, 64, 64, True, None),      # group 4
    (4, 2, 64, 64, False, None),     # no mask
    (4, 2, 64, 64, True, 24),        # causal + sliding window
    (4, 1, 32, 64, True, None),      # Sq != Sk (causal from row 0)
    (4, 2, 48, 16, False, None),     # Sq > Sk
])
def test_flash_plain_matches_pallas_interpret(nh, nkv, Sq, Sk, causal,
                                             window):
    q, k, v = _qkv(0, 2, Sq, Sk, nh, nkv, 16)
    out_j, lse_j = jax_flash(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2),
                             jnp.swapaxes(v, 1, 2), causal=causal,
                             window=window, block_q=16, block_k=16,
                             interpret=True)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(out_j), 1, 2),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=0)


def test_flash_fully_masked_rows_give_zero_and_neg_lse():
    """window=0 hides every key: out 0, lse -1e30, as the Pallas kernel's
    l == 0 guard gives."""
    q, k, v = _qkv(1, 1, 16, 16, 2, 1, 16)
    out_j, lse_j = jax_flash(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2),
                             jnp.swapaxes(v, 1, 2), causal=True, window=0,
                             interpret=True)
    out, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True,
                                   window=0)
    assert torch.count_nonzero(out) == 0
    np.testing.assert_array_equal(np.swapaxes(np.asarray(out_j), 1, 2), 0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-6)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (8, 2)])
def test_decode_plain_matches_pallas_interpret(nh, nkv):
    B, S, hd = 6, 64, 16
    rng = np.random.default_rng(nh * 10 + nkv)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    # dead slot, one token, mid-block, block edge, one past it, full
    lens = np.array([0, 1, 17, 32, 33, 64], np.int32)
    out_j = jax_decode(jnp.asarray(q.reshape(B, nkv, nh // nkv, hd)),
                       jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
                       jnp.asarray(lens), block_k=16, interpret=True)
    out = decode_attention_fwd(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(out_j).reshape(B, nh, hd),
                               atol=TOL, rtol=0)
    assert torch.count_nonzero(out[0]) == 0          # exact zeros


def test_ops_match_reference_ops_model_layout():
    """The model-layout wrappers against the reference's ops/ref on the
    path the model takes (causal prefill, ragged decode with kv_len >= 1,
    the reference's 4-d decode q against the port's [B, nh, hd] one); and
    the model's naive attention (``sdpa``)
    against the reference's oracle with a query offset and a key length,
    the per-slot decode's masks."""
    q, k, v = _qkv(3, 2, 32, 32, 4, 2, 16)
    want = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True)
    np.testing.assert_allclose(ops.flash_attention(_t(q), _t(k), _t(v)),
                               np.asarray(want), atol=TOL, rtol=0)
    lens = np.array([5, 32], np.int32)
    qd = q[:, :1]
    want = jax_ops.decode_attention(jnp.asarray(qd), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens))
    got = ops.decode_attention(_t(qd[:, 0]), _t(k), _t(v), _t(lens))
    assert got.shape == qd[:, 0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               atol=TOL, rtol=0)
    want = jax_ref.flash_attention_ref(
        jnp.asarray(q[:, :4]), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=20, kv_len=24)
    got = sdpa(_t(q[:, :4]), _t(k), _t(v), causal=True, q_offset=20,
               kv_len=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_cpu_takes_plain_versions_without_loading_cuda():
    reset_launches()
    q, k, v = _qkv(4, 1, 8, 8, 2, 1, 16)
    ops.flash_attention(_t(q), _t(k), _t(v))
    ops.decode_attention(_t(q[:, 0]), _t(k), _t(v),
                         torch.full((1,), 3, dtype=torch.int32))
    assert launch_counts() == {}
    assert "flash_attention" not in _build._libs
    assert "decode_attention" not in _build._libs


def test_bind_after_first_call_neither_loads_nor_rebinds(monkeypatch):
    """A bound library is returned from the cache: no load, no lock."""
    lib = object()
    monkeypatch.setitem(_build._bound, "some_kernel", lib)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("loaded"))
    monkeypatch.setattr(_build, "_lock", None)   # taking it would raise
    assert _build.bind("some_kernel", {"some_kernel": []}) is lib


def test_forward_only():
    """Flash-decode is serving only (no backward, as in the reference);
    flash attention has one (``tests/test_torch_ssd.py`` checks it)."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(5, 1, 8, 8, 2, 1, 16))
    with pytest.raises(NotImplementedError, match="serving only"):
        ops.decode_attention(q[:, 0], k, v,
                             torch.full((1,), 4, dtype=torch.int32))
    with torch.no_grad():
        assert ops.decode_attention(
            q[:, 0], k, v, torch.full((1,), 4, dtype=torch.int32)).shape \
            == q[:, 0].shape
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.grad_fn is not None


def test_bad_shapes_raise():
    q, k, v = _qkv(6, 1, 8, 8, 3, 2, 16)       # 2 does not divide 3
    with pytest.raises(ValueError, match="nkv"):
        flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    q, k, v = _qkv(6, 1, 8, 8, 4, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention_fwd(_t(q[:, 0]), _t(k), _t(v),
                             torch.zeros(1, dtype=torch.int64))

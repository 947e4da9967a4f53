"""The rest of the attention options against the reference, on the CPU:
the int8 KV cache (``kv_quant``), the chunked online-softmax attention
(``attn_impl="chunked"``) and the score-free measurement stand-in
(``attn_impl="noscore"``); the port's mirror of
``tests/test_perf_variants.py`` (``TestChunkedAttention``,
``TestKVQuant``).

Inputs come from numpy seeds and go to both packages.  Tolerances:
``quantize_kv`` bit for bit (the same float32 ops, round half to even,
the same fp16 rounding); the chunked attention within 1e-5 of the
reference's and 3e-5 of the port's naive attention (the reference test's
bound), its gradient within 1e-5 of ``jax.grad`` through the reference;
``noscore`` within 1e-6; an int8 cache's logits within the reference's
0.05 relative gap of the bf16/fp32 cache's, and within 1e-4 of the
reference's own int8 run (float32, summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params

LOGIT_REL = 1e-4
KV_GAP = 0.05


def _randn(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _qkv(seed: int, B=2, S=128, nh=4, nkv=2, hd=32):
    return (_randn(seed, (B, S, nh, hd)), _randn(seed + 1, (B, S, nkv, hd)),
            _randn(seed + 2, (B, S, nkv, hd)))


# ---------------------------------------------------------------------------
# chunked and noscore attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,chunk", [
    (True, None, 64), (False, None, 64), (True, 96, 64),
    (True, None, 33),                      # non-divisor chunk (padded tail)
    (False, 40, 33),
])
def test_sdpa_chunked_matches_reference(causal, window, chunk):
    q, k, v = _qkv(0)
    got = L.sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal,
                         window=window, chunk=chunk).numpy()
    want = np.asarray(JL.sdpa_chunked(q, k, v, causal=causal, window=window,
                                      chunk=chunk))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    naive = L.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                   window=window).numpy()
    np.testing.assert_allclose(got, naive, atol=3e-5, rtol=0)


def test_sdpa_chunked_grad_matches_reference():
    q, k, v = _qkv(3, B=1, S=64, nh=2, nkv=2, hd=16)
    want = jax.grad(lambda q: jnp.sum(
        JL.sdpa_chunked(q, k, v, causal=True, chunk=16) ** 2))(q)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = L.sdpa_chunked(qt, torch.from_numpy(k), torch.from_numpy(v),
                         causal=True, chunk=16)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    naive = torch.from_numpy(q).requires_grad_(True)
    (L.sdpa(naive, torch.from_numpy(k), torch.from_numpy(v),
            causal=True) ** 2).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), naive.grad.numpy(),
                               atol=1e-4, rtol=0)


def test_noscore_matches_reference():
    q, k, v = _qkv(5, S=16)
    got = L._noscore_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(JL._noscore_attention(q, k, v))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def qwen():
    cfg_j = jax_get_config("qwen3-0.6b").with_reduced(dtype="float32")
    cfg_t = get_config("qwen3-0.6b").with_reduced(dtype="float32")
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab, (2, 64)) \
        .astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, toks


def _close(got, want, rel=LOGIT_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("impl", ["chunked", "noscore"])
def test_forward_with_attn_impl_matches_reference(qwen, impl):
    """``forward`` routes ``attn_impl`` as the reference's ``attention``
    does; chunked also agrees with naive (the reference test's 5e-2)."""
    cfg_j, cfg_t, params_j, params_t, toks = qwen
    cj = dataclasses.replace(cfg_j, attn_impl=impl)
    ct = dataclasses.replace(cfg_t, attn_impl=impl)
    got, _ = lm.forward(params_t, ct, torch.from_numpy(toks))
    want, _ = jlm.forward(params_j, cj, jnp.asarray(toks))
    _close(got.numpy(), want)
    if impl == "chunked":
        naive, _ = lm.forward(params_t, cfg_t, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=5e-2)


@pytest.mark.parametrize("impl", ["chunked", "noscore"])
def test_prefill_with_attn_impl_matches_reference(qwen, impl):
    """The prefill branch: chunked through ``sdpa_chunked``, noscore
    through plain ``sdpa`` (the reference's ``lm.py:364-369``)."""
    cfg_j, cfg_t, params_j, params_t, toks = qwen
    cj = dataclasses.replace(cfg_j, attn_impl=impl)
    ct = dataclasses.replace(cfg_t, attn_impl=impl)
    got, cache = lm.prefill(params_t, ct, torch.from_numpy(toks[:, :40]),
                            max_seq=64)
    want, jcache = jlm.prefill(params_j, cj, jnp.asarray(toks[:, :40]),
                               max_seq=64)
    _close(got.numpy(), want)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((2, 8, 4, 32), 1.0),
                                         ((1, 37, 2, 16), 1e-3),
                                         ((3, 5, 1, 64), 40.0),
                                         ((2, 3, 2, 16), None)])
def test_quantize_kv_bit_exact(shape, scale):
    if scale is None:
        # scale exactly 1 (every row's largest magnitude 127) and codes
        # at x.5: rounding half to even, as jnp.round, is what is held
        t = np.random.default_rng(7).integers(-250, 251, shape) \
            .astype(np.float32) / 2
        t[..., 0] = 127.0
    else:
        t = _randn(7, shape, scale)
    t[0, 0, 0] = 0.0                            # an all-zero row: 1e-6
    q, s = L.quantize_kv(torch.from_numpy(t))
    qj, sj = JL.quantize_kv(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.uint16),
                                  np.asarray(sj).view(np.uint16))
    back = L.dequantize_kv(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(JL.dequantize_kv(qj, sj, jnp.float32)))


def test_quantize_roundtrip_and_footprint():
    """The reference's ``test_quantize_roundtrip``: a bf16 tensor back
    within 1% relative, int8 values and fp16 scales."""
    t = torch.from_numpy(_randn(9, (2, 8, 4, 32))).to(torch.bfloat16)
    q, s = L.quantize_kv(t)
    back = L.dequantize_kv(q, s, torch.float32)
    rel = float((back - t.float()).norm() / t.float().norm())
    assert rel < 0.01 and q.dtype == torch.int8 and s.dtype == torch.float16


def test_int8_cache_decode_close_to_fp(qwen):
    """The reference's ``test_int8_cache_decode_close_to_fp``: prefill and
    3 decode steps on one token stream through an fp32 and an int8 cache,
    logits within a 0.05 relative gap; and each int8 step against the
    reference's int8 step on the same weights and tokens."""
    cfg_j, cfg_t, params_j, params_t, toks = qwen
    cq_t = dataclasses.replace(cfg_t, kv_quant=True)
    cq_j = dataclasses.replace(cfg_j, kv_quant=True)
    t16 = toks[:, :16]
    l1, c1 = lm.prefill(params_t, cfg_t, torch.from_numpy(t16), max_seq=32)
    l2, c2 = lm.prefill(params_t, cq_t, torch.from_numpy(t16), max_seq=32)
    lj, cj = jlm.prefill(params_j, cq_j, jnp.asarray(t16), max_seq=32)
    assert c2["k"].dtype == torch.int8 and c2["k_scale"].dtype == \
        torch.float16 and tuple(c2["k_scale"].shape) == \
        tuple(c2["k"].shape[:-1])
    assert set(c2) == set(cj)
    _close(l2.numpy(), lj)
    for key in ("k", "v"):
        # int8 codes: equal but where a value sits at a rounding boundary
        diff = np.abs(c2[key].numpy().astype(np.int32)
                      - np.asarray(cj[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, key
    t = torch.argmax(l1, -1).to(torch.int32)
    for _ in range(3):
        g1, c1 = lm.decode_step(params_t, cfg_t, t, c1)
        g2, c2 = lm.decode_step(params_t, cq_t, t, c2)
        gj, cj = jlm.decode_step(params_j, cq_j, jnp.asarray(t.numpy()), cj)
        rel = float((g1 - g2).norm() / g1.norm())
        assert rel < KV_GAP, rel
        _close(g2.numpy(), gj)
        t = torch.argmax(g1, -1).to(torch.int32)
    assert int(c2["len"]) == 19


def test_int8_packed_serving_cache(qwen):
    """The packed cache under ``kv_quant``: int8 K/V with fp16 scales
    beside them, written slot by slot and decoded with ragged lengths,
    logits within the 0.05 gap of the fp32 packed cache's."""
    _, cfg_t, _, params_t, toks = qwen
    out = {}
    for quant in (False, True):
        cfg = dataclasses.replace(cfg_t, kv_quant=quant)
        ad = lm.serving_adapter(params_t, cfg, max_seq=32, device="cpu")
        packed = ad.init_slots(3)
        lens = torch.tensor([5, 16], dtype=torch.int32)
        _, cache = ad.prefill_fn(torch.from_numpy(toks[:, :16]), lens,
                                 torch.tensor(0))
        for row, slot in ((0, 2), (1, 0)):
            ad.write_slot_fn(packed, cache, torch.tensor(row),
                             torch.tensor(slot))
        if quant:
            assert packed["k"].dtype == torch.int8
            assert packed["v_scale"].dtype == torch.float16
        logits, _ = lm.decode_step(params_t, cfg,
                                   torch.tensor([3, 0, 9], dtype=torch.int32),
                                   packed)
        out[quant] = logits[[0, 2]]
        assert packed["len"].tolist() == [16, 0, 5]
    rel = float((out[True] - out[False]).norm() / out[False].norm())
    assert rel < KV_GAP, rel


def test_kv_quant_refused_where_the_reference_has_no_int8_cache():
    cfg = dataclasses.replace(get_config("zamba2-1.2b").with_reduced(),
                              kv_quant=True)
    with pytest.raises(ValueError, match="kv_quant"):
        lm.init_decode_cache(cfg, 1, 16, "cpu")

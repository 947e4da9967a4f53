"""The port's dense LM against the reference, on the CPU.

A reduced Qwen3 (``with_reduced()``: 2 layers, d_model 64, 4 query and 2
KV heads of width 16, qk-norm, tied embeddings) in float32.  The
reference initialises the parameters; ``from_jax_params`` carries them
over, so both packages run the same weights on the same numpy tokens.

Tolerance: logits within 1e-4 of their largest magnitude, caches within
1e-5 absolute — float32 throughout, differing only in summation order
(XLA and PyTorch reduce matmuls and softmaxes differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params

LOGIT_REL = 1e-4
CACHE_TOL = 1e-5
MAX_SEQ = 32


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_get_config("qwen3-0.6b").with_reduced(dtype="float32")
    cfg_t = get_config("qwen3-0.6b").with_reduced(dtype="float32")
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _close_logits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= LOGIT_REL * scale, (err, scale)


def _close_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=CACHE_TOL, rtol=0, err_msg=key)


def test_configs_resolve_as_in_reference():
    from repro.configs import ARCH_IDS as J_IDS, all_configs as j_all
    assert ARCH_IDS == J_IDS
    for arch, cfg in all_configs().items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_all()[arch])
    for alias in ("qwen3-0.6b", "mamba2-130m", "grok-1-314b"):
        assert dataclasses.asdict(get_config(alias)) == \
            dataclasses.asdict(jax_get_config(alias))


@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_matches_param_count(reduced):
    """The port's parameters have the reference's tree, shapes and count.
    ``param_count`` in the port counts qk-norm as the two [hd] scales
    that exist; the reference's counts ``2 * n_heads * hd`` (ROADMAP
    queue C)."""
    cfg_t = get_config("qwen3-0.6b")
    cfg_j = jax_get_config("qwen3-0.6b")
    if reduced:
        cfg_t, cfg_j = cfg_t.with_reduced(), cfg_j.with_reduced()
        p = lm.init_params(cfg_t, device="cpu")
    else:       # shapes only, nothing allocated
        p = lm.init_params(cfg_t, device="meta")
    shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape),
                            jlm.abstract_params(cfg_j))
    assert shapes_t == shapes_j
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert n == cfg_t.param_count()
    extra = cfg_j.n_layers * 2 * (cfg_j.n_heads - 1) * cfg_j.hd
    assert cfg_j.param_count() == n + extra
    if not reduced:
        assert n == 596_049_920
        assert p["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("reduced", [True, False])
def test_mamba2_init_params_matches_param_count(reduced):
    """Mamba2's tree, shapes and dtypes are the reference's (``A_log``,
    ``D`` and ``dt_bias`` float32 in a bf16 model).  The port's
    ``param_count`` counts ``conv_b`` and ``dt_bias`` ([nh], not [di]);
    the reference's leaves out ``conv_b`` and counts ``dt_bias`` and the
    gate norm as ``di`` together (ROADMAP queue C): 128,983,488 against
    128,939,904 at full width."""
    cfg_t, cfg_j = get_config("mamba2-130m"), jax_get_config("mamba2-130m")
    if reduced:
        cfg_t, cfg_j = cfg_t.with_reduced(), cfg_j.with_reduced()
    p = lm.init_params(cfg_t, device="cpu" if reduced else "meta")
    want = jlm.abstract_params(cfg_j)
    assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)
                                             .split(".")[-1]), p) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert n == cfg_t.param_count()
    s = cfg_j.ssm
    conv_ch = s.d_inner(cfg_j.d_model) + 2 * s.n_groups * s.d_state
    assert cfg_j.param_count() == n - cfg_j.n_layers * (
        conv_ch + s.n_heads(cfg_j.d_model))
    if not reduced:
        assert (n, cfg_j.param_count()) == (128_983_488, 128_939_904)


def test_from_jax_params_keeps_each_leaf_dtype():
    """A bf16 Mamba2 carried over: the matrices arrive as bf16 with the
    reference's bits, ``A_log``, ``D`` and ``dt_bias`` as float32."""
    cfg_j = jax_get_config("mamba2-130m").with_reduced()     # bf16
    params_j = jlm.init_params(cfg_j, jax.random.key(1))
    p = from_jax_params(jax.tree.map(np.asarray, params_j), device="cpu")
    m = p["layers"]["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        assert m[k].dtype == torch.float32, k
        np.testing.assert_array_equal(
            m[k].numpy(), np.asarray(params_j["layers"]["mamba"][k]))
    for k in ("in_proj", "conv_w", "out_proj"):
        assert m[k].dtype == torch.bfloat16, k
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m["in_proj"].float().numpy(),
        np.asarray(params_j["layers"]["mamba"]["in_proj"], np.float32))


def test_init_params_is_seeded():
    cfg = get_config("qwen3-0.6b").with_reduced()
    a = lm.init_params(cfg, 3, device="cpu")
    b = lm.init_params(cfg, 3, device="cpu")
    c = lm.init_params(cfg, 4, device="cpu")
    assert torch.equal(a["layers"]["mlp"]["wg"], b["layers"]["mlp"]["wg"])
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_prefill_and_decode_match_reference(model, attn_impl):
    """Bucketed prefill with ragged true_len (full row, mid row, one
    token, empty row), the caches it fills, then four ragged decode
    steps; the port updates its cache in place."""
    cfg_j, cfg_t, params_j, params_t = model
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_t.vocab, (4, 16)).astype(np.int32)
    true_len = np.array([16, 9, 1, 0], np.int32)
    lj, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), max_seq=MAX_SEQ,
                         true_len=jnp.asarray(true_len))
    lt, ct = lm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                        max_seq=MAX_SEQ, true_len=torch.from_numpy(true_len))
    live = true_len > 0                      # an empty row is discarded
    _close_logits(lt.numpy()[live], np.asarray(lj)[live])
    _close_cache(ct, cj)
    for step in range(4):
        tok = rng.integers(0, cfg_t.vocab, (4,)).astype(np.int32)
        lj, cj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), cj)
        lt, ct = lm.decode_step(params_t, cfg_t, torch.from_numpy(tok), ct)
        _close_logits(lt.numpy(), np.asarray(lj))
    _close_cache(ct, cj)


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_unbucketed_prefill_and_scalar_decode(model, attn_impl):
    """The per-slot path: prefill without true_len (scalar len) and decode
    against the scalar-length cache, sdpa or the decode kernel's plain
    version by attn_impl, up to the capacity clamp."""
    cfg_j, cfg_t, params_j, params_t = model
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    toks = np.random.default_rng(2).integers(0, cfg_t.vocab, (2, 13)) \
        .astype(np.int32)
    lj, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), max_seq=16)
    lt, ct = lm.prefill(params_t, cfg_t, torch.from_numpy(toks), max_seq=16)
    _close_logits(lt.numpy(), np.asarray(lj))
    assert ct["len"].dim() == 0 and int(ct["len"]) == 13
    for t in range(4):                       # the 4th writes at len == 16
        tok = np.array([t, 2 * t], np.int32)
        lj, cj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), cj)
        lt, ct = lm.decode_step(params_t, cfg_t, torch.from_numpy(tok), ct)
        _close_logits(lt.numpy(), np.asarray(lj))
    _close_cache(ct, cj)


def test_write_and_retire_slot_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    toks = np.random.default_rng(3).integers(0, cfg_t.vocab, (2, 8)) \
        .astype(np.int32)
    lens = np.array([8, 5], np.int32)
    _, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), max_seq=MAX_SEQ,
                        true_len=jnp.asarray(lens))
    _, ct = lm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                       max_seq=MAX_SEQ, true_len=torch.from_numpy(lens))
    pj = jlm.init_packed_cache(cfg_j, 3, MAX_SEQ)
    pt = lm.init_packed_cache(cfg_t, 3, MAX_SEQ, "cpu")
    for row, slot in ((0, 2), (1, 0)):
        pj = jlm.write_slot(pj, cj, jnp.int32(row), jnp.int32(slot))
        same = lm.write_slot(pt, ct, np.int32(row), np.int32(slot))
        assert same is pt                     # updated in place
    _close_cache(pt, pj)
    assert pt["len"].tolist() == [5, 0, 8]
    pj = jlm.retire_slot(pj, jnp.int32(2))
    lm.retire_slot(pt, 2)
    _close_cache(pt, pj)
    assert pt["len"].tolist() == [5, 0, 0]


def test_ragged_decode_drops_write_at_capacity(model):
    """A row at len == S_max writes nothing (the reference's out-of-range
    scatter with mode="drop"); its neighbours still write."""
    cfg_j, cfg_t, params_j, params_t = model
    pj = jlm.init_packed_cache(cfg_j, 2, 8)
    pt = lm.init_packed_cache(cfg_t, 2, 8, "cpu")
    pj["len"] = jnp.asarray([8, 3], jnp.int32)
    pt["len"] = torch.tensor([8, 3], dtype=torch.int32)
    tok = np.array([5, 6], np.int32)
    lj, pj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), pj)
    lt, pt2 = lm.decode_step(params_t, cfg_t, torch.from_numpy(tok), pt)
    _close_logits(lt.numpy(), np.asarray(lj))
    _close_cache(pt2, pj)
    assert torch.count_nonzero(pt["k"][:, 0]) == 0
    assert torch.count_nonzero(pt["k"][:, 1, 3]) > 0


def test_sample_tokens_greedy_and_topk1():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 3.0, 0.0]])
    assert lm.sample_tokens(logits).tolist() == [1, 0]   # first max wins
    gen = torch.Generator().manual_seed(0)
    assert lm.sample_tokens(logits[:1], gen, 0.7, top_k=1).tolist() == [1]
    gen = torch.Generator().manual_seed(0)
    draws = lm.sample_tokens(logits[[0] * 200], gen, 1.5, top_k=2)
    assert set(draws.tolist()) <= {0, 1} and draws.dtype == torch.int32


def test_batched_adapter_refuses_the_hybrid_family():
    """Batched serving is not ported for the non-attention-cache families,
    nor is it in the reference: the adapter refuses the hybrid family
    (zamba2, served per slot: ``tests/test_torch_recurrent_audio.py``)
    and a config's family mismatched with its parameters does not slip
    through."""
    cfg = get_config("zamba2-1.2b").with_reduced()
    lm.init_params(cfg, device="cpu")          # the family is ported
    dense = lm.init_params(get_config("qwen3-0.6b").with_reduced(),
                           device="cpu")
    with pytest.raises(ValueError, match="dense.*per-slot"):
        lm.serving_adapter(dense, cfg, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        lm.init_params(dataclasses.replace(cfg, family="rnn"), device="cpu")


def test_batched_adapter_refuses_mamba2_which_serves_per_slot():
    """Mamba2 serves per slot only (recurrent decode): the batched adapter
    refuses it, as the reference's does; prefill fills the per-slot
    cache (states, no K/V) and ``init_decode_cache`` makes its zeros."""
    cfg = get_config("mamba2-130m").with_reduced()
    p = lm.init_params(cfg, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense.*per-slot"):
        lm.serving_adapter(p, cfg, max_seq=16, device="cpu")
    _, cache = lm.prefill(p, cfg, tok, max_seq=16)
    zero = lm.init_decode_cache(cfg, 1, 16, "cpu")
    assert set(cache) == set(zero) == {"len", "ssm", "conv"}
    assert int(cache["len"]) == 4 and cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("attn_impl,causal", [("naive", True),
                                              ("kernel", True),
                                              ("naive", False)])
def test_attention_layer_matches_reference(model, attn_impl, causal):
    """The full-sequence attention layer (projections, qk-norm, RoPE,
    attention, output projection) on layer 0's weights."""
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    cfg_j, cfg_t, params_j, params_t = model
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    x = np.random.default_rng(4).standard_normal((2, 12, cfg_t.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want = jL.attention(jax.tree.map(lambda a: a[0], params_j["layers"])
                        ["attn"], cfg_j, jnp.asarray(x), jnp.asarray(pos),
                        causal=causal)
    with torch.no_grad():
        got = L.attention(lm.layer_params(params_t, 0)["attn"], cfg_t,
                          torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          causal=causal)
    _close_logits(got.numpy(), np.asarray(want))

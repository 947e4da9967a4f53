"""Neural-net building blocks of the LMs, as plain functions on tensors.

The port's counterpart of the reference's ``models/layers.py``: RMSNorm
and LayerNorm, rotary embedding, grouped-query attention with optional
qk-norm and sliding window (full-sequence — naive, chunked online
softmax, the flash kernel, or the score-free measurement stand-in —,
cross-attention and one-token decode against a KV cache, bf16/fp32 or
int8 with per-(position, head) scales), the SwiGLU and two-matrix GELU MLPs, the
token-dropping top-k MoE (scatter and GShard dispatch), the Mamba2 block
(causal conv, chunked SSD) for training and prefill and its one-token
recurrence, and the cross-entropy loss.  Parameters are plain nested
dicts of tensors with the reference's names and layouts — a matrix is
``[in, out]`` and applied as ``x @ W`` — so the reference's parameter
pytree carries over leaf for leaf
(:func:`repro_torch.models.weights.from_jax_params`).

Compute runs in the parameters' dtype with fp32 norms, rotary angles and
softmax, as in the reference.  Unlike the reference, the decode path
writes the new token's K/V into the cache in place (the reference's
arrays are immutable and it relies on buffer donation instead).
"""

from __future__ import annotations

import dataclasses
import fractions
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..dtensor import (is_dtensor, replicate, settle, shard_offset,
                       vocab_pick, whole_heads)
from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
                device) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def _embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
                device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary embedding
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., :, None].float() * inv            # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + RoPE + optional qk-norm + optional sliding window)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _dense_init(gen, d, nh * hd, dtype, device),
         "wk": _dense_init(gen, d, nkv * hd, dtype, device),
         "wv": _dense_init(gen, d, nkv * hd, dtype, device),
         "wo": _dense_init(gen, nh * hd, d, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, rope: bool = True) -> tuple:
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = whole_heads(x @ p["wq"], nh).reshape(B, S, nh, hd)
    k = whole_heads(x @ p["wk"], nkv).reshape(B, S, nkv, hd)
    v = whole_heads(x @ p["wv"], nkv).reshape(B, S, nkv, hd)
    if cfg.qk_norm:                      # qk-norm before RoPE
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset=0, kv_len=None,
         window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, fp32 softmax.

    q: [B, Sq, nh, hd]; k/v: [B, Sk, nkv, hd].  ``q_offset`` is the
    absolute position of q[0] (decode: cache length); ``kv_len`` masks
    cache slots >= kv_len; both may be ints or per-row ``[B]`` tensors.
    """
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    dev = q.device
    qg = q.reshape(B, Sq, nkv, group, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    off = torch.as_tensor(q_offset, dtype=torch.int32,
                          device=dev).reshape(-1, 1, 1)
    qpos = torch.arange(Sq, device=dev)[None, :, None] + off  # [B|1, Sq, 1]
    kpos = torch.arange(Sk, device=dev)[None, None, :]        # [1, 1, Sk]
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=dev).reshape(-1, 1, 1)
        mask = mask & (kpos < kl)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, nh, hd).to(q.dtype)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int] = None,
                 chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV chunks, the
    reference's ``sdpa_chunked`` (``layers.py:164``).

    The flash recurrence in torch ops (a Python loop over KV blocks where
    the reference scans; fp32 running max and sum): the ``[Sq, Sk]``
    score matrix is never materialised whole.  The keys are zero-padded
    to a multiple of ``chunk`` and the padded tail is masked.
    Differentiable through autograd.
    """
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qg = q.reshape(B, Sq, nkv, g, hd).float() / math.sqrt(hd)
    qpos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, nkv, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nkv, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nkv, g, Sq, hd), dtype=torch.float32, device=dev)
    for bi in range(k.shape[1] // chunk):
        kc = k[:, bi * chunk:(bi + 1) * chunk].float()
        vc = v[:, bi * chunk:(bi + 1) * chunk].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc)
        kpos = bi * chunk + torch.arange(chunk, device=dev)[None, :]
        mask = kpos < Sk                                  # padded tail
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                    vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # [B,nkv,g,Sq,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype)


def _noscore_attention(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The reference's measurement stand-in (``layers.py:245``): keeps the
    q/k/v/o projections but computes no scores, ``q + (k + v) / 2`` with
    each KV head repeated over its query group."""
    g = q.shape[2] // k.shape[2]
    return q + 0.5 * torch.repeat_interleave(k + v, g, dim=2)


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, use_kernel: bool,
            noscore: bool = True) -> torch.Tensor:
    """Full-sequence attention routed by ``cfg.attn_impl`` as the
    reference's ``attention`` routes it: ``kernel`` (or ``use_kernel``)
    through the flash kernel, ``chunked`` through :func:`sdpa_chunked`,
    ``noscore`` through :func:`_noscore_attention`, anything else through
    :func:`sdpa`.  ``noscore=False`` is the reference's prefill branch
    (``lm.py:364``), which sends ``noscore`` to :func:`sdpa`."""
    if use_kernel or cfg.attn_impl == "kernel":
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window)
    if cfg.attn_impl == "chunked":
        return sdpa_chunked(q, k, v, causal=causal,
                            window=cfg.sliding_window)
    if cfg.attn_impl == "noscore" and noscore:
        return _noscore_attention(q, k, v)
    return sdpa(q, k, v, causal=causal, window=cfg.sliding_window)


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: Optional[bool] = None,
              kv: Optional[tuple] = None,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence attention (prefill).  ``kv`` overrides k/v (cross-
    attention)."""
    causal = cfg.causal if causal is None else causal
    q, k, v = _qkv(p, cfg, x, positions, rope=kv is None)
    if kv is not None:
        k, v = kv
    out = _attend(cfg, q, k, v, causal=causal, use_kernel=use_kernel)
    B, S = x.shape[:2]
    return settle(out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"])


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             cache_len: torch.Tensor, layer: Optional[int] = None) -> None:
    """Write the one-token update ``new[B, 1, n, ...]`` into ``cache[B,
    S_max, n, ...]`` in place, at each row's length (K/V rows ``[n,
    hd]``, or an int8 cache's scales ``[n]``).  With ``layer``, ``cache``
    is the stacked ``[L, B, S_max, ...]`` leaf and the write goes to its
    layer ``layer`` by indexing the stacked tensor itself: no write
    through a view, so a compiled step updates the cache in place where a
    view's write would be a copy of the whole leaf.

    A ``[B]`` length is the ragged path: only the B rows are touched, and
    a row whose length equals S_max writes nothing (the capacity stop;
    the reference's out-of-range scatter with ``mode="drop"``).  A scalar
    length writes the same position for every row, clamped to the last
    one as ``dynamic_update_slice`` clamps it.  No host sync either way.
    """
    if is_dtensor(cache):
        return _write_kv_shards(cache, new, cache_len, layer)
    B, S = new.shape[0], cache.shape[1 if layer is None else 2]
    new = new[:, 0].to(cache.dtype)
    rows = torch.arange(B, device=cache.device)
    pos = cache_len.clamp(max=S - 1).long().expand(B)
    idx = (rows, pos) if layer is None else \
        (torch.full_like(rows, layer), rows, pos)
    if cache_len.dim() == 1:
        keep = (cache_len >= S).reshape(-1, *([1] * (new.dim() - 1)))
        new = torch.where(keep, cache[idx], new)
    cache.index_put_(idx, new)


def _write_kv_shards(cache, new, cache_len, layer) -> None:
    """:func:`write_kv` into a sharded cache (a DTensor): each rank writes
    its own shard in place.  ``new`` is laid out as the cache's batch and
    head dims are, a ``[B]`` length as its batch; a rank whose shard of
    the sequence does not hold a row's position writes nothing there."""
    from torch.distributed.tensor import Replicate, Shard
    off = 0 if layer is None else 1        # cache dims: [L,] B, S, n, ...
    mesh, pl = cache.device_mesh, cache.placements

    def moved(p):           # a cache placement as `new`'s [B, 1, n, ...]
        if not isinstance(p, Shard) or p.dim in (off + 1, off - 1):
            return Replicate()
        return Shard(p.dim - off)
    new_l = new.redistribute(mesh, [moved(p) for p in pl]).to_local() \
        if is_dtensor(new) else new
    if cache_len.dim() == 1:
        cl = cache_len.redistribute(
            mesh, [Shard(0) if isinstance(p, Shard) and p.dim == off
                   else Replicate() for p in pl]) \
            if is_dtensor(cache_len) else cache_len
    else:
        cl = replicate(cache_len)
    cl = cl.to_local() if is_dtensor(cl) else cl
    local = cache.to_local()
    S, s0 = cache.shape[off + 1], shard_offset(cache, off + 1)
    pos = cl.clamp(max=S - 1).long().expand(new_l.shape[0]) - s0
    mine = (pos >= 0) & (pos < local.shape[off + 1])
    if cl.dim() == 1:
        mine = mine & (cl < S)
    pos = pos.clamp(0, local.shape[off + 1] - 1)
    rows = torch.arange(new_l.shape[0], device=local.device)
    idx = (rows, pos) if layer is None else \
        (torch.full_like(rows, layer), rows, pos)
    val = new_l[:, 0].to(local.dtype)
    keep = ~mine.reshape(-1, *([1] * (val.dim() - 1)))
    local.index_put_(idx, torch.where(keep, local[idx], val))


def quantize_kv(t: torch.Tensor) -> tuple:
    """Per-(position, head) symmetric int8 quantization of K or V, the
    reference's ``quantize_kv`` (``layers.py:256``).

    t: [B, S, n, hd] -> (int8 values, fp16 scales [B, S, n]).  The scale
    is ``max(|t|, 1e-6) / 127`` in float32 and the values round half to
    even, as ``jnp.round`` does, so equal float32 inputs give equal bits.
    """
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     layer: Optional[int] = None) -> torch.Tensor:
    """One-token decode against a KV cache, updating the cache in place.

    x: [B, 1, d]; cache_k/v: [B, S_max, nkv, hd], or with ``layer`` the
    stacked ``[L, B, S_max, nkv, hd]`` leaves whose layer ``layer`` this
    is (and the scales likewise); cache_len: [] or [B] int32 on x's
    device.  Returns out [B, 1, d]; the new token's K/V are written into
    ``cache_k``/``cache_v`` at each row's length (:func:`write_kv`).

    Routing as the reference's ``layers.py:328``: with no sliding window,
    a ragged ``[B]`` length (the packed serving batch) or
    ``attn_impl="kernel"`` takes the flash-decode kernel; otherwise
    :func:`sdpa`.  With ``cfg.kv_quant`` the caches are int8 with fp16
    scales ``k_scale``/``v_scale`` ``[B, S_max, nkv]``: the new K/V are
    quantized (:func:`quantize_kv`) and written with their scales, and
    the dequantized cache goes through :func:`sdpa`, as in the reference
    (no kernel).  A row at length 0 is a dead slot — its output is
    finite and the caller masks its token.
    """
    B = x.shape[0]
    ragged = cache_len.dim() == 1
    positions = cache_len.reshape(-1, 1).expand(B, 1)
    q, k, v = _qkv(p, cfg, x, positions)
    def at(t):
        return t if layer is None else t[layer]
    if cfg.kv_quant:
        (qk, sk), (qv, sv) = quantize_kv(k), quantize_kv(v)
        for leaf, val in ((cache_k, qk), (cache_v, qv), (k_scale, sk),
                          (v_scale, sv)):
            write_kv(leaf, val, cache_len, layer)
        out = sdpa(q, dequantize_kv(at(cache_k), at(k_scale), q.dtype),
                   dequantize_kv(at(cache_v), at(v_scale), q.dtype),
                   causal=False, q_offset=cache_len, kv_len=cache_len + 1,
                   window=cfg.sliding_window)
        return settle(out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"])
    write_kv(cache_k, k, cache_len, layer)
    write_kv(cache_v, v, cache_len, layer)
    cache_k, cache_v = at(cache_k), at(cache_v)
    if cfg.sliding_window is None and (ragged or cfg.attn_impl == "kernel"):
        from ..kernels import ops as kops
        lens = cache_len + 1 if ragged else (cache_len + 1).expand(B)
        out = kops.decode_attention(q[:, 0], cache_k, cache_v,
                                    lens)[:, None]
    else:
        out = sdpa(q, cache_k, cache_v, causal=False, q_offset=cache_len,
                   kv_len=cache_len + 1, window=cfg.sliding_window)
    return settle(out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"])


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                         device) -> dict:
    """Cross-attention's parameters: full multi-head (whisper's MHA), no
    qk-norm, the shapes of :func:`init_attention`."""
    return init_attention(gen, dataclasses.replace(
        cfg, n_kv_heads=cfg.n_heads, qk_norm=False), dtype, device)


# ---------------------------------------------------------------------------
# MLPs (SwiGLU; whisper's two-matrix GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, device) -> dict:
    return {"wg": _dense_init(gen, d, ff, dtype, device),
            "wu": _dense_init(gen, d, ff, dtype, device),
            "wd": _dense_init(gen, ff, d, dtype, device)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return settle((F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"])


def init_mlp2(gen: torch.Generator, d: int, ff: int, dtype, device) -> dict:
    """Two-matrix GELU MLP (whisper-style)."""
    return {"w1": _dense_init(gen, d, ff, dtype, device),
            "b1": torch.zeros((ff,), dtype=dtype, device=device),
            "w2": _dense_init(gen, ff, d, dtype, device),
            "b2": torch.zeros((d,), dtype=dtype, device=device)}


def mlp2(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x W1 + b1) W2 + b2`` with GELU in its tanh form: the
    reference's ``jax.nn.gelu`` defaults to ``approximate=True``."""
    return settle(F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
                  @ p["w2"]) + p["b2"]


# ---------------------------------------------------------------------------
# Mixture of Experts with capacity-based token dispatch (GShard/Switch style)
# ---------------------------------------------------------------------------

MOE_IMPLS = ("scatter", "scatter_fast", "dense")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The router (float32 whatever ``dtype`` is, as in the reference) and
    ``E`` stacked SwiGLU experts."""
    m = cfg.moe
    d, E, ff = cfg.d_model, m.n_experts, m.d_ff_expert

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device)
        return (w * scale).to(dtype)
    return {"router": _dense_init(gen, d, E, torch.float32, device),
            "wg": normal((E, d, ff), 1.0 / math.sqrt(d)),
            "wu": normal((E, d, ff), 1.0 / math.sqrt(d)),
            "wd": normal((E, ff, d), 1.0 / math.sqrt(ff))}


def moe_capacity(tokens: int, cfg: ModelConfig,
                 capacity_factor: float = 1.25) -> int:
    """Slots an expert has for ``tokens`` tokens (of a group):
    ``max(ceil(tokens * K / E * factor), 4)`` (symbolic under
    ``torch.export`` when ``tokens`` is: no guard on its value)."""
    m = cfg.moe
    if isinstance(tokens, int):
        return max(int(math.ceil(tokens * m.top_k / m.n_experts
                                 * capacity_factor)), 4)
    # a symbolic count: the same ceiling in integers (exact where the
    # float form is, e.g. a power-of-two expert count)
    f = fractions.Fraction(capacity_factor).limit_denominator(1 << 16)
    den = m.n_experts * f.denominator
    return torch.sym_max((tokens * m.top_k * f.numerator + den - 1) // den,
                         4)


def moe_router(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """Router of :func:`moe_layer`, all float32: ``(probs [T, E], topw
    [T, K] renormalised, tope [T, K] in descending probability, aux)``,
    ``aux`` the Switch load-balancing loss (eq. 4) times
    ``load_balance_coef``."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, tope = torch.topk(probs, K, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(tope, E).float().sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum() * m.load_balance_coef
    return probs, topw, tope, aux


def moe_slots(tope: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k) copy's slot in its expert: the copies of the same
    expert before it, in (token, k) order (an exclusive prefix sum over
    the second-to-last axis pair).  tope: [..., T, K] -> [..., T, K]."""
    *lead, T, K = tope.shape
    # a prefix sum over tokens split across ranks (a DTensor) needs every
    # token: the expert choices are gathered first
    tope = replicate(tope)
    oh = F.one_hot(tope.reshape(*lead, T * K), n_experts)
    pos = oh.cumsum(dim=-2) - oh
    return pos.gather(-1, tope.reshape(*lead, T * K, 1)) \
        .reshape(*lead, T, K)


def moe_dispatch(x: torch.Tensor, tope: torch.Tensor, n_experts: int,
                 capacity: int) -> tuple:
    """The scatter dispatch: ``(disp [E, C, d], slot [T, K], keep [T,
    K])``; ``disp[e, c]`` is the token whose copy took slot ``c`` of
    expert ``e`` (zeros where none did).  Copies past capacity are
    dropped; no host sync."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    T, K = tope.shape
    slot = moe_slots(tope, n_experts)
    keep = slot < capacity
    # a dropped copy writes a spare row past the last slot, cut off below,
    # so every kept (expert, slot) is written by exactly one copy
    disp = xt.new_zeros((n_experts, capacity + 1, d))
    disp[tope.reshape(-1), torch.where(keep, slot, capacity).reshape(-1)] = \
        xt[:, None].expand(T, K, d).reshape(T * K, d)
    return disp[:, :capacity], slot, keep


def _experts(p: dict, disp: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: ``[..., E, C, d]``."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", disp, p["wg"])) * \
        torch.einsum("...ecd,edf->...ecf", disp, p["wu"])
    return torch.einsum("...ecf,efd->...ecd", h, p["wd"])


def moe_layer(p: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float = 1.25) -> tuple:
    """Token-dropping top-k MoE, the reference's ``moe_layer``
    (``src/repro/models/layers.py:398``).  Returns ``(y, aux)``.

    ``cfg.moe_impl``: ``scatter`` and ``scatter_fast`` are one function
    here (the reference's two differ only in how XLA lowers the prefix
    sum; ``torch.cumsum`` is both): every (token, k) copy takes the next
    slot of its expert over all ``T = B * S`` tokens, pad tokens and dead
    serving slots included, and copies past ``C = max(ceil(T K / E *
    factor), 4)`` are dropped.  ``dense`` is the GShard einsum dispatch
    with capacity per batch row (:func:`_moe_dense_grouped`).  The router,
    the top-k weights and ``aux`` are float32; a token's K expert outputs
    are summed in float32 in k order.
    """
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl={cfg.moe_impl!r}: the port takes "
                         f"{', '.join(MOE_IMPLS)}")
    B, S, d = x.shape
    probs, topw, tope, aux = moe_router(p, cfg, x)
    if cfg.moe_impl == "dense":
        return _moe_dense_grouped(p, cfg, x, probs, aux, capacity_factor)
    T, K = tope.shape
    C = moe_capacity(T, cfg, capacity_factor)
    disp, slot, keep = moe_dispatch(x, tope, cfg.moe.n_experts, C)
    eo = _experts(p, disp)                                   # [E, C, d]
    gathered = eo[tope, slot.clamp(max=C - 1)]               # [T, K, d]
    w = torch.where(keep, topw, 0.0)
    y = (gathered.float() * w[..., None]).sum(dim=1)
    return settle(y.reshape(B, S, d).to(x.dtype)), aux


def moe_dense_masks(cfg: ModelConfig, probs: torch.Tensor, B: int, S: int,
                    capacity_factor: float = 1.25) -> tuple:
    """The grouped dispatch's masks: ``(dispatch [B, S, E, C] of 0/1,
    combine [B, S, E, C] float32 weights)``, capacity ``C`` per batch
    row."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    C = moe_capacity(S, cfg, capacity_factor)
    topw, tope = torch.topk(probs.reshape(B, S, E), K, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    slot = moe_slots(tope, E)                                # [B, S, K]
    keep = slot < C
    oh = F.one_hot(tope, E).float()                          # [B, S, K, E]
    oh_c = F.one_hot(slot.clamp(max=C - 1), C).float()       # [B, S, K, C]
    w = torch.where(keep, topw, 0.0)
    combine = torch.einsum("bske,bskc,bsk->bsec", oh, oh_c, w)
    return combine > 0, combine


def _moe_dense_grouped(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       probs: torch.Tensor, aux: torch.Tensor,
                       capacity_factor: float) -> tuple:
    """GShard einsum dispatch grouped by batch row (the reference's
    ``_moe_dense_grouped``, ``layers.py:463``, arXiv:2006.16668)."""
    B, S, _ = x.shape
    dispatch, combine = moe_dense_masks(cfg, probs, B, S, capacity_factor)
    disp = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    eo = _experts(p, disp)                                   # [B, E, C, d]
    y = torch.einsum("bsec,becd->bsd", combine, eo.float())
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Mamba2 / SSD (state-space duality)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> dict:
    """One Mamba2 block's parameters.  ``A_log``, ``D`` and ``dt_bias``
    stay float32 whatever ``dtype`` is, as in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    G, N = s.n_groups, s.d_state
    conv_ch = di + 2 * G * N
    f32 = torch.float32
    conv_w = torch.randn((s.conv_width, conv_ch), generator=gen,
                         device=device) * 0.1
    return {
        # fused input projection: [z | x | B | C | dt], widths di, di,
        # G*N, G*N, nh
        "in_proj": _dense_init(gen, d, 2 * di + 2 * G * N + nh, dtype,
                               device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": init_rmsnorm(di, dtype, device),
        "out_proj": _dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv1d + SiLU.  x: [B, S, C]; w: [W, C].  Returns
    (y, new conv state = the last W-1 inputs)."""
    W, S = w.shape[0], x.shape[1]
    pad = state if state is not None else x.new_zeros(
        (x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                 # [B, S+W-1, C]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    return F.silu(y), (xp[:, -(W - 1):] if W > 1 else pad)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False) -> tuple:
    """SSD (Mamba-2) sequence mixing.

    x: [B, S, H, P]; dt: [B, S, H] (softplus-ed); A: [H] (negative);
    Bm/Cm: [B, S, G, N] (G groups broadcast to H); D: [H].  Returns
    (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] float32).

    ``use_kernel`` goes through :func:`repro_torch.kernels.ops.ssd_scan`
    (the CUDA kernel on a card tensor).  Otherwise the chunked algorithm
    (arXiv:2405.21060 section 6) runs in differentiable torch ops, fp32
    state math: intra-chunk quadratic attention with a decay mask plus
    the inter-chunk state recurrence.  This is also what the kernel op's
    backward differentiates.
    """
    if use_kernel:
        from ..kernels import ops as kops
        return kops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                             init_state=init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk
    if pad:
        # dt = 0 on padded steps: exp(0 * A) = 1 decay and zero input, so
        # padding is state-neutral and trimming y afterwards is exact
        y, final = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, 0, 0, pad)),
            D, chunk, init_state)
        return y[:, :S], final
    nc, rep = S // chunk, H // G
    xf = x.float().reshape(B, nc, chunk, H, P)
    dtf = dt.float().reshape(B, nc, chunk, H)
    Bf = Bm.float().repeat_interleave(rep, dim=2) \
        .reshape(B, nc, chunk, H, N)
    Cf = Cm.float().repeat_interleave(rep, dim=2) \
        .reshape(B, nc, chunk, H, N)

    cum = (dtf * A).cumsum(dim=2)                  # [B,nc,Q,H], inclusive
    # decay from step j (exclusive) to step i (inclusive), i >= j; the
    # exponent is masked, not the exp, so masked entries never produce
    # inf forward or NaN backward
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(tril, diff, float("-inf")))

    xdt = xf * dtf[..., None]
    # intra-chunk: y[i] = sum_{j<=i} C_i . B_j decay(i, j) x_j dt_j
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xdt)
    # chunk summary states: sum_j decay(end..j) B_j x_j dt_j
    tail = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_state = torch.einsum("bcjhn,bcjhp->bchpn", Bf,
                               xdt * tail[..., None])
    # inter-chunk recurrence over the chunk states
    total = torch.exp(cum[:, :, -1, :])            # [B, nc, H]
    state = init_state.float() if init_state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)                     # state entering chunk c
        state = state * total[:, c, :, None, None] + chunk_state[:, c]
    # inter-chunk contribution: y[i] += C_i . (decay(start..i) * state_in)
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Cf * torch.exp(cum)[..., None],
                           torch.stack(entering, dim=1))
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), state


def mamba2_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   use_kernel: bool = False) -> tuple:
    """Full Mamba2 block (train/prefill): in_proj -> conv -> SSD -> gate
    -> out_proj.  x: [B, S, d].  Returns ``(y [B, S, d], ssm_state [B,
    H, P, N] float32, conv_state [B, W-1, conv_ch])``, the states a decode
    continues from (the reference's ``lm._mamba_prefill``)."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    G, N = s.n_groups, s.d_state
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"]
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, nh],
                                     dim=-1)
    conv_out, conv_state = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                                        p["conv_w"], p["conv_b"])
    xin, Bc, Cc = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xin.reshape(B, S, nh, s.head_dim), dtv, A,
                           Bc.reshape(B, S, G, N), Cc.reshape(B, S, G, N),
                           p["D"], chunk=min(s.chunk, S),
                           use_kernel=use_kernel)
    y = rms_norm(p["norm"], y.reshape(B, S, di) * F.silu(z), cfg.norm_eps)
    return settle(y @ p["out_proj"]), state.float(), conv_state


def mamba2_layer(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """Full Mamba2 block's output alone (:func:`mamba2_prefill`)."""
    return mamba2_prefill(p, cfg, x, use_kernel)[0]


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor) -> tuple:
    """Single-token recurrent step of the Mamba2 block (the reference's
    ``layers.py:657``; no kernel there, none here).  x: [B, 1, d];
    ssm_state: [B, H, P, N] float32; conv_state: [B, W-1, conv_ch].
    Returns ``(y [B, 1, d], new ssm_state, new conv_state)``, new tensors
    (the caller decides where they go)."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    G, N = s.n_groups, s.d_state
    B = x.shape[0]
    z, xin, Bc, Cc, dt = torch.split(x @ p["in_proj"],
                                     [di, di, G * N, G * N, nh], dim=-1)
    conv_out, new_conv = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                                      p["conv_w"], p["conv_b"],
                                      state=conv_state)
    xin, Bc, Cc = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])        # [B, nh]
    dA = torch.exp(dtv * -torch.exp(p["A_log"]))             # [B, nh]
    xh = xin[:, 0].reshape(B, nh, s.head_dim).float()
    rep = nh // G
    Bh = Bc[:, 0].reshape(B, G, N).float().repeat_interleave(rep, dim=1)
    Ch = Cc[:, 0].reshape(B, G, N).float().repeat_interleave(rep, dim=1)
    upd = (dtv[..., None] * xh)[..., None] * Bh[:, :, None, :]  # [B,nh,P,N]
    new_state = ssm_state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return settle(y @ p["out_proj"]), new_state.to(ssm_state.dtype), \
        new_conv


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy with optional z-loss, fp32.

    The log-sum-exp is a max and a sum, the form that also runs on logits
    sharded on the vocab (a DTensor, the sharded step's ``lm_head``): each
    is a partial reduced by a small all-reduce (:func:`settle`; left to
    DTensor, the sum came back split on the sequence and the backward
    gathered the logits to match), and the label's logit comes from the
    shard that holds it (:func:`repro_torch.dtensor.vocab_pick`), so the
    logits themselves are never gathered."""
    lf = logits.float()
    m = settle(lf.detach().amax(dim=-1, keepdim=True))
    lse = (m + torch.log(settle(torch.exp(lf - m).sum(dim=-1,
                                                      keepdim=True))))[..., 0]
    ll = vocab_pick(lf, labels.long())
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss

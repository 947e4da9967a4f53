"""Neural-net building blocks of the dense LM, as plain functions on
tensors.

The port's counterpart of the dense subset of the reference's
``models/layers.py``: RMSNorm, rotary embedding, grouped-query attention
with optional qk-norm and sliding window (full-sequence and one-token
decode against a KV cache), and the SwiGLU MLP.  Parameters are plain
nested dicts of tensors with the reference's names and layouts — a
matrix is ``[in, out]`` and applied as ``x @ W`` — so the reference's
parameter pytree carries over leaf for leaf
(:func:`repro_torch.models.weights.from_jax_params`).

Compute runs in the parameters' dtype with fp32 norms, rotary angles and
softmax, as in the reference.  Unlike the reference, the decode path
writes the new token's K/V into the cache in place (the reference's
arrays are immutable and it relies on buffer donation instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
    q = (x @ p["wq"]).reshape(B, S, nh, hd)
    k = (x @ p["wk"]).reshape(B, S, nkv, hd)
    v = (x @ p["wv"]).reshape(B, S, nkv, hd)
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


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool,
            use_kernel: bool) -> torch.Tensor:
    """Full-sequence attention routed by ``cfg.attn_impl``: ``kernel``
    (or ``use_kernel``) goes through the flash kernel, ``naive`` through
    :func:`sdpa`; the reference's ``chunked``/``noscore`` measurement
    variants are not ported yet."""
    if use_kernel or cfg.attn_impl == "kernel":
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window)
    if cfg.attn_impl == "naive":
        return sdpa(q, k, v, causal=causal, window=cfg.sliding_window)
    raise NotImplementedError(
        f"attn_impl={cfg.attn_impl!r} is not ported yet (the port keeps "
        f"'naive' and 'kernel')")


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
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             cache_len: torch.Tensor) -> None:
    """Write the one-token update ``new[B, 1, n, hd]`` into ``cache[B,
    S_max, n, hd]`` in place, at each row's length.

    A ``[B]`` length is the ragged path: only the B rows are touched, and
    a row whose length equals S_max writes nothing (the capacity stop;
    the reference's out-of-range scatter with ``mode="drop"``).  A scalar
    length writes the same position for every row, clamped to the last
    one as ``dynamic_update_slice`` clamps it.  No host sync either way.
    """
    S = cache.shape[1]
    new = new[:, 0].to(cache.dtype)
    if cache_len.dim() == 0:
        pos = cache_len.clamp(max=S - 1).reshape(1).long()
        cache.index_copy_(1, pos, new[:, None])
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = cache_len.clamp(max=S - 1).long()
    keep = (cache_len >= S).reshape(-1, *([1] * (new.dim() - 1)))
    cache[rows, pos] = torch.where(keep, cache[rows, pos], new)


def attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One-token decode against a KV cache, updating the cache in place.

    x: [B, 1, d]; cache_k/v: [B, S_max, nkv, hd]; cache_len: [] or [B]
    int32 on x's device.  Returns out [B, 1, d]; the new token's K/V are
    written into ``cache_k``/``cache_v`` at each row's length
    (:func:`write_kv`).

    Routing as the reference's ``layers.py:328``: with no sliding window,
    a ragged ``[B]`` length (the packed serving batch) or
    ``attn_impl="kernel"`` takes the flash-decode kernel; otherwise
    :func:`sdpa`.  A row at length 0 is a dead slot — its output is
    finite and the caller masks its token.
    """
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) is not "
                                  "ported yet")
    B = x.shape[0]
    ragged = cache_len.dim() == 1
    positions = cache_len.reshape(-1, 1).expand(B, 1)
    q, k, v = _qkv(p, cfg, x, positions)
    write_kv(cache_k, k, cache_len)
    write_kv(cache_v, v, cache_len)
    if cfg.sliding_window is None and (ragged or cfg.attn_impl == "kernel"):
        from ..kernels import ops as kops
        lens = cache_len + 1 if ragged else (cache_len + 1).expand(B)
        out = kops.decode_attention(q[:, 0], cache_k, cache_v,
                                    lens)[:, None]
    else:
        out = sdpa(q, cache_k, cache_v, causal=False, q_offset=cache_len,
                   kv_len=cache_len + 1, window=cfg.sliding_window)
    return out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, device) -> dict:
    return {"wg": _dense_init(gen, d, ff, dtype, device),
            "wu": _dense_init(gen, d, ff, dtype, device),
            "wd": _dense_init(gen, ff, d, dtype, device)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]

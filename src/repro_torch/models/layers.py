"""Neural-net building blocks of the dense and SSM LMs, as plain
functions on tensors.

The port's counterpart of the dense and Mamba2 subsets of the reference's
``models/layers.py``: RMSNorm, rotary embedding, grouped-query attention
with optional qk-norm and sliding window (full-sequence and one-token
decode against a KV cache), the SwiGLU MLP, the Mamba2 block (causal
conv, chunked SSD) for training and prefill, and the cross-entropy
loss.  Parameters are plain nested dicts of tensors with the reference's
names and layouts — a matrix is ``[in, out]`` and applied as ``x @ W`` —
so the reference's parameter pytree carries over leaf for leaf
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


def mamba2_layer(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """Full Mamba2 block (train/prefill): in_proj -> conv -> SSD -> gate
    -> out_proj.  x: [B, S, d]."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    G, N = s.n_groups, s.d_state
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"]
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, nh],
                                     dim=-1)
    conv_out, _ = _causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                               p["conv_w"], p["conv_b"])
    xin, Bc, Cc = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(xin.reshape(B, S, nh, s.head_dim), dtv, A,
                       Bc.reshape(B, S, G, N), Cc.reshape(B, S, G, N),
                       p["D"], chunk=min(s.chunk, S), use_kernel=use_kernel)
    y = rms_norm(p["norm"], y.reshape(B, S, di) * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy with optional z-loss, fp32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss

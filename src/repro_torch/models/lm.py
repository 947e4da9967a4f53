"""LM assembly: init, forward, loss, prefill and decode for every family
(dense, vlm, moe, ssm, hybrid, audio), and packed-slot serving for the
attention-cache families (dense, vlm, moe).

The port's counterpart of the reference's ``models/lm.py``.  Parameters
keep the reference's nested-dict layout with per-layer leaves stacked
along a leading ``[L, ...]`` axis (the hybrid family's one shared block
has no layer axis); the forward passes loop over layers in Python
(PyTorch runs eagerly; the reference's ``lax.scan`` and ``lax.cond``
have nothing to save here), and ``remat`` checkpoints each layer
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).
The vlm family takes
its precomputed patch embeddings as ``extra={"patches": [B, n_patches,
d_patch]}`` (serving is text-only, as in the reference), the audio
family its encoder's frame embeddings as ``extra={"frames": [B,
n_audio_ctx, d_model]}``; the moe family adds its load-balancing loss to
``forward``'s ``aux``.  The recurrent families (ssm, hybrid) serve
through the engine's per-slot path: a bucket's pads would enter their
state, so :func:`serving_adapter` refuses them, as the reference's does.

In-place updates (the reference's arrays are immutable; it donates
buffers instead): :func:`decode_step` writes each new token's K/V (int8
with fp16 scales under ``cfg.kv_quant``), and the recurrent families'
new SSM and conv states, into the cache it is given, and
:func:`write_slot` / :func:`retire_slot` update the packed cache they
are given and return it.  ``cfg.attn_impl`` takes ``naive``,
``chunked``, ``kernel`` and ``noscore`` as the reference's does.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`init_params`, :func:`serving_adapter`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.synth import resolve_device
from ..dtensor import is_dtensor, rows_like, vocab_embedding, vocab_logits
from . import layers as L
from .config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.dtype`` (a name, as in the reference) as a ``torch.dtype``."""
    return _DTYPES[cfg.dtype]


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
# packed-slot batched serving (serving_adapter): right-padded buckets are
# exact only where causal attention hides the pads
BATCHED_FAMILIES = ("dense", "vlm", "moe")
# served one slot a call (the engine's per-slot path): recurrent state
PER_SLOT_FAMILIES = ("ssm", "hybrid")


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer ``i``'s parameters of the stack ``params[key]`` (the decoder
    layers, or the audio family's ``enc_layers``): views into the stacked
    ``[L, ...]`` leaves."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params[key])


def _shared_at(cfg: ModelConfig, i: int) -> bool:
    """The hybrid family's shared block follows layers ``period - 1``,
    ``2 period - 1``, ...; its cache block is ``i // period``."""
    return cfg.family == "hybrid" and \
        i % cfg.hybrid.attn_period == cfg.hybrid.attn_period - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the card; raises without one).  Same distributions as the
    reference's ``init_params`` (normal / sqrt(fan_in) matrices, 0.02
    embedding, 0.01 audio positions, unit norms, zero biases; Mamba2's
    float32 ``A_log``/``D``/``dt_bias`` and the MoE router's float32) but
    not the same numbers: parity tests carry the reference's parameters
    over with :func:`repro_torch.models.weights.from_jax_params`."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    # a meta tensor has no values to draw, nor a generator to draw them
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    d, n = cfg.d_model, cfg.n_layers
    p: dict = {"embed": L._embed_init(gen, cfg.vocab, d, dt, dev),
               "final_norm": L.init_rmsnorm(d, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L._dense_init(gen, d, cfg.vocab, dt, dev)
    if cfg.family in ("ssm", "hybrid"):
        layers = [{"norm": L.init_rmsnorm(d, dt, dev),
                   "mamba": L.init_mamba2(gen, cfg, dt, dev)}
                  for _ in range(n)]
    elif cfg.family == "audio":
        full = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)
        layers = [{"attn_norm": L.init_layernorm(d, dt, dev),
                   "attn": L.init_attention(gen, full, dt, dev),
                   "xattn_norm": L.init_layernorm(d, dt, dev),
                   "xattn": L.init_cross_attention(gen, cfg, dt, dev),
                   "mlp_norm": L.init_layernorm(d, dt, dev),
                   "mlp": L.init_mlp2(gen, d, cfg.d_ff, dt, dev)}
                  for _ in range(n)]
        enc = [{"attn_norm": L.init_layernorm(d, dt, dev),
                "attn": L.init_attention(gen, full, dt, dev),
                "mlp_norm": L.init_layernorm(d, dt, dev),
                "mlp": L.init_mlp2(gen, d, cfg.d_ff, dt, dev)}
               for _ in range(cfg.encdec.n_encoder_layers)]
    else:       # dense, vlm: a SwiGLU MLP; moe: the experts in its place
        moe = cfg.family == "moe"
        layers = [{"attn_norm": L.init_rmsnorm(d, dt, dev),
                   "attn": L.init_attention(gen, cfg, dt, dev),
                   "mlp_norm": L.init_rmsnorm(d, dt, dev),
                   "moe" if moe else "mlp":
                       L.init_moe(gen, cfg, dt, dev) if moe else
                       L.init_mlp(gen, d, cfg.d_ff, dt, dev)}
                  for _ in range(n)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)
    p["layers"] = stack(*layers)
    if cfg.family == "hybrid":       # ONE set of weights, many call sites
        p["shared_attn"] = {"attn_norm": L.init_rmsnorm(d, dt, dev),
                            "attn": L.init_attention(gen, cfg, dt, dev),
                            "mlp_norm": L.init_rmsnorm(d, dt, dev),
                            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, dev)}
    if cfg.family == "audio":
        p["enc_layers"] = stack(*enc)
        pos = torch.randn((cfg.encdec.n_audio_ctx, d), generator=gen,
                          device=dev)
        p["enc_pos"] = (pos * 0.01).to(dt)
        p["enc_final_norm"] = L.init_layernorm(d, dt, dev)
    if cfg.vlm is not None:
        p["patch_proj"] = L._dense_init(gen, cfg.vlm.d_patch, d, dt, dev)
    return p


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           extra: Optional[dict]) -> torch.Tensor:
    """Token embeddings ``[B, S, d]``; for the vlm family with
    ``extra["patches"]`` ``[B, P, d_patch]``, ``patches @ patch_proj``
    over the first ``min(n_patches, S, P)`` positions."""
    h = vocab_embedding(tokens.long(), params["embed"])
    if cfg.vlm is not None and extra and "patches" in extra:
        pe = (extra["patches"] @ params["patch_proj"]).to(h.dtype)
        n = min(cfg.vlm.n_patches, h.shape[1], pe.shape[1])
        h = torch.cat([pe[:, :n], h[:, n:]], dim=1)
    return h


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> tuple:
    """The block's feed-forward half on ``h`` (residual not added):
    ``(y, aux)``, the MoE's load-balancing term or ``None``."""
    x = L.rms_norm(lp["mlp_norm"], h, cfg.norm_eps)
    if cfg.family == "moe":
        return L.moe_layer(lp["moe"], cfg, x)
    return L.mlp(lp["mlp"], x), None


def _attn_block(lp: dict, cfg: ModelConfig, h: torch.Tensor, positions,
                use_kernel: bool) -> tuple:
    """A pre-norm attention and feed-forward block (a dense, vlm or moe
    layer; the hybrid family's shared block): ``(h, aux)``."""
    h = h + L.attention(lp["attn"], cfg,
                        L.rms_norm(lp["attn_norm"], h, cfg.norm_eps),
                        positions, use_kernel=use_kernel)
    y, aux = _ffn(lp, cfg, h)
    return h + y, aux


def _frames(cfg: ModelConfig, extra: Optional[dict]) -> torch.Tensor:
    if not extra or "frames" not in extra:
        raise ValueError(
            f"{cfg.name}: the audio family needs extra['frames'] [B, "
            f"n_audio_ctx, d_model], its encoder's input")
    return extra["frames"]


def _encode_audio(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  use_kernel: bool = False) -> torch.Tensor:
    """Whisper's encoder over precomputed (stub) frame embeddings
    ``[B, Ta, d]``: learned positions, non-causal pre-LayerNorm blocks, a
    final LayerNorm."""
    B, Ta, _ = frames.shape
    eps = cfg.norm_eps
    h = frames.to(torch_dtype(cfg)) + params["enc_pos"][None, :Ta]
    positions = torch.arange(Ta, device=h.device).expand(B, Ta)
    for i in range(cfg.encdec.n_encoder_layers):
        lp = layer_params(params, i, "enc_layers")
        h = h + L.attention(lp["attn"], cfg,
                            L.layer_norm(lp["attn_norm"], h, eps),
                            positions, causal=False, use_kernel=use_kernel)
        h = h + L.mlp2(lp["mlp"], L.layer_norm(lp["mlp_norm"], h, eps))
    return L.layer_norm(params["enc_final_norm"], h, eps)


def _cross_kv(lp: dict, cfg: ModelConfig, enc_out: torch.Tensor) -> tuple:
    """A decoder layer's cross-attention K/V ``[B, Ta, nh, hd]`` over the
    encoder's output (no RoPE)."""
    B = enc_out.shape[0]
    return tuple((enc_out @ lp["xattn"][w]).reshape(B, -1, cfg.n_heads,
                                                    cfg.hd)
                 for w in ("wk", "wv"))


def _cross(lp: dict, cfg: ModelConfig, h: torch.Tensor, kv: tuple,
           positions, use_kernel: bool = False) -> torch.Tensor:
    """Cross-attention (residual not added): q from ``h`` with no RoPE,
    non-causal over every encoder position."""
    x = L.layer_norm(lp["xattn_norm"], h, cfg.norm_eps)
    return L.attention(lp["xattn"], cfg, x, positions, causal=False, kv=kv,
                       use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# forward (train) and loss
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra: Optional[dict] = None, remat: bool = False,
            use_kernel: bool = False) -> tuple:
    """Token logits for a full sequence (training).

    tokens: [B, S] int; ``extra`` holds the vlm family's ``patches``
    ``[B, n_patches, d_patch]`` or the audio family's ``frames`` ``[B,
    Ta, d]`` (required there).  Returns ``(logits [B, S, vocab], aux)``;
    ``aux`` (float32) is the MoE load-balancing loss summed over the
    layers, zero for the other families.  ``remat`` recomputes each
    layer's activations in the backward pass (``torch.utils.checkpoint``,
    non-reentrant); ``use_kernel`` routes attention through the flash
    kernel and the SSD scan through its kernel (on a card tensor).
    """
    B, S = tokens.shape
    eps = cfg.norm_eps
    h = _embed(params, cfg, tokens, extra)
    positions = torch.arange(S, device=tokens.device).expand(B, S)

    if cfg.family in ("ssm", "hybrid"):
        def block(hh, lp, i):
            hh = hh + L.mamba2_layer(lp["mamba"], cfg,
                                     L.rms_norm(lp["norm"], hh, eps),
                                     use_kernel=use_kernel)
            if _shared_at(cfg, i):
                hh = _attn_block(params["shared_attn"], cfg, hh, positions,
                                 use_kernel)[0]
            return hh, None
    elif cfg.family == "audio":
        enc_out = _encode_audio(params, cfg, _frames(cfg, extra),
                                use_kernel)

        def block(hh, lp, i):
            hh = hh + L.attention(lp["attn"], cfg,
                                  L.layer_norm(lp["attn_norm"], hh, eps),
                                  positions, use_kernel=use_kernel)
            hh = hh + _cross(lp, cfg, hh, _cross_kv(lp, cfg, enc_out),
                             positions, use_kernel)
            return hh + L.mlp2(lp["mlp"],
                               L.layer_norm(lp["mlp_norm"], hh, eps)), None
    else:
        def block(hh, lp, i):
            return _attn_block(lp, cfg, hh, positions, use_kernel)

    aux_total = h.new_zeros((), dtype=torch.float32)
    for i in range(cfg.n_layers):
        h = rows_like(h, tokens)
        if remat:
            h, aux = checkpoint(
                lambda hh, i=i: block(hh, layer_params(params, i), i), h,
                use_reentrant=False)
        else:
            h, aux = block(h, layer_params(params, i), i)
        if aux is not None:
            aux_total = aux_total + aux
    h = L.rms_norm(params["final_norm"], rows_like(h, tokens), eps)
    return vocab_logits(h, _head(params, cfg)), aux_total


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, use_kernel: bool = False) -> torch.Tensor:
    """Token-mean cross entropy (z-loss 1e-4) plus the auxiliary loss;
    ``batch`` holds ``tokens`` and ``labels`` (and ``patches`` for the vlm
    family, ``frames`` for the audio family)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          extra={k: v for k, v in batch.items()
                                 if k in ("patches", "frames")},
                          remat=remat, use_kernel=use_kernel)
    return L.softmax_xent(logits, batch["labels"], z_loss=1e-4) + aux


# ---------------------------------------------------------------------------
# prefill (full-sequence forward that also fills the decode cache)
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra: Optional[dict] = None, max_seq: Optional[int] = None,
            use_kernel: bool = False,
            true_len: Optional[torch.Tensor] = None) -> tuple:
    """Process a prompt; return (last-token logits [B, vocab], cache).

    The cache layout matches ``init_decode_cache(cfg, B, max_seq)`` so
    :func:`decode_step` continues from it: K/V ``[L, B, max_seq, nkv,
    hd]`` (dense, vlm, moe); each layer's SSM state ``[L, B, H, P, N]``
    float32 and conv state ``[L, B, W-1, conv_ch]`` (ssm, hybrid); the
    hybrid family's K/V of its shared block, one block of ``[n_attn, B,
    max_seq, nkv, hd]`` an application; the audio family's self-attention
    K/V and its cross-attention K/V ``xk``/``xv`` ``[L, B, n_audio_ctx,
    nh, hd]``.  ``true_len`` ([B] int32) enables bucketed prefill:
    ``tokens`` is right-padded to a shared bucket length, logits are
    gathered at each row's last real token (position 0 for an empty row,
    which the caller discards), and ``cache["len"]`` becomes the per-row
    vector (a recurrent family's pads enter its state, which is why it is
    served per slot).  ``extra`` may hold the vlm family's ``patches``
    and must hold the audio family's ``frames`` (as :func:`forward`).
    The moe family's pad positions take expert capacity as live tokens
    do, as in the reference.  ``use_kernel`` routes attention through the
    flash kernel and the SSD scan through its kernel (on a card tensor).
    """
    B, S = tokens.shape
    max_seq = max_seq or S
    dev = tokens.device
    eps = cfg.norm_eps
    h = _embed(params, cfg, tokens, extra)
    positions = torch.arange(S, device=dev).expand(B, S)
    # sharded (DTensors): each layer's cache leaves are stacked at the
    # end, so no whole-size plain cache is made nor written in place
    sharded = is_dtensor(tokens)
    cache = {} if sharded else init_decode_cache(cfg, B, max_seq, dev)
    parts: dict = {}

    def put(name: str, i: int, val) -> None:
        if sharded:
            parts.setdefault(name, {})[i] = val
        else:
            cache[name][i] = val

    def pad(x):     # [B, S, ...] -> [B, max_seq, ...], as the reference's
        # pad_kv: a whole layer written, so a symbolic S (torch.export)
        # meets no guard on the cache's strides
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, max_seq - S))
    if cfg.family == "audio":
        enc_out = _encode_audio(params, cfg, _frames(cfg, extra), use_kernel)
    shared = params.get("shared_attn")
    for i in range(cfg.n_layers):
        h = rows_like(h, tokens)
        lp = layer_params(params, i)
        if cfg.family in ("ssm", "hybrid"):
            y, st, conv = L.mamba2_prefill(
                lp["mamba"], cfg, L.rms_norm(lp["norm"], h, eps),
                use_kernel)
            put("ssm", i, st)
            put("conv", i, conv)
            h = h + y
            if not _shared_at(cfg, i):
                continue
            lp, c = shared, i // cfg.hybrid.attn_period
        else:
            c = i
        norm = L.layer_norm if cfg.family == "audio" else L.rms_norm
        q, k, v = L._qkv(lp["attn"], cfg, norm(lp["attn_norm"], h, eps),
                         positions)
        o = L._attend(cfg, q, k, v, causal=True, use_kernel=use_kernel,
                      noscore=False)
        h = h + o.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        if cfg.kv_quant:
            (k, ks), (v, vs) = L.quantize_kv(k), L.quantize_kv(v)
            put("k_scale", c, pad(ks))
            put("v_scale", c, pad(vs))
        put("k", c, pad(k))
        put("v", c, pad(v))
        if cfg.family == "audio":
            kv = _cross_kv(lp, cfg, enc_out)
            h = h + _cross(lp, cfg, h, kv, positions, use_kernel)
            h = h + L.mlp2(lp["mlp"], L.layer_norm(lp["mlp_norm"], h, eps))
            put("xk", i, kv[0])
            put("xv", i, kv[1])
        else:
            h = h + _ffn(lp, cfg, h)[0]
    if true_len is None:
        length = torch.tensor(S, dtype=torch.int32, device=dev)
        h = h[:, -1:]
    else:
        length = torch.as_tensor(true_len, dtype=torch.int32, device=dev)
        idx = (length.long() - 1).clamp(0, S - 1)
        h = h[torch.arange(B, device=dev), idx][:, None]
    h = L.rms_norm(params["final_norm"], h, eps)
    if sharded:
        want = init_decode_cache(cfg, 1, 1, "meta")      # the leaves' dtypes
        cache = {k: torch.stack([d[j] for j in sorted(d)]).to(want[k].dtype)
                 for k, d in parts.items()}
    cache["len"] = length
    return h[:, 0] @ _head(params, cfg), cache


# ---------------------------------------------------------------------------
# decode (one new token against a cache)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Zero cache for :func:`decode_step`: scalar ``len`` and the
    family's leaves as :func:`prefill` describes them; with
    ``cfg.kv_quant`` (dense, vlm, moe) K/V are int8 with fp16 scales
    ``k_scale``/``v_scale`` ``[L, B, max_seq, nkv]`` beside them."""
    if cfg.kv_quant and cfg.family in ("hybrid", "audio"):
        raise ValueError(f"kv_quant applies to the attention-cache "
                         f"families (dense, vlm, moe), not {cfg.family!r}")
    dev = torch.device(device)
    dt = torch_dtype(cfg)
    Lc, d = cfg.n_layers, cfg.d_model
    c = {"len": torch.zeros((), dtype=torch.int32, device=dev)}

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        c["ssm"] = zeros(Lc, batch, s.n_heads(d), s.head_dim, s.d_state,
                         dtype=torch.float32)
        c["conv"] = zeros(Lc, batch, s.conv_width - 1,
                          s.d_inner(d) + 2 * s.n_groups * s.d_state)
    if cfg.family != "ssm":
        n_kv = Lc // cfg.hybrid.attn_period if cfg.family == "hybrid" \
            else Lc
        kv_dt = torch.int8 if cfg.kv_quant else dt
        c["k"] = zeros(n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd,
                       dtype=kv_dt)
        c["v"] = zeros(n_kv, batch, max_seq, cfg.n_kv_heads, cfg.hd,
                       dtype=kv_dt)
        if cfg.kv_quant:
            c["k_scale"] = zeros(n_kv, batch, max_seq, cfg.n_kv_heads,
                                 dtype=torch.float16)
            c["v_scale"] = zeros(n_kv, batch, max_seq, cfg.n_kv_heads,
                                 dtype=torch.float16)
    if cfg.family == "audio":
        ctx = cfg.encdec.n_audio_ctx
        c["xk"] = zeros(Lc, batch, ctx, cfg.n_heads, cfg.hd)
        c["xv"] = zeros(Lc, batch, ctx, cfg.n_heads, cfg.hd)
    return c


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple:
    """One new token for every sequence in the batch.

    token: [B] int.  Returns (logits [B, vocab], cache'): ``cache``'s K/V
    (each row's new K/V written at its length) and SSM/conv states are
    updated in place, and ``cache'`` is a new dict sharing them, with
    ``len + 1``.  Attention routes by ``cfg.attn_impl``
    (:func:`repro_torch.models.layers.attention_decode`; a ``[B]`` length
    always takes the flash-decode kernel).
    """
    B = token.shape[0]
    eps = cfg.norm_eps
    h = vocab_embedding(token.long(), params["embed"])[:, None, :]
    clen = cache["len"]
    shared = params.get("shared_attn")
    zero = torch.zeros((B, 1), dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        h = rows_like(h, token)
        lp = layer_params(params, i)
        if cfg.family in ("ssm", "hybrid"):
            y, st, conv = L.mamba2_decode(
                lp["mamba"], cfg, L.rms_norm(lp["norm"], h, eps),
                cache["ssm"][i], cache["conv"][i])
            # into the stacked leaves, not through a view of layer i: a
            # compiled step then writes them in place (layers.write_kv)
            layer = torch.full((1,), i, device=h.device)
            cache["ssm"].index_put_((layer,), st[None])
            cache["conv"].index_put_((layer,), conv[None].to(
                cache["conv"].dtype))
            h = h + y
            if not _shared_at(cfg, i):
                continue
            lp, c = shared, i // cfg.hybrid.attn_period
        else:
            c = i
        norm = L.layer_norm if cfg.family == "audio" else L.rms_norm
        scales = (cache["k_scale"], cache["v_scale"]) if cfg.kv_quant \
            else (None, None)
        # the stacked leaves and the layer: written in place, not through
        # a view (see layers.write_kv)
        h = h + L.attention_decode(
            lp["attn"], cfg, norm(lp["attn_norm"], h, eps), cache["k"],
            cache["v"], clen, *scales, layer=c)
        if cfg.family == "audio":
            # positions of zero: the cross-attention's q takes no RoPE
            h = h + _cross(lp, cfg, h, (cache["xk"][i], cache["xv"][i]),
                           zero)
            h = h + L.mlp2(lp["mlp"], L.layer_norm(lp["mlp_norm"], h, eps))
        else:
            h = h + _ffn(lp, cfg, h)[0]
    h = L.rms_norm(params["final_norm"], h, eps)
    return h[:, 0] @ _head(params, cfg), dict(cache, len=clen + 1)


# ---------------------------------------------------------------------------
# packed-slot serving: one batched decode step for the whole slot array
# ---------------------------------------------------------------------------
#
# The serving engine keeps ONE cache of shape [..., slots, ...] (the batch
# axis of every K/V leaf is axis 1) plus a per-slot ``len`` vector.
# Admission writes a prefilled request's rows into a slot, retirement
# zeroes its length, and the decode step runs once per iteration over all
# slots — live or dead — with dead slots marked by ``len == 0``.
#
# Every function here takes tensors only (indices as 0-d int32 tensors,
# as the reference's ``sds((), int32)`` arguments), so ``torch.export``
# can take each as it is: the engine compiles them through the compile
# cache (``ServingEngine.warmup(cache=...)``), or calls them eagerly.

def init_packed_cache(cfg: ModelConfig, slots: int, max_seq: int,
                      device) -> dict:
    """Decode cache for ``slots`` packed sequences with per-slot lengths."""
    c = init_decode_cache(cfg, slots, max_seq, device)
    c["len"] = torch.zeros((slots,), dtype=torch.int32, device=c["k"].device)
    return c


def _index(i, device) -> torch.Tensor:
    """A row or slot index (a 0-d tensor, or an int) as the ``[1]`` int64
    index ``index_select``/``index_copy_`` take."""
    if isinstance(i, torch.Tensor):
        return i.reshape(1).to(device=device, dtype=torch.int64)
    return torch.tensor([int(i)], device=device)


def write_slot(packed: dict, cache: dict, row, slot) -> dict:
    """Copy row ``row`` of a prefill ``cache`` (per-row ``len`` form) into
    slot ``slot`` of ``packed``, in place, leaf by leaf (the int8 cache's
    scales included); returns ``packed``.  ``row``/``slot``: 0-d int
    tensors or ints."""
    dev = packed["len"].device
    row, slot = _index(row, dev), _index(slot, dev)
    for key, dst in packed.items():
        axis = 0 if key == "len" else 1
        dst.index_copy_(axis, slot,
                        cache[key].index_select(axis, row).to(dst.dtype))
    return packed


def retire_slot(packed: dict, slot) -> dict:
    """Free a slot in place: zero its length.  Its stale K/V rows are dead
    weight (masked by ``len``) until the next admission overwrites them."""
    n = packed["len"]
    n.index_fill_(0, _index(slot, n.device), 0)
    return packed


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """[B, V] logits -> [B] int32 tokens on the logits' device.

    ``temperature <= 0`` (or no generator) is greedy argmax; otherwise a
    temperature-scaled categorical draw from ``generator``, optionally
    truncated to the top-k logits.  The distribution is the reference's;
    the random bits are not (``torch.Generator`` in place of
    ``jax.random.fold_in``)."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k and top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -1e30, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


@dataclasses.dataclass
class ServingAdapter:
    """The batched-decode protocol consumed by ``ServingEngine``.

    ``prefill_fn(tokens[B,S], true_len[B], step) -> (first_tok[B], cache)``
    ``step_fn(tokens[slots], packed, step) -> (next_tok[slots], packed)``
    ``write_slot_fn(packed, cache, row, slot) -> packed``
    ``retire_fn(packed, slot) -> packed``

    Arguments are tensors on ``device`` (the engine moves tokens, lengths,
    indices and ``step``, a 0-d int32 tensor, there); sampled tokens come
    back as int32 tensors on ``device``, which the engine copies to the
    host once per call.  ``step_fn``, ``write_slot_fn`` and ``retire_fn``
    update ``packed`` in place and return it.

    A model's adapter (:func:`serving_adapter`) also carries what the
    engine compiles: ``params`` and the graphs ``prefill_graph(params,
    tokens, true_len, step) -> (out, cache)`` and ``step_graph(params,
    tokens, packed, step) -> out`` (``packed`` updated in place), whose
    ``out`` is the tokens when greedy and the logits otherwise; ``draw(out,
    step, lens=None)`` turns it into tokens (one eager call when sampling;
    ``lens``, the packed lengths after a step, zeroes the dead slots).
    ``prefill_fn``/``step_fn`` are the graphs called eagerly, then
    ``draw``.  An adapter without graphs (a toy) serves eagerly only.
    """
    cfg: Optional[ModelConfig]
    max_seq: int
    prefill_fn: Any
    step_fn: Any
    write_slot_fn: Any
    retire_fn: Any
    temperature: float = 0.0
    top_k: int = 0
    device: Any = "cpu"
    params: Any = None
    prefill_graph: Any = None
    step_graph: Any = None
    draw: Any = None

    def init_slots(self, slots: int) -> dict:
        return init_packed_cache(self.cfg, slots, self.max_seq, self.device)


def serving_adapter(params: dict, cfg: ModelConfig, *, max_seq: int,
                    temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                    device=None) -> ServingAdapter:
    """Build the packed-slot batched decode adapter for a model whose
    parameters lie on ``device`` (default: the card; raises without one).

    Only attention-cache families qualify (dense, vlm, moe, as in the
    reference): right-padded bucketed prefill is exact for them (causal
    attention never lets a real token see a later pad, and decode masks
    cache slots >= len; an MoE's pads and dead slots take expert capacity
    as the reference's do).  Serving is text-only: no patches reach a
    vlm.  The recurrent families (ssm, hybrid) would fold a bucket's pads
    into their state and the audio family needs its frames: they raise
    ``ValueError`` as the reference does (ssm and hybrid serve through
    the engine's per-slot path, :mod:`repro_torch.launch.serve`).

    The weights are an argument of the graphs, not a constant inside
    them: a compiled step holds none, and one copy on the card serves
    every executable.  Greedy decoding takes its argmax inside the graph;
    with ``temperature > 0`` the graphs return logits and the draw is one
    eager call (a ``torch.Generator`` seeded from ``seed`` and the step).
    """
    if cfg.family not in BATCHED_FAMILIES:
        raise ValueError(
            f"batched serving supports the attention-cache families "
            f"(dense/vlm/moe), not {cfg.family!r}; use the per-slot path")
    dev = resolve_device(device)
    if params["embed"].device != dev and not (
            dev.type == "cuda" and params["embed"].is_cuda):
        raise ValueError(f"serving_adapter: parameters lie on "
                         f"{params['embed'].device}, not {dev}")
    greedy = temperature <= 0.0

    def prefill_graph(params, tokens, true_len, step):
        logits, cache = prefill(params, cfg, tokens, max_seq=max_seq,
                                true_len=true_len)
        return (sample_tokens(logits) if greedy else logits), cache

    def step_graph(params, tokens, packed, step):
        live = packed["len"] > 0
        logits, _ = decode_step(params, cfg, tokens, packed)
        # dead slots stay at len 0 (liveness is derived from it) and emit
        # a harmless pad token
        packed["len"].copy_(torch.where(live, packed["len"] + 1, 0))
        if not greedy:
            return logits
        return torch.where(live, sample_tokens(logits), 0).to(torch.int32)

    def draw(out, step, lens=None):
        if greedy:
            return out
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + int(step)) % (2 ** 63))
        tok = sample_tokens(out, gen, temperature, top_k)
        return tok if lens is None else torch.where(lens > 0, tok, 0)

    def prefill_fn(tokens, true_len, step):
        out, cache = prefill_graph(params, tokens, true_len, step)
        return draw(out, step), cache

    def step_fn(tokens, packed, step):
        out = step_graph(params, tokens, packed, step)
        return draw(out, step, packed["len"]), packed

    return ServingAdapter(cfg=cfg, max_seq=max_seq, prefill_fn=prefill_fn,
                          step_fn=step_fn, write_slot_fn=write_slot,
                          retire_fn=retire_slot, temperature=temperature,
                          top_k=top_k, device=dev, params=params,
                          prefill_graph=prefill_graph, step_graph=step_graph,
                          draw=draw)

"""LM assembly: init, forward and loss (dense and ssm families), and
prefill, decode and packed-slot serving (dense family).

The port's counterpart of the reference's ``models/lm.py``.  Parameters
keep the reference's nested-dict layout with per-layer leaves stacked
along a leading ``[L, ...]`` axis; the forward passes loop over layers in
Python (PyTorch runs eagerly; the reference's ``lax.scan`` has nothing to
save here), and ``remat`` checkpoints each layer
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).
``cfg.attn_impl`` keeps ``naive`` and ``kernel``.  Training runs the
dense and ssm families; serving runs the dense family; the other
families, and serving the ssm family (per-slot recurrent decode), come
with later slices and raise ``NotImplementedError`` here.

In-place updates (the reference's arrays are immutable; it donates
buffers instead): :func:`decode_step` writes each new token's K/V into
the cache it is given, and :func:`write_slot` / :func:`retire_slot`
update the packed cache they are given and return it.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`init_params`, :func:`serving_adapter`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.synth import resolve_device
from . import layers as L
from .config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.dtype`` (a name, as in the reference) as a ``torch.dtype``."""
    return _DTYPES[cfg.dtype]


TRAIN_FAMILIES = ("dense", "ssm")      # init_params, forward, loss_fn
SERVE_FAMILIES = ("dense",)            # prefill, decode, serving


def _require(cfg: ModelConfig, what: str, families: tuple) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family is not ported to this entry "
            f"point yet (it takes {', '.join(families)}; the rest follow "
            f"in ROADMAP queue A: moe/vlm/hybrid/audio and the per-slot "
            f"serving of ssm)")


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]``
    leaves."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the card; raises without one).  Same distributions as the
    reference's ``init_params`` (normal / sqrt(fan_in) matrices, 0.02
    embedding, unit norms; Mamba2's float32 ``A_log``/``D``/``dt_bias``)
    but not the same numbers: parity tests carry
    the reference's parameters over with
    :func:`repro_torch.models.weights.from_jax_params`."""
    _require(cfg, "init_params", TRAIN_FAMILIES)
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
    if cfg.family == "dense":
        layers = [{"attn_norm": L.init_rmsnorm(d, dt, dev),
                   "attn": L.init_attention(gen, cfg, dt, dev),
                   "mlp_norm": L.init_rmsnorm(d, dt, dev),
                   "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, dev)}
                  for _ in range(n)]
    else:
        layers = [{"norm": L.init_rmsnorm(d, dt, dev),
                   "mamba": L.init_mamba2(gen, cfg, dt, dev)}
                  for _ in range(n)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)
    p["layers"] = stack(*layers)
    return p


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# forward (train) and loss
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = False, use_kernel: bool = False) -> tuple:
    """Token logits for a full sequence (training).

    tokens: [B, S] int.  Returns ``(logits [B, S, vocab], aux)``; ``aux``
    is the auxiliary loss, zero for the dense and ssm families (the
    reference's MoE load-balancing term is not ported).  ``remat``
    recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); ``use_kernel`` routes
    attention through the flash kernel and the SSD scan through its
    kernel (on a card tensor).
    """
    _require(cfg, "forward", TRAIN_FAMILIES)
    B, S = tokens.shape
    eps = cfg.norm_eps
    h = params["embed"][tokens.long()]
    positions = torch.arange(S, device=tokens.device).expand(B, S)

    if cfg.family == "dense":
        def block(hh, lp):
            hh = hh + L.attention(lp["attn"], cfg,
                                  L.rms_norm(lp["attn_norm"], hh, eps),
                                  positions, use_kernel=use_kernel)
            return hh + L.mlp(lp["mlp"], L.rms_norm(lp["mlp_norm"], hh, eps))
    else:
        def block(hh, lp):
            return hh + L.mamba2_layer(lp["mamba"], cfg,
                                       L.rms_norm(lp["norm"], hh, eps),
                                       use_kernel=use_kernel)

    for i in range(cfg.n_layers):
        if remat:
            h = checkpoint(lambda hh, i=i: block(hh, layer_params(params, i)),
                           h, use_reentrant=False)
        else:
            h = block(h, layer_params(params, i))
    h = L.rms_norm(params["final_norm"], h, eps)
    return h @ _head(params, cfg), h.new_zeros((), dtype=torch.float32)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, use_kernel: bool = False) -> torch.Tensor:
    """Token-mean cross entropy (z-loss 1e-4) plus the auxiliary loss."""
    logits, aux = forward(params, cfg, batch["tokens"], remat=remat,
                          use_kernel=use_kernel)
    return L.softmax_xent(logits, batch["labels"], z_loss=1e-4) + aux


# ---------------------------------------------------------------------------
# prefill (full-sequence forward that also fills the decode cache)
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_seq: Optional[int] = None, use_kernel: bool = False,
            true_len: Optional[torch.Tensor] = None) -> tuple:
    """Process a prompt; return (last-token logits [B, vocab], cache).

    The cache layout matches ``init_decode_cache(cfg, B, max_seq)`` so
    :func:`decode_step` continues from it.  ``true_len`` ([B] int32)
    enables bucketed prefill: ``tokens`` is right-padded to a shared
    bucket length, logits are gathered at each row's last real token
    (position 0 for an empty row, which the caller discards), and
    ``cache["len"]`` becomes the per-row vector.
    """
    _require(cfg, "prefill", SERVE_FAMILIES)
    B, S = tokens.shape
    max_seq = max_seq or S
    dt = torch_dtype(cfg)
    dev = tokens.device
    h = params["embed"][tokens.long()]
    positions = torch.arange(S, device=dev).expand(B, S)
    shape = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd)
    ck = torch.zeros(shape, dtype=dt, device=dev)
    cv = torch.zeros(shape, dtype=dt, device=dev)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x = L.rms_norm(lp["attn_norm"], h, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], cfg, x, positions)
        o = L._attend(cfg, q, k, v, causal=True, use_kernel=use_kernel)
        h = h + o.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["attn"]["wo"]
        h = h + L.mlp(lp["mlp"], L.rms_norm(lp["mlp_norm"], h, cfg.norm_eps))
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    if true_len is None:
        length = torch.tensor(S, dtype=torch.int32, device=dev)
        h = h[:, -1:]
    else:
        length = torch.as_tensor(true_len, dtype=torch.int32, device=dev)
        idx = (length.long() - 1).clamp(0, S - 1)
        h = h[torch.arange(B, device=dev), idx][:, None]
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return h[:, 0] @ _head(params, cfg), {"len": length, "k": ck, "v": cv}


# ---------------------------------------------------------------------------
# decode (one new token against a cache)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Zero cache for :func:`decode_step`: scalar ``len``, K/V
    ``[L, batch, max_seq, nkv, hd]``."""
    _require(cfg, "init_decode_cache", SERVE_FAMILIES)
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) is not "
                                  "ported yet")
    dev = torch.device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"len": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)}


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> tuple:
    """One new token for every sequence in the batch.

    token: [B] int.  Returns (logits [B, vocab], cache'): ``cache``'s K/V
    are updated in place (each row's new K/V written at its length) and
    ``cache'`` is a new dict sharing them, with ``len + 1``.
    """
    _require(cfg, "decode_step", SERVE_FAMILIES)
    h = params["embed"][token.long()][:, None, :]         # [B, 1, d]
    clen = cache["len"]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = h + L.attention_decode(
            lp["attn"], cfg, L.rms_norm(lp["attn_norm"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], clen)
        h = h + L.mlp(lp["mlp"], L.rms_norm(lp["mlp_norm"], h, cfg.norm_eps))
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
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

def init_packed_cache(cfg: ModelConfig, slots: int, max_seq: int,
                      device) -> dict:
    """Decode cache for ``slots`` packed sequences with per-slot lengths."""
    c = init_decode_cache(cfg, slots, max_seq, device)
    c["len"] = torch.zeros((slots,), dtype=torch.int32, device=c["k"].device)
    return c


def write_slot(packed: dict, cache: dict, row, slot) -> dict:
    """Copy row ``row`` of a prefill ``cache`` (per-row ``len`` form) into
    slot ``slot`` of ``packed``, in place; returns ``packed``."""
    row, slot = int(row), int(slot)
    for key, dst in packed.items():
        if key == "len":
            dst[slot] = cache["len"][row]
        else:
            dst[:, slot] = cache[key][:, row]
    return packed


def retire_slot(packed: dict, slot) -> dict:
    """Free a slot in place: zero its length.  Its stale K/V rows are dead
    weight (masked by ``len``) until the next admission overwrites them."""
    packed["len"][int(slot)] = 0
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

    Token and length arguments arrive as host (numpy) arrays and ``step``
    as an int; sampled tokens are returned as int32 tensors on
    ``device``, which the engine copies to the host once per call.
    ``step_fn``, ``write_slot_fn`` and ``retire_fn`` update ``packed`` in
    place and return it.
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

    def init_slots(self, slots: int) -> dict:
        return init_packed_cache(self.cfg, slots, self.max_seq, self.device)


def serving_adapter(params: dict, cfg: ModelConfig, *, max_seq: int,
                    temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                    device=None) -> ServingAdapter:
    """Build the packed-slot batched decode adapter for a dense model whose
    parameters lie on ``device`` (default: the card; raises without one).

    Right-padded bucketed prefill is exact for attention-cache families
    (causal attention never lets a real token see a later pad, and decode
    masks cache slots >= len).  The port serves the dense family; others
    raise ``ValueError`` as the reference does for recurrent families.
    """
    if cfg.family != "dense":
        raise ValueError(
            f"batched serving in the port supports the dense family, not "
            f"{cfg.family!r}; moe/vlm come with a later serving slice and "
            f"ssm/hybrid with per-slot recurrent serving (ROADMAP queue A)")
    dev = resolve_device(device)
    if params["embed"].device != dev and not (
            dev.type == "cuda" and params["embed"].is_cuda):
        raise ValueError(f"serving_adapter: parameters lie on "
                         f"{params['embed'].device}, not {dev}")

    def _sample(logits, step):
        if temperature <= 0.0:
            return sample_tokens(logits)
        gen = torch.Generator(device=dev).manual_seed(
            (seed * 1_000_003 + int(step)) % (2 ** 63))
        return sample_tokens(logits, gen, temperature, top_k)

    def _dev(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    def prefill_fn(tokens, true_len, step):
        logits, cache = prefill(params, cfg, _dev(tokens), max_seq=max_seq,
                                true_len=_dev(true_len))
        return _sample(logits, step), cache

    def step_fn(tokens, packed, step):
        live = packed["len"] > 0
        logits, _ = decode_step(params, cfg, _dev(tokens), packed)
        # dead slots stay at len 0 (liveness is derived from it) and emit
        # a harmless pad token
        packed["len"].copy_(torch.where(live, packed["len"] + 1, 0))
        nxt = _sample(logits, step)
        return torch.where(live, nxt, 0).to(torch.int32), packed

    return ServingAdapter(cfg=cfg, max_seq=max_seq, prefill_fn=prefill_fn,
                          step_fn=step_fn, write_slot_fn=write_slot,
                          retire_fn=retire_slot, temperature=temperature,
                          top_k=top_k, device=dev)

"""Shared cases of the port's serving parity tests over every
architecture (``tests/test_torch_serve_*.py``); not a test file.

Each architecture runs at ``with_reduced(dtype="float32")`` with its
published GQA group kept: ``n_kv_heads = min(published, 2)`` and
``n_heads = group * n_kv_heads`` (qwen3-4b 8/2, yi-6b 16/2, starcoder2-3b
24/2, grok-1-314b 12/2, the MHA families 2/2; ``with_reduced`` alone
cuts every GQA config to group 2).  zamba2-1.2b runs 4 layers, so its
shared block is applied twice.  The reference initialises the
parameters and ``from_jax_params`` carries them over, so both packages
run the same weights on the same numpy tokens; the vlm's ``patches``
and the audio family's ``frames`` are drawn from ``default_rng``.

Tolerances: logits within ``LOGIT_REL`` (1e-4, ``tests/test_torch_
train.py``'s, through ``tests/torch_train_parity.py``'s ``close``) of
their largest magnitude, caches within ``CACHE_TOL`` (1e-5) absolute:
float32 throughout, the two packages differing in summation order only.  Greedy tokens are compared exactly, with every
sampled position's top-2 logit margin above ``MARGIN`` where a test
says so, so no near tie can flip one.
"""

import jax.numpy as jnp
import numpy as np
import torch

import torch_train_parity
from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from torch_train_parity import LOGIT_REL

CACHE_TOL = 1e-5
MARGIN = 1e-3


def published_group(cfg) -> dict:
    """``with_reduced`` overrides that keep ``cfg``'s GQA group."""
    if not cfg.n_heads:
        return {}
    nkv = min(cfg.n_kv_heads, 2)
    kw = dict(n_heads=cfg.n_heads // cfg.n_kv_heads * nkv, n_kv_heads=nkv)
    if cfg.hybrid is not None:
        kw["n_layers"] = 4
    return kw


def pair(arch: str, seed: int = 0, **kw) -> tuple:
    """``(cfg_j, cfg_t, params_j, params_t)`` at the published group, the
    reference's parameters carried over."""
    return torch_train_parity.pair(
        arch, seed, **{**published_group(get_config(arch)), **kw})


def extra(cfg, batch: int, seed: int = 7) -> tuple:
    """Random patches (vlm) or frames (audio), numpy, seeded: ``(the
    reference's, the port's)``."""
    rng = np.random.default_rng(seed)
    if cfg.vlm is not None:
        shape, key = (batch, cfg.vlm.n_patches, cfg.vlm.d_patch), "patches"
    elif cfg.encdec is not None:
        shape, key = (batch, cfg.encdec.n_audio_ctx, cfg.d_model), "frames"
    else:
        return {}, {}
    x = rng.standard_normal(shape).astype(np.float32)
    return {key: jnp.asarray(x)}, {key: torch.from_numpy(x)}


def close(got, want, what: str = "") -> None:
    """Logits within ``LOGIT_REL`` of the reference's largest magnitude."""
    torch_train_parity.close(got, want, LOGIT_REL, what)


def margin(logits) -> float:
    v = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((v[..., -1] - v[..., -2]).min())


def dropless(monkeypatch) -> None:
    """Both packages' MoE layers at a capacity that drops nothing."""
    for mod in (L, jL):
        layer = mod.moe_layer
        monkeypatch.setattr(mod, "moe_layer", lambda p, cfg, x, _f=layer:
                            _f(p, cfg, x,
                               capacity_factor=float(cfg.moe.n_experts)))


def close_cache(got: dict, want: dict) -> None:
    """Every leaf of a cache within ``CACHE_TOL``; lengths equal."""
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=CACHE_TOL, rtol=0, err_msg=key)

"""Step builders of the train and serve entry points.

The port's counterpart of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` in the reference's ``launch/steps.py``: the loss,
its gradients with respect to every parameter leaf
(``torch.autograd.grad``), and the AdamW update, as one function of
``(params, opt_state, batch)``; a prompt's prefill from a batch (its
``patches`` for the vlm family, ``frames`` for the audio family); one
decode step.  :func:`abstract_batch` and :func:`input_specs` give the
dry run (``launch.dryrun``) a cell's step and its inputs, laid out on a
mesh by the sharding rules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..distributed import sharding as shd
from ..dtensor import like_placements, replicate, sharded_context
from ..models import lm
from ..models.config import InputShape, ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update, opt_state_specs
from ..tree import leaves, tree_map


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def abstract_batch(cfg: ModelConfig, B: int, S: int) -> dict:
    """A batch as ``meta`` tensors of the reference's dtypes: int32
    ``tokens``/``labels`` ``[B, S]``, bf16 ``patches`` (vlm) or ``frames``
    (audio)."""
    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    d: dict = {"tokens": meta(B, S), "labels": meta(B, S)}
    if cfg.vlm is not None:
        d["patches"] = meta(B, cfg.vlm.n_patches, cfg.vlm.d_patch,
                            dtype=torch.bfloat16)
    if cfg.encdec is not None:
        d["frames"] = meta(B, cfg.encdec.n_audio_ctx, cfg.d_model,
                           dtype=torch.bfloat16)
    return d


def input_specs(cfg: ModelConfig, shape: InputShape, mesh,
                pol: Optional[shd.ShardingPolicy] = None,
                opt: Optional[AdamWConfig] = None, remat: bool = True,
                use_kernel: bool = False) -> dict:
    """Everything a dry run needs for one (arch x input-shape) cell on a
    ``DeviceMesh``: ``{"fn", "args", "in_specs", "out_specs",
    "donate_argnums"}``.

    ``args`` are DTensors laid out by ``in_specs`` whose local shards are
    uninitialised tensors (``sharding.place_empty``; fake under
    ``FakeTensorMode``); ``fn(*args)`` is the step, and its
    outputs come out laid out by ``out_specs``.  There is no ``jit`` to
    hand the specs to: the port places the inputs by them, the train
    step lays its outputs out as its inputs were, and ``donate_argnums``
    names the inputs a caller drops once the step returns (the step
    makes new tensors for them), which the dry run's live-byte estimate
    releases.  The policy choices are the reference's: FSDP and bf16
    optimizer state above 5e10 parameters.
    """
    big = cfg.param_count() > 5e10
    pol = pol or shd.for_mesh(mesh, fsdp=big)
    opt = opt or AdamWConfig(state_dtype="bfloat16" if big else "float32")
    aparams = shd.abstract_params(cfg)
    pspec = shd.param_specs(cfg, mesh, pol, like=aparams)
    params = shd.place_empty(aparams, pspec, mesh)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        ospec = opt_state_specs(cfg, mesh, pol)
        state = shd.place_empty(adamw_init(aparams, opt), ospec, mesh)
        bspec = shd.batch_spec(cfg, mesh, B, pol)
        batch = shd.place_empty(abstract_batch(cfg, B, S), bspec, mesh)
        fn = make_train_step(cfg, opt, remat=remat, use_kernel=use_kernel)
        return dict(fn=fn, args=(params, state, batch),
                    in_specs=(pspec, ospec, bspec),
                    out_specs=(pspec, ospec, shd.Spec()),
                    donate_argnums=(0, 1))

    bdim = shd.batch_dim(mesh, B, pol) \
        if pol.batch_spec_axes is not None else None
    cspec = shd.cache_specs(cfg, mesh, B, pol)
    if shape.kind == "prefill":
        bspec = shd.batch_spec(cfg, mesh, B, pol)
        abatch = abstract_batch(cfg, B, S)
        del abatch["labels"], bspec["labels"]
        batch = shd.place_empty(abatch, bspec, mesh)
        fn = make_prefill_step(cfg, use_kernel=use_kernel)
        return dict(fn=fn, args=(params, batch), in_specs=(pspec, bspec),
                    out_specs=(shd.Spec(bdim, None), cspec),
                    donate_argnums=())

    # decode (and long-context decode): one new token against a full cache
    acache = lm.init_decode_cache(cfg, B, S, "meta")
    cache = shd.place_empty(acache, cspec, mesh)
    tspec = shd.Spec(bdim)
    token = shd.place_empty(torch.empty((B,), dtype=torch.int32,
                                        device="meta"), tspec, mesh)
    # use_kernel: flash-decode, as attn_impl="kernel" routes it
    fn = make_decode_step(dataclasses.replace(cfg, attn_impl="kernel")
                          if use_kernel else cfg)
    return dict(fn=fn, args=(params, token, cache),
                in_specs=(pspec, tspec, cspec),
                out_specs=(shd.Spec(bdim, None), cspec),
                donate_argnums=(2,))


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = True, use_kernel: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` ([B, S] int
    tensors on the parameters' device), ``metrics`` the 0-d tensors
    ``loss``, ``lr`` and ``grad_norm`` (before clipping).  The caller's
    tensors are not modified: the step returns new parameters and state.

    Sharded: on DTensor parameters, state and batch (placed by
    :func:`repro_torch.distributed.sharding.place_tree` from the specs)
    the same function runs under DTensor's propagation, plain tensors it
    makes count as replicated, and its outputs keep the placements of its
    inputs (the reference's ``out_shardings``), the metrics replicated.
    """
    def train_step(params, opt_state, batch):
        with sharded_context(params):
            # differentiate aliases of the leaves, so the caller's tensors
            # gain no requires_grad flag
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = lm.loss_fn(live, cfg, batch, remat=remat,
                              use_kernel=use_kernel)
            grads = iter(torch.autograd.grad(loss, leaves(live)))
            # sharded: autograd leaves a data-parallel gradient partial
            # (a sum over the batch shards); reduce it to the parameter's
            # placement before the update, whose division by the second
            # moment must see the whole gradient
            grads = like_placements(tree_map(lambda _: next(grads), params),
                                    params)
            new_p, new_s, metrics = adamw_update(grads, opt_state, params,
                                                 opt)
            metrics["loss"] = loss.detach()
            return (like_placements(new_p, params),
                    like_placements(new_s, opt_state),
                    {k: replicate(v) for k, v in metrics.items()})
    train_step.__name__ = f"train_step_{cfg.name}"
    return train_step


def make_prefill_step(cfg: ModelConfig, use_kernel: bool = False,
                      max_seq: Optional[int] = None):
    """``prefill_step(params, batch) -> (last-token logits, cache)``;
    ``batch`` holds ``tokens`` ([B, S] int) and, for the vlm family,
    ``patches``, for the audio family ``frames``.  The cache holds
    ``max_seq`` positions (default: the prompt's, as in the reference)."""
    def prefill_step(params, batch):
        extra = {k: v for k, v in batch.items()
                 if k in ("patches", "frames")}
        with sharded_context(params):
            return lm.prefill(params, cfg, batch["tokens"], extra=extra,
                              max_seq=max_seq, use_kernel=use_kernel)
    prefill_step.__name__ = f"prefill_step_{cfg.name}"
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, cache) -> (logits, cache')``, one new
    token a sequence (:func:`repro_torch.models.lm.decode_step`)."""
    def decode_step(params, token, cache):
        with sharded_context(params):
            return lm.decode_step(params, cfg, token, cache)
    decode_step.__name__ = f"decode_step_{cfg.name}"
    return decode_step

"""Step builders of the train and serve entry points.

The port's counterpart of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` in the reference's ``launch/steps.py:122-151``: the
loss, its gradients with respect to every parameter leaf
(``torch.autograd.grad``), and the AdamW update, as one function of
``(params, opt_state, batch)``; a prompt's prefill from a batch (its
``patches`` for the vlm family, ``frames`` for the audio family); one
decode step.  The reference's
abstract ``abstract_batch``/``input_specs`` belong to the dry-run and the
distributed slice (ROADMAP queue A, item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update
from ..tree import leaves, tree_map


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = True, use_kernel: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` ([B, S] int
    tensors on the parameters' device), ``metrics`` the 0-d tensors
    ``loss``, ``lr`` and ``grad_norm`` (before clipping).  The caller's
    tensors are not modified: the step returns new parameters and state.
    """
    def train_step(params, opt_state, batch):
        # differentiate aliases of the leaves, so the caller's tensors
        # gain no requires_grad flag
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = lm.loss_fn(live, cfg, batch, remat=remat,
                          use_kernel=use_kernel)
        grads = iter(torch.autograd.grad(loss, leaves(live)))
        grads = tree_map(lambda _: next(grads), params)
        new_p, new_s, metrics = adamw_update(grads, opt_state, params, opt)
        metrics["loss"] = loss.detach()
        return new_p, new_s, metrics
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
        return lm.prefill(params, cfg, batch["tokens"], extra=extra,
                          max_seq=max_seq, use_kernel=use_kernel)
    prefill_step.__name__ = f"prefill_step_{cfg.name}"
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, cache) -> (logits, cache')``, one new
    token a sequence (:func:`repro_torch.models.lm.decode_step`)."""
    def decode_step(params, token, cache):
        return lm.decode_step(params, cfg, token, cache)
    decode_step.__name__ = f"decode_step_{cfg.name}"
    return decode_step

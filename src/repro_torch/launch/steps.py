"""Step builders of the train driver.

The port's counterpart of ``make_train_step`` in the reference's
``launch/steps.py:122-133``: the loss, its gradients with respect to
every parameter leaf (``torch.autograd.grad``), and the AdamW update, as
one function of ``(params, opt_state, batch)``.  The reference's abstract
``input_specs`` and prefill/decode steps belong to the dry-run and the
distributed slice (ROADMAP A11-A12).
"""

from __future__ import annotations

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

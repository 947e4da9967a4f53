"""Training of the dense family's other configs (qwen3-4b, yi-6b,
starcoder2-3b) against the reference, on the CPU; starcoder2-3b with a
sliding window that binds; the reference's kernel-path check.

The loss, every gradient leaf, one train step and the reference's
four-step overfit at ``with_reduced(dtype="float32")`` (cases and
tolerances: ``tests/torch_train_parity.py``; qwen3-0.6b's loss,
gradients and step are held in ``tests/test_torch_train.py``, its
overfit here).  starcoder2-3b is the one config with
``sliding_window``: at ``WINDOW`` = 8 and S = 32 the window binds (a
query sees 8 of up to 32 keys), through the flash kernel's plain version
(``use_kernel``) and through ``sdpa``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params
from torch_train_parity import (LOGIT_REL, batch, check_loss_and_grads,
                                check_overfit, check_train_step, close, pair)

ARCHS = ("qwen3-4b", "yi-6b", "starcoder2-3b")
WINDOW = 8
KERNEL_TOL = 5e-2           # tests/test_models.py:127's, bf16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return pair(request.param)


def test_loss_and_grads_match_reference(model):
    check_loss_and_grads(model)


def test_train_step_matches_reference(model):
    check_train_step(model)


@pytest.mark.parametrize("arch", ("qwen3-0.6b",) + ARCHS)
def test_overfit_matches_reference(arch):
    check_overfit(pair(arch))


# ---------------------------------------------------------------------------
# starcoder2-3b with a window that binds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def windowed():
    return pair("starcoder2-3b", sliding_window=WINDOW)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_window_binds_and_logits_match_reference(windowed, use_kernel):
    """Logits of 32 positions against the reference's: equal to the
    unwindowed model's where a query sees every key (positions below the
    window), and far from them past it."""
    cfg_j, cfg_t, params_j, params_t = windowed
    toks = batch(cfg_t, 2, 32, seed=5)["tokens"]
    want, _ = jlm.forward(params_j, cfg_j, jnp.asarray(toks),
                          use_kernel=use_kernel)
    with torch.no_grad():
        got, _ = lm.forward(params_t, cfg_t, torch.from_numpy(toks),
                            use_kernel=use_kernel)
        wide, _ = lm.forward(params_t,
                             dataclasses.replace(cfg_t, sliding_window=None),
                             torch.from_numpy(toks), use_kernel=use_kernel)
    close(got, want, LOGIT_REL, "logits")
    close(got[:, :WINDOW], wide[:, :WINDOW], LOGIT_REL, "inside the window")
    scale = float(wide.abs().max())
    assert float((got - wide)[:, WINDOW:].abs().max()) > 1e-2 * scale


@pytest.mark.parametrize("use_kernel", [False, True])
def test_window_loss_and_grads_match_reference(windowed, use_kernel):
    check_loss_and_grads(windowed, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# the reference's tests/test_models.py:127
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_use_kernel_matches_xla_path(arch):
    """``use_kernel=True`` (flash attention, the SSD scan) against the
    plain path, at the reference test's sizes (reduced, bf16, 2 layers,
    ``max_seq_len`` 512, one sequence of 128) and tolerance; the kernel
    path also against the reference's (its Pallas kernels interpreted),
    on the same weights."""
    cfg_j = jax_get_config(arch).with_reduced(n_layers=2, max_seq_len=512)
    cfg_t = get_config(arch).with_reduced(n_layers=2, max_seq_len=512)
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab, (1, 128)) \
        .astype(np.int32)
    with torch.no_grad():
        l1, _ = lm.forward(params_t, cfg_t, torch.from_numpy(toks))
        l2, _ = lm.forward(params_t, cfg_t, torch.from_numpy(toks),
                           use_kernel=True)
    assert l1.dtype == l2.dtype == torch.bfloat16
    np.testing.assert_allclose(l1.float().numpy(), l2.float().numpy(),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    lj, _ = jlm.forward(params_j, cfg_j, jnp.asarray(toks), use_kernel=True)
    np.testing.assert_allclose(l2.float().numpy(),
                               np.asarray(lj, np.float32),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)

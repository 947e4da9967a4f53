"""Training of the moe and vlm families (granite-moe-1b-a400m,
grok-1-314b, phi-3-vision-4.2b) against the reference, on the CPU, and
the MoE dispatch's gradient under capacity drops.

The loss, every gradient leaf, one train step and the reference's
four-step overfit at ``with_reduced(dtype="float32")`` (cases and
tolerances: ``tests/torch_train_parity.py``).  The MoE's routing rests on
float32 router probabilities that XLA and PyTorch sum in different
orders; every case here has no top-k near tie (``ROUTE_MARGIN``), which
``test_moe_layer_gradients_with_drops_match_reference`` asserts for its
own input.

The dispatch's gradient is exact: a (token, k) copy that lost its slot
to capacity writes a spare row that is cut off, so its gradient is zero
bit for bit, and each kept slot's gradient goes to its one copy, unsummed
(``test_moe_dispatch_gradient_reaches_one_copy_a_slot``); the combine
reads a dropped copy from a kept slot with weight zero, so the layer's
gradients equal the reference's ``jax.grad`` within ``GRAD_REL`` of each
leaf's largest magnitude and repeat bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from torch_train_parity import (GRAD_REL, check_loss_and_grads,
                                check_overfit, check_train_step, close, pair)

ARCHS = ("granite-moe-1b-a400m", "grok-1-314b", "phi-3-vision-4.2b")
ROUTE_MARGIN = 1e-5
DROP_FACTOR = 0.25          # capacity max(ceil(T K / E / 4), 4): drops


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return pair(request.param)


def test_loss_and_grads_match_reference(model):
    check_loss_and_grads(model)


def test_train_step_matches_reference(model):
    check_train_step(model)


def test_overfit_matches_reference(model):
    check_overfit(model)


# ---------------------------------------------------------------------------
# the dispatch's gradient under capacity drops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    return pair("granite-moe-1b-a400m")


def _layer_input(cfg, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)


def test_moe_dispatch_gradient_reaches_one_copy_a_slot(granite):
    """Every (token, k) copy as its own row of ``moe_dispatch`` (K = 1, the
    same slots in (token, k) order): under a random cotangent ``G`` of the
    dispatch buffer, a kept copy's gradient is ``G[expert, slot]`` bit for
    bit and a dropped copy's is exactly zero."""
    _, cfg, _, params = granite
    p = lm.layer_params(params, 0)["moe"]
    x = torch.from_numpy(_layer_input(cfg))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    _, _, tope, _ = L.moe_router(p, cfg, x)
    T = tope.shape[0]
    C = L.moe_capacity(T, cfg, DROP_FACTOR)
    copies = x.reshape(T, 1, -1).expand(T, K, -1).reshape(T * K, -1)
    copies = (copies + torch.arange(T * K)[:, None]).requires_grad_()
    disp, slot, keep = L.moe_dispatch(copies, tope.reshape(T * K, 1), E, C)
    assert torch.equal(slot.reshape(T, K), L.moe_slots(tope, E))
    assert 0 < int(keep.sum()) < T * K                # copies were dropped
    G = torch.randn(disp.shape, generator=torch.Generator().manual_seed(3))
    (g,) = torch.autograd.grad(disp, copies, G)
    e, s, k = tope.reshape(-1), slot.reshape(-1), keep.reshape(-1)
    assert torch.equal(g[k], G[e[k], s[k]])
    assert not bool(g[~k].any())
    # each kept slot holds its copy's row, once
    assert torch.equal(disp.detach()[e[k], s[k]], copies.detach()[k])


def test_moe_layer_gradients_with_drops_match_reference(granite):
    """``moe_layer`` at a capacity that drops copies: ``y`` and the
    gradients of ``x`` and of every expert and router weight under a
    random cotangent against ``jax.grad`` of the reference's
    ``moe_layer``; the copies' choices and drops first equal the
    reference's, with no near tie at the top-k boundary; and a second
    backward gives the same bits (no order-dependent accumulation)."""
    cfg_j, cfg_t, params_j, params_t = granite
    pj = jax.tree.map(lambda a: a[0], params_j["layers"]["moe"])
    pt = {k: v.detach().clone()
          for k, v in lm.layer_params(params_t, 0)["moe"].items()}
    x = _layer_input(cfg_t)
    dy = np.random.default_rng(4).standard_normal(x.shape) \
        .astype(np.float32)
    E, K = cfg_t.moe.n_experts, cfg_t.moe.top_k

    def ref(p, xx):
        y, aux = jL.moe_layer(p, cfg_j, xx, capacity_factor=DROP_FACTOR)
        return (y * dy).sum() + aux, y

    (val_j, y_j), (gp_j, gx_j) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(pj, jnp.asarray(x))

    def port():
        xt = torch.from_numpy(x).requires_grad_()
        live = {k: v.requires_grad_() for k, v in pt.items()}
        y, aux = L.moe_layer(live, cfg_t, xt, capacity_factor=DROP_FACTOR)
        val = (y * torch.from_numpy(dy)).sum() + aux
        names = sorted(live)
        grads = torch.autograd.grad(val, [xt] + [live[n] for n in names])
        return val.detach(), y.detach(), grads[0], dict(zip(names,
                                                            grads[1:]))

    with torch.no_grad():
        probs, _, tope, _ = L.moe_router(pt, cfg_t, torch.from_numpy(x))
    srt = probs.sort(dim=-1, descending=True).values
    assert float((srt[:, K - 1] - srt[:, K]).min()) > ROUTE_MARGIN
    C = L.moe_capacity(tope.shape[0], cfg_t, DROP_FACTOR)
    assert 0 < int((L.moe_slots(tope, E) < C).sum()) < tope.numel()

    val, y, gx, gp = port()
    close(y, y_j, GRAD_REL, "y")
    close(val, val_j, GRAD_REL, "value")
    close(gx, gx_j, GRAD_REL, "x")
    assert sorted(gp) == sorted(gp_j)
    for name, g in gp.items():
        close(g, gp_j[name], GRAD_REL, name)
    for name, g in gp.items():
        if name != "router":
            assert float(g.abs().max()) > 0, name
    _, _, gx2, gp2 = port()
    assert torch.equal(gx, gx2)
    assert all(torch.equal(gp[n], gp2[n]) for n in gp)


def test_moe_aux_loss_and_capacity():
    """The reference's ``tests/test_models.py:119`` at its config (reduced,
    bf16, seed 0): the load-balancing term is active.  At float32 it is
    held to the reference's in ``tests/test_torch_moe_vlm.py``."""
    cfg = get_config("granite-moe-1b-a400m").with_reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)) \
        .astype(np.int32)
    with torch.no_grad():
        _, aux = lm.forward(params, cfg, torch.from_numpy(toks))
    assert cfg.dtype == "bfloat16" and float(aux) > 0.0

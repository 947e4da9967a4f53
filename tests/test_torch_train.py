"""The port's training path against the reference, on the CPU.

Reduced Mamba2 (``with_reduced(dtype="float32")``: 2 layers, d_model 64,
d_state 16, head width 16, chunk 16) and reduced Qwen3 (2 layers, 4 query
and 2 KV heads of width 16, qk-norm), both float32.  The reference
initialises the parameters and ``from_jax_params`` carries them over, so
both packages run the same weights on the same numpy tokens.  With
``use_kernel`` the reference runs its Pallas kernels under the
interpreter; the port's wrappers take their plain versions on the CPU.

Tolerances (float32 throughout, differing in summation order only):
logits within ``LOGIT_REL`` (1e-4) of their largest magnitude; the loss
within 1e-5 relative; each gradient leaf within ``GRAD_REL`` (1e-4) of
that leaf's largest magnitude (the reference's SSD backward is the
sequential recurrence, the port's the chunked form); one AdamW step's
parameter change within ``STEP_REL`` (2e-3) of the reference's largest
change per leaf.  Adam's first step moves each element by ``lr * g /
(|g| + eps)``, which turns the gradients' float32 differences into
differences of ``lr`` size where ``|g|`` is near ``eps``; the step test
takes ``eps = 1e-5`` so no element sits there (at 1e-8 some in_proj
elements differ by 4% of the largest change, at 1e-5 none by 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import launch_counts, reset_launches
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, named_leaves

LOGIT_REL, LOSS_REL, GRAD_REL, STEP_REL = 1e-4, 1e-5, 1e-4, 2e-3
ARCHS = ("mamba2-130m", "qwen3-0.6b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg_j = jax_get_config(arch).with_reduced(dtype="float32")
    cfg_t = get_config(arch).with_reduced(dtype="float32")
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _batch(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= rel * scale, (what, err, scale)


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(model, S, use_kernel):
    """Logits of a full sequence; S = 40 is not a multiple of Mamba2's
    chunk of 16 (the pad path)."""
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _batch(cfg_t, 2, S)["tokens"]
    want, _ = jlm.forward(params_j, cfg_j, jnp.asarray(tokens),
                          use_kernel=use_kernel)
    with torch.no_grad():
        got, aux = lm.forward(params_t, cfg_t, torch.from_numpy(tokens),
                              use_kernel=use_kernel)
    assert float(aux) == 0.0
    _close(got, want, LOGIT_REL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(model, remat):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(lm.loss_fn)``, through the kernels' paths."""
    cfg_j, cfg_t, params_j, params_t = model
    batch = _batch(cfg_t, 2, 40, seed=1)
    loss_j, grads_j = jax.value_and_grad(jlm.loss_fn)(
        params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=remat, use_kernel=True)
    flat = [p.requires_grad_() for p in leaves(params_t)]
    try:
        loss = lm.loss_fn(params_t, cfg_t, _t(batch), remat=remat,
                          use_kernel=True)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    _close(loss.detach(), loss_j, LOSS_REL, "loss")
    want = _jax_leaves(grads_j)
    names = [n for n, _ in named_leaves(params_t)]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        _close(g, want[name], GRAD_REL, name)


def test_train_step_matches_reference(model):
    """One ``make_train_step`` (remat, kernels) against the reference's
    jitted step: loss, lr, pre-clip gradient norm and every parameter's
    change."""
    cfg_j, cfg_t, params_j, params_t = model
    batch = _batch(cfg_t, 2, 32, seed=2)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.5,
              eps=1e-5)
    opt_j, opt_t = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    step_j = jax.jit(jax_make_train_step(cfg_j, opt_j, remat=True,
                                         use_kernel=True))
    new_j, state_j, m_j = step_j(params_j, jax_adamw_init(params_j, opt_j),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    reset_launches()
    step_t = make_train_step(cfg_t, opt_t, use_kernel=True)
    new_t, state_t, m_t = step_t(params_t, adamw_init(params_t, opt_t),
                                 _t(batch))
    assert launch_counts() == {}          # the CPU takes the plain versions
    for k in ("loss", "lr", "grad_norm"):
        _close(m_t[k], m_j[k], LOSS_REL, k)
    assert int(state_t["step"]) == int(state_j["step"]) == 1
    old = dict(named_leaves(params_t))
    want_new, want_old = _jax_leaves(new_j), _jax_leaves(params_j)
    for name, p in named_leaves(new_t):
        assert not old[name].requires_grad and p.dtype == old[name].dtype
        _close(p - old[name], want_new[name] - want_old[name], STEP_REL,
               name)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_with_clipping(state_dtype):
    """Three AdamW updates of a mixed-dtype tree with clipping active
    (gradient norm ~20 against ``clip_norm`` 1) and the warmup/cosine
    schedule, against the reference."""
    rng = np.random.default_rng(7)

    def tree(scale):
        def mk(*shape):
            return (scale * rng.standard_normal(shape)).astype(np.float32)
        return {"w": mk(8, 4), "b": mk(4), "inner": {"s": mk(3)}}

    params = tree(1.0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0,
              state_dtype=state_dtype)
    cj, ct = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    pj = jax.tree.map(jnp.asarray, params)
    pt = jax.tree.map(torch.from_numpy, params)
    sj, st = jax_adamw_init(pj, cj), adamw_init(pt, ct)
    for _ in range(3):
        g = tree(5.0)
        pj, sj, mj = jax_adamw_update(jax.tree.map(jnp.asarray, g), sj, pj,
                                      cj)
        pt, st, mt = adamw_update(jax.tree.map(torch.from_numpy, g), st, pt,
                                  ct)
        assert float(mj["grad_norm"]) > 10 * ct.clip_norm
        for k in ("grad_norm", "lr"):
            _close(mt[k], mj[k], 1e-6, k)
    for part_t, part_j in ((pt, pj), (st["m"], sj["m"]), (st["v"], sj["v"])):
        want = _jax_leaves(part_j)
        for name, t in named_leaves(part_t):
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
            _close(t.float(), want[name].astype(np.float32),
                   1e-2 if state_dtype == "bfloat16" else 1e-5, name)
    assert int(st["step"]) == 3

"""Shared cases of the port's training parity tests over every
architecture (``tests/test_torch_train_families_*.py``); not a test file.

Each architecture runs at ``with_reduced(dtype="float32")``.  The
reference initialises the parameters and ``from_jax_params`` carries them
over, so both packages run the same weights on the same numpy batch:
tokens and labels from ``default_rng(seed)``, and the vlm family's
``patches`` or the audio family's ``frames`` drawn from the same
generator (not zeros, so the patch projection and the encoder carry
gradient).  With ``use_kernel`` the reference runs its Pallas kernels
under the interpreter; the port's wrappers take their plain versions on
the CPU.

Tolerances are ``tests/test_torch_train.py``'s (float32 throughout,
differing in summation order only): logits within ``LOGIT_REL`` (1e-4)
of their largest magnitude; the loss within ``LOSS_REL`` (1e-5)
relative; each gradient leaf within ``GRAD_REL`` (1e-4) of that leaf's
largest magnitude; one AdamW step's parameter change within ``STEP_REL``
(2e-3) of the reference's largest change per leaf, with ``eps = 1e-5``
(Adam's first step moves an element by ``lr * g / (|g| + eps)``, which
turns float32 differences of gradients near ``eps`` into differences of
``lr`` size).  The four-step overfit (``tests/test_models.py:44``) holds
each of the port's four losses within ``LOSS_REL`` of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import leaves, named_leaves

LOGIT_REL, LOSS_REL, GRAD_REL, STEP_REL = 1e-4, 1e-5, 1e-4, 2e-3
OVERFIT_STEPS = 4


def pair(arch: str, seed: int = 0, **kw) -> tuple:
    """``(cfg_j, cfg_t, params_j, params_t)`` at ``with_reduced(dtype=
    "float32", **kw)``, the reference's parameters carried over."""
    cfg_j = jax_get_config(arch).with_reduced(dtype="float32", **kw)
    cfg_t = get_config(arch).with_reduced(dtype="float32", **kw)
    params_j = jlm.init_params(cfg_j, jax.random.key(seed))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def batch(cfg, B: int, S: int, seed: int, roll: bool = False) -> dict:
    """A numpy batch: tokens, labels (the next tokens, or with ``roll``
    the tokens rolled by one as ``tests/test_models.py`` makes them), and
    random ``patches`` / ``frames`` where the family takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if roll:
        out["labels"] = np.roll(out["tokens"], -1, 1)
    if cfg.vlm is not None:
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(np.float32)
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return out


def as_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def close(got, want, rel: float, what: str = "") -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= rel * scale, (what, err, scale)


def jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def port_loss_and_grads(params_t, cfg_t, b: dict, **kw) -> tuple:
    """The port's ``loss_fn`` and its gradient a leaf, as numpy."""
    flat = [p.requires_grad_() for p in leaves(params_t)]
    try:
        loss = lm.loss_fn(params_t, cfg_t, as_torch(b), **kw)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    names = [n for n, _ in named_leaves(params_t)]
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def check_loss_and_grads(model, S: int = 32, **kw) -> None:
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(lm.loss_fn)``, remat and the kernels' paths
    unless ``kw`` says otherwise."""
    cfg_j, cfg_t, params_j, params_t = model
    kw = {"remat": True, "use_kernel": True, **kw}
    b = batch(cfg_t, 2, S, seed=1)
    loss_j, grads_j = jax.value_and_grad(jlm.loss_fn)(
        params_j, cfg_j, as_jax(b), **kw)
    loss_t, grads_t = port_loss_and_grads(params_t, cfg_t, b, **kw)
    close(loss_t, loss_j, LOSS_REL, "loss")
    want = jax_leaves(grads_j)
    assert sorted(grads_t) == sorted(want)
    for name, g in grads_t.items():
        close(g, want[name], GRAD_REL, name)
        if cfg_t.vlm is not None and name == "patch_proj" or \
                cfg_t.encdec is not None and name.startswith("enc_"):
            assert np.abs(g).max() > 0, name      # the extra inputs train


def check_train_step(model) -> None:
    """One ``make_train_step`` (remat, kernels) against the reference's
    jitted step: loss, lr, pre-clip gradient norm and every parameter's
    change; on the CPU no kernel is launched."""
    cfg_j, cfg_t, params_j, params_t = model
    b = batch(cfg_t, 2, 32, seed=2)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.5,
              eps=1e-5)
    opt_j, opt_t = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    step_j = jax.jit(jax_make_train_step(cfg_j, opt_j, remat=True,
                                         use_kernel=True))
    new_j, state_j, m_j = step_j(params_j, jax_adamw_init(params_j, opt_j),
                                 as_jax(b))
    reset_launches()
    step_t = make_train_step(cfg_t, opt_t, use_kernel=True)
    new_t, state_t, m_t = step_t(params_t, adamw_init(params_t, opt_t),
                                 as_torch(b))
    assert launch_counts() == {}
    for k in ("loss", "lr", "grad_norm"):
        close(m_t[k], m_j[k], LOSS_REL, k)
    assert int(state_t["step"]) == int(state_j["step"]) == 1
    old = dict(named_leaves(params_t))
    want_new, want_old = jax_leaves(new_j), jax_leaves(params_j)
    assert sorted(old) == sorted(want_new)
    for name, p in named_leaves(new_t):
        assert not old[name].requires_grad and p.dtype == old[name].dtype
        close(p - old[name], want_new[name] - want_old[name], STEP_REL,
              name)


def check_overfit(model) -> None:
    """The reference's same-batch overfit (``tests/test_models.py:44``):
    ``OVERFIT_STEPS`` steps of ``value_and_grad(loss_fn)`` and AdamW (the
    test's settings: lr 1e-3, warmup 1, 10 total) on one batch, jitted in the
    reference and through ``make_train_step(remat=False)`` in the port;
    each loss within ``LOSS_REL`` of the reference's, finite, and the
    last below the first."""
    cfg_j, cfg_t, params_j, params_t = model
    b = batch(cfg_t, 2, 32, seed=3, roll=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_j, opt_t = JaxAdamWConfig(**kw), AdamWConfig(**kw)

    @jax.jit
    def step(p, s, bb):
        loss, g = jax.value_and_grad(jlm.loss_fn)(p, cfg_j, bb)
        p2, s2, _ = jax_adamw_update(g, s, p, opt_j)
        return p2, s2, loss

    p, s, bj = params_j, jax_adamw_init(params_j, opt_j), as_jax(b)
    step_t = make_train_step(cfg_t, opt_t, remat=False)
    q, st, bt = params_t, adamw_init(params_t, opt_t), as_torch(b)
    want, got = [], []
    for _ in range(OVERFIT_STEPS):
        p, s, loss = step(p, s, bj)
        want.append(float(loss))
        q, st, m = step_t(q, st, bt)
        got.append(float(m["loss"]))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, LOSS_REL, f"loss {i}")
    assert got[-1] < got[0] and want[-1] < want[0]

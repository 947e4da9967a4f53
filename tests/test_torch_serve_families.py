"""Serving over every architecture, on the CPU: prefill + decode equals
the forward pass; and the three dense models' parameter counts.

The serving half of the reference's model tests
(``tests/test_models.py:66-94``, which is marked ``slow`` and takes six
architectures) over every ``ARCH_IDS`` entry, grok-1-314b included, at
the published GQA groups (shared cases and tolerances:
``tests/torch_serve_parity.py``).  An MoE runs at a dropless capacity
(``capacity_factor = n_experts``) in both packages: the forward pass
routes B * S tokens against a capacity of ceil(B S K / E * 1.25), a
decode step B, so at the default capacity the longer pass may rightly
drop a copy the decode step keeps.  The port's serving logits against
the reference's are in ``tests/test_torch_serve_logits.py``,
starcoder2-3b's binding window in ``tests/test_torch_serve_window.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from torch_serve_parity import MARGIN, close, dropless, extra, margin, pair

B, S, MAX_SEQ, STEPS = 2, 16, 32, 3
# (from the leaves at full width, which the port's param_count() gives;
# the reference's param_count()): the reference counts qk-norm as 2 x
# n_heads x hd a layer where the model has two [hd] scales
DENSE_PARAMS = {"qwen3-4b": (4_022_468_096, 4_022_753_792),
                "yi-6b": (6_061_035_520, 6_061_035_520),
                "starcoder2-3b": (4_312_980_480, 4_312_980_480)}


@pytest.mark.parametrize("arch", sorted(DENSE_PARAMS))
def test_dense_param_count_from_the_leaves(arch):
    """The full-width tree (meta tensors: shapes only) has the
    reference's leaves and shapes; its count from the leaves equals the
    port's ``param_count()`` and the pinned number, and the reference's
    ``param_count()`` the second pinned number."""
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    p = lm.init_params(cfg_t, device="meta")
    shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape),
                            jlm.abstract_params(cfg_j))
    assert shapes_t == shapes_j
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert (n, cfg_j.param_count()) == DENSE_PARAMS[arch]
    assert cfg_t.param_count() == n
    if cfg_t.qk_norm:
        assert cfg_j.param_count() - n == \
            cfg_j.n_layers * 2 * (cfg_j.n_heads - 1) * cfg_j.hd


def _greedy(prefill, decode_step, params, cfg, toks, ext, as_in) -> tuple:
    """Prefill + ``STEPS`` greedy decode steps: the ``STEPS + 1`` tokens
    and the logits each was taken from, as numpy."""
    logits, cache = prefill(params, cfg, as_in(toks), extra=ext,
                            max_seq=MAX_SEQ)
    seen, out = [], []
    for t in range(STEPS + 1):
        seen.append(np.asarray(logits, np.float32))
        out.append(seen[-1].argmax(-1).astype(np.int32))
        if t < STEPS:
            logits, cache = decode_step(params, cfg, as_in(out[-1]), cache)
    return out, seen


def _forward_greedy(forward, params, cfg, toks, ext, as_in) -> tuple:
    """The forward pass's greedy token on the growing sequence."""
    seq, out, seen = toks, [], []
    for _ in range(STEPS + 1):
        logits, _ = forward(params, cfg, as_in(seq), extra=ext)
        seen.append(np.asarray(logits[:, -1], np.float32))
        out.append(seen[-1].argmax(-1).astype(np.int32))
        seq = np.concatenate([seq, out[-1][:, None]], axis=1)
    return out, seen


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward(arch, monkeypatch):
    """The reference's ``test_prefill_decode_matches_forward`` at the
    published group: in each package the greedy continuation by prefill
    + 3 decode steps equals the forward pass's on the growing sequence,
    token by token; the port's tokens equal the reference's and its
    logits are within ``LOGIT_REL`` of them at every step, by both
    paths."""
    cfg_j, cfg_t, params_j, params_t = pair(arch)
    dropless(monkeypatch)
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab, (B, S)) \
        .astype(np.int32)
    ej, et = extra(cfg_t, B)
    dec_j, seen_j = _greedy(jlm.prefill, jlm.decode_step, params_j, cfg_j,
                            toks, ej, jnp.asarray)
    fwd_j, fseen_j = _forward_greedy(jlm.forward, params_j, cfg_j, toks, ej,
                                     jnp.asarray)
    with torch.no_grad():
        dec_t, seen_t = _greedy(lm.prefill, lm.decode_step, params_t, cfg_t,
                                toks, et, torch.from_numpy)
        fwd_t, fseen_t = _forward_greedy(lm.forward, params_t, cfg_t, toks,
                                         et, torch.from_numpy)
    assert min(map(margin, seen_j + fseen_j)) > MARGIN
    for t in range(STEPS + 1):
        assert dec_j[t].tolist() == fwd_j[t].tolist(), ("reference", t)
        assert dec_t[t].tolist() == fwd_t[t].tolist(), ("port", t)
        assert dec_t[t].tolist() == dec_j[t].tolist(), ("port vs ref", t)
        close(seen_t[t], seen_j[t], f"decode {t}")
        close(fseen_t[t], fseen_j[t], f"forward {t}")

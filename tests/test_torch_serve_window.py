"""starcoder2-3b's sliding window binding in serving, on the CPU, against
the reference.

The published window is 4096, which no reduced prompt reaches, so both
packages run ``with_reduced(sliding_window=8)`` at the published group
(24 query heads on 2 KV heads of 16; shared cases and tolerances:
``tests/torch_serve_parity.py``).  A 6-token prefill sits at positions
0-5; decode step ``t`` writes position ``6 + t`` and sees the keys past
``6 + t - 8``, so the window first hides a key at step 2 (the third).
Decode with a window goes through windowed ``sdpa`` whatever
``attn_impl`` says, in both packages (the reference's
``layers.py:328``, the port's ``attention_decode``); the prefill's
attention goes through flash attention's windowed plain version under
``attn_impl="kernel"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm
from torch_serve_parity import LOGIT_REL, close, close_cache, pair

ARCH, WINDOW = "starcoder2-3b", 8
PROMPT, STEPS, MAX_SEQ = 6, 12, 32
BINDS = WINDOW - PROMPT       # the first decode step the window binds at
MOVED = 100 * LOGIT_REL       # the least relative change a bound window makes


@pytest.fixture(scope="module")
def windowed():
    return pair(ARCH, sliding_window=WINDOW)


def _decode(prefill, decode_step, params, cfg, toks, steps, as_in) -> list:
    """The prefill's logits and then ``steps`` decode steps' on the given
    token rows, as numpy."""
    logits, cache = prefill(params, cfg, as_in(toks[:, :PROMPT]),
                            max_seq=MAX_SEQ)
    out = [np.asarray(logits, np.float32)]
    for t in range(steps):
        logits, cache = decode_step(params, cfg, as_in(toks[:, PROMPT + t]),
                                    cache)
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_windowed_decode_matches_reference(windowed, attn_impl):
    """A 6-token prefill, then 12 decode steps: each step's logits within
    ``LOGIT_REL`` of the reference's ``decode_step``, the window binding
    from step 2 on."""
    cfg_j, cfg_t, params_j, params_t = windowed
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    toks = np.random.default_rng(11).integers(
        0, cfg_t.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    want = _decode(jlm.prefill, jlm.decode_step, params_j, cfg_j, toks,
                   STEPS, jnp.asarray)
    with torch.no_grad():
        got = _decode(lm.prefill, lm.decode_step, params_t, cfg_t, toks,
                      STEPS, torch.from_numpy)
    for t, (g, w) in enumerate(zip(got, want)):
        close(g, w, f"step {t - 1}" if t else "prefill")


def test_window_binds_in_decode(windowed):
    """The same weights without a window: the logits agree while every
    key lies inside the window (the prefill and steps 0-1) and move by
    more than ``MOVED`` of their largest magnitude at every step after."""
    _, cfg_t, _, params_t = windowed
    toks = np.random.default_rng(11).integers(
        0, cfg_t.vocab, (2, PROMPT + STEPS)).astype(np.int32)
    with torch.no_grad():
        win = _decode(lm.prefill, lm.decode_step, params_t, cfg_t, toks,
                      STEPS, torch.from_numpy)
        full = _decode(lm.prefill, lm.decode_step, params_t,
                       dataclasses.replace(cfg_t, sliding_window=None), toks,
                       STEPS, torch.from_numpy)
    for t, (w, f) in enumerate(zip(win, full)):
        step = t - 1                          # -1: the prefill
        rel = np.abs(w - f).max() / np.abs(f).max()
        if step < BINDS:
            assert rel <= LOGIT_REL, (step, rel)
        else:
            assert rel > MOVED, (step, rel)


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_windowed_batched_adapter_matches_reference(windowed, attn_impl):
    """The batched ``serving_adapter`` on both sides: prompts of 3, 6, 10
    and 14 tokens in one 16-token bucket (the last two past the window in
    the prefill, the first two crossing it in decode) written into 5
    slots, one left dead, then 12 greedy steps: the prefill's and every
    step's tokens equal the reference adapter's, the dead slot's 0, and
    the packed caches agree after the last step."""
    cfg_j, cfg_t, params_j, params_t = windowed
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    ad_j = jlm.serving_adapter(params_j, cfg_j, max_seq=MAX_SEQ)
    ad_t = lm.serving_adapter(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu")
    lens = np.array([3, 6, 10, 14], np.int32)
    toks = np.zeros((4, 16), np.int32)
    rng = np.random.default_rng(12)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg_t.vocab, n)
    first_j, cache_j = ad_j.prefill_fn(jnp.asarray(toks), jnp.asarray(lens),
                                       jnp.int32(0))
    pj = ad_j.init_slots(5)
    with torch.no_grad():
        first_t, cache_t = ad_t.prefill_fn(
            torch.from_numpy(toks), torch.from_numpy(lens),
            torch.tensor(0, dtype=torch.int32))
        assert first_t.tolist() == np.asarray(first_j).tolist()
        pt = ad_t.init_slots(5)
        slots = (4, 0, 2, 1)                  # slot 3 stays dead
        tok = np.zeros(5, np.int32)
        for row, slot in enumerate(slots):
            pj = ad_j.write_slot_fn(pj, cache_j, jnp.int32(row),
                                    jnp.int32(slot))
            ad_t.write_slot_fn(pt, cache_t, torch.tensor(row),
                               torch.tensor(slot))
            tok[slot] = int(first_t[row])
        assert pt["len"].tolist() == [6, 14, 10, 0, 3]
        for step in range(1, STEPS + 1):
            nj, pj = ad_j.step_fn(jnp.asarray(tok), pj, jnp.int32(step))
            nt, pt = ad_t.step_fn(torch.from_numpy(tok), pt,
                                  torch.tensor(step, dtype=torch.int32))
            assert nt.tolist() == np.asarray(nj).tolist(), step
            assert int(nt[3]) == 0
            tok = nt.numpy().astype(np.int32)
    assert pt["len"].tolist() == [6 + STEPS, 14 + STEPS, 10 + STEPS, 0,
                                  3 + STEPS]
    close_cache(pt, pj)

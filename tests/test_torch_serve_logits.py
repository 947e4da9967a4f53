"""The port's serving logits against the reference's over every
architecture, on the CPU, at the published GQA groups (shared cases and
tolerances: ``tests/torch_serve_parity.py``): the flash-decode kernel's
plain version at groups 4 (qwen3-4b), 6 (grok-1-314b), 8 (yi-6b) and 12
(starcoder2-3b, whose published window of 4096 does not bind here),
beside the families already served.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS
from repro_torch.models import lm
from torch_serve_parity import close, close_cache, extra, pair

B, S, MAX_SEQ = 2, 16, 32


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_logits_match_reference(arch, attn_impl):
    """The port's ``prefill`` and ``decode_step`` logits against the
    reference's ``lm.prefill`` / ``lm.decode_step``, through ``attn_impl``
    ``kernel`` (the port's kernels take their plain versions here, the
    reference's Pallas kernels run in interpret mode) and ``naive``.  The
    batched families as they serve: a bucketed prefill with ragged
    lengths (a full row, a mid row, one token) and 4 ragged decode steps
    through flash-decode; the per-slot families (ssm, hybrid, audio) one
    prompt length a call, as ``launch.serve`` and ``make_prefill_step``
    run them.  The caches after the last step too."""
    cfg_j, cfg_t, params_j, params_t = pair(arch)
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    rng = np.random.default_rng(5)
    batched = cfg_t.family in lm.BATCHED_FAMILIES
    nb = 3 if batched else B
    toks = rng.integers(0, cfg_t.vocab, (nb, S)).astype(np.int32)
    ej, et = extra(cfg_t, nb)
    kw_j, kw_t = {}, {}
    if batched:
        lens = np.array([S, 9, 1], np.int32)
        kw_j = dict(true_len=jnp.asarray(lens))
        kw_t = dict(true_len=torch.from_numpy(lens))
    lj, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), extra=ej,
                         max_seq=MAX_SEQ, **kw_j)
    with torch.no_grad():
        lt, ct = lm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                            extra=et, max_seq=MAX_SEQ, **kw_t)
        close(lt.numpy(), lj, "prefill")
        for step in range(4):
            tok = rng.integers(0, cfg_t.vocab, (nb,)).astype(np.int32)
            lj, cj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), cj)
            lt, ct = lm.decode_step(params_t, cfg_t, torch.from_numpy(tok),
                                    ct)
            close(lt.numpy(), lj, f"decode {step}")
    close_cache(ct, cj)

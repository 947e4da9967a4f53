"""The port's moe and vlm families against the reference, on the CPU.

Reduced granite-moe-1b-a400m (``with_reduced()``: 2 layers, d_model 64,
4 experts top-2 of width 32, GQA 4/2 heads of 16) and phi-3-vision-4.2b
(2 layers, MHA 4/4 heads of 16, 8 patches of 32), float32 unless a test
says otherwise.  The reference initialises the parameters and
``from_jax_params`` carries them over, so both packages run the same
weights on the same numpy inputs.

Tolerances:

* ``moe_layer``: the dispatch (which token sits in which slot of which
  expert, and which copies are dropped) is exact — the reference's
  dispatch buffer is read off its own einsum and must equal the port's
  bit for bit; ``y`` within ``Y_TOL`` of the reference (absolute, |y| is
  O(1)), ``aux`` within ``AUX_TOL``.  The routing decision rests on
  float32 router logits that XLA and PyTorch sum in different orders, so
  each case first asserts that every token's k-th and (k+1)-th
  probabilities are more than ``ROUTE_MARGIN`` apart: a difference there
  would be a float-class near tie, told apart from a dispatch fault.
* logits within ``LOGIT_REL`` of their largest magnitude (float32, the
  summation order differs), aux within ``AUX_TOL``;
* greedy tokens equal, with every sampled position's top-2 logit margin
  above ``MARGIN`` (so no near tie can flip one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jax_get_config
from repro.core.compile_cache import CompileCache
from repro.launch import steps as jsteps
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params
from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                               serve_requests)

ARCHS = ("granite-moe-1b-a400m", "phi-3-vision-4.2b")
LOGIT_REL = 1e-4
Y_TOL = 1e-5
AUX_TOL = 1e-6
ROUTE_MARGIN = 1e-5
MARGIN = 1e-3
MAX_SEQ = 32


def _pair(arch: str, dtype: str = "float32", seed: int = 0):
    cfg_j = jax_get_config(arch).with_reduced(dtype=dtype)
    cfg_t = get_config(arch).with_reduced(dtype=dtype)
    params_j = jlm.init_params(cfg_j, jax.random.key(seed))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-moe-1b-a400m")


def _close(got, want, rel=LOGIT_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


def _extra(cfg, B: int, seed: int = 7):
    """Random patches for a vlm (numpy, seeded), else nothing:
    ``(extra for the reference, extra for the port)``."""
    if cfg.vlm is None:
        return {}, {}
    p = np.random.default_rng(seed).standard_normal(
        (B, cfg.vlm.n_patches, cfg.vlm.d_patch)).astype(np.float32)
    return {"patches": jnp.asarray(p)}, {"patches": torch.from_numpy(p)}


# ---------------------------------------------------------------------------
# moe_layer: dispatch exact, y and aux close
# ---------------------------------------------------------------------------

class _EinsumSpy:
    """Stands in for ``jax.numpy`` inside the reference's layers module and
    keeps the first operand of every einsum of ``spec`` (the dispatch
    buffer, or the grouped dispatch mask)."""

    def __init__(self, spec: str):
        self.spec, self.seen = spec, []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == self.spec:
            self.seen.append(np.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)


def _moe_input(cfg, case: str) -> np.ndarray:
    """[2, 16, d] float32: random rows; ``pads`` repeats one row over the
    last 6 positions of each batch row, as a right-padded bucket's pad
    tokens all carry the pad token's embedding."""
    x = np.random.default_rng(11).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    if case == "pads":
        x[:, 10:] = x[0, 0]
    return x


CASES = {"plain": 1.25, "drops": 0.25, "pads": 1.25}


@pytest.mark.parametrize("impl", ["scatter", "scatter_fast", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_matches_reference(granite, monkeypatch, impl, case):
    cfg_j, cfg_t, params_j, params_t = granite
    cfg_j = dataclasses.replace(cfg_j, moe_impl=impl)
    cfg_t = dataclasses.replace(cfg_t, moe_impl=impl)
    cf = CASES[case]
    pj = jax.tree.map(lambda a: a[0], params_j["layers"]["moe"])
    pt = lm.layer_params(params_t, 0)["moe"]
    x = _moe_input(cfg_t, case)
    B, S, d = x.shape
    E, K = cfg_t.moe.n_experts, cfg_t.moe.top_k

    spy = _EinsumSpy("bsec,bsd->becd" if impl == "dense" else
                     "ecd,edf->ecf")
    monkeypatch.setattr(jL, "jnp", spy)
    y_j, aux_j = jL.moe_layer(pj, cfg_j, jnp.asarray(x),
                              capacity_factor=cf)
    monkeypatch.undo()
    want = spy.seen[0]          # the gate's product; the up's reads the same
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_t, aux_t = L.moe_layer(pt, cfg_t, xt, capacity_factor=cf)
        probs, _, tope, _ = L.moe_router(pt, cfg_t, xt)

    # no float-class near tie at the top-k boundary
    srt = probs.sort(dim=-1, descending=True).values
    assert float((srt[:, K - 1] - srt[:, K]).min()) > ROUTE_MARGIN

    if impl == "dense":
        got, _ = L.moe_dense_masks(cfg_t, probs, B, S, cf)
        assert np.array_equal(got.numpy(), want != 0)
        kept = int(got.sum())
    else:
        C = L.moe_capacity(B * S, cfg_t, cf)
        disp, slot, keep = L.moe_dispatch(xt, tope, E, C)
        assert disp.shape == want.shape == (E, C, d)
        assert np.array_equal(disp.numpy(), want)     # bit for bit
        kept = int(keep.sum())
        if case != "pads":
            # the (token, k, expert, slot) set: the reference's decoded
            # from its buffer (every token row is distinct here)
            rows = {x.reshape(-1, d)[t].tobytes(): t for t in range(B * S)}
            ref = {(rows[want[e, c].tobytes()], e, c)
                   for e in range(E) for c in range(C)
                   if want[e, c].any()}
            port = {(t, int(tope[t, k]), int(slot[t, k]))
                    for t in range(B * S) for k in range(K)
                    if bool(keep[t, k])}
            assert port == ref
    if case == "drops":
        assert kept < B * S * K                # copies were dropped
    else:
        assert kept > 0
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=Y_TOL)
    assert abs(float(aux_t) - float(aux_j)) <= AUX_TOL
    assert float(aux_t) > 0


def test_moe_layer_refuses_an_unknown_impl(granite):
    _, cfg, _, params = granite
    with pytest.raises(ValueError, match="moe_impl"):
        L.moe_layer(lm.layer_params(params, 0)["moe"],
                    dataclasses.replace(cfg, moe_impl="ragged"),
                    torch.zeros(1, 4, cfg.d_model))


def test_moe_dispatch_keeps_each_slot_for_one_copy():
    """Every token on expert 0 of a capacity of 3: copies 0-2 take slots
    0-2, the rest are dropped, and the spare row never shows."""
    tope = torch.zeros((6, 1), dtype=torch.long)
    x = torch.arange(6, dtype=torch.float32)[:, None].expand(6, 2)
    disp, slot, keep = L.moe_dispatch(x, tope, 2, 3)
    assert slot[:, 0].tolist() == [0, 1, 2, 3, 4, 5]
    assert keep[:, 0].tolist() == [True] * 3 + [False] * 3
    assert disp[0, :, 0].tolist() == [0.0, 1.0, 2.0]
    assert disp.shape == (2, 3, 2) and not bool(disp[1].any())


# ---------------------------------------------------------------------------
# forward, loss, prefill/decode
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_t.vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg_t.vocab, (2, 24)).astype(np.int32)
    ej, et = _extra(cfg_t, 2)
    lj, aj = jlm.forward(params_j, cfg_j, jnp.asarray(toks), extra=ej)
    with torch.no_grad():
        lt, at = lm.forward(params_t, cfg_t, torch.from_numpy(toks),
                            extra=et)
    _close(lt.numpy(), np.asarray(lj))
    assert abs(float(at) - float(aj)) <= AUX_TOL
    if cfg_t.family == "moe":
        assert float(at) > 0.0                 # load-balance loss active
    else:
        assert float(at) == 0.0
        # the patches reach the logits: without them the first positions
        # differ
        lt0, _ = lm.forward(params_t, cfg_t, torch.from_numpy(toks))
        assert not torch.allclose(lt0[:, 0], lt[:, 0])
        _close(lt0[:, cfg_t.vlm.n_patches:].detach().numpy(),
               np.asarray(jlm.forward(params_j, cfg_j,
                                      jnp.asarray(toks))[0])
               [:, cfg_t.vlm.n_patches:])
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **ej}
    bt = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels), **et}
    loss_j = float(jlm.loss_fn(params_j, cfg_j, bj))
    with torch.no_grad():
        loss_t = float(lm.loss_fn(params_t, cfg_t, bt))
    assert abs(loss_t - loss_j) <= LOGIT_REL * abs(loss_j)


def test_remat_forward_and_gradients_keep_the_aux(granite):
    """The aux term survives per-layer checkpointing, and the loss's
    gradient reaches the router through it."""
    _, cfg, _, params = granite
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    live = dict(params)
    router = params["layers"]["moe"]["router"].detach().requires_grad_()
    live["layers"] = dict(params["layers"],
                          moe=dict(params["layers"]["moe"], router=router))
    _, aux = lm.forward(live, cfg, toks)
    _, aux_r = lm.forward(live, cfg, toks, remat=True)
    assert float(aux_r.detach()) == pytest.approx(float(aux.detach()),
                                                  abs=AUX_TOL)
    (g,) = torch.autograd.grad(aux_r, [router])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def _greedy_margin(logits) -> float:
    v = torch.as_tensor(np.asarray(logits, np.float32)).topk(2, -1).values
    return float((v[..., 0] - v[..., 1]).min())


def _greedy(params, cfg, toks: np.ndarray, extra, prefill, decode_step,
            as_in) -> tuple:
    """Prefill, then 3 greedy decode steps: ``(4 [B] token arrays, every
    step's logits)``; ``as_in`` makes a package's array of numpy."""
    logits, cache = prefill(params, cfg, as_in(toks), extra=extra,
                            max_seq=MAX_SEQ)
    out, seen = [], []
    for _ in range(4):
        seen.append(np.asarray(logits, np.float32))
        out.append(np.argmax(seen[-1], -1).astype(np.int32))
        if len(out) < 4:
            logits, cache = decode_step(params, cfg, as_in(out[-1]), cache)
    return out, seen


def _forward_greedy(forward, params, cfg, toks: np.ndarray, extra, as_in):
    """The forward pass's greedy token on the growing sequence, 4 times."""
    seq, out = toks, []
    for _ in range(4):
        logits, _ = forward(params, cfg, as_in(seq), extra=extra)
        nxt = np.argmax(np.asarray(logits[:, -1], np.float32), -1) \
            .astype(np.int32)
        out.append(nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    return out


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_prefill_decode_matches_forward_and_reference(model, attn_impl,
                                                       monkeypatch):
    """Mirrors the reference's ``test_prefill_decode_matches_forward``.

    * The port's greedy continuation by prefill + decode_step equals the
      reference's (logits close, tokens equal), and so does its forward
      pass on the growing sequence.
    * Within the port, prefill + decode equals the forward pass on the
      growing sequence with no expert copy dropped.  With the default
      capacity the two may rightly differ for an MoE, in both packages:
      the forward pass routes B * S tokens against a capacity of
      ceil(B S K / E * 1.25), a decode step B tokens against at least 4
      slots, so the longer pass may drop a copy the decode step keeps (at
      these inputs it does, in the forward pass of 2 x 17 tokens).  The
      capacity is raised to ``E`` (C >= T K, dropless) for that check.
    """
    cfg_j, cfg_t, params_j, params_t = model
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg_t = dataclasses.replace(cfg_t, attn_impl=attn_impl)
    B, S = 2, 16
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab, (B, S)) \
        .astype(np.int32)
    ej, et = _extra(cfg_t, B)
    with torch.no_grad():
        dec_t, seen_t = _greedy(params_t, cfg_t, toks, et, lm.prefill,
                                lm.decode_step, torch.from_numpy)
        dec_j, seen_j = _greedy(params_j, cfg_j, toks, ej, jlm.prefill,
                                jlm.decode_step, jnp.asarray)
        for got, want in zip(seen_t, seen_j):
            _close(got, want)
        assert min(map(_greedy_margin, seen_t)) > MARGIN
        assert [d.tolist() for d in dec_t] == [d.tolist() for d in dec_j]
        fwd_t = _forward_greedy(lm.forward, params_t, cfg_t, toks, et,
                                torch.from_numpy)
        fwd_j = _forward_greedy(jlm.forward, params_j, cfg_j, toks, ej,
                                jnp.asarray)
        assert [d.tolist() for d in fwd_t] == [d.tolist() for d in fwd_j]

        moe_layer = L.moe_layer
        monkeypatch.setattr(L, "moe_layer", lambda p, cfg, x: moe_layer(
            p, cfg, x, capacity_factor=float(cfg.moe.n_experts)))
        dec, _ = _greedy(params_t, cfg_t, toks, et, lm.prefill,
                         lm.decode_step, torch.from_numpy)
        fwd = _forward_greedy(lm.forward, params_t, cfg_t, toks, et,
                              torch.from_numpy)
    assert [d.tolist() for d in dec] == [d.tolist() for d in fwd]


def test_bucketed_prefill_and_ragged_decode_match_reference(model):
    """Right-padded bucketed prefill with ragged true_len (full row, mid
    row, one token, empty row) — an MoE's pad positions take expert
    capacity in both — its caches, then ragged decode steps."""
    cfg_j, cfg_t, params_j, params_t = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_t.vocab, (4, 16)).astype(np.int32)
    true_len = np.array([16, 9, 1, 0], np.int32)
    lj, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), max_seq=MAX_SEQ,
                         true_len=jnp.asarray(true_len))
    lt, ct = lm.prefill(params_t, cfg_t, torch.from_numpy(toks),
                        max_seq=MAX_SEQ, true_len=torch.from_numpy(true_len))
    live = true_len > 0
    _close(lt.numpy()[live], np.asarray(lj)[live])
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   atol=1e-5, rtol=0)
    for _ in range(4):
        tok = rng.integers(0, cfg_t.vocab, (4,)).astype(np.int32)
        lj, cj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), cj)
        lt, ct = lm.decode_step(params_t, cfg_t, torch.from_numpy(tok), ct)
        _close(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# batched serving: the port's engine against the JAX engine
# ---------------------------------------------------------------------------

def _margins(monkeypatch) -> list:
    seen = []
    prefill, decode_step = lm.prefill, lm.decode_step

    def top2(logits, live):
        v = logits[live].float().topk(2, dim=-1).values
        seen.extend((v[:, 0] - v[:, 1]).tolist())

    def rec_prefill(*a, **kw):
        logits, cache = prefill(*a, **kw)
        top2(logits, kw["true_len"] > 0)
        return logits, cache

    def rec_decode(params, cfg, token, cache):
        live = cache["len"] > 0
        logits, cache = decode_step(params, cfg, token, cache)
        top2(logits, live)
        return logits, cache

    monkeypatch.setattr(lm, "prefill", rec_prefill)
    monkeypatch.setattr(lm, "decode_step", rec_decode)
    return seen


def test_batched_serving_matches_reference(model, monkeypatch):
    cfg_j, cfg_t, params_j, params_t = model
    scfg = dict(batch_slots=4, max_seq=MAX_SEQ, prefill_buckets=(16, 32))
    rng = np.random.default_rng(14)
    reqs = [Request(i, rng.integers(0, cfg_t.vocab,
                                    int(rng.integers(1, 21))).tolist(),
                    max_new=int(rng.integers(3, 7))) for i in range(9)]
    reqs.append(Request(9, [], max_new=3))              # empty prompt

    jeng = jserve.ServingEngine(
        jserve.ServeConfig(**scfg),
        batched=jlm.serving_adapter(params_j, cfg_j, max_seq=MAX_SEQ))
    assert jeng.warmup(cache=CompileCache(disk=False))["ok"]
    want = jserve.serve_requests(
        jeng, [jserve.Request(r.rid, r.prompt, r.max_new) for r in reqs])

    eng = ServingEngine(ServeConfig(**scfg), batched=lm.serving_adapter(
        params_t, cfg_t, max_seq=MAX_SEQ, device="cpu"))
    assert eng.warmup()["ok"]
    margins = _margins(monkeypatch)
    got = serve_requests(eng, reqs)

    assert got == want
    assert [len(got[r.rid]) for r in reqs] == [r.max_new for r in reqs]
    assert min(margins) > MARGIN, min(margins)


# ---------------------------------------------------------------------------
# parameters, steps, the serving command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,full", [("granite-moe-1b-a400m",
                                        1_334_628_352),
                                       ("phi-3-vision-4.2b", 3_824_225_280)])
@pytest.mark.parametrize("reduced", [True, False])
def test_init_params_tree_and_param_count(arch, full, reduced):
    """The reference's tree, shapes and dtypes (the router float32 in a
    bf16 model), and ``param_count`` equal to the leaves; at full width
    (``meta`` tensors, nothing allocated) the published counts."""
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg_t, cfg_j = cfg_t.with_reduced(), cfg_j.with_reduced()
    p = lm.init_params(cfg_t, device="cpu" if reduced else "meta")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), p) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                     jlm.abstract_params(cfg_j))
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert n == cfg_t.param_count() == cfg_j.param_count()
    if not reduced:
        assert n == full


def test_init_params_moe_is_seeded_and_finite():
    cfg = get_config("granite-moe-1b-a400m").with_reduced()
    a = lm.init_params(cfg, 3, device="cpu")
    b = lm.init_params(cfg, 3, device="cpu")
    assert torch.equal(a["layers"]["moe"]["wg"], b["layers"]["moe"]["wg"])
    assert a["layers"]["moe"]["router"].dtype == torch.float32
    assert all(bool(torch.isfinite(t.float()).all())
               for t in jax.tree_util.tree_leaves(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_every_leaf(arch):
    """A bf16 model carried over: every leaf in its own dtype with the
    reference's bits (the router float32, experts and ``patch_proj``
    bf16)."""
    cfg_j = jax_get_config(arch).with_reduced()          # bf16
    params_j = jlm.init_params(cfg_j, jax.random.key(1))
    p = from_jax_params(jax.tree.map(np.asarray, params_j), device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(params_j)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(p))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        got = flat_t[path]
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32),
                                      err_msg=str(path))
    if cfg_j.family == "moe":
        assert p["layers"]["moe"]["router"].dtype == torch.float32
        assert p["layers"]["moe"]["wd"].dtype == torch.bfloat16
    else:
        assert p["patch_proj"].dtype == torch.bfloat16


def test_prefill_and_decode_steps_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab, (2, 12)) \
        .astype(np.int32)
    ej, et = _extra(cfg_t, 2)
    lj, cj = jsteps.make_prefill_step(cfg_j)(
        params_j, {"tokens": jnp.asarray(toks), **ej})
    step_t = steps.make_prefill_step(cfg_t)
    assert step_t.__name__ == f"prefill_step_{cfg_t.name}"
    lt, ct = step_t(params_t, {"tokens": torch.from_numpy(toks), **et})
    _close(lt.numpy(), np.asarray(lj))
    dec_t = steps.make_decode_step(cfg_t)
    assert dec_t.__name__ == f"decode_step_{cfg_t.name}"
    # the prefill cache is exactly the prompt long: grow it for decoding
    grow = {k: np.pad(np.asarray(v), ((0, 0), (0, 0), (0, 4), (0, 0),
                                      (0, 0))) for k, v in cj.items()
            if k != "len"}
    cj = dict(cj, **{k: jnp.asarray(v) for k, v in grow.items()})
    ct = dict(ct, **{k: torch.from_numpy(v.copy()) for k, v in
                     grow.items()})
    tok = np.array([3, 5], np.int32)
    for _ in range(2):
        lj, cj = jsteps.make_decode_step(cfg_j)(params_j, jnp.asarray(tok),
                                                cj)
        lt, ct = dec_t(params_t, torch.from_numpy(tok), ct)
        _close(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_reduced_on_cpu(arch, capsys):
    from repro_torch.launch.serve import serve
    rc = serve(["--device", "cpu", "--arch", arch, "--requests", "4",
                "--max-new", "3", "--slots", "2", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert rc == 0, out
    family = get_config(arch).family
    assert f"family={family}" in out and "batched decode" in out
    assert out.count(" tok -> [") == 4

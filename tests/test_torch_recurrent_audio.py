"""The port's ssm, hybrid and audio families against the reference, on the
CPU.

Reduced mamba2-130m (``with_reduced()``: 2 layers, d_model 64, SSM heads
of 16 with N 16 and chunk 16), zamba2-1.2b (4 layers, so its shared
block runs twice, after layers 1 and 3, and both cache blocks are used;
MHA 4/4 heads of 16) and whisper-small (2 + 2 layers, MHA 4/4 heads of
16, 32 encoder frames), float32 unless a test says otherwise.  The
reference initialises the parameters and ``from_jax_params`` carries
them over, so both packages run the same weights on the same numpy
inputs.

Tolerances, all float32 with the summation order the only difference:

* logits within ``LOGIT_REL`` of their largest magnitude;
* SSM states, conv states and K/V caches within ``STATE_REL`` of each
  leaf's largest magnitude; ``layer_norm``, ``mlp2`` and
  ``mamba2_decode`` within ``LAYER_TOL`` absolute (their outputs are
  O(1));
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
from repro.launch import steps as jsteps
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.serve import per_slot_engine
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params
from repro_torch.serve import Request, ServeConfig, serve_requests

ARCHS = ("mamba2-130m", "zamba2-1.2b", "whisper-small")
RECURRENT = ("mamba2-130m", "zamba2-1.2b")
LOGIT_REL = 1e-4
STATE_REL = 1e-5
LAYER_TOL = 1e-5
MARGIN = 1e-3
MAX_SEQ = 48


def _reduced(get, arch: str, dtype: str):
    kw = {"n_layers": 4} if arch == "zamba2-1.2b" else {}
    return get(arch).with_reduced(dtype=dtype, **kw)


def _pair(arch: str, dtype: str = "float32", seed: int = 0):
    cfg_j = _reduced(jax_get_config, arch, dtype)
    cfg_t = _reduced(get_config, arch, dtype)
    params_j = jlm.init_params(cfg_j, jax.random.key(seed))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


_PAIRS: dict = {}


def _model(arch: str):
    if arch not in _PAIRS:
        _PAIRS[arch] = _pair(arch)
    return _PAIRS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent(request):
    return _model(request.param)


def _close(got, want, rel=LOGIT_REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


def _close_cache(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        if key == "len":
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))
        else:
            _close(got[key].numpy(), want[key], STATE_REL, key)


def _extra(cfg, B: int, seed: int = 7):
    """Random frames for the audio family (numpy, seeded), else nothing:
    ``(extra for the reference, extra for the port)``."""
    if cfg.encdec is None:
        return {}, {}
    f = np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return {"frames": jnp.asarray(f)}, {"frames": torch.from_numpy(f)}


def _layer0(params_j, key: str = "layers"):
    return jax.tree.map(lambda a: a[0], params_j[key])


# ---------------------------------------------------------------------------
# layers: layer_norm, mlp2, mamba2_decode, the Mamba2 prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["layer_norm", "mlp2"])
def test_whisper_layers_match_reference(layer):
    """LayerNorm (non-unit scale and bias) and the two-matrix MLP (GELU
    in its tanh form, the reference's ``jax.nn.gelu`` default) on layer
    0's weights."""
    _, cfg, params_j, params_t = _model("whisper-small")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    if layer == "layer_norm":
        pj = {"scale": jnp.asarray(rng.standard_normal(cfg.d_model),
                                   jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(cfg.d_model),
                                  jnp.float32)}
        want = jL.layer_norm(pj, jnp.asarray(x), cfg.norm_eps)
        got = L.layer_norm({k: torch.from_numpy(np.array(v))
                            for k, v in pj.items()}, torch.from_numpy(x),
                           cfg.norm_eps)
    else:
        pj = dict(_layer0(params_j)["mlp"])
        pj["b1"] = jnp.asarray(rng.standard_normal(cfg.d_ff), jnp.float32)
        pj["b2"] = jnp.asarray(rng.standard_normal(cfg.d_model),
                               jnp.float32)
        want = jL.mlp2(pj, jnp.asarray(x))
        got = L.mlp2({k: torch.from_numpy(np.array(v))
                      for k, v in pj.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)


def test_mamba2_decode_matches_reference(recurrent):
    """One recurrent step from random SSM and conv states."""
    cfg_j, cfg, params_j, params_t = recurrent
    s = cfg.ssm
    H, conv_ch = s.n_heads(cfg.d_model), \
        s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ss = rng.standard_normal((3, H, s.head_dim, s.d_state)) \
        .astype(np.float32)
    cs = rng.standard_normal((3, s.conv_width - 1, conv_ch)) \
        .astype(np.float32)
    yj, ssj, csj = jL.mamba2_decode(_layer0(params_j)["mamba"], cfg_j,
                                    jnp.asarray(x), jnp.asarray(ss),
                                    jnp.asarray(cs))
    with torch.no_grad():
        yt, sst, cst = L.mamba2_decode(
            lm.layer_params(params_t, 0)["mamba"], cfg,
            torch.from_numpy(x), torch.from_numpy(ss), torch.from_numpy(cs))
    assert sst.dtype == torch.float32
    for got, want in ((yt, yj), (sst, ssj), (cst, csj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LAYER_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [8, 16, 37])
def test_mamba_prefill_matches_reference(recurrent, S, use_kernel):
    """``(y, ssm state float32, conv state)`` of the Mamba2 prefill at a
    prompt below the chunk (8: chunk 8), at it (16) and past it, not a
    multiple (37: two chunks of 16 and the padded third), through the
    chunked SSD and through ``ops.ssd_scan`` (its plain version here)."""
    cfg_j, cfg, params_j, params_t = recurrent
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    yj, stj, cj = jlm._mamba_prefill(_layer0(params_j)["mamba"], cfg_j,
                                     jnp.asarray(x), False)
    with torch.no_grad():
        yt, stt, ct = L.mamba2_prefill(lm.layer_params(params_t, 0)["mamba"],
                                       cfg, torch.from_numpy(x), use_kernel)
    assert stt.dtype == torch.float32
    _close(yt.numpy(), yj, STATE_REL, "y")
    _close(stt.numpy(), stj, STATE_REL, "ssm state")
    _close(ct.numpy(), cj, STATE_REL, "conv state")


# ---------------------------------------------------------------------------
# forward, loss, prefill/decode
# ---------------------------------------------------------------------------

def test_forward_and_loss_match_reference(model):
    cfg_j, cfg, params_j, params_t = model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    ej, et = _extra(cfg, 2)
    lj, aj = jlm.forward(params_j, cfg_j, jnp.asarray(toks), extra=ej)
    with torch.no_grad():
        lt, at = lm.forward(params_t, cfg, torch.from_numpy(toks), extra=et)
        lr, _ = lm.forward(params_t, cfg, torch.from_numpy(toks), extra=et,
                           remat=True)
    _close(lt.numpy(), lj)
    assert torch.equal(lr, lt) and float(at) == float(aj) == 0.0
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), **ej}
    bt = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels), **et}
    loss_j = float(jlm.loss_fn(params_j, cfg_j, bj))
    with torch.no_grad():
        loss_t = float(lm.loss_fn(params_t, cfg, bt))
    assert abs(loss_t - loss_j) <= LOGIT_REL * abs(loss_j)
    if cfg.family == "audio":
        # the frames reach the logits, and the encoder cannot run without
        other = {"frames": et["frames"] + 1.0}
        with torch.no_grad():
            moved, _ = lm.forward(params_t, cfg, torch.from_numpy(toks),
                                  extra=other)
            assert not torch.allclose(moved, lt)
            with pytest.raises(ValueError, match="frames"):
                lm.forward(params_t, cfg, torch.from_numpy(toks))


def test_gradients_reach_every_leaf(model):
    """The port's loss differentiates to every parameter leaf (the shared
    block's and the encoder's included), finite."""
    _, cfg, _, params_t = model
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))
                            .astype(np.int32))
    _, et = _extra(cfg, 2)
    live = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(),
                                  params_t)
    loss = lm.loss_fn(live, cfg, {"tokens": toks, "labels": toks, **et},
                      remat=True)
    leaves = jax.tree_util.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


@pytest.mark.parametrize("attn_impl", ["naive", "kernel"])
def test_prefill_decode_match_reference(model, attn_impl):
    """Prefill of a 21-token prompt (the SSD's chunk of 16 and a padded
    second) into a 48-row cache, every cache leaf against the
    reference's, then 4 decode steps, logits and caches each step."""
    cfg_j, cfg, params_j, params_t = model
    cfg_j = dataclasses.replace(cfg_j, attn_impl=attn_impl)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    ej, et = _extra(cfg, 2)
    lj, cj = jlm.prefill(params_j, cfg_j, jnp.asarray(toks), extra=ej,
                         max_seq=MAX_SEQ)
    lt, ct = lm.prefill(params_t, cfg, torch.from_numpy(toks), extra=et,
                        max_seq=MAX_SEQ)
    _close(lt.numpy(), lj)
    _close_cache(ct, cj)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
        lj, cj = jlm.decode_step(params_j, cfg_j, jnp.asarray(tok), cj)
        lt, ct = lm.decode_step(params_t, cfg, torch.from_numpy(tok), ct)
        _close(lt.numpy(), lj)
        _close_cache(ct, cj)


def _greedy_margin(logits) -> float:
    v = torch.as_tensor(np.asarray(logits, np.float32)).topk(2, -1).values
    return float((v[..., 0] - v[..., 1]).min())


def test_prefill_decode_matches_forward(model):
    """Mirrors the reference's ``test_prefill_decode_matches_forward``:
    the greedy continuation by prefill + 3 decode steps equals the
    forward pass's on the growing sequence, in the port, and equals the
    reference's."""
    cfg_j, cfg, params_j, params_t = model
    B, S = 2, 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    ej, et = _extra(cfg, B)
    with torch.no_grad():
        logits, cache = lm.prefill(params_t, cfg, torch.from_numpy(toks),
                                   extra=et, max_seq=32)
        dec, seen = [], []
        for _ in range(4):
            seen.append(logits.numpy())
            dec.append(logits.argmax(-1).to(torch.int32))
            if len(dec) < 4:
                logits, cache = lm.decode_step(params_t, cfg, dec[-1], cache)
        seq, seq_j = torch.from_numpy(toks), jnp.asarray(toks)
        for t in range(4):
            lf, _ = lm.forward(params_t, cfg, seq, extra=et)
            lfj, _ = jlm.forward(params_j, cfg_j, seq_j, extra=ej)
            nxt = lf[:, -1].argmax(-1).to(torch.int32)
            assert nxt.tolist() == dec[t].tolist(), t
            assert np.asarray(jnp.argmax(lfj[:, -1], -1)).tolist() == \
                nxt.tolist(), t
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            seq_j = jnp.asarray(seq.numpy())
    assert min(map(_greedy_margin, seen)) > MARGIN


def test_hybrid_shared_block_holds_one_parameter_set():
    """zamba2's shared block: ONE parameter set (no layer axis), applied
    after layers 1 and 3 of 4, its K/V in cache blocks 0 and 1."""
    _, cfg, _, params = _model("zamba2-1.2b")
    shared = params["shared_attn"]
    assert shared["attn"]["wq"].dim() == 2
    assert shared["mlp"]["wg"].dim() == 2
    assert "shared_attn" not in params["layers"]
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, 9)).astype(np.int32))
    _, cache = lm.prefill(params, cfg, toks, max_seq=16)
    assert tuple(cache["k"].shape) == (2, 1, 16, cfg.n_kv_heads, cfg.hd)
    # block 0's keys come from the residual after layer 1, block 1's after
    # layer 3: both filled, and different
    assert bool(cache["k"][:, :, :9].abs().amax(dim=(1, 2, 3, 4)).gt(0)
                .all())
    assert not torch.allclose(cache["k"][0], cache["k"][1])
    assert not bool(cache["k"][:, :, 9:].any())
    # a second model differing only in the shared block's wo: every
    # application reads the one tensor
    other = dict(params, shared_attn=dict(
        shared, attn=dict(shared["attn"], wo=shared["attn"]["wo"] * 2)))
    l0, _ = lm.forward(params, cfg, toks)
    l1, _ = lm.forward(other, cfg, toks)
    assert not torch.allclose(l0, l1)


# ---------------------------------------------------------------------------
# parameters and the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_every_leaf(arch):
    """A bf16 model carried over: every leaf in its own dtype with the
    reference's bits (Mamba2's ``A_log``, ``D``, ``dt_bias`` float32; the
    shared block, the encoder and its positions bf16)."""
    cfg_j = _reduced(jax_get_config, arch, "bfloat16")
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
    if cfg_j.family == "hybrid":
        assert p["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    if cfg_j.family == "audio":
        assert p["enc_pos"].dtype == torch.bfloat16
        assert set(p["layers"]["mlp"]) == {"w1", "b1", "w2", "b2"}


@pytest.mark.parametrize("arch,leaves,ref_count", [
    ("mamba2-130m", 128_983_488, 128_939_904),
    ("zamba2-1.2b", 1_170_473_856, 1_170_310_912),
    ("whisper-small", 279_184_128, 334_515_456)])
def test_param_count_against_the_leaves(arch, leaves, ref_count):
    """The reference's tree, shapes and dtypes at full width (``meta``
    tensors, nothing allocated), and the port's ``param_count`` equal to
    the leaves.  The reference's ``param_count`` differs (ROADMAP queue
    C): it undercounts each Mamba2 layer (no ``conv_b``; ``dt_bias`` and
    the gate norm as ``di`` together), and it counts whisper's MLP as a
    SwiGLU and each LayerNorm as one vector."""
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    p = lm.init_params(cfg_t, device="meta")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), p) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                     jlm.abstract_params(cfg_j))
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(p))
    assert n == cfg_t.param_count() == leaves
    assert cfg_j.param_count() == ref_count
    red = _reduced(get_config, arch, "float32")
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(
        _model(arch)[3])) == red.param_count()


def test_audio_prefill_and_decode_steps_match_reference():
    """``make_prefill_step`` passes the batch's ``frames`` (as the
    reference's does); ``make_decode_step`` continues from its cache."""
    cfg_j, cfg, params_j, params_t = _model("whisper-small")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 11)) \
        .astype(np.int32)
    ej, et = _extra(cfg, 2, seed=10)
    lj, cj = jsteps.make_prefill_step(cfg_j)(
        params_j, {"tokens": jnp.asarray(toks), **ej})
    lt, ct = steps.make_prefill_step(cfg)(
        params_t, {"tokens": torch.from_numpy(toks), **et})
    _close(lt.numpy(), lj)
    _close_cache(ct, cj)
    # the prefill cache is exactly the prompt long: grow it for decoding
    grow = {k: np.pad(np.asarray(cj[k]), ((0, 0), (0, 0), (0, 3), (0, 0),
                                          (0, 0))) for k in ("k", "v")}
    cj = dict(cj, **{k: jnp.asarray(v) for k, v in grow.items()})
    ct = dict(ct, **{k: torch.from_numpy(v.copy()) for k, v in grow.items()})
    dec_t = steps.make_decode_step(dataclasses.replace(cfg,
                                                       attn_impl="kernel"))
    tok = np.array([3, 5], np.int32)
    for _ in range(2):
        lj, cj = jsteps.make_decode_step(cfg_j)(params_j, jnp.asarray(tok),
                                                cj)
        lt, ct = dec_t(params_t, torch.from_numpy(tok), ct)
        _close(lt.numpy(), lj)


# ---------------------------------------------------------------------------
# serving: the per-slot engine against the JAX one, the refusals, the CLI
# ---------------------------------------------------------------------------

def _margins(monkeypatch) -> list:
    seen = []
    prefill, decode_step = lm.prefill, lm.decode_step

    def top2(logits):
        v = logits.float().topk(2, dim=-1).values
        seen.extend((v[:, 0] - v[:, 1]).tolist())

    def rec_prefill(*a, **kw):
        logits, cache = prefill(*a, **kw)
        top2(logits)
        return logits, cache

    def rec_decode(*a, **kw):
        logits, cache = decode_step(*a, **kw)
        top2(logits)
        return logits, cache

    monkeypatch.setattr(lm, "prefill", rec_prefill)
    monkeypatch.setattr(lm, "decode_step", rec_decode)
    return seen


def test_per_slot_serving_matches_reference(recurrent, monkeypatch):
    """``launch.serve``'s per-slot engine (the kernels' plain versions
    here) against the reference's per-slot ``ServingEngine`` with its
    jitted ``prefill``/``decode_step``, as its ``launch.serve`` builds
    it: the same tokens for every request, prompts below, at and past
    the SSD chunk, more requests than slots, an empty one."""
    cfg_j, cfg, params_j, params_t = recurrent
    scfg = dict(batch_slots=2, max_seq=MAX_SEQ)
    rng = np.random.default_rng(14)
    lens = [5, 16, 37, 9, 21]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).tolist(),
                    max_new=int(rng.integers(3, 7)))
            for i, n in enumerate(lens)]
    reqs.append(Request(len(lens), [], max_new=0))

    @jax.jit
    def prefill_fn(tokens):
        return jlm.prefill(params_j, cfg_j, tokens, max_seq=MAX_SEQ)

    @jax.jit
    def decode_fn(token, cache):
        return jlm.decode_step(params_j, cfg_j, token, cache)

    want = jserve.serve_requests(
        jserve.ServingEngine(jserve.ServeConfig(**scfg), prefill_fn,
                             decode_fn),
        [jserve.Request(r.rid, r.prompt, r.max_new) for r in reqs])
    eng = per_slot_engine(params_t, cfg, ServeConfig(**scfg),
                          torch.device("cpu"))
    assert eng.batched is None and eng.warmup()["ok"]
    margins = _margins(monkeypatch)
    got = serve_requests(eng, reqs)
    assert got == want
    assert [len(got[r.rid]) for r in reqs] == [r.max_new for r in reqs]
    assert min(margins) > MARGIN, min(margins)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_adapter_refuses_as_reference(arch):
    cfg_j, cfg, params_j, params_t = _model(arch)
    with pytest.raises(ValueError, match="per-slot"):
        jlm.serving_adapter(params_j, cfg_j, max_seq=16)
    with pytest.raises(ValueError, match="per-slot"):
        lm.serving_adapter(params_t, cfg, max_seq=16, device="cpu")


@pytest.mark.parametrize("arch", RECURRENT)
def test_launch_serve_reduced_on_cpu(arch, capsys):
    from repro_torch.launch.serve import serve
    rc = serve(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--max-new", "3", "--slots", "2", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert rc == 0, out
    family = get_config(arch).family
    assert f"the {family} family serves per slot" in out
    assert "mode=per-slot" in out and "per-slot decode" in out
    assert out.count(" tok -> [") == 3


def test_launch_serve_refuses_audio_as_reference_cannot(capsys):
    """The reference's ``launch.serve --arch whisper-small`` answers every
    request with an error (its per-slot prefill passes no frames:
    ``KeyError('frames')``) and returns 1; the port refuses the family
    before building anything."""
    from repro.launch.serve import serve as jserve_cli
    from repro_torch.launch.serve import serve
    argv = ["--arch", "whisper-small", "--requests", "2", "--max-new", "2",
            "--slots", "2", "--max-seq", "32"]
    assert jserve_cli(argv) == 1
    out = capsys.readouterr().out
    assert out.count("error (KeyError('frames'))") == 2
    with pytest.raises(ValueError, match="audio.*frames"):
        serve(["--device", "cpu", *argv])

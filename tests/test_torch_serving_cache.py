"""The serving engine's compiled steps through the compile cache, on the
CPU (the exported-program lowering; the card's AOTInductor packages are
``chip_smoke.py`` phases 24-25).

* the port's mirror of ``tests/test_compile_cache.py::
  test_serve_warmup_through_cache``: a toy per-slot engine compiles,
  serves, resolves again from the store, and a toy that cannot be
  exported reports ``ok: False``;
* the batched engine on the reduced Qwen3 and granite-moe (float32, the
  reference's weights carried over): cold ``"compiled"`` for every
  (batch size, bucket) and the decode step, ``"memory"`` for a second
  engine on the same cache, ``"disk"`` after ``clear_memory()`` and from
  a fresh cache on the same root; the tokens served equal the eager
  engine's and the reference's batched engine's (the same requests as
  ``tests/test_torch_serving.py`` / ``test_torch_moe_vlm.py``, whose
  top-2 margins there exceed 1e-3);
* the slot write and retire with 0-d tensor indices, eager and compiled,
  equal to the eager ones with integer indices, leaf by leaf (exact);
* the int8 KV cache and the sampled draw through the compiled steps;
* the reduced Mamba2 per slot through the cache: prefill and decode
  compiled, the tokens of the eager per-slot engine, no fall-off.
"""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import serve as jserve
from repro.configs import get_config as jax_get_config
from repro.core.compile_cache import CompileCache as JaxCompileCache
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core.compile_cache import CompileCache, Dyn
from repro_torch.launch.serve import per_slot_engine
from repro_torch.models import lm
from repro_torch.models.weights import from_jax_params
from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                               serve_requests)

V = 16
MAX_SEQ = 32


def _pair(arch: str):
    cfg_j = jax_get_config(arch).with_reduced(dtype="float32")
    cfg_t = get_config(arch).with_reduced(dtype="float32")
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _requests(cfg, n, seed=14):
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab,
                                    int(rng.integers(1, 21))).tolist(),
                    max_new=int(rng.integers(3, 7)))
            for i in range(n - 1)]
    reqs.append(Request(n - 1, [], max_new=3))       # empty prompt
    return reqs


# ---------------------------------------------------------------------------
# toy engines
# ---------------------------------------------------------------------------

def test_serve_warmup_through_cache(tmp_path):
    def prefill(toks):
        cache = toks.float().sum(dim=1)
        return F.one_hot(((toks[:, -1] + 1) % V).long(), V), cache

    def decode(tok, cache):
        return F.one_hot(((tok + 1) % V).long(), V), cache + 1.0

    cc = CompileCache(root=tmp_path)
    eng = ServingEngine(ServeConfig(batch_slots=2), prefill, decode)
    info = eng.warmup(prompt_len=3, cache=cc)
    assert info == {"ok": True, "prefill": "compiled", "decode": "compiled"}
    res = serve_requests(eng, [Request(0, [1, 2, 3], max_new=3)])
    assert res[0] == [4, 5, 6] and eng.fall_offs == []
    # a second engine (same shapes) resolves warmup from the cache
    eng2 = ServingEngine(ServeConfig(batch_slots=2), prefill, decode)
    info2 = eng2.warmup(prompt_len=3, cache=cc)
    assert info2["ok"] and info2["prefill"] in ("memory", "disk")
    # a toy that cannot be exported (numpy on a traced tensor) reports
    # ok False and serves eagerly, as the reference's does
    eng3 = ServingEngine(
        ServeConfig(),
        lambda t: (np.ones((1, V)) * float(np.asarray(t).sum()),
                   np.zeros(1)),
        lambda t, c: (np.ones((1, V)), c))
    assert eng3.warmup(cache=cc)["ok"] is False
    assert serve_requests(eng3, [Request(0, [1], max_new=2)])[0] == [0, 0]


def test_batched_toy_without_graphs_reports_not_ok(tmp_path):
    """An adapter with no exportable graphs (a toy of eager callables)
    gives ``ok: False`` and the reason, and compiles nothing."""
    toy = lm.ServingAdapter(cfg=None, max_seq=32, prefill_fn=None,
                            step_fn=None, write_slot_fn=None, retire_fn=None)
    eng = ServingEngine(ServeConfig(batch_slots=2, max_seq=32), batched=toy)
    cc = CompileCache(root=tmp_path)
    info = eng.warmup(cache=cc)
    assert info["ok"] is False and "graphs" in info["reason"]
    assert cc.stats.puts == 0 and eng.compile_log == []


def test_executable_takes_any_size_on_a_dynamic_axis(tmp_path):
    def f(x, y):
        return x * 2 + y.sum()

    cc = CompileCache(root=tmp_path)
    x, y = torch.ones(4, 3), torch.ones(5)
    exe, src = cc.compile_cached(f, (x, y), device="cpu",
                                 dynamic=(Dyn(((0, "n", 1, 8),)), None))
    assert src == "compiled" and exe.avals[0] == ((None, 3), "float32")
    for n in (1, 2, 8):
        assert torch.equal(exe(torch.ones(n, 3), y), torch.full((n, 3), 7.))
    with pytest.raises(TypeError, match="compiled stage takes inputs"):
        exe(torch.ones(2, 4), y)                    # a static axis
    with pytest.raises(TypeError, match="compiled stage takes inputs"):
        exe(x, torch.ones(6))
    # the dynamic spec is part of the key: static is another executable
    _, src = cc.compile_cached(f, (x, y), device="cpu")
    assert src == "compiled"


# ---------------------------------------------------------------------------
# the batched engine on reduced models
# ---------------------------------------------------------------------------

SCFG = dict(batch_slots=4, max_seq=MAX_SEQ, prefill_buckets=(16, 32))


def _engine(params, cfg, **kw) -> ServingEngine:
    return ServingEngine(ServeConfig(**SCFG), batched=lm.serving_adapter(
        params, cfg, max_seq=MAX_SEQ, device="cpu", **kw))


def _sources(info: dict) -> set:
    return set(info["buckets"].values()) | {info["decode"]}


@pytest.mark.parametrize("arch,n", [("qwen3-0.6b", 12),
                                    ("granite-moe-1b-a400m", 10)])
def test_batched_engine_through_cache(arch, n, tmp_path):
    cfg_j, cfg_t, params_j, params_t = _pair(arch)
    reqs = _requests(cfg_t, n)
    sizes = (1, 2, 4)

    jeng = jserve.ServingEngine(
        jserve.ServeConfig(**SCFG),
        batched=jlm.serving_adapter(params_j, cfg_j, max_seq=MAX_SEQ))
    assert jeng.warmup(cache=JaxCompileCache(disk=False))["ok"]
    want = jserve.serve_requests(
        jeng, [jserve.Request(r.rid, r.prompt, r.max_new) for r in reqs])
    eager = _engine(params_t, cfg_t)
    assert eager.warmup(batch_sizes=sizes)["ok"]
    assert serve_requests(eager, reqs) == want

    cc = CompileCache(root=tmp_path)
    eng = _engine(params_t, cfg_t)
    info = eng.warmup(cache=cc, batch_sizes=sizes)
    assert info["ok"] and _sources(info) == {"compiled"}, info
    assert set(info["buckets"]) == {f"{b}x{L}" for b in sizes
                                    for L in (16, 32)}
    kinds = [k for k, _, _ in eng.compile_log]
    assert kinds.count("prefill") == 6 and kinds.count("write_slot") == 3
    assert {s for _, _, s in eng.compile_log} == {"compiled"}
    assert serve_requests(eng, reqs) == want
    # every shape the serving run met was resolved at warmup
    assert len(eng.compile_log) == 11

    eng2 = _engine(params_t, cfg_t)
    assert _sources(eng2.warmup(cache=cc, batch_sizes=sizes)) == {"memory"}
    cc.clear_memory()
    eng3 = _engine(params_t, cfg_t)
    assert _sources(eng3.warmup(cache=cc, batch_sizes=sizes)) == {"disk"}
    eng4 = _engine(params_t, cfg_t)
    info4 = eng4.warmup(cache=CompileCache(root=tmp_path), batch_sizes=sizes)
    assert _sources(info4) == {"disk"}
    assert serve_requests(eng4, reqs) == want


def test_weights_are_an_input_not_a_constant(tmp_path):
    """Two models of one shape share every executable (the key holds the
    weights' shapes, not their values), and each serves its own tokens."""
    _, cfg, _, params = _pair("qwen3-0.6b")
    other = {k: v for k, v in params.items()}
    other["embed"] = params["embed"].flip(0).contiguous()
    reqs = _requests(cfg, 5)
    cc = CompileCache(root=tmp_path)
    outs = []
    for p in (params, other):
        eng = _engine(p, cfg)
        info = eng.warmup(cache=cc, batch_sizes=(1, 2, 4))
        eager = _engine(p, cfg)
        eager.warmup(batch_sizes=(1, 2, 4))
        outs.append((info, serve_requests(eng, reqs),
                     serve_requests(eager, reqs)))
    assert _sources(outs[0][0]) == {"compiled"}
    assert _sources(outs[1][0]) == {"memory"}
    assert outs[0][1] == outs[0][2] and outs[1][1] == outs[1][2]
    assert outs[0][1] != outs[1][1]
    for exe in cc._mem.values():        # no weight inside a program
        ep = torch.export.load(io.BytesIO(exe.payload))
        assert not ep.state_dict and all(
            t.numel() <= 1 for t in ep.constants.values())
        assert ep.example_inputs is None


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7, top_k=1)])
def test_kv_quant_and_draw_through_cache(kw, tmp_path):
    """The int8 cache's leaves through the compiled prefill, write, step
    and retire; with ``temperature > 0`` the compiled step returns logits
    and the draw is one eager call (top-k 1: the greedy tokens)."""
    _, cfg, _, params = _pair("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, kv_quant=True)
    reqs = _requests(cfg, 7, seed=3)
    eager = _engine(params, cfg)
    assert eager.warmup(batch_sizes=(1, 2, 4))["ok"]
    want = serve_requests(eager, reqs)
    eng = _engine(params, cfg, **kw)
    info = eng.warmup(cache=CompileCache(root=tmp_path),
                      batch_sizes=(1, 2, 4))
    assert _sources(info) == {"compiled"}
    assert serve_requests(eng, reqs) == want


def _leaves_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kv_quant", [False, True])
def test_write_and_retire_with_tensor_indices(kv_quant, tmp_path):
    _, cfg, _, params = _pair("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    ad = lm.serving_adapter(params, cfg, max_seq=MAX_SEQ, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    _, cache = ad.prefill_fn(toks, torch.tensor([7, 16], dtype=torch.int32),
                             torch.tensor(0, dtype=torch.int32))
    eng = _engine(params, cfg)
    assert eng.warmup(cache=CompileCache(root=tmp_path),
                      batch_sizes=(2,))["ok"]
    write, retire = eng._resolve_write(2), eng._resolve_retire()
    i32 = lambda i: torch.tensor(i, dtype=torch.int32)  # noqa: E731
    by_int, by_tensor, compiled = (ad.init_slots(4) for _ in range(3))
    for row, slot in ((1, 3), (0, 0), (1, 2)):
        lm.write_slot(by_int, cache, row, slot)
        lm.write_slot(by_tensor, cache, i32(row), i32(slot))
        assert write(compiled, cache, i32(row), i32(slot)) is compiled
        _leaves_equal(by_tensor, by_int)
        _leaves_equal(compiled, by_int)
    assert by_int["len"].tolist() == [7, 0, 16, 16]
    lm.retire_slot(by_int, 2)
    lm.retire_slot(by_tensor, i32(2))
    retire(compiled, i32(2))
    for p in (by_tensor, compiled):
        _leaves_equal(p, by_int)
    assert by_int["len"].tolist() == [7, 0, 0, 16]


# ---------------------------------------------------------------------------
# per slot: the reduced Mamba2
# ---------------------------------------------------------------------------

def test_per_slot_mamba2_through_cache(tmp_path):
    _, cfg, _, params = _pair("mamba2-130m")
    scfg = ServeConfig(batch_slots=2, max_seq=48)
    rng = np.random.default_rng(5)
    P = 12
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).tolist(),
                    max_new=int(rng.integers(3, 6)))
            for i, n in enumerate([P, P, 5, P, 30])]
    eager = per_slot_engine(params, cfg, scfg, torch.device("cpu"))
    assert eager.warmup()["ok"]
    want = serve_requests(eager, reqs)

    eng = per_slot_engine(params, cfg, scfg, torch.device("cpu"))
    info = eng.warmup(prompt_len=P, cache=CompileCache(root=tmp_path))
    assert info == {"ok": True, "prefill": "compiled", "decode": "compiled"}
    calls = []
    pre = eng._aot_prefill[(1, P)]
    eng._aot_prefill[(1, P)] = lambda t: calls.append(t.shape) or pre(t)
    assert serve_requests(eng, reqs) == want
    assert len(calls) == 3 and eng.fall_offs == []

    eng2 = per_slot_engine(params, cfg, scfg, torch.device("cpu"))
    info2 = eng2.warmup(prompt_len=P, cache=CompileCache(root=tmp_path))
    assert info2 == {"ok": True, "prefill": "disk", "decode": "disk"}
    assert serve_requests(eng2, reqs) == want

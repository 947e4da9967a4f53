"""The port's serving engine against the reference, on the CPU.

Three parts:

* toy engines (a mod-V counter as the "model") through both decode paths,
  mirroring the fast tests of ``tests/test_serving.py`` and the serving
  robustness tests of ``tests/test_faults.py``: eos, churn, empty prompt,
  capacity stop, long prompts, one step call per iteration, the peeked
  header consumed once, poison/transients, an unattributable step
  failure;
* the overload layer and the traffic generator against the reference:
  the same trace digests, and the same virtual-time overload run (a pure
  function of its seeds) answered identically by both packages;
* a reduced Qwen3 (float32, the reference's parameters carried over by
  ``from_jax_params``) served by the reference's batched engine and by the
  port's: the same 12 requests give identical token lists.  Both sides
  agree on every logit to ~1e-6 (``tests/test_torch_lm.py``); the test
  asserts a top-2 margin above 1e-3 at every sampled position, so no
  near-tie can flip a greedy token.
"""

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jax_get_config
from repro.core.compile_cache import CompileCache
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.models import lm
from repro_torch.models.lm import ServingAdapter, retire_slot, write_slot
from repro_torch.models.weights import from_jax_params
from repro_torch import serve as tserve
from repro_torch.serve import (Request, RequestError, ServeConfig,
                               ServingEngine, make_trace, noisy_neighbor_mix,
                               serve_requests, trace_digest, uniform_mix)

V = 16   # toy vocab: next token = (prev + 1) % V
MARGIN = 1e-3


# ---------------------------------------------------------------------------
# toy engines for both paths
# ---------------------------------------------------------------------------

def toy_prefill(toks):
    last = int(toks[0, -1]) % V
    return np.eye(1, V, k=(last + 1) % V), {"n": toks.shape[1]}


def toy_decode(tok, cache):
    return np.eye(1, V, k=int(tok[0] + 1) % V), {"n": cache["n"] + 1}


def toy_per_slot_engine(scfg: ServeConfig, **kw) -> ServingEngine:
    return ServingEngine(scfg, toy_prefill, toy_decode, **kw)


def toy_batched_adapter(max_seq: int) -> ServingAdapter:
    """The counter model as a packed-slot adapter on CPU tensors: the
    packed cache is ``{"len": [slots], "last": [1, slots]}``, batch on
    axis 1 as in the real KV cache, updated in place."""

    def prefill_fn(tokens, true_len, step):
        toks = torch.from_numpy(np.asarray(tokens, np.int64))
        lens = torch.from_numpy(np.asarray(true_len, np.int32))
        idx = (lens.long() - 1).clamp(0, toks.shape[1] - 1)
        last = toks[torch.arange(toks.shape[0]), idx]
        first = ((last + 1) % V).to(torch.int32)
        return first, {"len": lens, "last": first[None].clone()}

    def step_fn(tokens, packed, step):
        live = packed["len"] > 0
        toks = torch.from_numpy(np.asarray(tokens, np.int32))
        nxt = torch.where(live, (toks + 1) % V, 0).to(torch.int32)
        packed["len"].copy_(torch.where(live, packed["len"] + 1, 0))
        packed["last"][0] = nxt
        return nxt, packed

    class ToyAdapter(ServingAdapter):
        def init_slots(self, slots):
            return {"len": torch.zeros(slots, dtype=torch.int32),
                    "last": torch.zeros((1, slots), dtype=torch.int32)}

    return ToyAdapter(cfg=None, max_seq=max_seq, prefill_fn=prefill_fn,
                      step_fn=step_fn, write_slot_fn=write_slot,
                      retire_fn=retire_slot)


def toy_batched_engine(scfg: ServeConfig, **kw) -> ServingEngine:
    eng = ServingEngine(scfg, batched=toy_batched_adapter(scfg.max_seq),
                        **kw)
    info = eng.warmup()
    assert info["ok"], info
    return eng


ENGINES = {"per_slot": toy_per_slot_engine, "batched": toy_batched_engine}


def expected(prompt, max_new, eos=-1):
    last = (prompt[-1] if prompt else 0) % V
    out = []
    for _ in range(max_new):
        last = (last + 1) % V
        out.append(last)
        if eos >= 0 and last == eos:
            break
    return out


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_eos_token_early_stop(variant):
    scfg = ServeConfig(batch_slots=2, max_seq=32, eos_token=5,
                       prefill_buckets=(8,))
    res = serve_requests(ENGINES[variant](scfg),
                         [Request(0, [1, 2, 3], max_new=8),
                          Request(1, [5], max_new=4)])
    assert res[0] == [4, 5]
    assert res[1] == [6, 7, 8, 9]


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_more_requests_than_slots_churn(variant):
    scfg = ServeConfig(batch_slots=2, max_seq=32, prefill_buckets=(8,))
    reqs = [Request(i, [(3 * i) % V], max_new=2 + i % 3) for i in range(9)]
    res = serve_requests(ENGINES[variant](scfg), reqs)
    assert set(res) == set(range(9))
    for r in reqs:
        assert res[r.rid] == expected(r.prompt, r.max_new), r.rid


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_empty_prompt_and_zero_max_new(variant):
    scfg = ServeConfig(batch_slots=2, max_seq=32, prefill_buckets=(8,))
    res = serve_requests(ENGINES[variant](scfg),
                         [Request(0, [], max_new=3),
                          Request(1, [4, 5], max_new=0),
                          Request(2, [7], max_new=2)])
    assert res[0] == [1, 2, 3]          # decodes from a single pad token
    assert res[1] == []
    assert res[2] == [8, 9]


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_max_seq_capacity_stop(variant):
    scfg = ServeConfig(batch_slots=1, max_seq=8, prefill_buckets=(8,))
    res = serve_requests(ENGINES[variant](scfg),
                         [Request(0, [1, 2, 3, 4], max_new=32)])
    assert res[0] == expected([1, 2, 3, 4], 4)   # 4 + 4 = max_seq


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_prompt_longer_than_largest_bucket(variant):
    scfg = ServeConfig(batch_slots=1, max_seq=16, prefill_buckets=(4,))
    res = serve_requests(ENGINES[variant](scfg),
                         [Request(0, [1] * 9 + [7], max_new=2),
                          Request(1, list(range(40)), max_new=2)])
    assert res[0] == [8, 9]
    # keeps its last 15 tokens; the capacity stop retires it after one
    assert res[1] == [8]


def test_batched_single_step_call_per_iteration():
    scfg = ServeConfig(batch_slots=4, max_seq=32, prefill_buckets=(8,))
    eng = toy_batched_engine(scfg)
    calls = {"n": 0}
    step = eng._exe[("step",)]

    def counting(*args):
        calls["n"] += 1
        return step(*args)

    eng._exe[("step",)] = counting
    reqs = [Request(i, [i], max_new=mn) for i, mn in enumerate((3, 5, 7, 9))]
    res = serve_requests(eng, reqs)
    for r in reqs:
        assert res[r.rid] == expected(r.prompt, r.max_new)
    assert calls["n"] == 8, calls["n"]   # per-slot would pay 20


def test_admission_consumes_peeked_header_once():
    scfg = ServeConfig(batch_slots=1, max_seq=32, prefill_buckets=(8,))
    reqs = [Request(i, [(i + 1) % V, (i + 2) % V], max_new=2)
            for i in range(6)]
    res = serve_requests(toy_batched_engine(scfg), reqs)
    for r in reqs:
        assert res[r.rid] == expected(r.prompt, r.max_new), r.rid


def test_warmup_runs_every_shape_once():
    scfg = ServeConfig(batch_slots=2, max_seq=32)
    eng = ServingEngine(scfg, batched=toy_batched_adapter(32))
    info = eng.warmup(batch_sizes=(1, 2))
    assert info["ok"]
    assert set(info["buckets"]) == {f"{b}x{L}" for b in (1, 2)
                                    for L in (8, 16, 32)}
    assert set(info["buckets"].values()) == {"eager"}
    assert info["decode"] == "eager"
    again = eng.warmup(batch_sizes=(1, 2))
    assert set(again["buckets"].values()) == {"pinned"}
    kinds = [k for k, _, _ in eng.compile_log]
    assert kinds.count("prefill") == 6 and kinds.count("decode_step") == 1
    assert {"write_slot", "retire"} <= set(kinds)


def test_failed_batched_warmup_raises_and_never_serves_per_slot():
    """A step that fails at warmup (a kernel that does not build or
    launch) raises out of ``warmup``, even when the per-slot closures are
    there to serve with: the engine never changes path on its own."""
    adapter = toy_batched_adapter(32)

    def broken(*args):
        raise RuntimeError("decode_attention kernel launch failed")

    adapter.step_fn = broken
    eng = ServingEngine(ServeConfig(batch_slots=2, max_seq=32,
                                    prefill_buckets=(8,)),
                        toy_prefill, toy_decode, batched=adapter)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.warmup()
    assert eng.batched is adapter


@pytest.mark.parametrize("variant", ["per_slot", "batched"])
def test_poison_and_transients_quarantine_only_victims(variant):
    scfg = ServeConfig(batch_slots=2, max_seq=32, prefill_buckets=(8,))
    eng = ENGINES[variant](scfg)
    reqs = [Request(i, [(3 * i) % V], max_new=3) for i in range(6)]
    plan = FaultPlan(seed=0, poison={2: "decode", 5: "prefill"},
                     transient={"prefill": 2, "decode": 1})
    res = serve_requests(eng, reqs, faults=plan)
    for rid in (2, 5):
        assert isinstance(res[rid], RequestError)
        assert res[rid].status == "poisoned"
    for rid in (0, 1, 3, 4):
        assert res[rid] == expected(reqs[rid].prompt, 3), rid
    assert len(eng.retry_log) == 3


def test_unattributable_step_failure_rebuilds_slots():
    """A real exception inside the one step call cannot be pinned on a
    request and may leave the in-place cache torn: the live requests get
    a structured error, the packed cache is rebuilt, the queue is
    served."""
    scfg = ServeConfig(batch_slots=2, max_seq=32, prefill_buckets=(8,))
    eng = toy_batched_engine(scfg)
    step = eng._exe[("step",)]
    state = {"fired": False}
    inits = {"n": 0}
    init = eng.batched.init_slots

    def exploding(tokens, packed, i):
        if not state["fired"]:
            state["fired"] = True
            packed["len"].fill_(7)          # tear the cache, then fail
            raise RuntimeError("step blew up")
        return step(tokens, packed, i)

    def counting_init(slots):
        inits["n"] += 1
        return init(slots)

    eng._exe[("step",)] = exploding
    eng.batched.init_slots = counting_init
    reqs = [Request(i, [i % V], max_new=3) for i in range(5)]
    res = serve_requests(eng, reqs)
    failed = [r for r, v in res.items() if isinstance(v, RequestError)]
    served = [r for r, v in res.items() if not isinstance(v, RequestError)]
    assert failed and served and len(res) == 5
    for rid in failed:
        assert res[rid].status == "error"
        assert "step blew up" in res[rid].detail
    for rid in served:
        assert res[rid] == expected(reqs[rid].prompt, 3), rid
    assert inits["n"] == 2                    # the start, and the rebuild


# ---------------------------------------------------------------------------
# traffic and the overload layer against the reference
# ---------------------------------------------------------------------------

def _trace_key(trace):
    return [(r.rid, r.tenant, r.t_arrival, r.prompt, r.max_new, r.deadline_s)
            for r in trace]


@pytest.mark.parametrize("mix", ["uniform", "noisy", "overlay"])
def test_trace_digest_matches_reference(mix):
    kw = {}
    if mix == "uniform":
        tenants = uniform_mix(3, rate=11.0, deadline_s=0.25)
        jtenants = jserve.uniform_mix(3, rate=11.0, deadline_s=0.25)
    else:
        tenants, jtenants = noisy_neighbor_mix(), jserve.noisy_neighbor_mix()
    if mix == "overlay":
        plan = dict(seed=5, arrival_burst={"*": {"at_s": 0.5, "dur_s": 0.5,
                                                 "rate": 30.0}},
                    tenant_flood={"mob": {"rate": 20.0, "start_s": 1.0}})
        kw, jkw = dict(faults=FaultPlan(**plan)), \
            dict(faults=JaxFaultPlan(**plan))
    else:
        jkw = {}
    got = make_trace(tenants, 2.0, seed=3, vocab=64, scale=1.5, **kw)
    want = jserve.make_trace(jtenants, 2.0, seed=3, vocab=64, scale=1.5,
                             **jkw)
    assert len(got) > 10
    assert trace_digest(got) == jserve.trace_digest(want)
    assert _trace_key(got) == _trace_key(want)


def test_virtual_overload_run_matches_reference():
    """The same deterministic overload run (virtual clock, admission
    control with reject-new shedding, deadlines) through both packages'
    engines with the same per-slot toy steps: identical answers, sheds
    and metrics."""
    outs = []
    for m in (jserve, tserve):
        vc = m.VirtualClock()
        metrics = m.ServeMetrics()
        ctrl = m.AdmissionController(m.AdmissionConfig(
            est_token_s=0.01, queue_limit=8))
        scfg = m.ServeConfig(batch_slots=2, max_seq=64, prefill_buckets=(8,))
        eng = m.ServingEngine(scfg, toy_prefill, toy_decode, admission=ctrl,
                              metrics=metrics, clock=vc, pace="virtual",
                              step_dt=0.01)
        tenants = m.uniform_mix(2, rate=35.0, deadline_s=0.4,
                                max_new=(4, 8), prompt_len=(2, 6))
        trace = m.make_trace(tenants, 2.0, seed=0, vocab=V)
        ctrl.register_tenants(tenants)
        res = m.serve_requests(eng, trace)
        metrics.check_accounting()
        outs.append(({rid: (v.status if hasattr(v, "status") else v)
                      for rid, v in res.items()},
                     metrics.summary(wall_s=vc())))
    (res_j, sum_j), (res_t, sum_t) = outs
    assert res_t == res_j
    assert sum_t == sum_j
    assert sum_t["shed"] > 0 and sum_t["completed"] > 0


# ---------------------------------------------------------------------------
# a real model: the port's batched serving against the reference's
# ---------------------------------------------------------------------------

MAX_SEQ = 32


@pytest.fixture(scope="module")
def qwen():
    cfg_j = jax_get_config("qwen3-0.6b").with_reduced(dtype="float32")
    cfg_t = get_config("qwen3-0.6b").with_reduced(dtype="float32")
    params_j = jlm.init_params(cfg_j, jax.random.key(0))
    params_t = from_jax_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _requests(cfg, n=12, seed=14):
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab,
                                    int(rng.integers(1, 21))).tolist(),
                    max_new=int(rng.integers(3, 7)))
            for i in range(n - 1)]
    reqs.append(Request(n - 1, [], max_new=3))       # empty prompt
    return reqs


def _margins(monkeypatch) -> list:
    """Record the top-2 logit margin of every row the port samples a
    token from (live rows of prefill and decode)."""
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


def test_batched_serving_matches_reference(qwen, monkeypatch):
    cfg_j, cfg_t, params_j, params_t = qwen
    scfg = dict(batch_slots=4, max_seq=MAX_SEQ, prefill_buckets=(16, 32))
    reqs = _requests(cfg_t)

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
    assert len(margins) == sum(r.max_new for r in reqs)
    assert min(margins) > MARGIN, min(margins)


def test_batched_matches_per_slot_in_port(qwen):
    """The port's own two decode paths on the real model: the per-slot
    seed path (scalar-length cache, sdpa) and the packed batched path
    (ragged lengths, the decode kernel's plain version) agree."""
    _, cfg, _, params = qwen
    reqs = _requests(cfg, n=6, seed=5)
    scfg = ServeConfig(batch_slots=3, max_seq=MAX_SEQ)

    def prefill_fn(tokens):
        return lm.prefill(params, cfg, torch.from_numpy(tokens),
                          max_seq=MAX_SEQ)

    def decode_fn(token, cache):
        return lm.decode_step(params, cfg, torch.from_numpy(token), cache)

    want = serve_requests(ServingEngine(scfg, prefill_fn, decode_fn), reqs)
    eng = ServingEngine(scfg, batched=lm.serving_adapter(
        params, cfg, max_seq=MAX_SEQ, device="cpu"))
    assert eng.warmup()["ok"]
    assert serve_requests(eng, reqs) == want


def test_sampling_top_k1_is_greedy_and_hot_stays_in_vocab(qwen):
    _, cfg, _, params = qwen
    scfg = ServeConfig(batch_slots=2, max_seq=MAX_SEQ)
    reqs = [Request(0, [1, 2, 3], max_new=4), Request(1, [9], max_new=4)]

    def run(**kw):
        eng = ServingEngine(scfg, batched=lm.serving_adapter(
            params, cfg, max_seq=MAX_SEQ, device="cpu", **kw))
        assert eng.warmup()["ok"]
        return serve_requests(eng, reqs)

    greedy = run()
    assert run(temperature=0.7, top_k=1) == greedy
    hot = run(temperature=1.5, top_k=8, seed=3)
    assert hot == run(temperature=1.5, top_k=8, seed=3)   # seeded
    assert all(0 <= t < cfg.vocab for seq in hot.values() for t in seq)
    assert [len(v) for v in hot.values()] == [4, 4]


@pytest.mark.parametrize("flags", [
    ["--per-slot"],
    ["--traffic", "poisson", "--tenants", "2", "--rate", "6",
     "--duration", "0.5"],
])
def test_launch_serve_modes_on_cpu(flags, capsys):
    """The serving driver's per-slot and open-loop traffic modes on the
    reduced config: every request answered, exit code 0."""
    from repro_torch.launch.serve import serve
    assert serve(["--device", "cpu", "--requests", "3", "--max-new", "3",
                  "--slots", "2", "--max-seq", "32", *flags]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out

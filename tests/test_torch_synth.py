"""Whole-graph synthesis in the port (repro_torch.core.synth) on the CPU.

Here every ring op takes its plain version.  The port's internal contract
is bitwise (a graph's twin and its compiled run agree exactly); against
the reference's ``CompiledEngine(ring_impl="xla")`` the schedule — sweeps,
fires, occupancy, token counts — is exactly equal, and float outputs
agree within the tolerances stated below.  Every refusal of the
reference's counting pass and lowering is kept.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.apps import gaussian as ref_gaussian
from repro.apps import gemm as ref_gemm
from repro.apps import page_rank as ref_page_rank

import repro_torch
from repro_torch import StepTask, SynthesisError, channel, mmap
from repro_torch.apps import gaussian, gemm, page_rank
from repro_torch.core.synth import (CompiledEngine, elaborate_step_graph,
                                    to_torch_state)

I32 = torch.int32


def _strip(x):
    """Instance names carry a process-wide ``#uid`` suffix unless named
    explicitly; compare without it."""
    return re.sub(r"#\d+", "", repr(x))


def _i(v):
    return torch.tensor(v, dtype=I32)


def compiled():
    return repro_torch.ENGINES["compiled"](device="cpu")


def relay_pipeline(n_tokens=64, stages=2, burst=8, capacity=16,
                   sink_extra=0, chan_kw=None):
    """Step-form Source -> stages x Relay -> Sink writing into an mmap."""
    fires = n_tokens // burst

    def source_step(k, out):
        out.write_burst(k * burst + torch.arange(burst, dtype=I32,
                                                  device=k.device))
        return k + 1

    def relay_step(state, inp, out):
        out.write_burst(inp.read_burst(burst))
        return state

    def sink_step(k, inp, res):
        res.write_burst(k * burst, inp.read_burst(burst))
        return k + 1

    Source = StepTask(source_step, steps=fires, init=_i(0), name="Source")
    Relay = StepTask(relay_step, steps=fires, name="Relay")
    Sink = StepTask(sink_step, steps=fires + sink_extra, init=_i(0),
                    name="Sink")

    buf = np.zeros(n_tokens + sink_extra * burst, np.int32)
    res = mmap(buf, "res")
    kw = chan_kw if chan_kw is not None else dict(dtype=np.int32, shape=())

    def Top(res):
        chans = [channel(capacity, f"c{i}", **kw) for i in range(stages + 1)]
        t = repro_torch.task().invoke(Source, chans[0])
        for s in range(stages):
            t = t.invoke(Relay, chans[s], chans[s + 1], name=f"Relay{s}")
        t.invoke(Sink, chans[stages], res)

    return Top, (res,), buf


def _sink():
    return StepTask(lambda state, inp: (inp.read(), state)[1], steps=1,
                    name="S")


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def test_relay_pipeline_end_to_end():
    top, args, buf = relay_pipeline(n_tokens=64, burst=8, capacity=16)
    eng = compiled()
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert np.array_equal(buf, np.arange(64))       # written back to host
    assert rep.engine == "compiled"
    assert rep.switches == eng.n_sweeps > 0
    assert all(st == "finished" for _, st in rep.instances)
    assert max(mo for _, _, mo in rep.channels) > 0


def test_stall_reports_blocked_task():
    top, args, _ = relay_pipeline(sink_extra=1)
    rep = compiled().run(top, *args)
    assert not rep.ok
    assert "Sink" in rep.error and "stalled" in rep.error
    assert any(v == "blocked" for v in dict(rep.instances).values())
    assert rep.deadlock is not None
    assert rep.deadlock.engine == "compiled"
    assert rep.deadlock.reason == "stall"
    assert [t.split("#")[0] for t, _ in rep.deadlock.blocked] == ["Sink"]


def test_stall_matches_reference():
    # the same graph in the reference: the same stall after the same
    # sweeps, with the same occupancy
    burst, fires = 8, 8

    def source_step(k, out):
        out.write_burst(k * burst + jnp.arange(burst, dtype=jnp.int32))
        return k + 1

    def relay_step(state, inp, out):
        out.write_burst(inp.read_burst(burst))
        return state

    def sink_step(k, inp, res):
        res.write_burst(k * burst, inp.read_burst(burst))
        return k + 1

    RS = repro.StepTask
    Source = RS(source_step, steps=fires, init=jnp.int32(0), name="Source")
    Relay = RS(relay_step, steps=fires, name="Relay")
    Sink = RS(sink_step, steps=fires + 1, init=jnp.int32(0), name="Sink")

    def RTop(res):
        chans = [repro.channel(16, f"c{i}", dtype=np.int32, shape=())
                 for i in range(3)]
        t = repro.task().invoke(Source, chans[0])
        for s in range(2):
            t = t.invoke(Relay, chans[s], chans[s + 1], name=f"Relay{s}")
        t.invoke(Sink, chans[2], res)

    ref = repro.ENGINES["compiled"](cache=False, ring_impl="xla") \
        .run(RTop, repro.mmap(np.zeros(72, np.int32), "res"))
    top, args, _ = relay_pipeline(sink_extra=1)
    rep = compiled().run(top, *args)
    assert _strip(rep.error) == _strip(ref.error)
    assert rep.switches == ref.switches
    assert _strip(rep.deadlock.blocked) == _strip(ref.deadlock.blocked)
    assert rep.deadlock.occupancy == ref.deadlock.occupancy


# ---------------------------------------------------------------------------
# refusals: each names the task or channel at fault
# ---------------------------------------------------------------------------

def test_refuses_non_step_leaf():
    def free_form(out):
        out.write(1)

    def Top():
        c = channel(2, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(free_form, c, name="Free") \
            .invoke(_sink(), c)

    with pytest.raises(SynthesisError, match="'Free'.*step-function form"):
        compiled().run(Top)


def test_refuses_unspecced_channel():
    top, args, _ = relay_pipeline(chan_kw={})
    with pytest.raises(SynthesisError, match="'c0' has no declared element"):
        compiled().run(top, *args)


def test_refuses_data_dependent_burst_size():
    def bad(k, inp, out):
        n = inp.read()
        out.write_burst(inp.read_burst(n))     # a tensor size
        return k

    B = StepTask(bad, steps=1, init=_i(0), name="Bad")
    src = StepTask(lambda k, o: (o.write_burst(k + torch.arange(
        4, dtype=I32, device=k.device)), k + 1)[1], steps=1, init=_i(0),
        name="Src")

    def Top():
        a = channel(8, "a", dtype=np.int32, shape=())
        b = channel(8, "b", dtype=np.int32, shape=())
        repro_torch.task().invoke(src, a).invoke(B, a, b)

    with pytest.raises(SynthesisError,
                       match=r"'Bad#\d+'.*'a' is data-dependent"):
        compiled().run(Top)


def test_refuses_data_dependent_mmap_burst():
    m = mmap(np.zeros(4, np.float32), "table")

    def bad(k, m, out):
        out.write(m.read_burst(0, k)[0])
        return k

    B = StepTask(bad, steps=1, init=_i(1), name="Bad")

    def Top(m):
        c = channel(2, "c", dtype=np.float32, shape=())
        repro_torch.task().invoke(B, m, c).invoke(_sink(), c)

    with pytest.raises(SynthesisError, match="mmap 'table' read_burst size "
                           "is data-dependent"):
        compiled().run(Top, m)


@pytest.mark.parametrize("tok,match", [
    (lambda: torch.zeros((3, 3)), r"shape \(3, 3\) to channel 'c'"),
    (lambda: torch.zeros((2, 2), dtype=torch.float64),
     r"dtype float64 to channel 'c'.*canonicalized float32"),
])
def test_refuses_wrong_token(tok, match):
    B = StepTask(lambda state, out: (out.write(tok()), state)[1], steps=1,
                 name="Bad")

    def Top():
        c = channel(2, "c", dtype=np.float32, shape=(2, 2))
        repro_torch.task().invoke(B, c).invoke(_sink(), c)

    with pytest.raises(SynthesisError, match=r"'Bad#\d+' wrote a token of "
                                             + match):
        compiled().run(Top)


def test_refuses_reads_beyond_capacity():
    top, args, _ = relay_pipeline(burst=8, capacity=4)
    with pytest.raises(SynthesisError,
                       match=r"'Source#\d+'.*writes 8 tokens per "
                           "firing to channel 'c0' of "
                           "capacity 4; it could never "
                           "fire"):
        compiled().run(top, *args)


def test_refuses_reads_beyond_capacity_on_the_read_side():
    # two single reads per firing from a capacity-1 channel
    def two(state, inp):
        inp.read()
        inp.read()
        return state

    T = StepTask(two, steps=1, name="Two")
    src = StepTask(lambda s, o: (o.write(_i(0)), s)[1], steps=2, name="Src")

    def Top():
        c = channel(1, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(src, c).invoke(T, c)

    with pytest.raises(SynthesisError, match=r"'Two#\d+'.*reads 2 tokens per "
                           "firing from channel 'c'"):
        compiled().run(Top)


def test_refuses_close_outputs():
    T = StepTask(lambda k, out: (out.write(_i(0)), k)[1], steps=1,
                 init=_i(0), close_outputs=True, name="T")

    def Top():
        c = channel(2, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(T, c).invoke(_sink(), c)

    with pytest.raises(SynthesisError, match=r"'T#\d+' closes its outputs"):
        compiled().run(Top)


def test_refuses_cross_task_mmap_read_after_write():
    m = mmap(np.zeros(4, np.float32), "shared")

    def writer(state, m):
        m[0] = torch.tensor(1.0)
        return state

    def reader(state, m, out):
        out.write(m[0])
        return state

    W = StepTask(writer, steps=1, name="W")
    R = StepTask(reader, steps=1, name="R")

    def Top(m):
        c = channel(2, "c", dtype=np.float32, shape=())
        repro_torch.task().invoke(W, m).invoke(R, m, c).invoke(_sink(), c)

    with pytest.raises(SynthesisError,
                       match=r"'shared' is written by \['W#\d+'\]"
                           r" and read by \['R#\d+'\].*"
                           "schedule-dependent"):
        compiled().run(Top, m)


def test_refuses_unstable_state_spec():
    def grow(state, out):
        out.write(_i(0))
        return torch.zeros(int(state.shape[0]) + 1, dtype=I32)

    G = StepTask(grow, steps=2, init=torch.zeros(1, dtype=I32), name="G")
    S = StepTask(lambda s, inp: (inp.read(), s)[1], steps=2, name="S")

    def Top():
        c = channel(2, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(G, c).invoke(S, c)

    with pytest.raises(SynthesisError,
                       match=r"'G#\d+': phase 'step' changed the "
                           "state spec"):
        compiled().run(Top)


def test_refuses_value_dependent_control_flow():
    # reading a value on the host cannot be lowered: the counting pass
    # runs on meta tensors, which hold no values
    def peeky(state, inp):
        if int(inp.read()) > 0:
            pass
        return state

    P = StepTask(peeky, steps=1, name="Peeky")
    src = StepTask(lambda s, o: (o.write(_i(1)), s)[1], steps=1, name="Src")

    def Top():
        c = channel(2, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(src, c).invoke(P, c)

    with pytest.raises(SynthesisError,
                       match=r"'Peeky#\d+': phase 'step' failed "
                           "to trace"):
        compiled().run(Top)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CompiledEngine()
    for mod in (gemm, gaussian, page_rank):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.build_step()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.run_step("compiled")


def test_to_torch_state_canonical_dtypes():
    tree = (np.float64(1.5), np.arange(3, dtype=np.int64),
            {"b": np.array([True, False])}, None, 7)
    out = to_torch_state(tree, "cpu")
    assert out[0].dtype == torch.float32 and float(out[0]) == 1.5
    assert out[1].dtype == torch.int32 and out[1].tolist() == [0, 1, 2]
    assert out[2]["b"].dtype == torch.bool and out[3] is None
    assert out[4].dtype == torch.int32


def test_elaborate_step_graph_runs_nothing():
    top, args, buf = relay_pipeline(n_tokens=16, burst=8)
    plan, graph, _ = elaborate_step_graph(top, *args)
    assert _strip([tp.inst.name for tp in plan.tasks]) == \
        repr(["Source", "Relay0", "Relay1", "Sink"])
    assert plan.tasks[0].phases[0].writes == {0: 8}
    assert not buf.any()
    graph.validate()


# ---------------------------------------------------------------------------
# the apps: torch twin == torch compiled, bitwise; schedule == reference
# ---------------------------------------------------------------------------

APPS = {
    # gemm: float32 matmuls sum in another order than XLA's, so outputs
    # agree within atol = 1e-5 * K * n
    "gemm": (gemm, ref_gemm, dict(P=2, n=4, K=2),
             dict(rtol=0, atol=1e-5 * 2 * 4)),
    # gaussian and page_rank: XLA may FMA-contract the stencil sum and
    # the damping mix; eager torch does not
    "gaussian": (gaussian, ref_gaussian, dict(h=6, w=6, iters=2),
                 dict(rtol=1e-6, atol=1e-6)),
    "page_rank": (page_rank, ref_page_rank,
                  dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=3),
                  dict(rtol=1e-6, atol=1e-6)),
}


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _out(name, args):
    if name == "gemm":
        return np.concatenate([_host(m.data) for m in args[2]])
    return _host(args[1].data)


def _chan_stats(rep, eng):
    return sorted((c.name, c.total_read, c.total_written, c.max_occupancy)
                  for c in eng.channel_set)


@pytest.mark.parametrize("name", sorted(APPS))
def test_app_twin_equals_compiled_and_reference(name):
    mod, ref_mod, kw, tol = APPS[name]
    top, args, check = mod.build_step(device="cpu", **kw)
    twin = repro_torch.ENGINES["coroutine"](track_stats=True).run(top, *args)
    assert twin.ok, twin.error
    y_twin = _out(name, args)

    top, args, check = mod.build_step(device="cpu", **kw)
    eng = compiled()
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert check()[0]
    y = _out(name, args)
    assert y.tobytes() == y_twin.tobytes()          # bitwise twin parity

    rtop, rargs, _ = ref_mod.build_step(**kw)
    # the same seeded inputs: the reference's numpy mmaps, carried across
    # with to_torch_state, are the port's
    for m, rm in zip(args[:1], rargs[:1]):
        assert torch.equal(m.data, to_torch_state(rm.data, "cpu"))
    reng = repro.ENGINES["compiled"](cache=False, ring_impl="xla")
    ref = reng.run(rtop, *rargs)
    assert ref.ok, ref.error
    assert rep.switches == ref.switches             # sweeps
    assert _strip(rep.instances) == _strip(ref.instances)   # all fired
    assert rep.channels == ref.channels             # written + highwater
    assert _chan_stats(rep, eng) == _chan_stats(ref, reng)
    assert rep.tokens == twin.tokens == ref.tokens
    np.testing.assert_allclose(y, _out(name, rargs), **tol)

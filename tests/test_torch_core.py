"""The port's framework-neutral core against the reference package.

The same programs run under the sequential, thread and coroutine engines
of ``repro_torch`` and of ``repro``: equal tokens, ``SimReport`` counts,
deadlock reasons, graph tables and validation verdicts.  Programs take the
package as an argument, so both run the same Python.
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro
from repro.apps import page_rank as ref_page_rank
from repro.core.errors import GraphValidationError as RefGraphError

import repro_torch
from repro_torch.apps import gemm, page_rank
from repro_torch.core.errors import GraphValidationError

ENGINES = ["sequential", "thread", "coroutine"]
PKGS = {"ref": repro, "port": repro_torch}


def pipeline(pkg, n=10, cap=2):
    def Producer(out: pkg.OStream, n: int):
        for i in range(n):
            out.write(i * 3)
        out.close()

    def Relay(inp: pkg.IStream, out: pkg.OStream):
        for v in inp:
            out.write(v + 1)
        out.close()

    def Consumer(inp: pkg.IStream, sink: list):
        for v in inp:
            sink.append(v)

    def Top(sink):
        a = pkg.channel(cap, "a")
        b = pkg.channel(cap, "b")
        pkg.task().invoke(Producer, a, n).invoke(Relay, a, b) \
            .invoke(Consumer, b, sink)
    return Top


def bursts(pkg, n=23, cap=4):
    def Producer(out: pkg.OStream):
        out.write_burst(list(range(n)))
        out.close()

    def Consumer(inp: pkg.IStream, sink: list):
        while True:
            chunk = inp.read_burst(5)
            sink.extend(chunk)
            if len(chunk) < 5:
                break
        inp.open()

    def Top(sink):
        c = pkg.channel(cap, "c")
        pkg.task().invoke(Producer, c).invoke(Consumer, c, sink)
    return Top


def feedback(pkg, n=6):
    """Request/response loop: a cycle, which the sequential engine must
    refuse (paper Fig. 7)."""
    def Ctrl(req: pkg.OStream, resp: pkg.IStream, sink: list):
        for i in range(n):
            req.write(i)
            sink.append(resp.read())
        req.close()

    def Server(req: pkg.IStream, resp: pkg.OStream):
        for v in req:
            resp.write(v * v)

    def Top(sink):
        req = pkg.channel(1, "req")
        resp = pkg.channel(1, "resp")
        pkg.task().invoke(Ctrl, req, resp, sink).invoke(Server, req, resp)
    return Top


def starved(pkg):
    """The consumer wants one token more than is ever produced."""
    def Producer(out: pkg.OStream):
        for i in range(3):
            out.write(i)

    def Consumer(inp: pkg.IStream, sink: list):
        for _ in range(4):
            sink.append(inp.read())

    def Top(sink):
        c = pkg.channel(2, "c")
        pkg.task().invoke(Producer, c).invoke(Consumer, c, sink)
    return Top


def merge(pkg, n=8):
    """Availability-routed merge: select + peek over two inputs."""
    def Src(out: pkg.OStream, base: int):
        for i in range(n):
            out.write(base + i)
        out.close()

    def Merge(a: pkg.IStream, b: pkg.IStream, out: pkg.OStream):
        live = [a, b]
        while live:
            pkg.select(*live)
            for s in list(live):
                if s.empty():
                    continue
                if s.eot():
                    s.open()
                    live.remove(s)
                else:
                    out.write(s.read())
        out.close()

    def Sink(inp: pkg.IStream, sink: list):
        sink.extend(sorted(inp.read_transaction()))

    def Top(sink):
        a, b, c = (pkg.channel(2, x) for x in "abc")
        pkg.task().invoke(Src, a, 0, name="SrcA") \
            .invoke(Src, b, 100, name="SrcB") \
            .invoke(Merge, a, b, c).invoke(Sink, c, sink)
    return Top


def memory(pkg):
    """mmap loads/stores and an async_mmap pipelined fetch (numpy buffers
    in both packages)."""
    table = np.arange(12, dtype=np.int32).reshape(6, 2)
    out = np.zeros(6, np.int32)

    def Fetch(port: pkg.AsyncMMap, o: pkg.OStream):
        for s, d in port.read_pipelined(range(6)):
            o.write(int(s) * 10 + int(d))
        o.close()

    def Store(i: pkg.IStream, dst: pkg.MMap, sink: list):
        for k, v in enumerate(i):
            dst[k] = v
        sink.extend(int(x) for x in dst.read_burst(0, 6))

    def Top(sink):
        c = pkg.channel(2, "c")
        port = pkg.async_mmap(table, latency=3, depth=2, name="table")
        pkg.task().invoke(Fetch, port, c) \
            .invoke(Store, c, pkg.mmap(out, "out"), sink)
    return Top


def _summary(rep, sink, engine):
    out = dict(ok=rep.ok, tokens=rep.tokens, sink=list(sink),
               error=rep.error is not None,
               reason=rep.deadlock.reason if rep.deadlock else None)
    if engine != "thread":      # thread interleavings depend on timing
        out.update(switches=rep.switches, channels=rep.channels,
                   instances=rep.instances,
                   blocked=sorted(rep.deadlock.blocked) if rep.deadlock
                   else None)
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("program", [pipeline, bursts, feedback, starved,
                                     merge, memory])
def test_same_program_same_report(program, engine):
    got = {}
    for name, pkg in PKGS.items():
        sink: list = []
        rep = pkg.ENGINES[engine](track_stats=True).run(program(pkg), sink)
        got[name] = _summary(rep, sink, engine)
    assert got["port"] == got["ref"]
    if program is feedback and engine == "sequential":
        assert not got["port"]["ok"]


@pytest.mark.parametrize("engine", ["coroutine", "thread"])
def test_typed_channel_tokens(engine):
    # the element spec accepts tensors of the declared dtype and names the
    # channel and task when a float64 tensor breaks it, as the reference
    # does for numpy arrays
    def run(pkg, make, bad):
        def P(out: pkg.OStream):
            out.write(make(np.arange(3, dtype=np.float32)))
            out.write(make(np.ones(3, dtype=np.float64 if bad
                                   else np.float32)))
            out.close()

        def C(inp: pkg.IStream, sink: list):
            for v in inp:
                sink.append(float(v.sum()))

        def Top(sink):
            c = pkg.channel(2, "typed", dtype=np.float32, shape=(3,))
            pkg.task().invoke(P, c, name="Prod").invoke(C, c, sink)

        sink: list = []
        rep = pkg.ENGINES[engine](track_stats=True).run(Top, sink)
        return rep, sink

    for bad in (False, True):
        rep, sink = run(repro_torch, torch.from_numpy, bad)
        ref, ref_sink = run(repro, np.asarray, bad)
        assert rep.ok == ref.ok == (not bad)
        if not bad:     # a failed run's partial output depends on timing
            assert sink == ref_sink == [3.0, 3.0]
        else:
            assert "typed" in rep.error and "Prod" in rep.error \
                and "float64" in rep.error


@pytest.mark.parametrize("engine", ["sequential", "coroutine"])
@pytest.mark.parametrize("plan_kw", [
    dict(chan_stall={"*": {"p": 0.4, "stall": 2, "wake": 1}}),
    dict(task_raise={"Relay": 5}),
])
def test_fault_injection_same_log(engine, plan_kw):
    got = {}
    for name, pkg in PKGS.items():
        inj = pkg.core.FaultPlan(seed=3, **plan_kw).injector()
        sink: list = []
        rep = pkg.ENGINES[engine](faults=inj).run(pipeline(pkg, n=20), sink)
        got[name] = (rep.ok, rep.error, sink, list(inj.log),
                     rep.switches)
    assert got["port"] == got["ref"]
    assert got["port"][3]                   # faults actually fired


def test_page_rank_twin_fails_sequential_in_both():
    kw = dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=3)
    ours = page_rank.run_step("sequential", device="cpu", **kw)
    ref = ref_page_rank.run_step("sequential", **kw)
    assert not ours.report.ok and not ref.report.ok
    assert ours.report.deadlock.reason == ref.report.deadlock.reason


def test_graph_tables_agree():
    from repro.apps import gemm as ref_gemm
    kw = dict(P=2, n=4, K=2)
    top, args, _ = gemm.build_step(device="cpu", **kw)
    g = repro_torch.elaborate(top, *args, engine="coroutine")
    rtop, rargs, _ = ref_gemm.build_step(**kw)
    rg = repro.elaborate(rtop, *rargs, engine="coroutine")
    assert [astuple(c) for c in g.channel_info] == \
        [astuple(c) for c in rg.channel_info]

    def defs(graph):
        return sorted((d.name, d.n_instances, d.instance_names,
                       tuple((i.param, i.kind, i.dtype, i.direction)
                             for i in d.interfaces))
                      for d in graph.definitions)

    assert defs(g) == defs(rg)
    assert g.summary() == rg.summary()


def test_validation_verdicts_agree():
    def dangling(pkg):
        def P(out: pkg.OStream):
            out.write(1)

        def Top():
            c = pkg.channel(2, "c")
            pkg.task().invoke(P, c, name="Prod")
        return Top

    with pytest.raises(GraphValidationError) as ours:
        repro_torch.elaborate(dangling(repro_torch))
    with pytest.raises(RefGraphError) as ref:
        repro.elaborate(dangling(repro))
    assert str(ours.value) == str(ref.value)
    assert "has no consumer" in str(ours.value)
    # and a valid graph passes in both
    for pkg in (repro_torch, repro):
        pkg.elaborate(pipeline(pkg), []).validate()

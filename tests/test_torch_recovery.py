"""Crash recovery in the port, on the CPU, held against the reference.

``repro_torch.ft.recovery`` mirrors ``repro.ft.recovery``: graph snapshots
in the reference's row layout, the snapshot store, chunked runs cut at the
abstract schedule's sweep boundaries, and supervised restart; under
``CompiledEngine`` each chunk replays the prepared sweep program (on the
card its captured CUDA graph, ``chip_smoke.py`` phase 16) for an exact
budget of sweeps from a carry restored in place.  Here:

* every graph-recovery test of ``tests/test_recovery.py`` against the port
  (``device="cpu"``), and its serving-journal tests against the port's
  journal and engine;
* parity with the reference: the abstract schedule's cuts and ``stalled``
  exactly, the compiled snapshot at every boundary (integers exactly,
  floats within the tolerances of ``tests/test_torch_synth.py``), and a
  snapshot the reference made restoring and finishing in the port;
* the resumable program's own checks: restore in place, a snapshot at
  completion, budgets against replay blocks, the chunk-local rebase of the
  ports' due stamps, and the unchunked run's counts.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.apps import gemm as ref_gemm
from repro.apps import page_rank as ref_page_rank
from repro.core import synth as ref_synth
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.ft import recovery as ref_recovery

import repro_torch
from repro_torch import StepTask, SynthesisError, channel
from repro_torch.apps import gaussian, gemm, page_rank
from repro_torch.core import CrashFault, synth
from repro_torch.core.channel import EOT
from repro_torch.core.faults import FaultPlan
from repro_torch.core.interface import MMap, async_mmap
from repro_torch.ft import recovery
from repro_torch.ft.recovery import (RestartPolicy, SnapshotStore,
                                     capture_channel, capture_port,
                                     restore_channel, restore_port,
                                     run_recoverable, run_supervised)
from repro_torch.kernels import ring
from repro_torch.serve import (Request, ServeConfig, ServeJournal,
                               ServingEngine, serve_requests)

CPU = dict(device="cpu")
I32 = torch.int32
SEED = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
# the float apps' tolerances against the reference, as in
# tests/test_torch_synth.py: gemm's fp32 sums agree within 1e-5 * K * n,
# page_rank's ranks within 1e-6
TOL = {"gemm": dict(rtol=0, atol=1e-5 * 3 * 4),
       "gemm_async": dict(rtol=0, atol=1e-5 * 4 * 4),
       "page_rank": dict(rtol=1e-6, atol=1e-6),
       "page_rank_async": dict(rtol=1e-6, atol=1e-6),
       "relay": dict(rtol=0, atol=0)}


# ---------------------------------------------------------------------------
# graphs, in both packages
# ---------------------------------------------------------------------------

def _mmaps(args, kind=MMap):
    out = []

    def walk(v):
        if isinstance(v, kind):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
    walk(args)
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _outputs(args):
    """Every mmap's and async port's buffer, in argument order."""
    return [np.array(_np(m.data), copy=True)
            for m in _mmaps(args, (MMap, repro_torch.AsyncMMap))]


def _ref_outputs(args):
    from repro.core.interface import AsyncMMap, MMap as RefMMap
    return [np.array(np.asarray(m.data), copy=True)
            for m in _mmaps(args, (RefMMap, AsyncMMap))]


def relay_pipeline(n_tokens=32, burst=8, capacity=16, pkg=repro_torch):
    """Source -> Relay (x2) -> Sink into an int32 mmap, in ``pkg``."""
    fires = n_tokens // burst
    if pkg is repro:
        ar = lambda k: jnp.arange(burst, dtype=jnp.int32)    # noqa: E731
        zero = jnp.int32(0)
        ST = repro.StepTask
    else:
        ar = lambda k: torch.arange(burst, dtype=I32,      # noqa: E731
                                    device=k.device)
        zero = torch.tensor(0, dtype=I32)
        ST = StepTask

    def source_step(k, out):
        out.write_burst(ar(k) + k * burst)
        return k + 1

    def relay_step(state, inp, out):
        out.write_burst(inp.read_burst(burst) * 2)
        return state

    def sink_step(k, inp, res):
        res.write_burst(k * burst, inp.read_burst(burst))
        return k + 1

    Source = ST(source_step, steps=fires, init=zero, name="Source")
    Relay = ST(relay_step, steps=fires, name="Relay")
    Sink = ST(sink_step, steps=fires, init=zero, name="Sink")
    buf = np.zeros(n_tokens, np.int32)
    res = pkg.mmap(buf, "res")

    def Top(res):
        c0 = pkg.channel(capacity, "c0", dtype=np.int32, shape=())
        c1 = pkg.channel(capacity, "c1", dtype=np.int32, shape=())
        pkg.task().invoke(Source, c0).invoke(Relay, c0, c1) \
            .invoke(Sink, c1, res)

    return Top, (res,), buf


GRAPHS = {
    # name: (port builder, reference builder), the reference test's sizes
    "relay": (lambda: relay_pipeline(48, 8, 8)[:2] + (None,),
              lambda: relay_pipeline(48, 8, 8, pkg=repro)[:2] + (None,)),
    "gemm": (lambda: gemm.build_step(P=2, n=4, K=3, seed=0, **CPU),
             lambda: ref_gemm.build_step(P=2, n=4, K=3, seed=0)),
    "page_rank": (lambda: page_rank.build_step(
        n_vertices=16, n_edges=48, n_pe=2, n_iters=4, seed=0, **CPU),
        lambda: ref_page_rank.build_step(n_vertices=16, n_edges=48, n_pe=2,
                                         n_iters=4, seed=0)),
}
ASYNC = {
    "gemm_async": (lambda d: gemm.build_step_async(P=2, n=4, K=4, depth=d,
                                                   **CPU),
                   lambda d: ref_gemm.build_step_async(P=2, n=4, K=4,
                                                       depth=d)),
    "page_rank_async": (
        lambda d: page_rank.build_step_async(
            n_vertices=16, n_edges=48, n_pe=2, n_iters=4, edge_depth=d,
            **CPU),
        lambda d: ref_page_rank.build_step_async(
            n_vertices=16, n_edges=48, n_pe=2, n_iters=4, edge_depth=d)),
}


def _build(name, depth=4, ref=False):
    if name in ASYNC:
        return ASYNC[name][ref](depth)
    return GRAPHS[name][ref]()


def _build_app(app):
    return _build(app)


@functools.lru_cache(maxsize=None)
def _golden(app):
    top, args, check = _build_app(app)
    rep = repro_torch.ENGINES["coroutine"]().run(top, *args)
    assert rep.ok, rep.error
    if check is not None:
        ok, err = check()
        assert ok, err
    return tuple(o.tobytes() for o in _outputs(args))


@functools.lru_cache(maxsize=None)
def _compiled_golden(name, depth=4):
    top, args, check = _build(name, depth)
    rep = repro_torch.ENGINES["compiled"](**CPU).run(top, *args)
    assert rep.ok, rep.error
    return rep.switches, tuple(o.tobytes() for o in _outputs(args))


def _bytes(args):
    return tuple(o.tobytes() for o in _outputs(args))


# ---------------------------------------------------------------------------
# snapshots + chunked execution (tests/test_recovery.py, on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine",
                         ["sequential", "thread", "coroutine", "compiled"])
def test_recoverable_matches_plain_every_engine(engine):
    top, args, buf = relay_pipeline()
    rep = repro_torch.ENGINES["coroutine"]().run(top, *args)
    assert rep.ok
    golden = buf.copy()

    top, args, buf = relay_pipeline()
    rep = run_recoverable(engine, top, *args, snapshot_every=2, **CPU)
    assert rep.ok, rep.error
    assert np.array_equal(buf, golden)


def test_recoverable_snapshots_cut_on_full_channels(tmp_path):
    """A tight capacity forces sweep cuts where channels are full — the
    snapshot must carry a full ring and restore it."""
    top, args, buf = relay_pipeline(n_tokens=48, burst=8, capacity=8)
    rep = repro_torch.ENGINES["coroutine"]().run(top, *args)
    assert rep.ok
    golden = buf.copy()
    for engine in ("coroutine", "compiled"):
        top, args, buf = relay_pipeline(n_tokens=48, burst=8, capacity=8)
        log = []
        rep = run_recoverable(engine, top, *args, snapshot_every=1,
                              store=SnapshotStore(tmp_path / engine),
                              log=log, **CPU)
        assert rep.ok, rep.error
        assert np.array_equal(buf, golden), engine
        assert any(s["full_channels"] for s in log[0].saves), engine


def test_store_resume_skips_completed_sweeps(tmp_path):
    top, args, buf = relay_pipeline()
    store = SnapshotStore(tmp_path)
    inj = FaultPlan(seed=SEED, crash={"chunk": 2}).injector()
    with pytest.raises(CrashFault):
        run_recoverable("coroutine", top, *args, store=store,
                        snapshot_every=1, faults=inj, **CPU)
    partial = buf.copy()
    top2, args2, buf2 = relay_pipeline()
    log = []
    rep = run_recoverable("coroutine", top2, *args2, store=store,
                          snapshot_every=1, log=log, **CPU)
    assert rep.ok, rep.error
    assert log[0].start_sweep == 2
    top3, args3, buf3 = relay_pipeline()
    repro_torch.ENGINES["coroutine"]().run(top3, *args3)
    assert np.array_equal(buf2, buf3)
    assert not np.array_equal(partial, buf3)   # the crash really cut it


def test_stale_snapshot_of_other_graph_is_ignored(tmp_path):
    store = SnapshotStore(tmp_path)
    top, args, _ = relay_pipeline()
    rep = run_recoverable("coroutine", top, *args, store=store,
                          snapshot_every=2, **CPU)
    assert rep.ok
    top2, args2, buf2 = relay_pipeline(n_tokens=48, burst=8, capacity=8)
    log = []
    rep = run_recoverable("coroutine", top2, *args2, store=store,
                          snapshot_every=2, log=log, **CPU)
    assert rep.ok, rep.error
    assert log[0].start_sweep == 0
    top3, args3, buf3 = relay_pipeline(n_tokens=48, burst=8, capacity=8)
    repro_torch.ENGINES["coroutine"]().run(top3, *args3)
    assert np.array_equal(buf2, buf3)


def test_abstract_schedule_matches_compiled_sweep_count():
    top, args, _ = relay_pipeline(n_tokens=48, burst=8, capacity=8)
    plan, graph, _ = synth.elaborate_step_graph(top, *args)
    cuts, stalled = recovery._abstract_schedule(plan)
    assert not stalled
    top2, args2, _ = relay_pipeline(n_tokens=48, burst=8, capacity=8)
    rep = repro_torch.ENGINES["compiled"](**CPU).run(top2, *args2)
    assert rep.ok
    assert rep.switches == len(cuts) - 1


_CRASHES = {
    "gemm": [{"chunk": 1}, {"PE1_1": 4}],
    "page_rank": [{"chunk": 1}, {"Scatter0": 2}],
}


@pytest.mark.parametrize("app", ["gemm", "page_rank"])
@pytest.mark.parametrize("engine", ["coroutine", "compiled"])
def test_fault_matrix_recovery_parity(app, engine, tmp_path):
    golden = _golden(app)
    crashes = _CRASHES[app] if engine != "compiled" else \
        [c for c in _CRASHES[app] if "chunk" in c]
    for k, crash in enumerate(crashes):
        top, args, check = _build_app(app)
        store = SnapshotStore(tmp_path / f"{engine}_{k}")
        log = []
        rep = run_supervised(engine, top, *args,
                             store=store, snapshot_every=2,
                             faults=FaultPlan(seed=SEED, crash=crash),
                             policy=RestartPolicy(max_restarts=2,
                                                  backoff_s=0.0),
                             log=log, **CPU)
        assert rep.ok, (crash, rep.error)
        assert _bytes(args) == golden, (crash, "output mismatch")
        ok, err = check()
        assert ok, (crash, err)
        assert [a.crashed for a in log] == [True, False], crash


@pytest.mark.parametrize("app", ["gemm", "page_rank"])
@pytest.mark.parametrize("first,second", [("coroutine", "compiled"),
                                          ("compiled", "coroutine")])
def test_cross_engine_snapshot_restore_parity(app, first, second, tmp_path):
    """Crash under one engine, finish under the other, from the same
    persisted snapshot — outputs must be bit-identical to fault-free."""
    golden = _golden(app)
    store = SnapshotStore(tmp_path)
    top, args, _ = _build_app(app)
    inj = FaultPlan(seed=SEED, crash={"chunk": 1}).injector()
    with pytest.raises(CrashFault):
        run_recoverable(first, top, *args, store=store, snapshot_every=1,
                        faults=inj, **CPU)
    top2, args2, check2 = _build_app(app)
    log = []
    rep = run_recoverable(second, top2, *args2, store=store,
                          snapshot_every=1, log=log, **CPU)
    assert rep.ok, rep.error
    assert log[0].start_sweep == 1
    assert _bytes(args2) == golden, "cross-engine output mismatch"
    ok, err = check2()
    assert ok, err


def test_supervisor_exhausts_restarts_and_raises():
    top, args, _ = relay_pipeline()
    with pytest.raises(CrashFault, match="still crashing"):
        run_supervised(
            "coroutine", top, *args,
            faults=FaultPlan(seed=SEED, crash={"Source": 0, "Relay": 0,
                                               "Sink": 0}),
            policy=RestartPolicy(max_restarts=1, backoff_s=0.0), **CPU)


def test_supervisor_plain_delegation_without_store():
    top, args, buf = relay_pipeline()
    rep = run_supervised("coroutine", top, *args,
                         faults=FaultPlan(seed=SEED, crash={"Relay": 3}),
                         policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                         **CPU)
    assert rep.ok, rep.error
    top2, args2, buf2 = relay_pipeline()
    repro_torch.ENGINES["coroutine"]().run(top2, *args2)
    assert np.array_equal(buf, buf2)


def test_supervisor_falls_back_for_non_step_graphs():
    got = []

    def producer(out):
        out.write_burst([1, 2, 3])
        out.close()

    def consumer(inp):
        got.append([int(t) for t in inp.read_transaction()])

    def Top():
        c = channel(8, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(producer, c).invoke(consumer, c)

    rep = run_supervised("coroutine", Top, store=None,
                         faults=FaultPlan(seed=SEED, crash={"producer": 1}),
                         policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                         **CPU)
    assert rep.ok, rep.error
    assert got[-1] == [1, 2, 3]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    top, args, _ = relay_pipeline()
    for fn in (run_recoverable, run_supervised):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn("compiled", top, *args)


# ---------------------------------------------------------------------------
# edge-case capture/restore containers
# ---------------------------------------------------------------------------

def test_capture_restore_channel_mid_burst():
    c = channel(8, "c", dtype=np.int32, shape=())
    for t in (1, 2, 3):
        c._push(t)
    st = capture_channel(c)
    c._pop(), c._push(9)                 # diverge after the capture
    c2 = channel(8, "c", dtype=np.int32, shape=())
    restore_channel(c2, st)
    assert list(c2._q) == [1, 2, 3]
    assert c2._eot_count == 0


def test_capture_restore_full_channel():
    c = channel(4, "c", dtype=np.int32, shape=())
    for t in range(4):
        c._push(t)
    st = capture_channel(c)
    c2 = channel(4, "c", dtype=np.int32, shape=())
    restore_channel(c2, st)
    assert len(c2._q) == c2.capacity == 4
    assert list(c2._q) == [0, 1, 2, 3]


def test_capture_restore_eot_propagated_but_unread():
    c = channel(8, "c", dtype=np.int32, shape=())
    c._push(7)
    c._push(8)
    c._push(EOT)
    st = capture_channel(c)
    assert st.eot_count == 1
    c2 = channel(8, "c", dtype=np.int32, shape=())
    restore_channel(c2, st)
    assert c2._eot_count == 1
    got = []
    while c2._q:
        t = c2._pop()
        if t is EOT:
            break
        got.append(int(t))
    assert got == [7, 8]
    assert c2._eot_count == 0 and not c2._q


class _StubEngine:
    """Just enough engine surface for AsyncMMap.pump: a clock and an
    event list we can drain (or abandon, simulating a crash)."""
    clock = 0
    force_async = True
    faults = None

    def __init__(self):
        self.events = []

    def schedule_async(self, lat, fn):
        self.events.append(fn)

    def _iface_pop(self, ch):
        return ch._pop()

    def _iface_deliver(self, ch, v):
        ch._push(v)


@pytest.mark.parametrize("data", ["numpy", "tensor"])
def test_capture_restore_port_with_pending_response(data):
    wrap = (lambda a: a) if data == "numpy" else torch.from_numpy
    buf = np.arange(8, dtype=np.float32)
    port = async_mmap(wrap(buf.copy()), name="m", latency=2, depth=4)
    eng = _StubEngine()
    port._raddr._push(3)
    port._raddr._push(5)
    port.pump(eng)
    assert port._pending_reads == 2
    assert port._inflight_reads == [3, 5]
    st = capture_port(port)

    port2 = async_mmap(wrap(np.zeros(8, np.float32)), name="m", latency=2,
                       depth=4)
    restore_port(port2, st)
    assert np.array_equal(_np(port2.data), buf)
    assert port2._pending_reads == 0
    assert list(port2._raddr._q) == [3, 5]
    eng2 = _StubEngine()
    port2.pump(eng2)
    for fn in list(eng2.events):
        fn(eng2)
    assert [float(v) for v in port2._rdata._q] == [3.0, 5.0]
    assert port2._pending_reads == 0 and port2._inflight_reads == []


def test_capture_restore_port_inflight_write():
    data = np.zeros(8, np.float32)
    port = async_mmap(data, name="m", latency=1, depth=4)
    eng = _StubEngine()
    port._waddr._push(2)
    port._wdata._push(7.5)
    port.pump(eng)
    assert port._inflight_writes == [(2, 7.5)]
    st = capture_port(port)
    port2 = async_mmap(np.zeros(8, np.float32), name="m", latency=1, depth=4)
    restore_port(port2, st)
    eng2 = _StubEngine()
    port2.pump(eng2)
    for fn in list(eng2.events):
        fn(eng2)
    assert float(_np(port2.data)[2]) == 7.5
    assert len(port2._wresp._q) == 1


# ---------------------------------------------------------------------------
# compiled latency queues in snapshots (resumable async_mmap)
# ---------------------------------------------------------------------------

def test_python_engines_refuse_port_graphs(tmp_path):
    top, args, _ = _build("gemm_async")
    with pytest.raises(SynthesisError, match="async_mmap ports .*compiled"):
        run_recoverable("coroutine", top, *args, store=SnapshotStore(
            tmp_path), snapshot_every=2, **CPU)


def test_compiled_port_chunks_match_plain(tmp_path):
    """Depth-4 async gemm run in snapshot chunks is a bit-twin of the
    unchunked compiled run, and the snapshot rows carry the four ports'
    16-row latency-queue carry."""
    golden = _compiled_golden("gemm_async")[1]
    store = SnapshotStore(tmp_path)
    top2, args2, check2 = _build("gemm_async")
    rep2 = run_recoverable("compiled", top2, *args2, store=store,
                           snapshot_every=3, **CPU)
    assert rep2.ok, rep2.error
    assert check2()[0]
    assert _bytes(args2) == golden

    plan, graph, _ = synth.elaborate_step_graph(top2, *args2)
    snap = store.load_latest(plan, graph.structural_hash(),
                             [c.capacity for c in plan.channels])
    assert snap is not None
    assert len(snap.ports) == len(plan.ports) == 4
    assert all(len(pc) == 16 for pc in snap.ports)


def test_compiled_port_crash_resume_supervised(tmp_path):
    """A crash between chunks resumes from the port-bearing snapshot and
    still produces the plain run's exact output bytes."""
    golden = _compiled_golden("gemm_async")[1]
    store = SnapshotStore(tmp_path)
    top2, args2, check2 = _build("gemm_async")
    log = []
    rep2 = run_supervised("compiled", top2, *args2, store=store,
                          snapshot_every=3,
                          faults=FaultPlan(seed=7, crash={"chunk": 2}),
                          policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                          log=log, **CPU)
    assert rep2.ok, rep2.error
    assert check2()[0]
    assert _bytes(args2) == golden
    assert [a.start_sweep for a in log] == [0, 6]


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

SCHEDULES = [("relay", 4), ("gemm", 4), ("page_rank", 4),
             ("gemm_async", 1), ("gemm_async", 4),
             ("page_rank_async", 1), ("page_rank_async", 4)]


@pytest.mark.parametrize("name,depth", SCHEDULES,
                         ids=[f"{n}-d{d}" for n, d in SCHEDULES])
def test_abstract_schedule_equals_reference(name, depth):
    top, args, _ = _build(name, depth)
    plan, _, _ = synth.elaborate_step_graph(top, *args)
    rtop, rargs, _ = _build(name, depth, ref=True)
    rplan, _, _ = ref_synth.elaborate_step_graph(rtop, *rargs)
    cuts, stalled = recovery._abstract_schedule(plan)
    assert (cuts, stalled) == ref_recovery._abstract_schedule(rplan)
    assert not stalled and len(cuts) > 2


def test_abstract_schedule_stall_equals_reference():
    """A sink that wants one firing more than its source gives: the
    schedule stalls at the same cut in both packages."""
    def build(pkg):
        top, (res,), _ = relay_pipeline(32, 8, 16, pkg=pkg)
        return top, res
    graphs = []
    for pkg, elab in ((repro_torch, synth.elaborate_step_graph),
                      (repro, ref_synth.elaborate_step_graph)):
        top, res = build(pkg)
        plan, _, _ = elab(top, res)
        plan.tasks[-1].phases[-1].count += 1      # the sink asks for more
        graphs.append(plan)
    got = recovery._abstract_schedule(graphs[0])
    assert got == ref_recovery._abstract_schedule(graphs[1])
    assert got[1] is True


class _RefRecording(ref_recovery.SnapshotStore):
    """The reference's store, keeping a copy of every snapshot it is given
    in memory instead of on disk (a copy: on the CPU the reference's
    snapshot arrays may alias the host buffers the run writes back)."""

    def __init__(self):
        self.saved = {}

    def save(self, snap):
        copy = lambda t: ref_recovery.jax.tree.map(    # noqa: E731
            lambda x: np.array(x, copy=True), t)
        self.saved[snap.sweep] = ref_recovery.GraphSnapshot(
            graph_hash=snap.graph_hash, sweep=snap.sweep,
            fires=copy(snap.fires), states=copy(snap.states),
            chans=[(copy(b), int(n)) for b, n in snap.chans],
            mmaps=copy(snap.mmaps), ports=copy(snap.ports))

    def load_latest(self, *a, **k):
        return None


def _eq(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
    else:
        assert got.dtype == want.dtype, what
        assert np.array_equal(got, want), what


def _snapshots_equal(snap, ref, tol, sweep):
    _eq(snap.fires, ref.fires, tol, f"fires at {sweep}")
    assert len(snap.chans) == len(ref.chans)
    for ci, ((b, n), (rb, rn)) in enumerate(zip(snap.chans, ref.chans)):
        assert n == rn, f"channel {ci} size at {sweep}"
        _eq(b, rb, tol, f"channel {ci} buffer at {sweep}")
    for ti, (s, rs) in enumerate(zip(snap.states, ref.states)):
        leaves = synth._leaves(s)
        rleaves = [np.asarray(x) for x in synth._leaves(rs)]
        assert len(leaves) == len(rleaves)
        for x, rx in zip(leaves, rleaves):
            _eq(x, rx, tol, f"task {ti} state at {sweep}")
    for mi, (m, rm) in enumerate(zip(snap.mmaps, ref.mmaps)):
        _eq(m, rm, tol, f"mmap {mi} at {sweep}")
    assert len(snap.ports) == len(ref.ports)
    for pi, (pc, rpc) in enumerate(zip(snap.ports, ref.ports)):
        assert len(pc) == len(rpc) == 16
        for e, (x, rx) in enumerate(zip(pc, rpc)):
            _eq(x, rx, tol, f"port {pi} entry {e} at {sweep}")


PARITY = [("relay", 4, 1), ("gemm", 4, 2), ("page_rank", 4, 2),
          ("gemm_async", 4, 3), ("page_rank_async", 4, 16)]


@pytest.mark.parametrize("name,depth,every", PARITY,
                         ids=[p[0] for p in PARITY])
def test_compiled_snapshots_equal_reference_at_every_boundary(
        name, depth, every, tmp_path):
    """The port's compiled snapshot at every chunk boundary, read back
    from its store, equals the reference's compiled snapshot at the same
    sweep: fires, channel sizes and buffers, port rows (the rebased dues
    and the six counters included), state leaves and mmaps; integers
    exactly, floats within ``TOL``."""
    rtop, rargs, _ = _build(name, depth, ref=True)
    ref_store = _RefRecording()
    rep = ref_recovery.run_recoverable("compiled", rtop, *rargs,
                                       store=ref_store, snapshot_every=every)
    assert rep.ok, rep.error

    top, args, _ = _build(name, depth)
    store = SnapshotStore(tmp_path, keep=10_000)
    log = []
    rep = run_recoverable("compiled", top, *args, store=store,
                          snapshot_every=every, log=log, **CPU)
    assert rep.ok, rep.error
    plan, graph, _ = synth.elaborate_step_graph(top, *args)
    steps = store.mgr.steps()
    assert steps == sorted(ref_store.saved) == \
        [s["sweep"] for s in log[0].saves]
    assert len(steps) > 2
    for s in steps:
        snap = store.load(s, plan, graph.structural_hash())
        assert snap is not None and snap.sweep == s
        _snapshots_equal(snap, ref_store.saved[s], TOL[name], s)
    if name == "page_rank_async":       # a cut with a request in flight
        assert any(s["inflight"] for s in log[0].saves)
    for got, want in zip(_outputs(args), _ref_outputs(rargs)):
        _eq(got, want, TOL[name], "outputs")


REF_RESTORE = [("relay", "compiled"), ("relay", "coroutine"),
               ("gemm", "compiled"), ("gemm", "coroutine"),
               ("page_rank", "compiled")]


@pytest.mark.parametrize("name,engine", REF_RESTORE,
                         ids=[f"{n}-{e}" for n, e in REF_RESTORE])
def test_reference_snapshot_restores_in_the_port(name, engine, tmp_path):
    """The reference crashes its compiled run; its latest snapshot, its
    arrays handed over as numpy, restores in the port and the port
    finishes the run to the reference's fault-free outputs (the relay's
    int32 exactly, the float apps within ``TOL``)."""
    rtop, rargs, _ = _build(name, ref=True)
    repro.ENGINES["coroutine"]().run(rtop, *rargs)
    golden = _ref_outputs(rargs)

    rtop, rargs, _ = _build(name, ref=True)
    ref_store = ref_recovery.SnapshotStore(tmp_path / "ref")
    with pytest.raises(repro.core.CrashFault):
        ref_recovery.run_recoverable(
            "compiled", rtop, *rargs, store=ref_store, snapshot_every=2,
            faults=RefFaultPlan(seed=SEED, crash={"chunk": 2}))
    rplan, rgraph, _ = ref_synth.elaborate_step_graph(rtop, *rargs)
    ref_snap = ref_store.load_latest(rplan, rgraph.structural_hash())
    assert ref_snap is not None and ref_snap.sweep == 4

    top, args, _ = _build(name)
    plan, graph, _ = synth.elaborate_step_graph(top, *args)
    as_np = lambda t: ref_recovery.jax.tree.map(np.asarray, t)  # noqa: E731
    snap = recovery.GraphSnapshot(
        graph_hash=graph.structural_hash(), sweep=ref_snap.sweep,
        fires=np.asarray(ref_snap.fires),
        states=[as_np(s) for s in ref_snap.states],
        chans=[(np.asarray(b), int(n)) for b, n in ref_snap.chans],
        mmaps=[np.asarray(m) for m in ref_snap.mmaps],
        ports=[[np.asarray(x) for x in pc] for pc in ref_snap.ports],
        engine="compiled")
    store = SnapshotStore(tmp_path / "port")
    store.save(snap)
    log = []
    rep = run_recoverable(engine, top, *args, store=store,
                          snapshot_every=2, log=log, **CPU)
    assert rep.ok, rep.error
    assert log[0].start_sweep == 4
    for got, want in zip(_outputs(args), golden):
        _eq(got, want, TOL[name], "outputs")


# ---------------------------------------------------------------------------
# the resumable program's own checks
# ---------------------------------------------------------------------------

def _prepared(top, args):
    plan, graph, _ = synth.elaborate_step_graph(top, *args)
    prog = synth._SweepProgram(plan, torch.device("cpu"))
    prog.prepare(
        tuple(synth.to_torch_state(tp.state0, "cpu") for tp in plan.tasks),
        tuple(synth._as_canon(m.data, "cpu").clone() for m in plan.mmaps),
        tuple(synth._as_canon(p.data, "cpu").clone() for p in plan.ports))
    return plan, graph, prog


def _rows(snap):
    return snap.fires, snap.chans, snap.states, snap.mmaps, snap.ports


@pytest.mark.parametrize("name", ["gemm", "gemm_async"])
def test_restore_keeps_every_carried_tensor_in_place(name, tmp_path):
    """A restore writes into the carry's tensors: every data pointer the
    sweep (on the card, its captured graph and ring handles) holds stays,
    and the carry then reads back as the snapshot."""
    top, args, _ = _build(name)
    store = SnapshotStore(tmp_path, keep=100)
    run_recoverable("compiled", top, *args, store=store, snapshot_every=2,
                    **CPU)
    top, args, _ = _build(name)
    plan, graph, prog = _prepared(top, args)
    c = prog.carry
    carried = c.tensors() + [c.flags] + [r.head for r in c.rings.values()]
    ptrs = [t.data_ptr() for t in carried]
    handles = [(r.buf.data_ptr(), r.head.data_ptr(), r.size.data_ptr())
               for r in c.rings.values()]
    snap = store.load(2, plan, graph.structural_hash())
    prog.carry.load(*_rows(snap))
    assert [t.data_ptr() for t in carried] == ptrs
    assert [(r.buf.data_ptr(), r.head.data_ptr(), r.size.data_ptr())
            for r in c.rings.values()] == handles
    assert c.state.tolist() == [0, 0] and c.heads.tolist() == \
        [0] * len(c.rings)
    r = prog.read()
    back = recovery._snapshot_carry(plan, snap.graph_hash, 2, r.chans,
                                    r.states, r.mmaps, r.fires, "compiled",
                                    ports=r.ports)
    _snapshots_equal(back, snap, TOL["relay"], 2)
    prog.close()


@pytest.mark.parametrize("name", ["relay", "gemm_async"])
def test_snapshot_at_completion_resumes_to_zero_sweeps(name, tmp_path):
    top, args, _ = _build(name)
    store = SnapshotStore(tmp_path)
    rep = run_recoverable("compiled", top, *args, store=store,
                          snapshot_every=5, **CPU)
    assert rep.ok
    golden = _bytes(args)
    top, args, _ = _build(name)
    plan, graph, prog = _prepared(top, args)
    snap = store.load_latest(plan, graph.structural_hash())
    assert snap.sweep == rep.switches
    prog.carry.load(*_rows(snap))
    assert int(prog.carry.state[0]) == 1            # done on restore
    before = [t.clone() for t in prog.carry.tensors()]
    out = prog.run_chunk(7)
    assert out.sweeps == 0 and out.done and out.progress
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 prog.carry.tensors()))
    # through the entry point: no chunk runs, the snapshot is republished
    top, args, _ = _build(name)
    log = []
    rep = run_recoverable("compiled", top, *args, store=store,
                          snapshot_every=5, log=log, **CPU)
    assert rep.ok and rep.switches == 0 and log[0].chunks == []
    assert _bytes(args) == golden


@pytest.mark.parametrize("every", [1, 3, 64])
@pytest.mark.parametrize("k", [1, 3, 64])
def test_budgets_and_blocks_give_the_same_cuts(monkeypatch, tmp_path, every,
                                               k):
    monkeypatch.setattr(synth, "SWEEP_BLOCKS", (k,))
    top, args, _ = _build("gemm")
    plan, _, _ = synth.elaborate_step_graph(top, *args)
    cuts, _ = recovery._abstract_schedule(plan)
    top, args, _ = _build("gemm")
    store = SnapshotStore(tmp_path, keep=10_000)
    log = []
    rep = run_recoverable("compiled", top, *args, store=store,
                          snapshot_every=every, log=log, **CPU)
    assert rep.ok, rep.error
    total = len(cuts) - 1
    want = list(range(0, total, every)) + [total]
    assert [s["sweep"] for s in log[0].saves] == want
    assert sum(log[0].chunks) == rep.switches == total
    plan, graph, _ = synth.elaborate_step_graph(top, *args)
    for s in want:
        snap = store.load(s, plan, graph.structural_hash())
        assert snap.fires.tolist() == list(cuts[s])
    assert _bytes(args) == _compiled_golden("gemm")[1]
    # no block crosses a chunk's budget
    assert log[0].replays == total


def _random_port(rng, d):
    nrow, row = 5, (3,)
    st = rng.integers(0, 50, ring.PORT_WORDS).astype(np.int32)
    st[[ring.P_RHEAD, ring.P_WHEAD]] = rng.integers(0, d, 2)
    st[[ring.P_RSIZE, ring.P_WSIZE]] = rng.integers(0, d + 1, 2)
    win = rng.integers(-5, 40, (4, d)).astype(np.int32)
    data = rng.standard_normal((nrow, *row)).astype(np.float32)
    wval = rng.standard_normal((d, *row)).astype(np.float32)
    return data, win, wval, st


@pytest.mark.parametrize("d", [1, 4, 8])
def test_rebase_equals_reference_on_random_carries(d):
    rng = np.random.default_rng(d)
    for _ in range(20):
        data, win, wval, st = _random_port(rng, d)
        sweeps = int(rng.integers(0, 30))
        pint = torch.from_numpy(st.copy())[None]
        q = ring.PortQueue(torch.from_numpy(data.copy()), pint[0],
                           range(5), d, 4)
        q.win.copy_(torch.from_numpy(win))
        q.wval.copy_(torch.from_numpy(wval))
        synth._rebase_port_dues(q, torch.tensor(sweeps, dtype=I32))
        got = synth.port_rows(q.data.numpy(), q.win.numpy(), q.wval.numpy(),
                              q.st.numpy())
        rows = synth.port_rows(data, win, wval, st)
        want = ref_synth._rebase_port_dues(
            tuple(jnp.asarray(x) for x in rows), jnp.int32(sweeps))
        for e, (x, w) in enumerate(zip(got, want)):
            assert np.array_equal(np.asarray(x), np.asarray(w)), e


def test_port_rows_are_the_reference_carry_layout():
    p = async_mmap(np.arange(12, dtype=np.float32).reshape(4, 3), depth=5,
                   name="m")
    from repro.core import async_mmap as ref_async_mmap
    rp = ref_async_mmap(np.arange(12, dtype=np.float32).reshape(4, 3),
                        depth=5, name="m")
    got, want = synth._port_carry0(p), ref_synth._port_carry0(rp)
    assert len(got) == len(want) == 16
    for x, w in zip(got, want):
        w = np.asarray(w)
        assert x.shape == w.shape and x.dtype == w.dtype
        assert np.array_equal(x, w)


UNCHUNKED = {"gemm": (gemm, dict(P=2, n=4, K=2)),
             "gaussian": (gaussian, dict(h=6, w=6, iters=2)),
             "page_rank": (page_rank, dict(n_vertices=16, n_edges=48,
                                           n_pe=2, n_iters=3))}


@pytest.mark.parametrize("name", sorted(UNCHUNKED))
def test_unchunked_run_keeps_its_counts(name):
    """``CompiledEngine.run`` on top of the split program: the sweeps of
    the reference, blocks of 1, 2, 4, ... 64 until the done flag, one
    host sync a block and one final read."""
    mod, kw = UNCHUNKED[name]
    ref_mod = {"gemm": ref_gemm, "page_rank": ref_page_rank}.get(name)
    if ref_mod is None:
        from repro.apps import gaussian as ref_mod
    rtop, rargs, _ = ref_mod.build_step(**kw)
    want = repro.ENGINES["compiled"](cache=False, ring_impl="xla") \
        .run(rtop, *rargs).switches
    top, args, check = mod.build_step(**kw, **CPU)
    eng = repro_torch.ENGINES["compiled"](**CPU)
    rep = eng.run(top, *args)
    assert rep.ok and check()[0]
    assert rep.switches == want
    blocks, replays = 0, 0
    sizes = list(synth.SWEEP_BLOCKS)
    while replays < want:
        replays += sizes[min(blocks, len(sizes) - 1)]
        blocks += 1
    assert (eng.n_blocks, eng.n_replays, eng.n_host_syncs) == \
        (blocks, replays, blocks + 1)


# ---------------------------------------------------------------------------
# serving journal (the port's ServeJournal and ServingEngine)
# ---------------------------------------------------------------------------

V = 16


def _toy_engine(scfg, journal=None, calls=None):
    def prefill(toks):
        if calls is not None:
            calls.append(("prefill", toks.shape))
        last = int(toks[0, -1]) % V
        return np.eye(1, V, k=(last + 1) % V), {"n": toks.shape[1]}

    def decode(tok, cache):
        return np.eye(1, V, k=int(tok[0] + 1) % V), {"n": cache["n"] + 1}

    return ServingEngine(scfg, prefill, decode, journal=journal)


def _reqs(n=6, max_new=5):
    return [Request(rid=i, prompt=[i, i + 1], max_new=max_new)
            for i in range(n)]


def test_journal_replay_folds_records(tmp_path):
    j = ServeJournal(tmp_path / "j.jsonl")
    j.admit(0, [1, 2], 4, None)
    j.tok(0, 3)
    j.tok(0, 4)
    j.admit(1, [5], 4, None)
    j.retire(0, toks=[3, 4, 9, 9])
    j.retire(2, status="deadline", detail="late")
    j.close()
    completed, inflight = ServeJournal.replay(tmp_path / "j.jsonl")
    assert completed == {0: [3, 4, 9, 9], 2: ("deadline", "late")}
    assert inflight == {1: {"prompt": [5], "max_new": 4, "deadline": None,
                            "toks": []}}


def test_journal_torn_tail_dropped_and_repaired(tmp_path):
    p = tmp_path / "j.jsonl"
    j = ServeJournal(p)
    j.admit(0, [1], 3, None)
    j.tok(0, 2)
    j.close()
    with open(p, "a") as f:
        f.write('{"t":"tok","rid":0,"to')      # crash mid-append
    completed, inflight = ServeJournal.replay(p)
    assert inflight[0]["toks"] == [2]
    j2 = ServeJournal(p)                       # reopen repairs the tail
    j2.tok(0, 5)
    j2.close()
    completed, inflight = ServeJournal.replay(p)
    assert inflight[0]["toks"] == [2, 5]


def test_exactly_once_after_simulated_crash(tmp_path):
    scfg = ServeConfig(batch_slots=2, max_seq=64)
    oracle = serve_requests(_toy_engine(scfg), _reqs())

    jp = tmp_path / "j.jsonl"
    serve_requests(_toy_engine(scfg, journal=jp), _reqs())
    lines = open(jp).read().splitlines()
    cut = tmp_path / "cut.jsonl"
    cut.write_text("\n".join(lines[:9]) + "\n")
    completed, inflight = ServeJournal.replay(cut)
    assert inflight

    res = serve_requests(_toy_engine(scfg, journal=cut), _reqs())
    assert sorted(res) == sorted(oracle)
    for rid in oracle:
        assert res[rid] == oracle[rid], rid


def test_completed_rids_answer_from_journal_without_recompute(tmp_path):
    scfg = ServeConfig(batch_slots=2, max_seq=64)
    jp = tmp_path / "j.jsonl"
    oracle = serve_requests(_toy_engine(scfg, journal=jp), _reqs())
    calls = []
    res = serve_requests(_toy_engine(scfg, journal=jp, calls=calls),
                         _reqs())
    assert res == oracle
    assert calls == []


def test_seeded_resume_counts_seeded_tokens_once(tmp_path):
    scfg = ServeConfig(batch_slots=1, max_seq=64)
    jp = tmp_path / "j.jsonl"
    j = ServeJournal(jp)
    j.admit(0, [4, 5], 3, None)
    j.tok(0, 6)
    j.tok(0, 7)
    j.close()
    res = serve_requests(_toy_engine(scfg, journal=jp),
                         [Request(rid=0, prompt=[4, 5], max_new=3)])
    assert res[0] == [6, 7, 8]
    completed, inflight = ServeJournal.replay(jp)
    assert completed[0] == [6, 7, 8] and not inflight


def test_journal_folds_as_the_reference(tmp_path):
    """The same serving run journaled by the port and by the reference:
    the same records, folded to the same completed results."""
    from repro.serve import ServeConfig as RefConfig
    from repro.serve import ServeJournal as RefJournal
    from repro.serve import ServingEngine as RefEngine
    from repro.serve import serve_requests as ref_serve
    from repro.serve import Request as RefRequest

    def prefill(toks):
        return np.eye(1, V, k=(int(toks[0, -1]) + 1) % V), {}

    def decode(tok, cache):
        return np.eye(1, V, k=int(tok[0] + 1) % V), cache

    serve_requests(ServingEngine(ServeConfig(batch_slots=2, max_seq=64),
                                 prefill, decode,
                                 journal=tmp_path / "port.jsonl"), _reqs())
    ref_serve(RefEngine(RefConfig(batch_slots=2, max_seq=64), prefill,
                        decode, journal=tmp_path / "ref.jsonl"),
              [RefRequest(rid=i, prompt=[i, i + 1], max_new=5)
               for i in range(6)])
    assert ServeJournal.replay(tmp_path / "port.jsonl") == \
        RefJournal.replay(tmp_path / "ref.jsonl")

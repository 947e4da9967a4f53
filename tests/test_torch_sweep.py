"""The sweep program of the port's CompiledEngine on the CPU.

A sweep is one ``sweep_guards`` launch (its plain version here) followed
by every (task, phase) body behind its predicate; on the card the sweep is
captured once as a CUDA graph and replayed in blocks, here it runs with
Python branches and the same blocks (``chip_smoke.py`` phases 3-6 run the
kernel and the captured graph on the card).  The sweep's control must
equal the reference's phase and guard computation
(``repro.core.synth._guard_tables`` + ``repro.kernels.ring.eval_guards``)
exactly, and a run at any block size must give the reference's sweeps,
fires, tokens, highwater marks and stall report.
"""

import ctypes
import functools
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.apps import gaussian as ref_gaussian
from repro.apps import gemm as ref_gemm
from repro.apps import page_rank as ref_page_rank
from repro.core import synth as ref_synth
from repro.kernels import ring as ref_ring

import repro_torch
from repro_torch import StepTask, SynthesisError, channel, mmap
from repro_torch.apps import gaussian, gemm, page_rank
from repro_torch.core import synth
from repro_torch.core.context import clear_context
from repro_torch.kernels import _build, dispatch, ring

I32 = torch.int32


def _strip(x):
    return re.sub(r"#\d+", "", repr(x))


# ---------------------------------------------------------------------------
# the sweep's control against the reference
# ---------------------------------------------------------------------------

def _random_plan(rng, n_tasks, n_chans, n_ph_max):
    """A duck-typed plan both packages' ``_guard_tables`` read: tasks of
    1..n_ph_max phases, each phase reading or writing a few channels."""
    caps = rng.integers(1, 9, n_chans)
    tasks = []
    for _ in range(n_tasks):
        phases = []
        for _ in range(int(rng.integers(1, n_ph_max + 1))):
            reads, writes = {}, {}
            k = int(rng.integers(0, min(n_chans, 5) + 1))
            for c in rng.choice(n_chans, size=k, replace=False):
                side = reads if rng.random() < 0.5 else writes
                side[int(c)] = int(rng.integers(1, caps[c] + 1))
            phases.append(SimpleNamespace(count=int(rng.integers(1, 5)),
                                          reads=reads, writes=writes))
        bounds = list(np.cumsum([p.count for p in phases]))
        tasks.append(SimpleNamespace(phases=phases, bounds=bounds,
                                     total=bounds[-1]))
    return SimpleNamespace(
        tasks=tasks, channels=[SimpleNamespace(capacity=int(c))
                               for c in caps]), caps


def _reference_sweep(plan, caps, fires, sizes, done, sweeps):
    """One sweep's control the way the reference's loop body and the
    eager loop computed it: phase from the bounds, fire from
    ``eval_guards`` (``impl="xla"``), then the firing counters and the
    sweep count and the end of the run."""
    need_r, need_w, bounds, n_ph = ref_synth._guard_tables(plan)
    n_tasks = len(plan.tasks)
    totals = np.asarray([tp.total for tp in plan.tasks])
    phase = np.zeros(n_tasks, np.int64)
    if n_ph > 1:
        phase = np.sum(fires[:, None] >= bounds, axis=1)
    live = (fires < totals) & (not done)
    rows = np.arange(n_tasks)
    if len(caps):
        fire = np.asarray(ref_ring.eval_guards(
            jnp.asarray(sizes), jnp.asarray(caps, jnp.int32),
            jnp.asarray(need_r[rows, phase]), jnp.asarray(need_w[rows, phase]),
            jnp.asarray(live), impl="xla"))
    else:
        fire = live
    if done:
        return phase, fire, fires, sweeps, 1
    new = fires + fire
    over = not live.any() or not fire.any() or not (new < totals).any()
    return phase, fire, new, sweeps + int(live.any()), int(over)


def _port_sweep(plan, caps, fires, sizes, done, sweeps):
    need_r, need_w, bounds, n_ph = synth._guard_tables(plan)
    n_tasks = len(plan.tasks)
    if bounds is None:
        bounds = np.zeros((n_tasks, 0), np.int32)
    row_ptr, entries = ring.sparse_needs(need_r, need_w, caps)
    totals = np.asarray([tp.total for tp in plan.tasks], np.int32)
    f = torch.from_numpy(fires.astype(np.int32))
    state = torch.tensor([done, sweeps], dtype=I32)
    run = torch.ones((n_tasks, n_ph), dtype=torch.bool)
    fire = torch.ones(n_tasks, dtype=torch.bool)
    phase = torch.full((n_tasks,), -1, dtype=I32)
    ring.sweep_guards(*(torch.from_numpy(a) for a in (totals, bounds,
                                                       row_ptr, entries)),
                      torch.from_numpy(sizes.astype(np.int32)), f, state, run,
                      fire, phase)
    return phase, fire, f, state, run


@pytest.mark.parametrize("n_tasks,n_chans,n_ph_max,seed", [
    (1, 1, 1, 0), (1, 0, 3, 1), (1, 3, 3, 2), (4, 0, 3, 3), (6, 5, 2, 4),
    (37, 64, 3, 5), (100, 200, 3, 6), (100, 5, 3, 7), (16, 200, 1, 8),
    (88, 192, 2, 9),
])
def test_sweep_control_equals_reference(n_tasks, n_chans, n_ph_max, seed):
    rng = np.random.default_rng(seed)
    plan, caps = _random_plan(rng, n_tasks, n_chans, n_ph_max)
    totals = np.asarray([tp.total for tp in plan.tasks])
    edges = [sorted({0, *tp.bounds}) for tp in plan.tasks]
    for trial in range(40):
        if trial == 0:
            fires = totals.copy()                        # all tasks dead
        elif trial % 3 == 0:                              # at a phase bound
            fires = np.asarray([rng.choice(e) for e in edges])
        elif trial % 3 == 1:                              # across one
            fires = np.asarray([max(0, rng.choice(e) - 1) for e in edges])
        else:
            fires = rng.integers(0, totals + 1)
        sizes = rng.integers(0, caps + 1) if n_chans else np.zeros(0, int)
        if trial % 2:                   # mostly full or empty rings
            sizes = np.where(rng.random(n_chans) < 0.5, 0, caps)
        done, sweeps = int(trial % 7 == 6), int(rng.integers(0, 99))
        phase, fire, new, sw, over = _reference_sweep(plan, caps, fires,
                                                      sizes, done, sweeps)
        g_phase, g_fire, g_new, g_state, g_run = _port_sweep(
            plan, caps, fires, sizes, done, sweeps)
        assert g_phase.tolist() == list(phase)
        assert g_fire.tolist() == [bool(x) for x in fire]
        assert g_new.tolist() == list(new)
        assert g_state.tolist() == [over, sw]
        want_run = np.zeros(g_run.shape, bool)
        want_run[np.arange(n_tasks), phase] = fire
        assert np.array_equal(g_run.numpy(), want_run)


@pytest.mark.parametrize("n_tasks,n_chans,n_ph_max,n_parts,seed", [
    (1, 1, 1, 2, 0), (6, 5, 2, 2, 1), (37, 64, 3, 4, 2), (88, 192, 2, 2, 3),
    (100, 200, 3, 4, 4), (16, 200, 1, 3, 5),
])
def test_owner_mask_gives_the_reference_sweep_end(n_tasks, n_chans,
                                                  n_ph_max, n_parts, seed):
    """A partition's ``sweep_guards`` (its owner mask) applies the moves of
    the tasks fired elsewhere; with the moves its own bodies' ring ops
    make (a Python model of pops and pushes), every partition ends the
    sweep on the reference's partitioned heads and sizes
    (``src/repro/core/synth.py:1309-1322``: ``head += sum fired * reads
    mod cap``, ``size += sum fired * (writes - reads)``), and every other
    output is the unmasked call's.  With every task owned it moves
    nothing."""
    rng = np.random.default_rng(seed)
    plan, caps = _random_plan(rng, n_tasks, n_chans, n_ph_max)
    need_r, need_w, _, _ = ref_synth._guard_tables(plan)
    totals = np.asarray([tp.total for tp in plan.tasks])
    for trial in range(30):
        fires = rng.integers(0, totals + 1)
        sizes = rng.integers(0, caps + 1)
        if trial % 2:
            sizes = np.where(rng.random(n_chans) < 0.5, 0, caps)
        heads = rng.integers(0, caps)
        done, sweeps = int(trial % 9 == 8), int(rng.integers(0, 99))
        phase, fire, _, _, _ = _reference_sweep(plan, caps, fires, sizes,
                                                done, sweeps)
        fv = np.asarray(fire, np.int64)[:, None]
        rows = np.arange(n_tasks)
        nr, nw = need_r[rows, phase], need_w[rows, phase]
        want_heads = (heads + (fv * nr).sum(0)) % np.maximum(caps, 1)
        want_sizes = sizes + (fv * (nw - nr)).sum(0)
        plain = _masked_sweep(plan, caps, fires, sizes, heads, done, sweeps,
                              None)
        owners = rng.integers(0, n_parts, n_tasks)
        for part in [*range(n_parts), "all"]:
            owned = np.ones(n_tasks, bool) if part == "all" \
                else owners == part
            got = _masked_sweep(plan, caps, fires, sizes, heads, done,
                                sweeps, owned)
            assert all(torch.equal(a, b) for a, b in
                       zip(got["outputs"], plain["outputs"]))
            h, z = got["heads"].numpy().copy(), got["sizes"].numpy().copy()
            if part == "all":
                assert h.tolist() == heads.tolist()
                assert z.tolist() == sizes.tolist()
            for t in np.flatnonzero(np.asarray(fire) & owned):
                for c in range(n_chans):       # the bodies' pops and pushes
                    h[c] = (h[c] + nr[t, c]) % caps[c]
                    z[c] += nw[t, c] - nr[t, c]
            assert h.tolist() == want_heads.tolist()
            assert z.tolist() == want_sizes.tolist()


def _masked_sweep(plan, caps, fires, sizes, heads, done, sweeps, owned):
    need_r, need_w, bounds, n_ph = synth._guard_tables(plan)
    n_tasks = len(plan.tasks)
    if bounds is None:
        bounds = np.zeros((n_tasks, 0), np.int32)
    row_ptr, entries = ring.sparse_needs(need_r, need_w, caps)
    totals = np.asarray([tp.total for tp in plan.tasks], np.int32)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    out = [i32(fires), torch.tensor([done, sweeps], dtype=I32),
           torch.zeros((n_tasks, n_ph), dtype=torch.bool),
           torch.zeros(n_tasks, dtype=torch.bool), torch.zeros(n_tasks,
                                                               dtype=I32)]
    h, z = i32(heads), i32(sizes)
    mask = {} if owned is None else dict(owned=torch.from_numpy(owned),
                                         heads=h)
    ring.sweep_guards_plain(*(i32(a) for a in (totals, bounds, row_ptr,
                                                 entries)), z, *out, **mask)
    return dict(outputs=out, heads=h, sizes=z)


def test_sparse_needs_hold_the_dense_tables():
    """gemm at P=8: 88 tasks over 192 channels, 2 phases; each row holds
    only the channels its phase touches, and the dense tables come back."""
    top, args, _ = gemm.build_step(P=8, n=2, K=2, device="cpu")
    plan, _, _ = synth.elaborate_step_graph(top, *args)
    need_r, need_w, _, n_ph = synth._guard_tables(plan)
    assert need_r.shape == (88, 2, 192) and n_ph == 2
    caps = np.asarray([c.capacity for c in plan.channels])
    row_ptr, entries = ring.sparse_needs(need_r, need_w, caps)
    assert row_ptr.dtype == entries.dtype == np.int32
    assert entries.shape[1] == 4 and row_ptr[-1] == len(entries)
    per_row = np.diff(row_ptr)
    assert per_row.max() <= 8 and per_row[per_row > 0].min() >= 1
    back_r, back_w = np.zeros_like(need_r), np.zeros_like(need_w)
    for row in range(88 * 2):
        for c, r, w, cap in entries[row_ptr[row]:row_ptr[row + 1]]:
            back_r[row // 2, row % 2, c] = r
            back_w[row // 2, row % 2, c] = w
            assert cap == caps[c]
    assert np.array_equal(back_r, need_r) and np.array_equal(back_w, need_w)


def _guard_args(n_tasks=3, n_ph=2, nnz=2, n_chans=2):
    z = functools.partial(torch.zeros, dtype=I32)
    return dict(totals=z(n_tasks), bounds=z((n_tasks, n_ph - 1)),
                row_ptr=z(n_tasks * n_ph + 1), entries=z((nnz, 4)),
                sizes=z(n_chans), fires=z(n_tasks), state=z(2),
                run=torch.zeros((n_tasks, n_ph), dtype=torch.bool),
                fire=torch.zeros(n_tasks, dtype=torch.bool),
                phase=z(n_tasks))


@pytest.mark.parametrize("name,bad", [
    ("fires", torch.zeros(3, dtype=torch.int64)),
    ("state", torch.zeros(3, dtype=I32)),
    ("run", torch.zeros((3, 2), dtype=I32)),
    ("bounds", torch.zeros((3, 2), dtype=I32)),
    ("entries", torch.zeros((2, 3), dtype=I32)),
    ("phase", torch.zeros(6, dtype=I32)[::2]),
])
def test_sweep_guards_checks_its_tables(name, bad):
    args = _guard_args()
    args[name] = bad
    with pytest.raises(ValueError, match=f"sweep_guards: {name} must be"):
        ring.SweepGuards(**args)


def test_sweep_guards_checks_its_owner_mask():
    args = _guard_args()
    with pytest.raises(ValueError, match="owned and heads go together"):
        ring.SweepGuards(**args, owned=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="sweep_guards: owned must be"):
        ring.SweepGuards(**args, owned=torch.ones(2, dtype=torch.bool),
                         heads=torch.zeros(2, dtype=I32))
    with pytest.raises(ValueError, match="sweep_guards: heads must be"):
        ring.SweepGuards(**args, owned=torch.ones(3, dtype=torch.bool),
                         heads=torch.zeros(3, dtype=I32))


def test_cpu_sweep_guards_takes_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU program tried to build/load {name!r}")

    monkeypatch.setattr(_build, "load", no_build)
    dispatch.reset_launches()
    a = _guard_args(n_tasks=2, n_ph=1, nnz=0, n_chans=0)
    a["totals"] += 1
    g = ring.SweepGuards(**a)
    g()
    assert a["fire"].tolist() == [True, True] and a["state"].tolist() == [1, 1]
    g()                                 # done: nothing moves
    assert a["fires"].tolist() == [1, 1] and not a["run"].any()
    assert a["state"].tolist() == [1, 1]
    assert dispatch.launch_counts() == {}


def test_sweep_launch_struct_matches_the_c_layout():
    # csrc/ring.cu's struct SweepLaunch: thirteen pointers, then T, P and
    # C, then a partition's owner mask and heads
    f = ring._SweepLaunch
    names = ["totals", "bounds", "row_ptr", "entries", "sizes", "fires",
             "state", "run", "fire", "phase", "flags", "handles", "stream"]
    assert [(n, getattr(f, n).offset) for n, _ in f._fields_] == \
        [(n, 8 * i) for i, n in enumerate(names)] + [
            ("T", 104), ("P", 108), ("C", 112), ("owned", 120),
            ("heads", 128)]
    assert ctypes.sizeof(f) == 136
    vp = ctypes.c_void_p
    assert ring._ARGTYPES["sweep_guards"] == [vp]
    # launch, rows, bodies, n, tail, handles, stamp, body_nodes, out
    assert ring._ARGTYPES["sweep_graph_create"] == [vp, vp, vp, ctypes.c_int,
                                                    vp, vp, vp, vp, vp]
    # csrc/ring.cu's struct StampLaunch: five pointers, then cap
    s = ring._StampLaunch
    assert [(n, getattr(s, n).offset) for n, _ in s._fields_] == [
        ("acc", 0), ("clock", 8), ("first", 16), ("last", 24), ("run", 32),
        ("cap", 40)]
    assert ctypes.sizeof(s) == 48
    assert (ring.MAX_SWEEP_TASKS, ring.MAX_SWEEP_PHASES,
            ring.MAX_SWEEP_CHANNELS) == (1024, 4, 12288)


# ---------------------------------------------------------------------------
# whole runs at every block size
# ---------------------------------------------------------------------------

APPS = {    # test_torch_synth.py's reduced sizes
    "gemm": (gemm, ref_gemm, dict(P=2, n=4, K=2)),
    "gaussian": (gaussian, ref_gaussian, dict(h=6, w=6, iters=2)),
    "page_rank": (page_rank, ref_page_rank,
                  dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=3)),
}


def _out(name, args):
    if name == "gemm":
        return np.concatenate([m.data.numpy() for m in args[2]])
    return args[1].data.numpy()


def _chan_stats(eng):
    return sorted((c.name, c.total_read, c.total_written, c.max_occupancy)
                  for c in eng.channel_set)


@functools.lru_cache(maxsize=None)
def _reference(name):
    _, ref_mod, kw = APPS[name]
    rtop, rargs, _ = ref_mod.build_step(**kw)
    reng = repro.ENGINES["compiled"](cache=False, ring_impl="xla")
    ref = reng.run(rtop, *rargs)
    assert ref.ok, ref.error
    return (ref.switches, _strip(ref.instances), ref.channels, ref.tokens,
            _chan_stats(reng))


@functools.lru_cache(maxsize=None)
def _default_output(name):
    mod, _, kw = APPS[name]
    top, args, _ = mod.build_step(device="cpu", **kw)
    rep = repro_torch.ENGINES["compiled"](device="cpu").run(top, *args)
    assert rep.ok, rep.error
    return _out(name, args).tobytes()


def _blocks_for(sweeps, k):
    return -(-sweeps // k)


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_at_every_block_size(monkeypatch, name, k):
    expected = _default_output(name)
    monkeypatch.setattr(synth, "SWEEP_BLOCKS", (k,))
    mod, _, kw = APPS[name]
    top, args, check = mod.build_step(device="cpu", **kw)
    eng = repro_torch.ENGINES["compiled"](device="cpu")
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert check()[0]
    assert _out(name, args).tobytes() == expected       # bitwise across K
    sweeps, instances, channels, tokens, stats = _reference(name)
    assert rep.switches == eng.n_sweeps == sweeps
    assert _strip(rep.instances) == instances           # all fired
    assert rep.channels == channels                     # written + highwater
    assert _chan_stats(eng) == stats
    assert rep.tokens == tokens
    # the run ends on the replay of its last sweep: whole blocks of k
    blocks = _blocks_for(sweeps, k)
    assert (eng.n_blocks, eng.n_replays) == (blocks, blocks * k)
    assert eng.n_host_syncs == blocks + 1 and eng.capture_s == 0.0


def _relay(sink_extra=1, burst=8, fires=8):
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

    Source = StepTask(source_step, steps=fires, init=torch.tensor(0, dtype=I32),
                      name="Source")
    Relay = StepTask(relay_step, steps=fires, name="Relay")
    Sink = StepTask(sink_step, steps=fires + sink_extra,
                    init=torch.tensor(0, dtype=I32), name="Sink")
    res = mmap(np.zeros((fires + sink_extra) * burst, np.int32), "res")

    def Top(res):
        chans = [channel(16, f"c{i}", dtype=np.int32, shape=())
                 for i in range(3)]
        t = repro_torch.task().invoke(Source, chans[0])
        for s in range(2):
            t = t.invoke(Relay, chans[s], chans[s + 1], name=f"Relay{s}")
        t.invoke(Sink, chans[2], res)

    return Top, (res,)


@functools.lru_cache(maxsize=None)
def _reference_stall():
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
    return (_strip(ref.error), ref.switches, _strip(ref.deadlock.blocked),
            ref.deadlock.occupancy)


@pytest.mark.parametrize("k", [1, 3, 64])
def test_stall_matches_reference_at_every_block_size(monkeypatch, k):
    monkeypatch.setattr(synth, "SWEEP_BLOCKS", (k,))
    error, sweeps, blocked, occupancy = _reference_stall()
    eng = repro_torch.ENGINES["compiled"](device="cpu")
    rep = eng.run(*_relay()[:1], *_relay()[1])
    assert not rep.ok
    assert _strip(rep.error) == error
    assert rep.switches == sweeps
    assert _strip(rep.deadlock.blocked) == blocked
    assert rep.deadlock.occupancy == occupancy
    blocks = _blocks_for(sweeps, k)
    assert (eng.n_blocks, eng.n_replays) == (blocks, blocks * k)


def _program(top, *args):
    """A CPU sweep program run to its end, as ``CompiledEngine.run`` runs
    it, with its carry left to inspect."""
    eng = synth.CompiledEngine(device="cpu")
    try:
        plan, _, _ = eng._elaborate(top, *args)
    finally:
        clear_context()
    states0 = tuple(synth._materialize_state(tp.state0, "cpu")
                    for tp in plan.tasks)
    mmaps0 = tuple(synth._as_canon(m.data, "cpu").clone()
                   for m in plan.mmaps)
    prog = synth._SweepProgram(plan, torch.device("cpu"))
    return prog, prog(states0, mmaps0)


@pytest.mark.parametrize("graph", ["gaussian", "stall"])
def test_a_block_after_done_changes_nothing(graph):
    if graph == "gaussian":
        top, args, _ = gaussian.build_step(h=6, w=6, iters=2, device="cpu")
    else:
        top, args = _relay()
    prog, out = _program(top, *args)
    assert int(prog.carry.state[0]) == 1
    before = [t.clone() for t in prog.carry.tensors()]
    assert len(before) > 8
    prog.block(5)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 prog.carry.tensors()))
    assert not prog.carry.run.any() and not prog.carry.fire.any()
    assert prog.n_replays - 5 >= out[2]     # sweeps


def _count_ring_ops(monkeypatch):
    """Count the RingHandle pops and pushes that move tokens (those a
    card's kernel launches for) in the sweep, not the counting pass."""
    seen = {"ring_pop": 0, "ring_push": 0}
    pop, push = ring.RingHandle.pop, ring.RingHandle.push

    def counted_pop(self, n, _one=False):
        if self.buf.device.type != "meta":
            seen["ring_pop"] += n > 0
        return pop(self, n, _one)

    def counted_push(self, arr):
        if self.buf.device.type != "meta":
            seen["ring_push"] += arr.nbytes > 0
        return push(self, arr)

    monkeypatch.setattr(ring.RingHandle, "pop", counted_pop)
    monkeypatch.setattr(ring.RingHandle, "push", counted_push)
    return seen


@pytest.mark.parametrize("name", sorted(APPS) + ["stall"])
def test_ring_ops_are_the_ops_the_firings_made(monkeypatch, name):
    """``ring_ops`` (what chip_smoke holds the card's launch counters
    against) is the pops and pushes the run's firings made."""
    seen = _count_ring_ops(monkeypatch)
    if name == "stall":
        top, args = _relay()
    else:
        mod, _, kw = APPS[name]
        top, args, _ = mod.build_step(device="cpu", **kw)
    eng = repro_torch.ENGINES["compiled"](device="cpu")
    rep = eng.run(top, *args)
    assert rep.ok == (name != "stall")
    assert eng.ring_ops == seen and seen["ring_pop"] > 0
    if name == "stall":     # Source 8, Relay0/1 8 each, Sink 8 of 9
        assert seen == {"ring_pop": 24, "ring_push": 24}


def test_device_counters_are_read_and_zeroed(monkeypatch):
    """Counters a kernel advances itself (here a CPU stand-in for the
    card's) add to the host's counts and are zeroed with them."""
    monkeypatch.setattr(dispatch, "_device_counters", [])
    monkeypatch.setattr(dispatch, "_launches", {})
    dev = torch.zeros(3, dtype=torch.int64)
    dispatch.add_device_counters(("a", "b", "c"), dev)
    dispatch.count_launch("b")
    dev += torch.tensor([2, 0, 5])
    assert dispatch.launch_counts() == {"a": 2, "b": 1, "c": 5}
    dispatch.reset_launches()
    assert dispatch.launch_counts() == {} and not dev.any()


def test_device_counter_layout_matches_the_c_source():
    """``ring.DEVICE_COUNTED`` names csrc/ring.cu's ``ring_launches``
    entries in order, each kernel adds to its own, and the counters are
    handed to torch as four int64 words."""
    src = (_build.CSRC / "ring.cu").read_text()
    assert "__device__ unsigned long long ring_launches[4];" in src
    assert "enum { kPopLaunches, kPushLaunches, kSweepLaunches, " \
        "kServiceLaunches };" in src
    assert ring.DEVICE_COUNTED == ("ring_pop", "ring_push", "sweep_guards",
                                   "service_ports")
    for kernel, entry in (("ring_pop_kernel", "kPopLaunches"),
                          ("ring_push_kernel", "kPushLaunches"),
                          ("sweep_guards_kernel", "kSweepLaunches"),
                          ("service_ports_kernel", "kServiceLaunches")):
        body = src[src.index(f"\n{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert body.count(f"atomicAdd(&ring_launches[{entry}], 1ull)") == 1
    assert ring._ARGTYPES["ring_launch_counters"] == [ctypes.c_void_p]
    words = ring._DeviceWords(4096, 4).__cuda_array_interface__
    assert words == dict(shape=(4,), typestr="<i8", data=(4096, False),
                         version=3)


def test_if_node_on_the_cpu_is_a_branch():
    for v in (True, False):
        with synth._if_node(torch.tensor(v)) as taken:
            assert taken is v


def test_a_state_that_swaps_its_parts():
    """A returned state whose leaves are the state's own buffers in other
    places: each firing's state is copied into the static buffers as the
    twin rebinds it."""
    def swap_step(state, out):
        a, b = state
        out.write(a)
        return (b, a + b)

    Fib = StepTask(swap_step, steps=6, init=(torch.tensor(0, dtype=I32),
                                            torch.tensor(1, dtype=I32)),
                   name="Fib")
    def collect(k, inp, res):
        res.write_burst(k, inp.read()[None])
        return k + 1

    Col = StepTask(collect, steps=6, init=torch.tensor(0, dtype=I32),
                   name="Col")
    Col2 = StepTask(collect, steps=4, init=torch.tensor(0, dtype=I32),
                    name="Col2")

    def swap_back(state, out):
        a, b = state
        out.write(a)
        return (b, a)               # a pure swap: both leaves alias

    Swap = StepTask(swap_back, steps=4, init=(torch.tensor(5, dtype=I32),
                                             torch.tensor(9, dtype=I32)),
                    name="Swap")

    def run(engine):
        fib, sw = np.zeros(6, np.int32), np.zeros(4, np.int32)

        def Top(r1, r2):
            c1 = channel(2, "c1", dtype=np.int32, shape=())
            c2 = channel(2, "c2", dtype=np.int32, shape=())
            repro_torch.task().invoke(Fib, c1).invoke(Col, c1, r1) \
                .invoke(Swap, c2).invoke(Col2, c2, r2)

        kw = {"device": "cpu"} if engine == "compiled" else {}
        rep = repro_torch.ENGINES[engine](**kw).run(Top, mmap(fib, "r1"),
                                                    mmap(sw, "r2"))
        assert rep.ok, rep.error
        return fib.tolist(), sw.tolist()

    assert run("compiled") == run("coroutine") == (
        [0, 1, 1, 2, 3, 5], [5, 9, 5, 9])


def test_host_constants_reach_the_device_before_the_sweep():
    """Numbers, arrays and CPU tensors a body writes are recorded by the
    counting pass and put on the program's device before the sweep; a
    host value the counting pass never saw is refused by name."""
    def src(k, out):
        out.write(7)
        out.write(np.int32(3))
        return k + 1

    def snk(k, inp, res):
        res.write_burst(k, (inp.read() + inp.read())[None])
        res[3] = 1.5                    # a host float into an int32 mmap
        res.write_burst(4, np.array([2, 3]))
        return k + 1

    S = StepTask(src, steps=3, init=torch.tensor(0, dtype=I32), name="Src")
    K = StepTask(snk, steps=3, init=torch.tensor(0, dtype=I32), name="Snk")
    buf = np.zeros(6, np.int32)

    def Top(res):
        c = channel(4, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(S, c).invoke(K, c, res)

    rep = repro_torch.ENGINES["compiled"](device="cpu").run(Top,
                                                            mmap(buf, "res"))
    assert rep.ok, rep.error
    assert buf.tolist() == [10, 10, 10, 1, 2, 3]

    calls = [0]

    def counting_src(k, out):
        calls[0] += 1
        out.write(calls[0])             # a host value that changes
        return k + 1

    C = StepTask(counting_src, steps=2, init=torch.tensor(0, dtype=I32),
                 name="Counter")
    D = StepTask(lambda s, inp: (inp.read(), s)[1], steps=2, name="Drain")

    def Top2():
        c = channel(2, "c", dtype=np.int32, shape=())
        repro_torch.task().invoke(C, c).invoke(D, c)

    with pytest.raises(SynthesisError, match=r"'Counter#\d+' used a host "
                                             r"value .* never saw"):
        repro_torch.ENGINES["compiled"](device="cpu").run(Top2)

"""``async_mmap`` synthesis in the port: the latency-queue lowering on the CPU.

Each bounded port is a fixed-depth latency queue serviced once a sweep
after the task bodies (``repro_torch.kernels.ring.ServicePorts``; here its
plain version, ``chip_smoke.py`` phases 3-5 run the kernel on the card).
The service step must equal the reference's ``_service_ports`` bit for bit
on any carry, the lowered apps must give the reference's schedule (sweeps,
fires, channel statistics, port counters) exactly and their coroutine
twin's outputs bit for bit, and the reference's three refusals hold.
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
from repro.apps import gemm as ref_gemm
from repro.apps import page_rank as ref_page_rank
from repro.core import async_mmap as ref_async_mmap
from repro.core import synth as ref_synth
from repro.core.synth import elaborate_step_graph as ref_elaborate

import repro_torch
from repro_torch import StepTask, SynthesisError, async_mmap
from repro_torch.apps import gemm, page_rank
from repro_torch.core import synth
from repro_torch.core.synth import elaborate_step_graph
from repro_torch.kernels import _build, dispatch, ring

I32 = torch.int32


def _strip(x):
    return re.sub(r"#\d+", "", repr(x))


def compiled():
    return repro_torch.ENGINES["compiled"](device="cpu")


# ---------------------------------------------------------------------------
# the reference's refusals, with its diagnostics
# ---------------------------------------------------------------------------

def _read_write(pkg, port):
    i32 = (lambda v: jnp.int32(v)) if pkg is repro else \
        (lambda v: torch.tensor(v, dtype=I32))

    def s(k, port):
        port.read_addr.write(i32(0))
        port.write_addr.write(i32(1))
        port.write_data.write(port.read_data.read())
        port.write_resp.read()
        return k
    return s


def _pipelined(pkg, port):
    ar = jnp.arange(2) if pkg is repro else torch.arange(2)

    def s(k, port):
        port.read_pipelined(ar)
        return k
    return s


REFUSALS = {
    # (depth, body, the reference test's pattern)
    "unbounded": (None, lambda pkg, port: lambda state, port: state,
                  r"'S#\d+' binds async_mmap 'm' .*unbounded.*bounded depth"),
    "read_write": (2, _read_write,
                   r"async_mmap 'm' is both read and written.*one port per "
                   r"direction"),
    "read_pipelined": (2, _pipelined,
                       r"'S#\d+' used read_pipelined on async_mmap 'm'"),
}


def _refusal_graph(pkg, case):
    depth, body, _ = REFUSALS[case]
    zero = jnp.int32(0) if pkg is repro else torch.tensor(0, dtype=I32)
    amap = ref_async_mmap if pkg is repro else async_mmap
    port = amap(np.zeros(4, np.float32), depth=depth, name="m")
    S = (ref_synth.StepTask if pkg is repro else StepTask)(
        body(pkg, port), steps=1, init=zero, name="S")

    def Top(port):
        pkg.task().invoke(S, port)
    return Top, port


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_with_the_reference_diagnostics(case):
    pattern = REFUSALS[case][2]
    top, port = _refusal_graph(repro, case)
    with pytest.raises(ref_synth.SynthesisError, match=pattern) as ref:
        repro.ENGINES["compiled"](cache=False).run(top, port)
    top, port = _refusal_graph(repro_torch, case)
    with pytest.raises(SynthesisError, match=pattern) as got:
        compiled().run(top, port)
    if case != "unbounded":         # the reference names its while_loop
        assert _strip(str(got.value)) == _strip(str(ref.value))


def test_latency_and_depth_in_structural_hash():
    # latency and depth size the lowered queue: graphs differing only there
    # must not share a program
    def s(k, port):
        port.read_addr.write(k)
        port.read_data.read()
        return k + 1

    def build(pkg, depth, latency=4):
        if pkg is repro:
            S = ref_synth.StepTask(s, steps=1, init=jnp.int32(0), name="S")
            port = ref_async_mmap(np.zeros(4, np.float32), depth=depth,
                                  latency=latency, name="m")
            elab = ref_elaborate
        else:
            S = StepTask(s, steps=1, init=torch.tensor(0, dtype=I32),
                         name="S")
            port = async_mmap(np.zeros(4, np.float32), depth=depth,
                              latency=latency, name="m")
            elab = elaborate_step_graph

        def Top(port):
            pkg.task().invoke(S, port)
        return elab(Top, port)[1].structural_hash()

    for pkg in (repro, repro_torch):
        assert build(pkg, 1) != build(pkg, 4)
        assert build(pkg, 4, latency=2) != build(pkg, 4, latency=8)
        assert build(pkg, 4) == build(pkg, 4)


# ---------------------------------------------------------------------------
# the service step against the reference's, on random carries
# ---------------------------------------------------------------------------

def _reference_service(ports, caps):
    """The reference's ``_service_ports`` for ``ports`` ((depth, latency)
    each, rings at channels 5k .. 5k + 4) over channels of ``caps``: the
    closure ``_build_program`` builds, taken out of its loop."""
    plan = SimpleNamespace(
        ports=[SimpleNamespace(depth=d, latency=lat) for d, lat in ports],
        port_chan_ids={k: tuple(range(5 * k, 5 * k + 5))
                       for k in range(len(ports))},
        channels=[SimpleNamespace(capacity=int(c)) for c in caps],
        tasks=[SimpleNamespace(total=1, bounds=[1], phases=[
            SimpleNamespace(reads={}, writes={})])],
        ring_impl="xla")
    program = ref_synth._build_program(plan)

    def cell(fn, name):
        return fn.__closure__[fn.__code__.co_freevars.index(name)] \
            .cell_contents
    return cell(cell(program, "_run_loop"), "_service_ports")


def _rows(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _random_carry(rng, ports, how):
    """Numpy carry of ``ports`` ((depth, latency, row, dtype, rows) each):
    rings of any occupancy, windows of any size with dues from 3 sweeps
    past to 5 ahead, addresses out of range (``clip``: far out), response
    rings full (``full``), write addresses with no value (``novalue``)."""
    n_ch = 5 * len(ports) + 2
    caps = rng.integers(1, 7, n_ch)
    heads, sizes = rng.integers(0, caps), rng.integers(0, caps + 1)
    bufs = {c: np.zeros(int(caps[c]), np.int32)
            for c in range(5 * len(ports), n_ch)}
    sweeps = int(rng.integers(0, 60))
    far = 1000 if how == "clip" else 3
    out = []
    for k, (d, lat, row, dt, nrow) in enumerate(ports):
        ra, rd, wa, wd, wr = range(5 * k, 5 * k + 5)
        if how == "full":
            sizes[rd], sizes[wr] = caps[rd], caps[wr]
        if how == "novalue":
            sizes[wd], sizes[wa] = 0, max(1, sizes[wa])
        bufs[ra] = rng.integers(-far, nrow + far, caps[ra]).astype(np.int32)
        bufs[wa] = rng.integers(-far, nrow + far, caps[wa]).astype(np.int32)
        bufs[rd] = _rows(rng, (int(caps[rd]), *row), dt)
        bufs[wd] = _rows(rng, (int(caps[wd]), *row), dt)
        bufs[wr] = rng.random(int(caps[wr])) < 0.5
        st = rng.integers(0, 100, 10).astype(np.int32)
        st[[0, 2]] = rng.integers(0, d, 2)
        st[[1, 3]] = rng.integers(0, d + 1, 2)
        st[[8, 9]] = rng.integers(0, d + 1, 2)
        win = np.stack([rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d),
                        rng.integers(-far, nrow + far, d),
                        sweeps + rng.integers(-3, 6, d)]).astype(np.int32)
        out.append(dict(depth=d, latency=lat, data=_rows(rng, (nrow, *row),
                                                         dt),
                        wval=_rows(rng, (d, *row), dt), st=st, win=win))
    return dict(ports=out, bufs=bufs, caps=caps, heads=heads.astype(np.int32),
                sizes=sizes.astype(np.int32), sweeps=sweeps,
                flags=rng.integers(0, 2, 2).astype(np.int32),
                maxocc=rng.integers(0, 8, n_ch).astype(np.int32))


def _port_service(carry):
    """The port's ``ServicePorts`` over a copy of ``carry`` on the CPU."""
    t = lambda a: torch.from_numpy(np.array(a))     # noqa: E731
    pint = torch.stack([t(q["st"]) for q in carry["ports"]])
    qs = []
    for k, q in enumerate(carry["ports"]):
        pq = ring.PortQueue(t(q["data"]), pint[k], range(5 * k, 5 * k + 5),
                            q["depth"], q["latency"])
        pq.win.copy_(t(q["win"]))
        pq.wval.copy_(t(q["wval"]))
        qs.append(pq)
    bufs = {c: t(b) for c, b in carry["bufs"].items()}
    state = torch.tensor([0, carry["sweeps"]], dtype=I32)
    svc = ring.ServicePorts(qs, bufs, t(carry["heads"]), t(carry["sizes"]),
                            t(carry["maxocc"]), state, t(carry["flags"]))
    return svc, pint, bufs, state


SERVICE_CASES = [
    ("8 B rows, depths 1/4/8", [(1, 4, (2,), np.int32, 32),
                                (4, 0, (2,), np.int32, 32),
                                (8, 2, (2,), np.int32, 32)], "random"),
    ("wide rows", [(4, 4, (16, 16), np.float32, 4),
                   (8, 1, (16, 16), np.float32, 3)], "random"),
    ("responses full", [(1, 3, (2,), np.int32, 8),
                        (4, 4, (5, 3), np.float32, 6)], "full"),
    ("clipped addresses", [(4, 4, (2,), np.int32, 5),
                           (8, 2, (7,), np.bool_, 9)], "clip"),
    ("no value tokens", [(4, 4, (2,), np.int32, 8),
                         (1, 5, (3,), np.float32, 2)], "novalue"),
]


@pytest.mark.parametrize("tag,ports,how", SERVICE_CASES,
                         ids=[c[0] for c in SERVICE_CASES])
def test_service_step_equals_reference(tag, ports, how):
    """12 random carries through the port's plain service step and the
    reference's ``_service_ports``: rings, windows, buffers and counters
    bit for bit, deferred deliveries and clipped addresses included; the
    commit (sweep count, done flag, highwater marks) as the reference's
    loop takes it from the step's activity and waiting."""
    rng = np.random.default_rng(len(tag))
    moved = 0
    for _ in range(12):
        c = _random_carry(rng, ports, how)
        svc, pint, bufs, state = _port_service(c)
        svc()
        ref = _reference_service([(q["depth"], q["latency"])
                                  for q in c["ports"]], c["caps"])
        chans = tuple((jnp.asarray(c["bufs"][i]), jnp.int32(c["heads"][i]),
                       jnp.int32(c["sizes"][i]))
                      for i in range(len(c["caps"])))
        pcs = tuple((jnp.asarray(q["data"]), *map(jnp.asarray, q["win"][:2]),
                     jnp.int32(q["st"][0]), jnp.int32(q["st"][1]),
                     *map(jnp.asarray, q["win"][2:]), jnp.asarray(q["wval"]),
                     jnp.int32(q["st"][2]), jnp.int32(q["st"][3]),
                     *(jnp.int32(v) for v in q["st"][4:]))
                    for q in c["ports"])
        r_chans, r_ports, activity, waiting = ref(chans, pcs,
                                                  jnp.int32(c["sweeps"]))
        for i, (buf, head, size) in enumerate(r_chans):
            assert np.array_equal(bufs[i].numpy(), np.asarray(buf)), i
            assert int(svc.args[0][i]) == int(head)
            assert int(svc.args[1][i]) == int(size)
        for k, (q, rp) in enumerate(zip(svc.ports, r_ports)):
            assert np.array_equal(q.data.numpy(), np.asarray(rp[0]))
            assert np.array_equal(q.win.numpy(), np.stack(
                [rp[1], rp[2], rp[5], rp[6]]))
            assert np.array_equal(q.wval.numpy(), np.asarray(rp[7]))
            want = [rp[3], rp[4], rp[8], rp[9], *rp[10:]]
            assert pint[k].tolist() == [int(v) for v in want]
            moved += pint[k].tolist() != c["ports"][k]["st"].tolist()
        pending = any(int(rp[4]) > 0 or int(rp[9]) > 0 for rp in r_ports)
        progress = bool(c["flags"][0]) or bool(activity) or bool(waiting)
        done = not (progress and (bool(c["flags"][1]) or pending))
        assert state.tolist() == [int(done), c["sweeps"] + 1]
        assert np.array_equal(svc.args[2].numpy(), np.maximum(
            c["maxocc"], np.stack([np.asarray(s) for _, _, s in r_chans])))
    assert moved > 4


def test_service_step_after_done_changes_nothing():
    rng = np.random.default_rng(5)
    c = _random_carry(rng, SERVICE_CASES[0][1], "random")
    svc, pint, bufs, state = _port_service(c)
    state[0] = 1
    before = [x.clone() for x in [pint, state, *svc.args,
                                  *bufs.values()]]
    svc()
    after = [pint, state, *svc.args, *bufs.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_cpu_service_takes_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU program tried to build/load {name!r}")

    monkeypatch.setattr(_build, "load", no_build)
    dispatch.reset_launches()
    c = _random_carry(np.random.default_rng(1), SERVICE_CASES[1][1],
                      "random")
    svc, _, _, state = _port_service(c)
    svc()
    assert int(state[1]) == c["sweeps"] + 1
    assert dispatch.launch_counts() == {}


def _service_args(bad):
    data = torch.zeros((4, 2), dtype=I32)
    pint = torch.zeros((1, ring.PORT_WORDS), dtype=I32)
    q = ring.PortQueue(data, pint[0], range(5), 2, 4)
    bufs = {0: torch.zeros(2, dtype=I32), 1: torch.zeros((2, 2), dtype=I32),
            2: torch.zeros(2, dtype=I32), 3: torch.zeros((2, 2), dtype=I32),
            4: torch.zeros(2, dtype=torch.bool)}
    z = functools.partial(torch.zeros, dtype=I32)
    args = dict(ports=[q], rings=bufs, heads=z(5), sizes=z(5), maxocc=z(5),
                state=z(2), flags=z(2))
    for k, v in bad.items():
        if k in args:
            args[k] = v
        elif k == "depth":
            q.depth = v
        else:
            bufs[k] = v
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(state=torch.zeros(3, dtype=I32)), "state must be"),
    (dict(flags=torch.zeros(2, dtype=torch.int64)), "flags must be"),
    (dict(ports=[]), "no ports"),
    (dict(depth=0), "depth 0 < 1"),
    ({1: torch.zeros((2, 3), dtype=I32)}, "ring 1 must be"),
    ({4: torch.zeros(2, dtype=I32)}, "ring 4 must be"),
])
def test_service_checks_its_carry(bad, match):
    with pytest.raises(ValueError, match=match):
        ring.ServicePorts(**_service_args(bad))


def test_service_launch_structs_match_the_c_layout():
    # csrc/ring.cu's struct PortLaunch and struct ServiceLaunch
    f = ring._PortLaunch
    assert [(n, getattr(f, n).offset) for n, _ in f._fields_] == [
        ("data", 0), ("wval", 8), ("win", 16), ("st", 24), ("buf", 32),
        ("row_bytes", 72), ("nrow", 80), ("depth", 84), ("latency", 88),
        ("word", 92), ("chan", 96), ("cap", 116)]
    assert ctypes.sizeof(f) == 136
    f = ring._ServiceLaunch
    names = ["ports", "heads", "sizes", "maxocc", "state", "flags",
             "scratch", "stream"]
    assert [(n, getattr(f, n).offset) for n, _ in f._fields_] == \
        [(n, 8 * i) for i, n in enumerate(names)] + [("n", 64), ("C", 68),
                                                     ("blocks", 72)]
    assert ctypes.sizeof(f) == 80
    assert ring._ARGTYPES["service_ports"] == [ctypes.c_void_p]
    src = (_build.CSRC / "ring.cu").read_text()
    assert "constexpr int kMaxDepth = 64;" in src
    assert "enum { kRHead, kRSize, kWHead, kWSize, kAccR, kDelR, kAccW, " \
        "kDelW, kMaxR,\n       kMaxW, kPortWords };" in src
    assert (ring.P_RHEAD, ring.P_RSIZE, ring.P_WHEAD, ring.P_WSIZE,
            ring.P_ACC_R, ring.P_DEL_R, ring.P_ACC_W, ring.P_DEL_W,
            ring.P_MAX_R, ring.P_MAX_W, ring.PORT_WORDS) == tuple(range(11))


# ---------------------------------------------------------------------------
# the async apps: twin == compiled bitwise; schedule == the reference's
# ---------------------------------------------------------------------------

ASYNC = {
    "gemm": (gemm, ref_gemm, dict(P=2, n=4, K=4), "depth",
             dict(rtol=0, atol=1e-5 * 4 * 4)),
    "page_rank": (page_rank, ref_page_rank,
                  dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=4),
                  "edge_depth", dict(rtol=1e-6, atol=1e-6)),
}


def _out(name, args):
    if name == "gemm":
        return np.stack([np.asarray(p.data) for p in args[2]])
    return np.asarray(args[1].data)


def _chan_stats(eng):
    return sorted((c.name, c.total_read, c.total_written, c.max_occupancy)
                  for c in eng.channel_set)


@functools.lru_cache(maxsize=None)
def _reference(name, depth):
    _, ref_mod, kw, dk, _ = ASYNC[name]
    rtop, rargs, check = ref_mod.build_step_async(**kw, **{dk: depth})
    reng = repro.ENGINES["compiled"](cache=False, ring_impl="xla")
    ref = reng.run(rtop, *rargs)
    assert ref.ok, ref.error
    assert check()[0]
    return (ref.switches, _strip(ref.instances), ref.channels, ref.tokens,
            _chan_stats(reng), ref.interfaces, _out(name, rargs))


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("name", sorted(ASYNC))
def test_async_app_twin_equals_compiled_and_reference(name, depth):
    mod, _, kw, dk, tol = ASYNC[name]
    top, args, _ = mod.build_step_async(device="cpu", **kw, **{dk: depth})
    twin = repro_torch.ENGINES["coroutine"](track_stats=True).run(top, *args)
    assert twin.ok, twin.error
    y_twin = _out(name, args)

    top, args, check = mod.build_step_async(device="cpu", **kw, **{dk: depth})
    eng = compiled()
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert check()[0]
    y = _out(name, args)
    assert y.tobytes() == y_twin.tobytes()          # bitwise twin parity
    assert rep.tokens == twin.tokens

    sweeps, instances, channels, tokens, stats, ifaces, y_ref = \
        _reference(name, depth)
    assert rep.switches == eng.n_sweeps == sweeps
    assert _strip(rep.instances) == instances       # all fired
    assert rep.channels == channels                 # written + highwater
    assert _chan_stats(eng) == stats
    assert rep.tokens == tokens
    assert rep.interfaces == ifaces                 # every port counter
    ports = [s for _, kind, s in rep.interfaces if kind == "async_mmap"]
    reads = [s["max_outstanding_reads"] for s in ports if s["read_reqs"]]
    assert reads
    assert all((r == 1) if depth == 1 else (r > 1) for r in reads)
    np.testing.assert_allclose(y, y_ref, **tol)


def test_async_app_at_every_block_size(monkeypatch):
    """The port graph's sweep count does not depend on the replay blocks,
    and its run ends on a whole block."""
    want = _reference("page_rank", 4)[0]
    for k in (1, 7, 64):
        monkeypatch.setattr(synth, "SWEEP_BLOCKS", (k,))
        top, args, check = page_rank.build_step_async(
            device="cpu", **ASYNC["page_rank"][2], edge_depth=4)
        eng = compiled()
        rep = eng.run(top, *args)
        assert rep.ok and check()[0]
        assert rep.switches == want
        assert eng.n_replays == k * eng.n_blocks >= want
        assert eng.n_host_syncs == eng.n_blocks + 1


def test_port_graph_block_after_done_changes_nothing():
    top, args, _ = gemm.build_step_async(device="cpu", P=2, n=4, K=4)
    plan, _, _ = elaborate_step_graph(top, *args)
    states0 = tuple(synth._materialize_state(tp.state0, "cpu")
                    for tp in plan.tasks)
    mmaps0 = tuple(synth._as_canon(m.data, "cpu").clone() for m in plan.mmaps)
    ports0 = tuple(synth._as_canon(p.data, "cpu").clone() for p in plan.ports)
    prog = synth._SweepProgram(plan, torch.device("cpu"))
    out = prog(states0, mmaps0, ports0)
    assert int(prog.carry.state[0]) == 1 and out[2] == 21
    before = [t.clone() for t in prog.carry.tensors()]
    prog.block(5)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 prog.carry.tensors()))
    counters, written = out[5]
    assert counters.shape == (4, ring.PORT_WORDS)
    assert sorted(written) == [2, 3]        # the C ports, written back


def test_graph_without_ports_keeps_its_sweep(monkeypatch):
    """A graph with no port takes no service step and leaves the sweep's
    count and done flag to the guards, as before ports were lowered."""
    calls = []
    monkeypatch.setattr(ring.ServicePorts, "__call__",
                        lambda self: calls.append(self))
    top, args, check = gemm.build_step(device="cpu", P=2, n=4, K=2)
    plan, _, _ = elaborate_step_graph(top, *args)
    assert plan.ports == [] and plan.port_dirs == []
    top, args, check = gemm.build_step(device="cpu", P=2, n=4, K=2)
    rep = compiled().run(top, *args)
    assert rep.ok and check()[0] and not calls


def test_async_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (gemm, page_rank):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.build_step_async()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.run_step_async("compiled")


def test_card_program_refuses_a_window_beyond_the_kernel():
    """The port service on the card keeps at most ``MAX_PORT_DEPTH``
    requests in flight a direction; a deeper port is refused, naming it,
    before anything reaches the card (the CPU's plain version takes any
    depth)."""
    def issue(k, port):
        port.read_addr.write(k)
        return k + 1

    def drain(k, port):
        port.read_data.read()
        return k

    S = StepTask(drain, steps=1, warmup=issue,
                 init=torch.tensor(0, dtype=I32), name="S")
    port = async_mmap(np.zeros(4, np.float32), name="deep",
                      depth=ring.MAX_PORT_DEPTH + 1)

    def Top(port):
        repro_torch.task().invoke(S, port)

    plan, _, _ = elaborate_step_graph(Top, port)
    with pytest.raises(SynthesisError, match="'deep' has depth 65"):
        synth._SweepProgram(plan, torch.device("cuda"))
    assert compiled().run(Top, port).ok

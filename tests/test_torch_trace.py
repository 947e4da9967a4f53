"""The trace of a ``CompiledEngine`` run (``repro_torch.core.trace``).

On the CPU: the span tree of small gemm and gaussian runs (one root
``invoke``, every child inside its parent, one invocation id, the parts of
``lower`` covering it), the engine's timing attributes as the durations of
their spans, the counters, and the bytes the final read takes from the
carry.  Marked ``card`` (skipped without one): a stamped run
(``trace=True``) leaves every output as it is, and its regions count the
replays and the firings exactly and fit inside the replays' device time.
"""

import numpy as np
import pytest
import torch

from repro_torch.apps import gaussian, gemm
from repro_torch.core import synth, trace
from repro_torch.core.synth import CompiledEngine
from repro_torch.kernels import ring
from repro_torch.kernels.ring import PORT_WORDS

APPS = {
    "gemm": lambda dev: gemm.build_step(device=dev, P=2, n=4, K=2),
    "gemm_async": lambda dev: gemm.build_step_async(device=dev, P=2, n=4,
                                                    K=4),
    "gaussian": lambda dev: gaussian.build_step(device=dev, h=6, w=6,
                                                iters=2),
}


def _outputs(name, args) -> list:
    if name == "gemm":
        return [m.data for m in args[2]]
    if name == "gemm_async":
        return [p.data for p in args[2]]
    return [args[1].data]


def _run(name, dev="cpu", **kw):
    top, args, check = APPS[name](dev)
    eng = CompiledEngine(device=dev, **kw)
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert check()[0]
    return eng, args


def _children(tr, i):
    return [s for s in tr.spans if s.parent == i]


@pytest.mark.parametrize("name", ["gemm", "gaussian"])
def test_span_tree(name):
    eng, _ = _run(name)
    tr = eng.trace
    roots = [i for i, s in enumerate(tr.spans) if s.parent is None]
    assert [tr.spans[i].name for i in roots] == ["invoke"]
    assert {s.inv for s in tr.spans} == {tr.id}
    for s in tr.spans:
        assert s.t1 is not None and s.t0 <= s.t1
        if s.parent is not None:
            p = tr.spans[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    top = [s.name for s in _children(tr, roots[0])]
    assert top == ["lower", "prepare", "loop", "read", "release",
                   "writeback"]        # no capture on the CPU
    lower = tr.spans.index(tr.first("lower"))
    kids = _children(tr, lower)
    assert [s.name for s in kids] == ["lower.elaborate", "lower.plan",
                                      "lower.count", "lower.rules",
                                      "lower.graph"]
    for a, b in zip(kids, kids[1:]):
        assert a.t1 <= b.t0                       # in order, disjoint
    assert sum(s.seconds for s in kids) >= 0.75 * tr.first("lower").seconds
    assert eng.trace is tr and trace.RECENT[-1]["id"] == tr.id


def test_span_tree_under_a_mesh():
    eng, _ = _run("gemm", mesh=2)
    tr = eng.trace
    top = [s.name for s in _children(tr, 0)]
    assert top == ["lower", "place", "prepare", "loop", "read", "release",
                   "writeback"]
    assert eng.place_s == tr.first("place").seconds > 0.0
    assert eng.program_s == (tr.first("writeback").t1 -
                             tr.first("prepare").t0) / 1e9


@pytest.mark.parametrize("name", ["gemm", "gaussian", "gemm_async"])
def test_timing_attributes_are_their_spans(name):
    eng, _ = _run(name)
    tr = eng.trace
    assert eng.lower_s == tr.first("lower").seconds > 0.0
    assert eng.loop_s == tr.first("loop").seconds > 0.0
    assert eng.capture_s == 0.0 and tr.first("capture") is None
    assert eng.place_s == 0.0
    assert eng.program_s == (tr.first("writeback").t1 -
                             tr.first("prepare").t0) / 1e9
    assert 0.0 < eng.loop_s < eng.program_s
    c = tr.counters
    assert (eng.n_sweeps, eng.n_replays, eng.n_blocks, eng.n_host_syncs) == \
        (c["n_sweeps"], c["n_replays"], c["n_blocks"], c["n_host_syncs"])
    assert eng.n_sweeps == eng.switches > 0
    assert eng.n_host_syncs == eng.n_blocks + 1
    # no card: no device interval, no node count, no stamps
    assert eng.graph_device_s == 0.0 and eng.nodes_per_sweep is None
    assert tr.stamps is None
    table = tr.table()
    assert list(table)[0] == "invoke"
    assert "invoke/lower/lower.count" in table
    for path, (host, busy, idle) in table.items():
        assert busy == 0.0 and 0.0 <= idle <= host
    summary = trace.RECENT[-1]
    assert summary["spans"]["invoke/lower"] == eng.lower_s
    assert summary["counters"] == c


def test_a_new_run_a_new_trace():
    eng, _ = _run("gaussian")
    first = eng.trace
    top, args, _ = APPS["gaussian"]("cpu")
    eng.run(top, *args)
    assert eng.trace is not first and eng.trace.id > first.id
    assert [s.name for s in eng.trace.spans].count("invoke") == 1


@pytest.mark.parametrize("name", ["gemm", "gaussian", "gemm_async"])
def test_read_bytes_are_the_carry_read(name, monkeypatch):
    seen = []
    read = synth._SweepProgram._read

    def spy(self):
        seen.append(self)
        return read(self)

    monkeypatch.setattr(synth._SweepProgram, "_read", spy)
    eng, _ = _run(name)
    (prog,) = seen
    c = prog.carry
    want = 4 * (len(c.fires) + 2 + 2 * len(c.sizes) + c.pint.numel())
    assert c.pint.numel() == len(c.ports) * PORT_WORDS
    written = [q.data for q, dirs in zip(c.ports, prog.plan.port_dirs)
               if "write" in dirs]
    assert bool(written) == (name == "gemm_async")
    want += sum(x.numel() * x.element_size() for x in written)
    assert eng.trace.counters["read_bytes"] == want


def test_a_resumable_read_counts_the_whole_carry():
    top, args, _ = APPS["gaussian"]("cpu")
    eng = CompiledEngine(device="cpu")
    plan, _, _ = eng._elaborate(top, *args)
    synth.clear_context()
    prog = synth._SweepProgram(plan, torch.device("cpu"))
    prog.prepare(tuple(synth._materialize_state(tp.state0, "cpu")
                       for tp in plan.tasks),
                 tuple(synth._as_canon(m.data, "cpu").clone()
                       for m in plan.mmaps))
    out = prog.run_chunk(1000)
    assert out.done and prog.read_s == prog.trace.first("read").seconds
    c = prog.carry
    small = len(c.fires) + 2 + 2 * len(c.sizes) + c.pint.numel()
    big = [r.buf for r in c.rings.values()] + c.mmaps + [
        x for st in c.states for x in synth._leaves(st)]
    assert len(big) > len(c.rings) and not c.ports
    assert prog.trace.counters["read_bytes"] == 4 * small + sum(
        x.numel() * x.element_size() for x in big)


def test_table_splits_each_span_by_the_device():
    tr = trace.Trace()
    with tr.span("a"):
        with tr.span("b"):
            pass
    a, b = tr.spans
    a.t0, a.t1, b.t0, b.t1 = 0, 100, 20, 50
    tr._device = [("replays", 1, 10, 30), ("read", 0, 40, 70),
                  ("clone", 0, 60, 65)]
    table = tr.table()
    # a alone: [0, 20) and [50, 100); busy [10, 20) and [50, 70)
    assert table["a"] == (1e-7, 30e-9, 40e-9)
    # b: [20, 50); busy [20, 30) and [40, 50)
    assert table["a/b"] == (3e-8, 20e-9, 10e-9)
    assert tr.device_seconds("replays") == 20e-9
    assert tr.blocks() == [(1, 20e-9)]


def test_interval_helpers():
    assert trace._union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4),
                                                               (5, 10)]
    assert trace._minus([(0, 10)], [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    assert trace._minus([(0, 10)], []) == [(0, 10)]
    assert trace._overlap([(0, 4), (6, 10)], [(3, 7), (9, 20)]) == 3


def test_stamps_read_on_the_host():
    """``SweepStamps.read``: each region's (ns, count), a body fired and
    skipped by its row, and each replay's first and last stamp moved onto
    the host's clock through the anchor."""
    st = ring.SweepStamps.__new__(ring.SweepStamps)
    st.n = 2
    st.acc = torch.tensor([[30, 3, 0, 0], [90, 3, 0, 0], [40, 2, 5, 1],
                           [0, 0, 12, 3], [7, 3, 0, 0]])
    st.clock = torch.tensor([999, 3])
    st.first = torch.tensor([100, 200, 300, 0])
    st.last = torch.tensor([150, 260, 390, 0])
    st.anchor = torch.tensor([50])
    out = st.read([4, 6], host_ns=1000)
    assert out == dict(stamp=(30, 3), guards=(90, 3), tail=(7, 3),
                       fired={4: (40, 2), 6: (0, 0)},
                       skipped={4: (5, 1), 6: (12, 3)}, replays=3,
                       spans=[(1050, 1100), (1150, 1210), (1250, 1340)])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible (run on the card)")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("name", ["gemm", "gaussian", "gemm_async"])
def test_stamps_on_the_card(name, cuda_device):
    plain, args0 = _run(name, cuda_device)
    out0 = [x.clone() for x in _outputs(name, args0)]
    eng, args = _run(name, cuda_device, trace=True)
    out = _outputs(name, args)
    assert all(torch.equal(a, b) for a, b in zip(out0, out))   # bitwise
    st = eng.trace.stamps
    replays = eng.n_replays
    assert st["replays"] == replays == plain.n_replays
    assert st["guards"][1] == replays and st["stamp"][1] == replays
    assert st["tail"][1] == (replays if name == "gemm_async" else 0)
    fires = eng._phase_fires
    assert set(st["fired"]) == {row for row, k in fires.items()
                                if eng.trace.counters.get(
                                    f"body_nodes[{row}]", 0)}
    assert set(st["fired"]) <= set(st["names"])
    for row, (_, n) in st["fired"].items():
        assert n == fires[row]                          # exactly
        assert n + st["skipped"][row][1] == replays
    regions = st["stamp"][0] + st["guards"][0] + st["tail"][0] + sum(
        ns for ns, _ in st["fired"].values()) + sum(
        ns for ns, _ in st["skipped"].values())
    graph_ns = eng.graph_device_s * 1e9
    assert 0 < regions <= graph_ns
    spans = st["spans"]
    assert len(spans) == replays and all(a < b for a, b in spans)
    assert regions == pytest.approx(sum(b - a for a, b in spans), rel=1e-6)
    # the device intervals lie inside the loop's span, on its clock
    loop = eng.trace.first("loop")
    blocks = [iv for iv in eng.trace.device() if iv[0] == "replays"]
    assert len(blocks) == eng.n_blocks
    assert loop.t0 - 50_000 <= blocks[0][2] and blocks[-1][3] <= \
        eng.trace.first("read").t1 + 50_000
    assert eng.nodes_per_sweep > 0 and plain.nodes_per_sweep == \
        eng.nodes_per_sweep
    table = eng.trace.table()
    assert table["invoke/loop"][1] > 0.0
    # the program's time outside the capture and the loop is in spans (to
    # a fifth here, where the microseconds between spans weigh the most)
    carry = eng.program_s - eng.capture_s - eng.loop_s
    parts = sum(table[f"invoke/{k}"][0] for k in (
        "prepare", "drop", "read", "stamps", "release", "writeback"))
    assert 0.8 * carry <= parts <= carry
    np.testing.assert_allclose(
        sum(h - sum(v[0] for p, v in table.items()
                    if p.startswith(k + "/") and p.count("/") ==
                    k.count("/") + 1)
            for k, (h, _, _) in table.items()),
        sum(b + i for _, b, i in table.values()), rtol=1e-9)

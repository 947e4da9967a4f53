"""The port's mesh floorplanner and partitioned synthesis on the CPU,
against the reference's (``tests/test_floorplan.py``, case by case).

The optimizer runs on synthetic costs here, in both packages, on graphs
built from the same inputs: the owners, the channel traffic, the cut
channels and the placement keys must be the reference's exactly.  The
reference's partitioned runs (``mesh=2``/``4`` over forced host devices)
run once, in a subprocess; the port's ``CompiledEngine(mesh=N)`` on the
CPU must give the port's single-device outputs bit for bit and the
reference's partitioned fires, sweeps, sweep-granular highwater marks and
sizes exactly.  The port's own costs (FLOPs and bytes on meta tensors) are
held to properties only: the reference's are XLA's counts.  On the card,
``chip_smoke.py`` phase 26 runs gemm and page_rank at full width over 2
and 4 partitions sharing one card.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.apps import gemm as ref_gemm
from repro.apps import page_rank as ref_page_rank
from repro.core import floorplan as ref_fp
from repro.core.synth import elaborate_step_graph as ref_elaborate

import repro_torch
from repro_torch import StepTask, SynthesisError, channel, mmap
from repro_torch.apps import gemm, page_rank
from repro_torch.core import cost, synth
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.floorplan import (Placement, channel_endpoints,
                                        channel_traffic, placement_key,
                                        plan_placement)
from repro_torch.core.synth import elaborate_step_graph

SRC = str(Path(__file__).resolve().parents[1] / "src")
I32 = torch.int32


# ---------------------------------------------------------------------------
# graphs: the reference's relay pipeline, in both packages
# ---------------------------------------------------------------------------

def relay_pipeline(n_tokens=32, stages=2, burst=8, capacity=16, bias=0):
    """Step-form Source -> stages x Relay -> Sink; ``bias`` edits the
    relay body (cost-cell dirtying)."""
    fires = n_tokens // burst

    def source_step(k, out):
        out.write_burst(k * burst + torch.arange(burst, dtype=I32,
                                                  device=k.device))
        return k + 1

    def relay_step(state, inp, out):
        out.write_burst(inp.read_burst(burst) + bias)
        return state

    def sink_step(k, inp, res):
        res.write_burst(k * burst, inp.read_burst(burst))
        return k + 1

    Source = StepTask(source_step, steps=fires,
                      init=torch.tensor(0, dtype=I32), name="Source")
    Relay = StepTask(relay_step, steps=fires, name="Relay")
    Sink = StepTask(sink_step, steps=fires, init=torch.tensor(0, dtype=I32),
                    name="Sink")
    buf = np.zeros(n_tokens, np.int32)
    res = mmap(buf, "res")

    def Top(res):
        chans = [channel(capacity, f"c{i}", dtype=np.int32, shape=())
                 for i in range(stages + 1)]
        t = repro_torch.task().invoke(Source, chans[0], name="Source")
        for s in range(stages):
            t = t.invoke(Relay, chans[s], chans[s + 1], name=f"Relay{s}")
        t.invoke(Sink, chans[stages], res, name="Sink")

    return Top, (res,), buf


def ref_relay_pipeline(n_tokens=32, stages=2, burst=8, capacity=16, bias=0):
    fires = n_tokens // burst

    def source_step(k, out):
        out.write_burst(k * burst + jnp.arange(burst, dtype=jnp.int32))
        return k + 1

    def relay_step(state, inp, out):
        out.write_burst(inp.read_burst(burst) + bias)
        return state

    def sink_step(k, inp, res):
        res.write_burst(k * burst, inp.read_burst(burst))
        return k + 1

    Source = repro.StepTask(source_step, steps=fires, init=jnp.int32(0),
                            name="Source")
    Relay = repro.StepTask(relay_step, steps=fires, name="Relay")
    Sink = repro.StepTask(sink_step, steps=fires, init=jnp.int32(0),
                          name="Sink")
    buf = np.zeros(n_tokens, np.int32)
    res = repro.mmap(buf, "res")

    def Top(res):
        chans = [repro.channel(capacity, f"c{i}", dtype=np.int32, shape=())
                 for i in range(stages + 1)]
        t = repro.task().invoke(Source, chans[0], name="Source")
        for s in range(stages):
            t = t.invoke(Relay, chans[s], chans[s + 1], name=f"Relay{s}")
        t.invoke(Sink, chans[stages], res, name="Sink")

    return Top, (res,), buf


def _plan(stages=2, **kw):
    top, args, _ = relay_pipeline(stages=stages, **kw)
    plan, graph, _ = elaborate_step_graph(top, *args)
    return plan, graph


def _ref_plan(stages=2, **kw):
    top, args, _ = ref_relay_pipeline(stages=stages, **kw)
    plan, graph, _ = ref_elaborate(top, *args)
    return plan, graph


def _flat_cost(plan, tp):
    return 1.0


def _named_cost(plan, tp):
    """A synthetic cost both packages compute alike: from the name, less
    the process-wide instance counter an unnamed invocation carries."""
    name = re.sub(r"#\d+", "", tp.inst.name)
    return 1.0 + zlib.crc32(name.encode()) % 5


def _both(n_dev, stages=2, **kw):
    """The placement of the relay pipeline in both packages, under the
    same cost function and the reference's HW; the port's must be the
    reference's exactly."""
    plan, graph = _plan(stages=stages)
    rplan, rgraph = _ref_plan(stages=stages)
    pl = plan_placement(plan, graph, n_dev, cache=False, hw=ref_fp.HW, **kw)
    rpl = ref_fp.plan_placement(rplan, rgraph, n_dev, cache=False, **kw)
    assert pl.owners == rpl.owners
    assert pl.task_names == rpl.task_names
    assert pl.objective == rpl.objective
    assert channel_traffic(plan) == ref_fp.channel_traffic(rplan)
    assert channel_endpoints(plan) == ref_fp.channel_endpoints(rplan)
    return pl


# ---------------------------------------------------------------------------
# the optimizer (synthetic costs)
# ---------------------------------------------------------------------------

def test_placement_is_deterministic():
    a = _both(2, stages=4, cost_fn=_flat_cost)
    b = _both(2, stages=4, cost_fn=_flat_cost)
    assert a.owners == b.owners
    assert a.objective == b.objective
    assert a.source == "partitioned"


def test_placement_balances_flat_costs():
    """Six unit-cost tasks on two partitions: the greedy and refining
    passes land a 3/3 split."""
    pl = _both(2, stages=4, cost_fn=_flat_cost)
    assert sorted(pl.objective["loads_s"]) == [3.0, 3.0]
    assert pl.objective["max_load_s"] == 3.0


def test_heavy_task_isolated():
    """A task worth more than all the rest gets a partition to itself."""
    def cost_fn(plan, tp):
        return 100.0 if tp.inst.name == "Relay1" else 1.0

    pl = _both(2, stages=3, cost_fn=cost_fn)
    heavy = dict(zip(pl.task_names, pl.owners))["Relay1"]
    others = [d for n, d in zip(pl.task_names, pl.owners) if n != "Relay1"]
    assert all(d != heavy for d in others)


def test_single_device_placement_has_no_cuts():
    pl = _both(1, cost_fn=_flat_cost)
    assert set(pl.owners) == {0}
    assert pl.objective["cut_bytes"] == 0
    assert pl.objective["cut_channels"] == []


def test_overrides_pin_tasks():
    pl = _both(2, cost_fn=_flat_cost, overrides={"Source": 1, "Sink": 1})
    byname = dict(zip(pl.task_names, pl.owners))
    assert byname["Source"] == 1 and byname["Sink"] == 1


@pytest.mark.parametrize("overrides,match", [
    ({"Relayz": 0}, "Relayz.*known instances"),
    ({"Source": 5}, "'Source' to device 5"),
])
def test_overrides_refused_as_the_reference(overrides, match):
    plan, graph = _plan(stages=1)
    rplan, rgraph = _ref_plan(stages=1)
    with pytest.raises(SynthesisError, match=match) as got:
        plan_placement(plan, graph, 2, cache=False, cost_fn=_flat_cost,
                       overrides=overrides)
    with pytest.raises(repro.SynthesisError) as want:
        ref_fp.plan_placement(rplan, rgraph, 2, cache=False,
                              cost_fn=_flat_cost, overrides=overrides)
    assert str(got.value) == str(want.value)


def test_channel_traffic_counts_full_run_bytes():
    plan, _ = _plan(stages=1, n_tokens=32, burst=8)
    rplan, _ = _ref_plan(stages=1, n_tokens=32, burst=8)
    traffic = channel_traffic(plan)
    assert traffic == ref_fp.channel_traffic(rplan)
    assert all(t == 32 * 4 for t in traffic)
    assert all(p >= 0 and c >= 0 for p, c in channel_endpoints(plan))


APPS = {
    "gemm": (gemm, ref_gemm, dict(P=2, n=4, K=2)),
    "page_rank": (page_rank, ref_page_rank,
                  dict(n_vertices=16, n_edges=48, n_pe=2, n_iters=4)),
}


def _app_plans(name):
    mod, ref_mod, kw = APPS[name]
    top, args, _ = mod.build_step(device="cpu", **kw)
    plan, graph, _ = elaborate_step_graph(top, *args)
    rtop, rargs, _ = ref_mod.build_step(**kw)
    rplan, rgraph, _ = ref_elaborate(rtop, *rargs)
    return plan, graph, rplan, rgraph


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_placements_equal_the_reference(name, n_dev):
    """gemm's 10 tasks and page_rank's 3 under one synthetic cost and the
    reference's HW: the same owners, objective, traffic and cut
    channels, with and without a pin."""
    plan, graph, rplan, rgraph = _app_plans(name)
    assert channel_traffic(plan) == ref_fp.channel_traffic(rplan)
    pins = [None, {plan.tasks[0].inst.name: n_dev - 1}]
    for pin in pins:
        pl = plan_placement(plan, graph, n_dev, cache=False,
                            cost_fn=_named_cost, hw=ref_fp.HW,
                            overrides=pin)
        rpl = ref_fp.plan_placement(rplan, rgraph, n_dev, cache=False,
                                    cost_fn=_named_cost, overrides=pin)
        assert pl.owners == rpl.owners
        assert pl.objective == rpl.objective
        assert pl.objective["cut_channels"] == \
            rpl.objective["cut_channels"]


# ---------------------------------------------------------------------------
# content addressing + memoization
# ---------------------------------------------------------------------------

def test_placement_key_sensitivity():
    plan, graph = _plan(stages=2)
    h = graph.structural_hash()
    base = placement_key(h, 2)
    assert base == placement_key(h, 2)
    assert base != placement_key(h, 4)
    assert base != placement_key(h, 2, {"Source": 1})
    assert placement_key(h, 2, {"Source": 1}) \
        != placement_key(h, 2, {"Source": 0})
    assert base != placement_key(h + "x", 2)
    assert base.startswith("place_")
    for n, pins in ((2, None), (4, None), (2, {"Source": 1}),
                    (2, {"Sink": 0, "Source": 1})):
        assert placement_key(h, n, pins) == ref_fp.placement_key(h, n, pins)


def test_placement_memo_round_trip(tmp_path):
    plan, graph = _plan(stages=3)
    cc = CompileCache(root=tmp_path)
    a = plan_placement(plan, graph, 2, cache=cc, cost_fn=_flat_cost)
    assert a.source == "partitioned"
    b = plan_placement(plan, graph, 2, cache=cc, cost_fn=_flat_cost)
    assert b.source == "memo"
    assert b.owners == a.owners
    assert b.objective == a.objective


def test_cost_cell_key_dirties_only_edited_task():
    """Editing one task's body changes that task's cost cell address and
    nobody else's."""
    plan_a, _ = _plan(stages=2, bias=0)
    plan_b, _ = _plan(stages=2, bias=1)
    keys_a = {tp.inst.name: cost.phase_key(plan_a, tp, tp.phases[0])
              for tp in plan_a.tasks}
    keys_b = {tp.inst.name: cost.phase_key(plan_b, tp, tp.phases[0])
              for tp in plan_b.tasks}
    assert keys_a["Source"] == keys_b["Source"]
    assert keys_a["Sink"] == keys_b["Sink"]
    assert keys_a["Relay0"] != keys_b["Relay0"]
    assert keys_a["Relay1"] != keys_b["Relay1"]
    assert cost.graph_cost_salt(plan_a) != cost.graph_cost_salt(plan_b)
    assert cost.graph_cost_salt(plan_a) == \
        cost.graph_cost_salt(_plan(stages=2, bias=0)[0])


def test_to_dot_colors_devices_and_cuts():
    plan, graph = _plan(stages=2)
    pl = plan_placement(plan, graph, 2, cache=False, cost_fn=_flat_cost)
    dot = graph.to_dot(placement=pl)
    assert "fillcolor" in dot and "dev0" in dot and "dev1" in dot
    assert ("color=red" in dot) == (len(pl.objective["cut_channels"]) > 0)
    assert "fillcolor" not in graph.to_dot()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_partitioned_ports_refuse_naming_port_and_task():
    """async_mmap latency queues have no cut protocol; the refusal names
    the port and the tasks bound to it, in the reference's words."""
    from repro_torch.core import async_mmap

    def graph(pkg, data, buf, init):
        port = pkg.async_mmap(data.copy(), latency=2, depth=2, name="mem")
        res = pkg.mmap(buf, "res")

        def warm(k, port, res):
            port.read_addr.write(k)
            return k + 1

        def step(k, port, res):
            res.write_burst(k - 2, port.read_data.read()[None])
            port.read_addr.write(k)
            return k + 1

        def flush(k, port, res):
            res.write_burst(k - 2, port.read_data.read()[None])
            return k + 1

        Fetch = pkg.StepTask(step, steps=6, init=init, warmup=warm,
                             n_warmup=2, flush=flush, n_flush=2,
                             name="Fetch")

        def Top(port, res):
            pkg.task().invoke(Fetch, port, res)

        return Top, port, res

    assert repro_torch.core.async_mmap is async_mmap
    data = np.arange(8, dtype=np.int32)
    top, port, res = graph(repro_torch, data, np.zeros(8, np.int32),
                           torch.tensor(0, dtype=I32))
    with pytest.raises(SynthesisError, match="mem.*Fetch") as got:
        repro_torch.ENGINES["compiled"](device="cpu", mesh=1,
                                        cache=False).run(top, port, res)
    rtop, rport, rres = graph(repro, data, np.zeros(8, np.int32),
                              jnp.int32(0))
    with pytest.raises(repro.SynthesisError) as want:
        repro.ENGINES["compiled"](mesh=1, cache=False).run(rtop, rport,
                                                           rres)
    strip = lambda e: re.sub(r"#\d+", "", str(e.value))   # noqa: E731
    assert strip(got) == strip(want)


@pytest.mark.parametrize("mesh", [
    [[torch.device("cpu")] * 2], "cpu", 2.0, [], [torch.device("cpu"), 0],
    [torch.device("cpu"), torch.device("meta")],
])
def test_mesh_not_flat_refuses(mesh):
    """The counterpart of the reference's non-1-D mesh: a mesh is an int
    or one flat sequence of devices of one type."""
    top, args, _ = relay_pipeline(stages=1)
    with pytest.raises(SynthesisError, match="one device axis"):
        repro_torch.ENGINES["compiled"](device="cpu", mesh=mesh,
                                        cache=False).run(top, *args)


def test_mesh_wider_than_visible_cards_refuses(monkeypatch):
    """``mesh=N`` on the card is the first N cards; with fewer visible it
    raises ``ValueError`` naming the count and the explicit form, before
    anything touches a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    top, args, _ = relay_pipeline(stages=1)
    with pytest.raises(ValueError, match=r"2 card\(s\) are visible.*"
                       r"mesh=\[torch.device\('cuda:0'\)\] \* 3"):
        repro_torch.ENGINES["compiled"](device="cuda", mesh=3,
                                        cache=False).run(top, *args)
    with pytest.raises(ValueError, match=r"cuda:2 but 2 card"):
        repro_torch.ENGINES["compiled"](
            device="cuda", mesh=["cuda:0", "cuda:2"],
            cache=False).run(top, *args)


@pytest.mark.parametrize("mesh", [2, ["cuda:0", "cuda:1"],
                                  [torch.device("cuda", 3)] * 2 + ["cuda:0"]])
def test_mesh_over_distinct_cards_refuses(monkeypatch, mesh):
    """Partitions share one card: a mesh over distinct cards (``mesh=N``
    with N cards visible, or a device list naming two cards) raises
    ``SynthesisError`` naming ROADMAP A5 and the one-card form, before
    anything touches a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    top, args, _ = relay_pipeline(stages=1)
    with pytest.raises(SynthesisError, match=r"distinct cards.*ROADMAP A5"
                       r".*mesh=\[torch.device\('cuda:0'\)\] \* \d"):
        repro_torch.ENGINES["compiled"](device="cuda", mesh=mesh,
                                        cache=False).run(top, *args)


def test_placement_reuse_mismatch_refuses():
    plan, graph = _plan(stages=2)
    pl = plan_placement(plan, graph, 2, cache=False, cost_fn=_flat_cost)
    wrong = Placement(n_devices=pl.n_devices + 1, owners=pl.owners,
                      task_names=pl.task_names, objective=pl.objective)
    top, args, _ = relay_pipeline(stages=2)
    with pytest.raises(SynthesisError, match="placement reuse mismatch"):
        repro_torch.ENGINES["compiled"](device="cpu", mesh=1, cache=False,
                                        placement=wrong).run(top, *args)


# ---------------------------------------------------------------------------
# the partitioned run against the reference's (forced host devices)
# ---------------------------------------------------------------------------

_REF_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import repro
    from repro.apps import gemm, page_rank
    from repro.core import synth

    got = {{}}
    finish = synth.CompiledEngine._finish

    def record(self, plan, mm_final, fires, sweeps, maxocc, sizes, result,
               t0):
        got.update(fires=np.asarray(fires).tolist(),
                   sweeps=int(np.asarray(sweeps)),
                   maxocc=np.asarray(maxocc).tolist(),
                   sizes=np.asarray(sizes).tolist())
        return finish(self, plan, mm_final, fires, sweeps, maxocc, sizes,
                      result, t0)

    synth.CompiledEngine._finish = record
    apps = {{"gemm": (gemm, dict(P=2, n=4, K=2)),
            "page_rank": (page_rank, dict(n_vertices=16, n_edges=48,
                                          n_pe=2, n_iters=4))}}
    out = {{}}
    for name, (mod, kw) in apps.items():
        for n in (2, 4):
            top, args, check = mod.build_step(**kw)
            eng = repro.ENGINES["compiled"](mesh=n, cache=False)
            rep = eng.run(top, *args)
            assert rep.ok and check()[0], rep.error
            y = (np.concatenate([np.asarray(m.data) for m in args[2]])
                 if name == "gemm" else np.asarray(args[1].data))
            out[f"{{name}}:{{n}}"] = dict(
                got, out=y.tolist(), owners=list(eng.placement_used.owners),
                channels=rep.channels)
    print("REF " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_partitioned(tmp_path_factory):
    """The reference's ``mesh=2`` and ``mesh=4`` runs of gemm and page_rank
    (test sizes) on 8 forced host devices, in a fresh process with a
    fresh ``HOME``: outputs, fires, sweeps, highwater marks, sizes,
    owners."""
    home = tmp_path_factory.mktemp("home")
    env = dict(os.environ, HOME=str(home), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REF_CHILD.format(src=SRC)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF ")][-1]
    return json.loads(line[4:])


TOL = {"gemm": dict(rtol=0, atol=1e-5 * 2 * 4),     # test_torch_synth's
       "page_rank": dict(rtol=1e-6, atol=1e-6)}


def _out(name, args):
    if name == "gemm":
        return np.concatenate([m.data.numpy() for m in args[2]])
    return args[1].data.numpy()


def _run(name, monkeypatch=None, **ekw):
    """The port's run of ``name`` on the CPU: output, engine, report, and
    what ``_finish`` saw (fires, sweeps, maxocc, sizes)."""
    mod, _, kw = APPS[name]
    top, args, check = mod.build_step(device="cpu", **kw)
    eng = repro_torch.ENGINES["compiled"](device="cpu", cache=False, **ekw)
    seen = {}
    finish = eng._finish

    def record(plan, mm_final, fires, sweeps, maxocc, sizes, *rest):
        seen.update(fires=np.asarray(fires).tolist(), sweeps=int(sweeps),
                    maxocc=maxocc.tolist(), sizes=sizes.tolist())
        return finish(plan, mm_final, fires, sweeps, maxocc, sizes, *rest)

    eng._finish = record
    rep = eng.run(top, *args)
    assert rep.ok, rep.error
    assert check()[0]
    return _out(name, args), eng, rep, seen


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", sorted(APPS))
def test_partitioned_bit_identical_and_equal_to_reference(
        reference_partitioned, name, n_dev):
    """The port's ``mesh=N`` on the CPU, placed on its own costs and on
    the reference run's owners: outputs bitwise equal to the port's
    single-device run and within the apps' tolerances of the reference's;
    fires, sweeps, highwater marks (sampled at sweep ends under a mesh)
    and sizes exactly the reference's partitioned run's."""
    ref = reference_partitioned[f"{name}:{n_dev}"]
    golden, eng0, rep0, seen0 = _run(name)
    assert len(set(ref["owners"])) > 1 or name == "page_rank"
    plan, graph, _, _ = _app_plans(name)
    theirs = Placement(n_devices=n_dev, owners=tuple(ref["owners"]),
                       task_names=tuple(tp.inst.name for tp in plan.tasks),
                       objective={})
    for placement in (None, theirs):
        y, eng, rep, seen = _run(name, mesh=n_dev, placement=placement)
        assert y.tobytes() == golden.tobytes()
        np.testing.assert_allclose(y, np.asarray(ref["out"], np.float32),
                                   **TOL[name])
        assert eng.placement_used.n_devices == n_dev
        assert eng.partition_source == "partitioned" or placement
        for k in ("fires", "sweeps", "maxocc", "sizes"):
            assert seen[k] == ref[k], k
        assert json.loads(json.dumps(rep.channels)) == ref["channels"]
        assert seen["fires"] == seen0["fires"]
        assert seen["sweeps"] == seen0["sweeps"]
        assert eng.ring_ops == eng0.ring_ops
        assert rep.tokens == rep0.tokens
        assert eng.n_replays >= seen["sweeps"]
        assert eng.n_host_syncs == eng.n_blocks + 1
    if name == "gemm":
        assert len(set(eng.placement_used.owners)) > 1


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", sorted(APPS))
def test_owners_equal_the_reference_under_a_shared_cost(name, n_dev):
    """Under the reference's HW and a shared cost function both packages
    place the apps alike, and the port's run on that placement is the
    single-device run bit for bit."""
    plan, graph, rplan, rgraph = _app_plans(name)
    pl = plan_placement(plan, graph, n_dev, cache=False,
                        cost_fn=_named_cost, hw=ref_fp.HW)
    rpl = ref_fp.plan_placement(rplan, rgraph, n_dev, cache=False,
                                cost_fn=_named_cost)
    assert pl.owners == rpl.owners
    golden = _run(name)[0]
    y, eng, _, _ = _run(name, mesh=n_dev, placement=pl)
    assert y.tobytes() == golden.tobytes()
    assert eng.placement_used is pl


def test_manual_placement_bit_identical():
    """Manual pins are honoured and give the same answer over another
    cut."""
    golden = _run("gemm")[0]
    auto, eng_a, _, _ = _run("gemm", mesh=2)
    manual, eng_m, _, _ = _run("gemm", mesh=2,
                               placement={"PE0_0": 0, "PE1_1": 1})
    assert auto.tobytes() == golden.tobytes() == manual.tobytes()
    byname = dict(zip(eng_m.placement_used.task_names,
                      eng_m.placement_used.owners))
    assert byname["PE0_0"] == 0 and byname["PE1_1"] == 1


def test_devices_given_explicitly_and_cut_copies():
    """A flat device list is the mesh as given; each cut channel's ring is
    copied once a sweep, and the cut bytes are its rings' bytes."""
    golden = _run("gemm")[0]
    y, eng, _, _ = _run("gemm", mesh=[torch.device("cpu")] * 3)
    assert y.tobytes() == golden.tobytes()
    assert eng.placement_used.n_devices == 3
    plan, _, _, _ = _app_plans("gemm")
    owners = eng.placement_used.owners
    ring_bytes = {c.name: c.capacity * 4 * 4 * 4 for c in plan.channels}
    cut = eng.placement_used.objective["cut_channels"]
    assert cut and eng.cut_bytes == sum(ring_bytes[c] for c in cut)
    assert len(set(owners)) > 1


def test_partition_program_counts_its_sweeps(monkeypatch):
    """Every partition replays every sweep; each runs only its own
    bodies, and the ring ops over the partitions are the firings'."""
    monkeypatch.setattr(synth, "SWEEP_BLOCKS", (3,))
    golden, eng0, _, seen0 = _run("page_rank")
    calls = []
    fire = synth._SweepProgram._fire

    def spy(self, ti, pi, capturing):
        calls.append((self.owned.index(True) if self.owned else -1, ti))
        return fire(self, ti, pi, capturing)

    monkeypatch.setattr(synth._SweepProgram, "_fire", spy)
    y, eng, _, seen = _run("page_rank", mesh=2)
    assert y.tobytes() == golden.tobytes()
    owners = eng.placement_used.owners
    assert calls and all(owners[ti] == owners[first]
                         for first, ti in calls if first >= 0)
    assert len(calls) == sum(seen["fires"])
    blocks = -(-seen["sweeps"] // 3)
    assert (eng.n_blocks, eng.n_replays) == (blocks, 3 * blocks)
    assert 0.0 < eng.loop_s < eng.program_s
    assert 0.0 < eng0.loop_s < eng0.program_s


# ---------------------------------------------------------------------------
# the port's own costs
# ---------------------------------------------------------------------------

def test_cost_probe_per_firing():
    """gemm's ``PE0_0`` step at P=2, n=4, K=2 reads two 4x4 float32 tokens,
    forwards both and accumulates their product.  Its FLOPs are at least
    the product's 2 m n k = 128 (``torch.utils.flop_counter``'s ``mm``
    formula, exact) plus the accumulate's 16 adds: the limit is exact, no
    tolerance.  Its bytes are at least its four tokens' 4 x 64 B: each
    token passes through at least one operation's input or output, which
    are counted once each.  A relay (``Relay0``, int32 tokens) and a
    collector (tokens copied into an mmap) do no floating-point
    arithmetic: 0 FLOPs.  The per-firing costs hold for every phase's
    count, and ``coll`` is 0."""
    cost.clear_cost_cells()
    plan, _, _, _ = _app_plans("gemm")
    byname = {tp.inst.name: tp for tp in plan.tasks}
    pe = byname["PE0_0"]
    step = cost.phase_cost(plan, pe, pe.phases[0], cache=False)
    assert step["flops"] >= 2 * 4 * 4 * 4 + 4 * 4
    assert step["bytes"] >= 4 * 4 * 4 * 4
    assert step["coll"] == 0.0
    col = byname["Collector0"]
    assert cost.phase_cost(plan, col, col.phases[0],
                           cache=False)["flops"] == 0.0
    rplan, _ = _plan(stages=1)
    relay = {tp.inst.name: tp for tp in rplan.tasks}["Relay0"]
    r = cost.phase_cost(rplan, relay, relay.phases[0], cache=False)
    assert r["flops"] == 0.0 and r["bytes"] >= 2 * 8 * 4
    tc = cost.task_cost(plan, pe, cache=False)
    assert tc["flops"] == sum(p["flops"] * p["count"] for p in tc["phases"])
    assert tc["seconds"] == pytest.approx(
        tc["flops"] / cost.HW["peak_flops"] + tc["bytes"] / cost.HW["hbm_bw"])


def test_cost_probe_charges_the_rows_a_ring_op_moves():
    """A pop or a push moves its tokens, not its ring: every task of the
    relay pipeline costs the same bytes a firing with rings of 16 and of
    256 tokens.  Exact: the two probes dispatch the same operations on
    the same token shapes."""
    got = []
    for cap in (16, 256):
        cost.clear_cost_cells()
        plan, _ = _plan(stages=1, capacity=cap)
        got.append([cost.phase_cost(plan, tp, tp.phases[0], cache=False)
                    for tp in plan.tasks])
    assert got[0] == got[1]
    assert all(c["bytes"] > 0 for c in got[0])


def test_card_hw_table():
    """The port prices on the card's data sheet, not the reference's
    TPU-class table."""
    assert cost.HW == {"peak_flops": 67e12, "hbm_bw": 3.35e12,
                       "ici_bw": 450e9, "hbm_capacity": 80e9}
    assert cost.HW != ref_fp.HW


def test_cost_cells_are_memoized(tmp_path):
    cost.clear_cost_cells()
    plan, _, _, _ = _app_plans("gemm")
    cc = CompileCache(root=tmp_path)
    tp = plan.tasks[4]
    a = cost.phase_cost(plan, tp, tp.phases[0], cache=cc)
    assert cost._CELLS and cc.stats.memo_hits == 0
    cost.clear_cost_cells()
    b = cost.phase_cost(plan, tp, tp.phases[0], cache=cc)
    assert a == b and cc.stats.memo_hits == 1


def test_real_costs_place_gemm_deterministically():
    """With the port's own costs, placement is deterministic and spreads
    gemm over more than one partition; every PE costs more than every
    collector, and one that forwards both its tokens more than one that
    forwards none."""
    plan, graph, _, _ = _app_plans("gemm")
    cost.clear_cost_cells()
    a = plan_placement(plan, graph, 2, cache=False)
    cost.clear_cost_cells()
    b = plan_placement(plan, graph, 2, cache=False)
    assert a.owners == b.owners and a.objective == b.objective
    assert len(set(a.owners)) > 1
    costs = dict(zip(a.task_names, a.objective["task_cost_s"]))
    pes = [costs[n] for n in costs if n.startswith("PE")]
    assert min(pes) > max(costs[n] for n in costs
                          if n.startswith("Collector"))
    assert costs["PE0_0"] > costs["PE1_1"]


_MEMO_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import repro_torch
    from repro_torch.apps import gemm
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.floorplan import placement_key
    from repro_torch.core.synth import elaborate_step_graph

    cc = CompileCache(root={root!r})
    top, args, check = gemm.build_step(P=2, n=4, K=2, device="cpu")
    eng = repro_torch.ENGINES["compiled"](device="cpu", mesh=2, cache=cc)
    rep = eng.run(top, *args)
    assert rep.ok and check()[0]
    top, args, _ = gemm.build_step(P=2, n=4, K=2, device="cpu")
    plan, graph, _ = elaborate_step_graph(top, *args)
    art = json.dumps(cc.memo_get(placement_key(graph.structural_hash(), 2)),
                     sort_keys=True)
    print("PSOURCE", eng.partition_source)
    print("ART", art)
""")


def test_second_process_reads_the_placement_from_the_memo(tmp_path):
    """Process 1 places gemm on its own costs; process 2 reads the
    placement back from the store (``partition_source == "memo"``) and
    sees a byte-identical artifact."""
    prog = _MEMO_CHILD.format(src=SRC, root=str(tmp_path))
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                           text=True, timeout=120, cwd=SRC,
                           env={**os.environ, "PYTHONPATH": SRC})
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append({ln.split(" ", 1)[0]: ln.split(" ", 1)[1]
                     for ln in r.stdout.strip().splitlines() if " " in ln})
    assert outs[0]["PSOURCE"] == "partitioned"
    assert outs[1]["PSOURCE"] == "memo"
    assert outs[0]["ART"] == outs[1]["ART"]
    art = json.loads(outs[0]["ART"])
    assert art["n_devices"] == 2 and len(set(art["owners"])) > 1

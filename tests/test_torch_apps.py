"""The paper's seven Table 3 apps in the port, under its simulation engines.

``build``/``run`` of cannon, cnn, gaussian, gcn, gemm, network and
page_rank are numpy graphs on host buffers; the port's engines must
verify each one and give the reference's token counts on the same seed
(the coroutine engine's schedule, deterministic, also its switches,
channel statistics and output error).  cannon and page_rank have
feedback, so the sequential engine must fail them (paper Fig. 7); the
network switch routes by ``peek``/``select``, so its step form's compiled
run is refused naming the switch.
"""

import numpy as np
import pytest

from repro.apps import APPS as REF_APPS
from repro.apps import FEEDBACK_APPS as REF_FEEDBACK_APPS

from repro_torch import ENGINES, SynthesisError
from repro_torch.apps import APPS, FEEDBACK_APPS, network
from repro_torch.core.engines import CoroutineEngine
from repro_torch.core.graph import extract_graph


def test_the_seven_apps():
    assert sorted(APPS) == sorted(REF_APPS) == [
        "cannon", "cnn", "gaussian", "gcn", "gemm", "network", "page_rank"]
    assert FEEDBACK_APPS == REF_FEEDBACK_APPS == ("cannon", "page_rank")


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_verified_coroutine_as_the_reference(app):
    r = APPS[app].run(engine="coroutine")
    assert r.report.ok, r.report.error
    assert r.correct, (app, r.max_err)
    ref = REF_APPS[app].run(engine="coroutine")
    assert ref.ok
    assert r.report.tokens == ref.report.tokens
    assert r.report.switches == ref.report.switches
    assert r.report.channels == ref.report.channels
    assert r.max_err == ref.max_err             # the same numpy arithmetic


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_verified_thread(app):
    r = APPS[app].run(engine="thread")
    assert r.report.ok, r.report.error
    assert r.correct, (app, r.max_err)
    assert r.report.tokens == REF_APPS[app].run(engine="thread").report.tokens


@pytest.mark.parametrize("app", sorted(FEEDBACK_APPS))
def test_feedback_app_fails_sequential(app):
    r = APPS[app].run(engine="sequential")
    ref = REF_APPS[app].run(engine="sequential")
    assert not r.report.ok and not ref.report.ok
    assert r.correct is None
    assert r.report.error.split(":")[0] == ref.report.error.split(":")[0]


@pytest.mark.parametrize("app", sorted(set(APPS) - set(FEEDBACK_APPS)))
def test_dag_app_passes_sequential(app):
    r = APPS[app].run(engine="sequential")
    assert r.report.ok and r.correct


@pytest.mark.parametrize("app", ["cannon", "gemm", "network", "page_rank"])
def test_app_graph_validates(app):
    """Every app's task graph obeys the one-producer/one-consumer/
    same-parent rule (paper Section 3.1.1) under metadata extraction."""
    top, args, _ = APPS[app].build()
    eng = CoroutineEngine()
    rep = eng.run(top, *args)
    assert rep.ok
    g = extract_graph(eng, rep)
    g.validate()
    assert g.n_instances >= g.n_tasks
    assert g.dedup_factor() >= 1.0
    kinds = {r.kind for d in g.definitions for r in d.interfaces}
    assert ("async_mmap" in kinds) == (app == "page_rank")


def test_network_compiled_run_refused_naming_the_switch():
    with pytest.raises(SynthesisError) as e:
        network.run_step("compiled", device="cpu")
    msg = str(e.value)
    assert "SW0_0" in msg and "step-function form" in msg


def test_network_step_graph_still_simulates():
    r = network.run_step("coroutine")
    assert r.ok and r.correct


def test_page_rank_ports_overlap_under_the_engines():
    """page_rank's ComputeUnits fetch edges through ``read_pipelined`` on an
    async port: at depth 4 several reads are in flight at once."""
    top, args, check = APPS["page_rank"].build(edge_depth=4)
    rep = ENGINES["coroutine"](track_stats=True).run(top, *args)
    assert rep.ok and check()[0]
    ports = [s for _, kind, s in rep.interfaces if kind == "async_mmap"]
    assert len(ports) == 2
    assert all(s["max_outstanding_reads"] > 1 for s in ports)
    assert all(s["read_reqs"] == s["read_resps"] > 0 for s in ports)
    assert isinstance(args[0].data, np.ndarray)     # host buffers

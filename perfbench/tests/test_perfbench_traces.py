"""The readers of the program's own spans and counters
(``perfbench/traces.py`` and the ``metrics/*.py`` beside it): each reads a
hand-made record, none reads anything from a program without a trace, and a
CPU ``--trace 1`` run reports them beside the metrics it had."""

import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, stamped
from perfbench.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _inv(lower, capture, loop):
    return dict(wall_s=1.0, ok=True, set=0, lower_s=lower, capture_s=capture,
                loop_s=loop, program_s=capture + loop + 0.01, n_replays=10,
                n_sweeps=8)


def _summary(lower, capture, loop, scale, nodes=True):
    spans = {"invoke": 2.0, "invoke/lower": lower, "invoke/capture": capture,
             "invoke/loop": loop,
             "invoke/lower/lower.elaborate": 0.1 * scale,
             "invoke/lower/lower.count": 0.2 * scale,
             "invoke/capture/capture.warm": 0.01 * scale,
             "invoke/capture/capture.kept": 0.02 * scale,
             "invoke/capture/capture.instantiate": 0.003 * scale,
             "invoke/read": 0.004 * scale,
             "invoke/writeback": 0.005 * scale}
    counters = dict(n_replays=10 * scale, n_sweeps=8 * scale,
                    read_bytes=2_000_000 * scale)
    if nodes:
        counters.update(body_nodes_run=100 * scale, sweep_nodes=2)
    return dict(id=scale, spans=spans, counters=counters)


@pytest.fixture
def record(monkeypatch):
    """Two window invocations, a warm one before them, and their
    summaries in the program's ``RECENT`` (the warm one's too)."""
    from repro_torch.core import trace
    recent = [_summary(9.0, 9.0, 9.0, 7), _summary(0.5, 0.2, 0.1, 1),
              _summary(0.7, 0.3, 0.2, 3)]
    monkeypatch.setattr(trace, "RECENT", recent)
    return dict(invocations=[_inv(0.5, 0.2, 0.1), _inv(0.7, 0.3, 0.2)])


READS = {
    "elaborate_ms": 200.0,          # (0.1 + 0.3) / 2 s
    "count_pass_ms": 400.0,
    "capture_warm_ms": 20.0,
    "capture_kept_ms": 40.0,
    "instantiate_ms": 6.0,
    "read_ms": 8.0,
    "writeback_ms": 10.0,
    "read_mb": 4.0,                 # (2 + 6) / 2 MB
    # (100 + 2 * 10) + (300 + 2 * 30) nodes over 8 + 24 sweeps
    "nodes_per_sweep": 480 / 32,
}


@pytest.mark.parametrize("quantity", sorted(READS))
def test_reader_reads_a_hand_made_record(record, quantity):
    bench = harness.Bench(ROOT)
    got = bench.module("metrics", quantity).read(record)
    assert got == pytest.approx(READS[quantity])
    for split in ("device_bound", "host_bound"):
        assert bench.reader(f"{quantity}.{split}").read(record) == \
            pytest.approx(READS[quantity])


@pytest.mark.parametrize("quantity", sorted(READS))
def test_reader_reads_nothing_without_the_trace(record, quantity,
                                                 monkeypatch):
    """A program without the trace module (the parent of the trace), or
    an invocation whose summary is gone: no number, no exception."""
    read = harness.Bench(ROOT).module("metrics", quantity).read
    from repro_torch.core import trace
    monkeypatch.setattr(trace, "RECENT", [])
    assert read(record) is None
    monkeypatch.setattr(trace, "RECENT", [_summary(0.5, 0.2, 0.1, 1)])
    assert read(record) is None            # the second invocation's is gone
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert read(record) is None


def test_nodes_read_nothing_off_the_card(record, monkeypatch):
    from repro_torch.core import trace
    monkeypatch.setattr(trace, "RECENT", [_summary(0.5, 0.2, 0.1, 1, False),
                                          _summary(0.7, 0.3, 0.2, 3, False)])
    assert harness.Bench(ROOT).module("metrics", "nodes_per_sweep").read(
        record) is None


def test_new_metrics_entries():
    """Each quantity split as the accepted ones are: ``.device_bound`` in
    the gaussian cell, ``.host_bound`` in the two gemm cells."""
    names = {m["name"]: m for m in SPEC["per_layer"]}
    for q in READS:
        dev, host = names[f"{q}.device_bound"], names[f"{q}.host_bound"]
        assert dev["workloads"] == ["gaussian-uhd.frames"]
        assert host["workloads"] == ["gemm-13x13.tiles",
                                     "gemm-13x13-async.tiles"]
        assert dev["source"] == host["source"] == (
            "program_counter" if q in ("read_mb", "nodes_per_sweep")
            else "program_span")
        assert (ROOT / "perfbench" / "metrics" / f"{q}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_cpu_reads_the_spans(small, cell):
    """A CPU ``--trace 1`` run at the apps' small sizes: the span metrics
    sit beside the accepted ones, inside the spans those read; the capture
    and the node counts, which exist on the card only, are left out."""
    res = harness.run_cell(small, cell, 2 ** 31 + 23, 0.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert res["correct"]
    split = "." + next(m["name"] for m in SPEC["end_to_end"]
                       if m["name"] != "setup_s" and cell in m["workloads"]
                       ).split(".")[1]
    got = {k.removesuffix(split): v["value"]
           for k, v in res["metrics"].items()}
    for q in ("elaborate_ms", "count_pass_ms", "read_ms", "writeback_ms",
              "read_mb"):
        assert got[q] > 0.0
    for q in ("capture_warm_ms", "capture_kept_ms", "instantiate_ms",
              "nodes_per_sweep", "graph_us_per_replay"):
        assert q not in got
    assert got["elaborate_ms"] + got["count_pass_ms"] < got["lower_ms"]
    assert got["read_ms"] + got["writeback_ms"] < got["carry_io_ms"]


def test_stamped_regions_from_hand_made_stamps():
    """``perfbench/stamped.py``'s arithmetic: every interval less one
    stamp's cost, a replay's regions and what is left of its device
    time."""
    st = dict(stamp=(2000, 10), guards=(5000, 10), tail=(0, 0),
              fired={4: (9000, 3), 6: (1200, 4)},
              skipped={4: (2800, 7), 6: (1800, 6)},
              names={4: "a.0", 6: "b.0"}, replays=10)
    trace = SimpleNamespace(stamps=st)
    eng = SimpleNamespace(trace=trace, graph_device_s=30e-6, n_replays=10)
    r = stamped._regions(eng, plain_us=2.0)
    # one stamp: 200 ns; intervals: 10 + 10 + 7 + 13
    assert r["stamp_us"] == pytest.approx(0.2)
    assert r["guards_us_per_replay"] == pytest.approx(0.3)
    assert r["fired_us_per_replay"] == pytest.approx((10200 - 1400) / 1e4)
    assert r["skipped_us_per_replay"] == pytest.approx((4600 - 2600) / 1e4)
    assert r["tail_us_per_replay"] is None
    assert r["stamps_us_per_replay"] == pytest.approx(200 * 40 / 1e4)
    assert r["stamped_us_per_replay"] == pytest.approx(3.0)
    assert r["unattributed_us_per_replay"] == pytest.approx(
        3.0 - 0.3 - 0.88 - 0.2 - 0.8)
    assert r["on_cost_us_per_replay"] == pytest.approx(1.0)
    assert [b["body"] for b in r["bodies"]] == ["a.0", "b.0"]
    # 1 us a replay more than the plain graph over 4 intervals a replay
    assert r["stamp_us_whole"] == pytest.approx(0.25)
    assert sum(r["plain_regions_us_per_replay"].values()) == pytest.approx(
        2.0 - r["unattributed_us_per_replay"])
    assert r["bodies"][0]["us_per_fire"] == pytest.approx(2.8)
    assert r["bodies"][1]["us_per_skip"] == pytest.approx(0.1)

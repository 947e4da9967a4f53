"""``correct`` has to come out false when the timed path is broken
underneath: the rest of a run, the chip's look skipped, at the apps' small
sizes on the CPU, once for each fault a cell can have.  (No cell spans
chips and none takes a mean over a batch: those faults have no place
here.)"""

import json
import time

import pytest
import torch

from perfbench import harness
from perfbench.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(bench, cell, seed=2 ** 31 + 23, control=False,
        device=torch.device("cpu")):
    return harness.run_cell(bench, cell, seed, 0.0, False, device,
                            time.perf_counter(), control=control)


def _state_unchanged(monkeypatch):
    """Every firing's returned state is dropped: each task's state stays
    as it started."""
    from repro_torch.core.synth import _SweepProgram
    monkeypatch.setattr(_SweepProgram, "_store", lambda self, ti, out: None)


def _half_written_back(monkeypatch):
    """The write-back copies only the first half of each output's rows."""
    from repro_torch.core.synth import CompiledEngine

    def half(dst, src):
        k = max(1, dst.shape[0] // 2)
        dst[:k].copy_(src[:k])

    def writeback(self, plan, mm_final):
        for tp in plan.tasks:
            for ph in tp.phases:
                for mi in ph.mmap_stores:
                    half(plan.mmaps[mi].data, mm_final[mi])

    def writeback_ports(self, plan, written):
        for pi, out in written.items():
            half(plan.ports[pi].data, out)

    monkeypatch.setattr(CompiledEngine, "_writeback", writeback)
    monkeypatch.setattr(CompiledEngine, "_writeback_ports", writeback_ports)


def _token_altered(monkeypatch):
    """Every float token a ring takes is off by one in its first element,
    where the producer pushes it."""
    from repro_torch.kernels import ring
    plain = ring.ring_push_plain

    def push(buf, head, size, arr):
        if arr.is_floating_point():
            arr = arr.clone()
            arr.view(-1)[0] += 1.0
        return plain(buf, head, size, arr)

    monkeypatch.setattr(ring, "ring_push_plain", push)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_written_back": _half_written_back,
          "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run(small, cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values()) \
        or res["failed"] > 0


def test_gaussian_control_is_not_correct(small):
    """The control: the reference in bfloat16 in the program's place."""
    res = run(small, "gaussian-uhd.frames", control=True)
    assert res["correct"] is False
    assert min(c["value"] / c["limit"] for c in
               res["compared"].values()) > 3


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(small, cuda_device, cell):
    """On the card at the small sizes: the program is correct and its
    lower-precision control (gemm: TF32 products; gaussian: bfloat16) is
    not."""
    assert run(small, cell, device=cuda_device)["correct"]
    assert run(small, cell, control=True,
               device=cuda_device)["correct"] is False

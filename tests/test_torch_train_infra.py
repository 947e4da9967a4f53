"""The port's training infrastructure on the CPU: the data pipeline against
the reference (batches bit for bit), the checkpoint manager on torch
tensors (mirroring ``tests/test_ckpt.py`` and the checkpoint chaos test of
``tests/test_faults.py``, plus bf16 round trips), the straggler detector
against the reference, the restart protocol, and the train driver.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import make_pipeline as jax_make_pipeline
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.data.pipeline import write_token_file as jax_write_token_file
from repro.ft import StragglerDetector as JaxStragglerDetector
import repro_torch
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.core.faults import FaultPlan
from repro_torch.data import (DataConfig, TokenPipeline, make_pipeline,
                              write_token_file)
from repro_torch.ft import StragglerDetector, resume_or_init

# ---------------------------------------------------------------------------
# data pipeline: the reference's batches, exactly
# ---------------------------------------------------------------------------


def _equal_batches(a, b, n):
    for _ in range(n):
        x, y = a.next_batch(), b.next_batch()
        assert set(x) == set(y) == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=32, global_batch=8, seed=5),
    dict(vocab=50280, seq_len=64, global_batch=4, seed=0),
    dict(vocab=100, seq_len=8, global_batch=8, n_hosts=4, host_id=3,
         seed=9),
])
def test_synthetic_batches_equal_reference_and_restart(kw):
    ours, ref = make_pipeline(**kw), jax_make_pipeline(**kw)
    _equal_batches(ours, ref, 3)
    st = ours.state_dict()
    assert st == ref.state_dict() == {"step": 3}
    again = make_pipeline(**kw)
    again.load_state_dict(st)
    _equal_batches(again, ref, 2)        # restart resumes the same stream


def test_memmap_batches_equal_reference(tmp_path):
    toks = np.random.default_rng(1).integers(0, 70_000, 20_000)
    for vocab in (50_000, 70_000):       # uint16 and uint32 files
        f_ours, f_ref = tmp_path / f"o{vocab}.bin", tmp_path / f"r{vocab}.bin"
        write_token_file(f_ours, toks % vocab, vocab)
        jax_write_token_file(f_ref, toks % vocab, vocab)
        assert f_ours.read_bytes() == f_ref.read_bytes()
        kw = dict(vocab=vocab, seq_len=64, global_batch=4, source="memmap",
                  seed=2)
        ours = TokenPipeline(DataConfig(path=str(f_ours), **kw))
        ref = JaxTokenPipeline(JaxDataConfig(path=str(f_ref), **kw))
        _equal_batches(ours, ref, 3)
        b = ours.next_batch()
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_as_task_prefetch_queue_on_port_channels():
    p = make_pipeline(vocab=100, seq_len=8, global_batch=2)
    producer = p.as_task(n_batches=5)
    got = []

    def Consumer(i, sink):
        for b in i:
            sink.append(b["tokens"].shape)

    def Top(sink):
        ch = repro_torch.channel(capacity=2)    # bounded prefetch queue
        repro_torch.task().invoke(producer, ch).invoke(Consumer, ch, sink)

    rep = repro_torch.run(Top, got, engine="coroutine")
    assert rep.ok and got == [(2, 8)] * 5


def test_bad_pipeline_configs_rejected():
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=3,
                                 n_hosts=2))
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=2,
                                 source="memmap"))


# ---------------------------------------------------------------------------
# checkpoint manager (tests/test_ckpt.py on torch tensors)
# ---------------------------------------------------------------------------

def _params(v=1.0):
    return {"w": torch.full((3, 2), v),
            "b": {"inner": torch.arange(4, dtype=torch.int32)}}


def _opt(v=0.0):
    return {"mu": torch.full((3, 2), v)}


def test_save_publishes_atomically_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path)
    path = mgr.save(3, _params(), _opt(), extra={"lr": 0.1})
    assert path.name == "step_00000003" and (path / "DONE").exists()
    assert not list(tmp_path.glob("*.tmp"))
    man = json.loads((path / "DONE").read_text())
    assert man["step"] == 3 and man["extra"] == {"lr": 0.1}
    assert set(man["params"]) == {"w", "b/inner"}
    for section in ("params", "opt_state"):
        for entry in man[section].values():
            assert (path / section / entry["file"]).exists()


def test_restore_round_trips_values_and_extra(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, _params(2.5), _opt(0.5), extra={"tokens": 123})
    p, o, extra = mgr.restore(7, _params(), _opt())
    assert torch.equal(p["w"], torch.full((3, 2), 2.5))
    assert torch.equal(p["b"]["inner"], torch.arange(4, dtype=torch.int32))
    assert torch.equal(o["mu"], torch.full((3, 2), 0.5))
    assert extra == {"tokens": 123}


def test_pytree_save_load_preserves_dtypes_bf16_bit_exact(tmp_path):
    bf = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"f16": torch.ones(3, dtype=torch.float16),
            "i8": torch.arange(3, dtype=torch.int8), "bf16": bf,
            "f32": torch.randn(2)}
    man = save_pytree(tree, tmp_path / "t")
    assert man["bf16"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "t" / man["bf16"]["file"]).dtype == np.uint16
    out = load_pytree(tree, tmp_path / "t", man)
    assert {k: v.dtype for k, v in out.items()} == \
        {k: v.dtype for k, v in tree.items()}
    assert torch.equal(out["bf16"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(out["f32"], tree["f32"])
    assert torch.equal(out["i8"], tree["i8"])


def test_manager_bf16_round_trip_onto_meta_like(tmp_path):
    """The driver's restore: bf16 parameters and float32 leaves beside
    them, restored from ``meta`` shapes onto a device, bit for bit."""
    p = {"w": torch.randn(4, 4).to(torch.bfloat16),
         "A_log": torch.randn(4)}
    o = {"m": torch.randn(4, 4), "step": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, p, o)
    meta = lambda t: {k: v.to("meta") for k, v in t.items()}  # noqa: E731
    step, p2, o2, _ = mgr.restore_latest(meta(p), meta(o), device="cpu")
    assert step == 1
    for a, b in ((p, p2), (o, o2)):
        for k in a:
            assert b[k].device.type == "cpu" and b[k].dtype == a[k].dtype
            assert torch.equal(a[k], b[k])


def test_restore_latest_skips_incomplete_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _params(1.0), _opt())
    (tmp_path / "step_00000002" / "params").mkdir(parents=True)
    assert mgr.steps() == [1]
    step, p, _, _ = mgr.restore_latest(_params(), _opt())
    assert step == 1 and float(p["w"][0, 0]) == 1.0


def test_restore_latest_skips_tmp_directory(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _params(1.0), _opt())
    tmp = tmp_path / "step_00000005.tmp"
    (tmp / "params").mkdir(parents=True)
    (tmp / "DONE").write_text("{}")
    assert mgr.latest_step() == 1


def test_restore_latest_none_when_empty(tmp_path):
    assert CheckpointManager(tmp_path).restore_latest(_params(),
                                                      _opt()) is None


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _params(float(s)), _opt())
    assert mgr.steps() == [3, 4]
    assert not (tmp_path / "step_00000001").exists()


def test_async_save_then_wait_is_restorable(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(9, _params(4.0), _opt(), blocking=False)
    mgr.wait()
    assert mgr.steps() == [9]
    _, p, _, _ = mgr.restore_latest(_params(), _opt())
    assert float(p["w"][0, 0]) == 4.0


def test_async_save_snapshots_before_return(tmp_path):
    """Updating the live tensors in place right after
    ``save(..., blocking=False)`` returns does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    params = _params(1.0)
    mgr.save(1, params, _opt(), blocking=False)
    params["w"].fill_(-999.0)
    mgr.wait()
    _, p, _, _ = mgr.restore_latest(_params(), _opt())
    assert float(p["w"][0, 0]) == 1.0


def test_second_save_waits_for_inflight_write(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as M
    mgr = CheckpointManager(tmp_path)
    release = threading.Event()
    orig = M.save_pytree

    def slow_save(tree, directory):
        if directory.name == "params" and "00000001" in str(directory):
            release.wait(timeout=10)
        return orig(tree, directory)

    monkeypatch.setattr(M, "save_pytree", slow_save)
    mgr.save(1, _params(1.0), _opt(), blocking=False)
    t = threading.Thread(target=lambda: mgr.save(2, _params(2.0), _opt()))
    t.start()
    time.sleep(0.05)
    assert mgr.steps() == []              # save(2) parked behind save(1)
    release.set()
    t.join(timeout=10)
    assert not t.is_alive() and mgr.steps() == [1, 2]


def test_resave_same_step_overwrites(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _params(1.0), _opt())
    mgr.save(5, _params(2.0), _opt())
    _, p, _, _ = mgr.restore_latest(_params(), _opt())
    assert float(p["w"][0, 0]) == 2.0 and mgr.steps() == [5]


def test_async_write_failure_reraised_at_wait(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as M

    def bad_save(tree, path):
        raise OSError("disk full")

    monkeypatch.setattr(M, "save_pytree", bad_save)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _params(), _opt(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                            # consumed: the next wait is clean
    assert mgr.steps() == []


def test_ckpt_truncation_skipped_io_retried(tmp_path):
    inj = FaultPlan(ckpt_io_errors=1, ckpt_truncate=(2,)).injector()
    mgr = CheckpointManager(tmp_path, keep=3, faults=inj)
    params = {"w": torch.arange(8, dtype=torch.float32)}
    opt = {"m": torch.zeros(8)}
    mgr.save(1, params, opt, extra={"step": 1})
    mgr.save(2, {"w": params["w"] * 2}, opt, extra={"step": 2})
    assert any(e[0] == "io_error" for e in inj.log)      # write retried
    assert any(e[0] == "ckpt_truncate" for e in inj.log)
    assert mgr.verify(2) and mgr.verify(1) == []
    step, p, _, extra = mgr.restore_latest(params, opt)
    assert step == 1 and extra["step"] == 1
    assert torch.equal(p["w"], params["w"])


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_detector_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 5.0, 5.2, 5.1, 1.0, 0.95, 9.0, 1.0]
    ours, ref = StragglerDetector(), JaxStragglerDetector()
    assert [ours.observe(t) for t in times] == \
        [ref.observe(t) for t in times]
    assert (ours.flagged, ours.mean, ours.var) == \
        (ref.flagged, ref.mean, ref.var)


def test_resume_or_init(tmp_path):
    mgr = CheckpointManager(tmp_path)
    calls = []

    def init():
        calls.append(1)
        return _params(3.0), _opt(1.0)

    start, p, o, extra = resume_or_init(mgr, init, _params(), _opt())
    assert (start, extra, calls) == (0, {}, [1])
    mgr.save(4, p, o, extra={"data": {"step": 4}})
    start, p2, _, extra = resume_or_init(mgr, init, _params(), _opt())
    assert (start, extra, calls) == (4, {"data": {"step": 4}}, [1])
    assert torch.equal(p2["w"], p["w"])


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def test_train_cli_mamba2_kernel_checkpoint_and_resume(tmp_path):
    """Six steps of reduced Mamba2 through the kernels' path on the CPU,
    checkpoints at 3 and 6; the same command again resumes at 6 and runs
    no step."""
    from repro_torch.launch.train import train
    args = ["--device", "cpu", "--arch", "mamba2-130m", "--reduced",
            "--use-kernel", "--steps", "6", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
            "--metrics", str(tmp_path / "m.jsonl")]
    assert train(args) == 0
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.steps() == [3, 6]
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 7))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    man = json.loads((tmp_path / "ck" / "step_00000006" / "DONE")
                     .read_text())
    assert man["extra"] == {"data": {"step": 6}}
    assert man["opt_state"]["step"]["dtype"] == "int32"
    assert train(args) == 0               # resumes at 6: nothing to do
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 6

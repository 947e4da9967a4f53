"""Checkpointing: atomic, resumable, async-capable, on torch tensors.

The port's copy of the reference's ``ckpt/manager.py`` with the same
guarantees:

* **Atomicity** — a half-written checkpoint is never restorable: write
  into ``step_XXXXXXXX.tmp`` and ``os.rename`` at the end (atomic on
  POSIX), with a ``DONE`` marker carrying a content manifest (sha256 of
  every leaf file).
* **Restartability** — ``restore_latest`` scans for the newest complete
  step whose files match their digests; incomplete or corrupt steps are
  skipped, so a job killed mid-save restarts from the previous good
  step.
* **Async** — ``save(..., blocking=False)`` copies every tensor to host
  memory before it returns and writes in a daemon thread, overlapping
  I/O with the next training steps; ``wait()`` joins (and re-raises the
  writer's failure) before the next save.
* **Chaos** — ``faults=`` (a :class:`repro_torch.core.faults.FaultPlan`
  or its injector) injects transient write failures (one retry absorbs
  one) and post-publish truncation.

One ``.npy`` per leaf.  numpy has no bfloat16, so a bf16 tensor is
written as its 2-byte pattern (``uint16``) and the manifest names its
dtype; restore views the pattern as bf16 again, bit for bit.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import map_named, named_leaves, tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array to write, dtype name for the manifest) of a host tensor."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor a stored array holds (a bf16 leaf's 2-byte pattern is
    viewed as bf16 again)."""
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _file_name(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def save_pytree(tree: Any, directory: Path) -> dict:
    """Write one tree of tensors; returns the manifest.

    Each leaf's entry records the sha256 of its ``.npy`` file bytes, and
    every file is read back and compared after writing (verify-after-
    write): a torn or silently failed write is caught here, while the
    data is still in memory, rather than at restore time.
    """
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, leaf in named_leaves(tree):
        arr, dtype_name = _to_numpy(leaf.detach().cpu())
        fn = _file_name(name)
        data = _npy_bytes(arr)
        digest = hashlib.sha256(data).hexdigest()
        path = directory / fn
        for attempt in (0, 1):
            path.write_bytes(data)
            if hashlib.sha256(path.read_bytes()).hexdigest() == digest:
                break
            if attempt:
                raise OSError(f"verify-after-write failed for {path}")
        manifest[name] = {"file": fn, "shape": list(arr.shape),
                          "dtype": dtype_name, "sha256": digest}
    return manifest


def load_pytree(like: Any, directory: Path, manifest: dict,
                device=None) -> Any:
    """Read a tree saved by :func:`save_pytree` with its ``manifest``,
    shaped like ``like`` (a tree of tensors, ``meta`` ones included),
    each leaf in ``like``'s dtype, on ``device`` (default: each ``like``
    leaf's own device)."""
    def load(name: str, leaf: torch.Tensor) -> torch.Tensor:
        ent = manifest[name]
        t = _from_numpy(np.load(directory / ent["file"]), ent["dtype"])
        return t.to(device if device is not None else leaf.device,
                    leaf.dtype)
    return map_named(load, like)


class CheckpointManager:
    """Keep-last-k atomic checkpoints of {params, opt_state, extra-state}."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 faults: Any = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # chaos harness (repro_torch.core.faults): injected transient write
        # failures and post-publish truncation; None in normal operation
        if faults is not None and not hasattr(faults, "io_error"):
            faults = faults.injector()
        self.faults = faults
        self._thread: Optional[threading.Thread] = None
        self._thread_exc: Optional[BaseException] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[dict] = None, blocking: bool = True) -> Path:
        """Snapshot to host memory now; write (possibly async) to disk."""
        self.wait()

        # synchronous snapshot: a copy the training loop cannot reach, so
        # it may update its tensors in place right after this returns
        def _snap(x):
            return x.detach().to("cpu", copy=True)

        host_p = tree_map(_snap, params)
        host_o = tree_map(_snap, opt_state)
        extra = dict(extra or {})

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            # one retry on a transient IO failure: the snapshot is still in
            # host memory, so a failed attempt only costs a rewrite of the
            # staging dir (a second failure propagates — that's persistent)
            for attempt in (0, 1):
                try:
                    if self.faults is not None and \
                            self.faults.io_error("ckpt"):
                        raise OSError(
                            "injected transient checkpoint IO failure")
                    if tmp.exists():
                        shutil.rmtree(tmp)
                    man = {
                        "step": step,
                        "time": time.time(),
                        "params": save_pytree(host_p, tmp / "params"),
                        "opt_state": save_pytree(host_o, tmp / "opt_state"),
                        "extra": extra,
                    }
                    (tmp / "DONE").write_text(json.dumps(man))
                    break
                except OSError:
                    shutil.rmtree(tmp, ignore_errors=True)
                    if attempt:
                        raise
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)            # atomic publish
            if self.faults is not None:
                self._maybe_truncate(final, step)
            self._gc()

        if blocking:
            write()
        else:
            # a daemon thread swallows exceptions by default; capture the
            # first failure so wait() (and therefore the next save()) can
            # re-raise it instead of silently dropping the step
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 - re-raised in wait
                    self._thread_exc = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        return self.dir / f"step_{step:08d}"

    def wait(self) -> None:
        """Join the in-flight async write, re-raising its failure (if any).

        An async save that died in the background — persistent IO error,
        full disk — would otherwise look exactly like a successful save
        until restore time; surfacing it at the next synchronization point
        keeps the at-most-one-lost-step contract honest.
        """
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._thread_exc is not None:
            exc, self._thread_exc = self._thread_exc, None
            raise exc

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def _maybe_truncate(self, final: Path, step: int) -> None:
        """Chaos-only: truncate one data file of a *published* checkpoint
        (simulating corruption after the atomic rename — the case atomicity
        cannot defend against), proving ``restore_latest`` skips it."""
        if not self.faults.truncate_step(step):
            return
        npys = sorted(final.rglob("*.npy"))
        if npys:
            data = npys[0].read_bytes()
            npys[0].write_bytes(data[:max(1, len(data) // 2)])

    # -- read ----------------------------------------------------------------
    def steps(self) -> list[int]:
        """Complete (DONE-marked) checkpoint steps, ascending."""
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "DONE").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, params_like: Any, opt_like: Any,
                device=None) -> tuple:
        """Returns (params, opt_state, extra), each leaf in its ``like``'s
        dtype, on ``device`` (default: the ``like`` leaf's device)."""
        d = self.dir / f"step_{step:08d}"
        man = json.loads((d / "DONE").read_text())
        p = load_pytree(params_like, d / "params", man["params"], device)
        o = load_pytree(opt_like, d / "opt_state", man["opt_state"], device)
        return p, o, man.get("extra", {})

    def verify(self, step: int) -> list:
        """Integrity-check one published step against its manifest digests.

        Returns a list of ``(file, problem)`` tuples — empty means sound.
        """
        d = self.dir / f"step_{step:08d}"
        try:
            man = json.loads((d / "DONE").read_text())
        except Exception as e:  # noqa: BLE001 - any unreadable manifest
            return [("DONE", repr(e))]
        bad = []
        for part in ("params", "opt_state"):
            for name, ent in man.get(part, {}).items():
                p = d / part / ent["file"]
                if not p.exists():
                    bad.append((f"{part}/{ent['file']}", "missing"))
                    continue
                want = ent.get("sha256")
                if want is not None and \
                        hashlib.sha256(p.read_bytes()).hexdigest() != want:
                    bad.append((f"{part}/{ent['file']}", "digest mismatch"))
        return bad

    def restore_latest(self, params_like: Any, opt_like: Any,
                       device=None) -> Optional[tuple]:
        """Restore the newest step that passes integrity verification:
        ``(step, params, opt_state, extra)``, or None.

        A published-then-corrupted step (truncated file, digest mismatch,
        unreadable manifest) is skipped and the scan falls back to the
        previous good step — the crash-mid-save guarantee, extended to
        post-publish corruption.
        """
        for step in reversed(self.steps()):
            if self.verify(step):
                continue
            return (step, *self.restore(step, params_like, opt_like, device))
        return None

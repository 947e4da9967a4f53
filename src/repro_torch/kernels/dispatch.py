"""Device routing and launch counts for the port's kernels.

One rule decides how a kernel-backed op runs, and nothing else chooses:

* tensors on a CUDA device launch the hand-written kernel, or the op
  raises;
* tensors on the CPU take the op's plain PyTorch version, and so do
  ``meta`` tensors (shape-only, in synthesis's counting pass).

There is no option, environment variable or fallback that sends a CUDA
tensor to a plain version.  Each wrapper adds one to its op's count where
it launches its kernel and nowhere else, so a run can show which kernels
its path went through (:func:`reset_launches` / :func:`launch_counts`).
"""

from __future__ import annotations

import torch

_launches: dict = {}


def uses_kernel(op: str, *tensors: torch.Tensor) -> bool:
    """True when ``op`` must launch its CUDA kernel on ``tensors``, False
    when it takes its plain version (CPU or meta).  Raises on mixed
    devices or any other device type."""
    if all(t.is_cuda for t in tensors) and \
            len({t.get_device() for t in tensors}) == 1:
        return True             # the hot path: no device objects built
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{op}: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {dev}")


def count_launch(op: str) -> None:
    _launches[op] = _launches.get(op, 0) + 1


def reset_launches() -> None:
    _launches.clear()


def launch_counts() -> dict:
    """``{op: kernel launches}`` since the last :func:`reset_launches`."""
    return dict(_launches)

"""Device routing and launch counts for the port's kernels.

One rule decides how a kernel-backed op runs, and nothing else chooses:

* tensors on a CUDA device launch the hand-written kernel, or the op
  raises;
* tensors on the CPU take the op's plain PyTorch version, and so do
  ``meta`` tensors (shape-only, in synthesis's counting pass).

There is no option, environment variable or fallback that sends a CUDA
tensor to a plain version.  A launch is counted once, and only a launch,
so a run can show which kernels its path went through
(:func:`reset_launches` / :func:`launch_counts`):

* a wrapper whose kernel launches from the host adds one to its op's
  count where it launches it (:func:`count_launch`);
* kernels that also run inside a replayed CUDA graph, where no wrapper
  runs, count themselves on the card: each launch adds one to its op's
  entry of a device counter (:func:`add_device_counters`; the ring
  kernels of ``csrc/ring.cu``), which :func:`launch_counts` reads and
  :func:`reset_launches` zeroes.
"""

from __future__ import annotations

import torch

_launches: dict = {}
_device_counters: list = []     # [(ops, counters)], add_device_counters


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


def add_device_counters(ops: tuple, counters: torch.Tensor) -> None:
    """Count the launches of ``ops`` in ``counters``, an int64
    ``[len(ops)]`` tensor that their kernels advance themselves, one a
    launch, in that order."""
    _device_counters.append((tuple(ops), counters))


def reset_launches() -> None:
    _launches.clear()
    for _, counters in _device_counters:
        counters.zero_()


def launch_counts() -> dict:
    """``{op: kernel launches}`` since the last :func:`reset_launches`;
    reading a device's counters waits for its current stream."""
    out = dict(_launches)
    for ops, counters in _device_counters:
        for op, n in zip(ops, counters.tolist()):
            if n:
                out[op] = out.get(op, 0) + n
    return out

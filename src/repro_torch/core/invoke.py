"""Unified system-integration interface (paper Section 3.1.4).

TAPA's host-side insight: offloading to the accelerator should be *one
function call* — the same source line runs software simulation, hardware
simulation, and on-board execution, selected by the target argument.

On one card::

    result = repro_torch.invoke(Top, args...,           # one call
                                target="sim")           # run-to-block sim
    result = repro_torch.invoke(Top, args..., target="compiled",
                                device="cuda")          # compiled stages

``target="sim"`` runs the task graph under a simulation engine (the
correctness-verification cycle, seconds).  ``target="compiled"`` elaborates
the graph once and hierarchically compiles every unique leaf stage
definition (Section 3.3) on ``device`` (the card unless the caller names
another), then returns the elaboration's result, as the reference does.
Metadata (graph topology, shape signatures) is extracted automatically
from the elaboration run — the analogue of TAPA's Clang pass over kernel
source.
"""

from __future__ import annotations

from typing import Any, Callable

from .channel import Channel
from .engines import ENGINES
from .errors import Deadlock
from .graph import elaborate
from .hier_compile import StageInstance, compile_stages


_DROP = object()


def _strip_channels(a: Any) -> Any:
    """Channels (and channel-only containers) become _DROP; containers
    mixing channels with other values keep the non-channel members."""
    if isinstance(a, Channel):
        return _DROP
    if isinstance(a, (list, tuple)):
        kept = [v for v in (_strip_channels(x) for x in a) if v is not _DROP]
        if not kept and a:
            return _DROP            # container held only channels
        return type(a)(kept) if isinstance(a, tuple) else kept
    if isinstance(a, dict):
        kept = {k: v for k, v in ((k, _strip_channels(x))
                                  for k, x in a.items()) if v is not _DROP}
        if not kept and a:
            return _DROP
        return kept
    return a


def _stage_args(args: tuple, kwargs: dict) -> tuple[tuple, dict]:
    """Project a task instance's invoke args onto what its compiled stage
    receives: channels vanish (their traffic becomes dataflow wiring),
    while mmap/async_mmap/scalar interface args — and plain values — carry
    through, positionally and by keyword.  The interface objects
    themselves are kept: the structural key then hashes them by aval, and
    execution feeds their buffer
    (``compile_cache.lower_spec``/``runtime_value``)."""
    a = tuple(v for v in (_strip_channels(x) for x in args)
              if v is not _DROP)
    k = {key: v for key, v in ((key, _strip_channels(x))
                               for key, x in kwargs.items())
         if v is not _DROP}
    return a, k


def invoke(top: Callable, *args, target: str = "sim",
           engine: str = "coroutine", device: Any = None,
           compile_mode: str = "hierarchical", **kwargs) -> Any:
    """Call a top-level task as a plain function (paper Listing: "a single
    function invocation of the synthesized FPGA bitstream").

    Returns the top-level task's return value.  Raises
    :class:`~repro_torch.core.errors.Deadlock` (and friends) on simulation
    failure instead of returning a report — this *is* the host API, not the
    debugging API (use :func:`repro_torch.run` for the full SimReport).
    """
    if target == "sim":
        rep = ENGINES[engine]().run(top, *args, **kwargs)
        if not rep.ok:
            raise Deadlock(f"simulation failed: {rep.error}")
        return rep.result

    if target == "compiled":
        # Elaborate (extract metadata), then compile each unique stage
        # definition once on the device.
        graph = elaborate(top, *args, engine=engine, **kwargs)
        if graph.report is not None and not graph.report.ok:
            raise Deadlock(f"elaboration failed: {graph.report.error}")
        stages = []
        for i in graph.instances:
            if i.children:
                continue
            sa, sk = _stage_args(i.args, i.kwargs)
            stages.append(StageInstance(fn=i.fn, args=sa, kwargs=sk,
                                        name=i.name))
        compile_stages(stages, mode=compile_mode, device=device)
        return graph.report.result

    raise ValueError(f"unknown target {target!r}; use 'sim' or 'compiled'")

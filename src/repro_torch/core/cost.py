"""Cost probes: the FLOPs and bytes of one firing of a step task's phase.

The floorplanner (:mod:`repro_torch.core.floorplan`) prices every
:class:`~repro_torch.core.synth.StepTask` firing with these, so that its
balance-and-cut objective has real weights for each task instead of a hash
of the task's name (:func:`task_cost` / :func:`phase_cost`).  The
counterpart of the reference's ``core/cost.py``, whose ``phase_cost``
reads XLA's ``cost_analysis`` of the lowered firing.  :func:`probe_compiled`
prices a whole sharded step, the LM side's dry run (``launch.dryrun``).

A phase is priced by one firing on ``meta`` tensors: synthesis's counting
pass (``synth._count_phase``) run under a ``TorchDispatchMode`` that sees
every aten operation the firing dispatches, ring ops and mmap transfers
included.

* FLOPs: the formulas of ``torch.utils.flop_counter`` for the
  matmul-class operations (``mm``, ``bmm``, ``addmm``, convolutions,
  attention: ``2 m n k`` for a product), plus one a result element for
  every other pointwise operation with a floating-point result.  Integer
  arithmetic (ring indices, counters) is not floating point and a copy
  (``clone``) is not arithmetic: a task that only moves tokens costs 0
  FLOPs.
* bytes: each operation's tensor inputs and outputs, once each; views
  and allocations move nothing and are not counted.  An indexed read or
  in-place write (``index_select``, ``index_copy_``, ``index_add_``,
  ``index_put_``: a ring's pop and push) moves the rows it touches, not
  the whole tensor it indexes: a pop of ``n`` tokens from a ring of
  ``cap`` costs ``n`` tokens, whatever ``cap`` is.
* ``coll``: 0.  A firing is local to its partition by construction; the
  traffic a placement causes is priced per channel by the floorplanner.

A cell is memoized in this process and in the compile cache's JSON store
(``memo_get``/``memo_put``) under :func:`phase_key`: the phase function's
structural digest plus the specs of what it is bound to, so editing one
task definition dirties exactly its own cells.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .compile_cache import (_dtype_name, _stable_repr, default_cache,
                            instance_key, structural_digest)
from .synth import (_ChanRef, _MMapRef, _PortRef, _count_phase, _tree_map,
                    canon_dtype)

COST_SCHEMA = "cost1"

# The card's data-sheet rates, H100 80GB HBM3 (SXM5), 700 W: the
# floorplan objective converts FLOPs, bytes and cut bytes into seconds
# with these, so that compute seconds and interconnect seconds compare.
# Task math is float32 with TF32 off, so the float32 CUDA-core rate; the
# interconnect is NVLink 4, one direction.  A placement uses only their
# ratios.
HW = {"peak_flops": 67e12, "hbm_bw": 3.35e12, "ici_bw": 450e9,
      "hbm_capacity": 80e9}

# in-process cost cells (the disk memo's first level): key -> result
_CELLS: dict[str, dict] = {}

_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default}
_COPIES = {torch.ops.aten.clone.default}
_aten = torch.ops.aten


def _index_put_rows(x, indices, values, accumulate=False) -> int:
    """Bytes of ``x[indices] = values`` (``+=`` with ``accumulate``): the
    elements it writes (read too when it accumulates), the values and the
    indices; a boolean mask's elements are not known on meta tensors, so
    such a write is charged the whole of ``x``."""
    idx = [i for i in indices if i is not None]
    if any(i.dtype == torch.bool for i in idx):
        return 2 * _tensor_bytes(x) + _tensor_bytes((idx, values))
    rows = torch.Size(torch.broadcast_shapes(*(i.shape for i in idx)))
    rest = [n for i, n in enumerate(x.shape)
            if i >= len(indices) or indices[i] is None]
    moved = rows.numel() * int(np.prod(rest, dtype=np.int64)) \
        * x.element_size()
    return (1 + bool(accumulate)) * moved + _tensor_bytes((idx, values))


# the bytes of an indexed read or in-place write, from its arguments
# (its rows, its index and its source) instead of the tensor it indexes
_INDEXED = {
    _aten.index_select.default:
        lambda x, dim, index, out: _tensor_bytes(index) + 2 * (
            _tensor_bytes(out)),
    _aten.index_copy_.default:
        lambda x, dim, index, src, out: _tensor_bytes(index) + 2 * (
            _tensor_bytes(src)),
    _aten.index_add_.default:
        lambda x, dim, index, src, out, alpha=1: _tensor_bytes(index) + 3 * (
            _tensor_bytes(src)),
    _aten.index_put_.default:
        lambda x, indices, values, accumulate=False, out=None:
            _index_put_rows(x, indices, values, accumulate),
}


def clear_cost_cells() -> None:
    """Drop the in-process cost cells (tests, timings)."""
    _CELLS.clear()


def _tensor_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _CostMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten operations dispatched
    under it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _ALLOCATIONS:
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags and func not in _COPIES:
            self.flops += sum(x.numel() for x in tree_leaves(out)
                              if isinstance(x, torch.Tensor)
                              and (x.is_floating_point() or x.is_complex()))
        indexed = _INDEXED.get(func)
        if indexed is not None:
            self.bytes += indexed(*args, out=out, **kwargs)
        else:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def _template_sig(plan, t: Any) -> Any:
    """Stable signature of one bound argument template: everything that
    shapes a firing except the phase function itself, which the key
    hashes by its structural digest."""
    if isinstance(t, _ChanRef):
        c = plan.channels[t.ci]
        return ("chan", c.capacity, str(canon_dtype(c.dtype)),
                tuple(c.shape))
    if isinstance(t, _MMapRef):
        m = plan.mmaps[t.mi]
        return ("mmap", tuple(m.shape), _dtype_name(m.dtype))
    if isinstance(t, _PortRef):
        p = plan.ports[t.pi]
        return ("port", tuple(p.shape), _dtype_name(p.dtype), p.latency,
                p.depth)
    if isinstance(t, (list, tuple)):
        return ("seq",) + tuple(_template_sig(plan, x) for x in t)
    return ("const", _stable_repr(t))


def phase_key(plan, tp, ph) -> str:
    """The cost cell's content address: the phase function's digest, the
    specs of what the task is bound to, its state's spec and the
    toolchain.  Nothing outside this task's definition and its bindings'
    shapes enters it, so editing another task, or rewiring another corner
    of the graph, leaves this cell warm."""
    sig = (tuple(_template_sig(plan, t) for t in tp.t_args),
           tuple(sorted((k, _template_sig(plan, t))
                        for k, t in tp.t_kwargs.items())))
    state = _stable_repr(_tree_map(
        lambda x: (tuple(x.shape), _dtype_name(x.dtype)), tp.state0))
    return instance_key(ph.fn, (), {}, device="cpu",
                        extra=("step_cost", COST_SCHEMA, ph.label, sig,
                               state))


def phase_cost(plan, tp, ph, *, cache: Any = None) -> dict:
    """``{"flops", "bytes", "coll"}`` of one firing of phase ``ph`` of
    task plan ``tp``, memoized under :func:`phase_key` (``cache``: the
    default compile cache for ``None``, none for ``False``)."""
    key = phase_key(plan, tp, ph)
    hit = _CELLS.get(key)
    if hit is not None:
        return hit
    cc = default_cache() if cache is None else (cache or None)
    if cc is not None:
        hit = cc.memo_get(key)
        if hit is not None:
            _CELLS[key] = hit
            return hit
    with _CostMode() as mode:
        _count_phase(plan, tp, ph.label, ph.fn, ph.count)
    out = {"flops": float(mode.flops), "bytes": float(mode.bytes),
           "coll": 0.0}
    _CELLS[key] = out
    if cc is not None:
        cc.memo_put(key, out)
    return out


def task_cost(plan, tp, *, cache: Any = None, hw: Optional[dict] = None
              ) -> dict:
    """Whole-run cost of one task instance: each phase's firing cost times
    its firings, and the roofline ``seconds`` the floorplan objective
    balances."""
    hw = hw or HW
    tot = {"flops": 0.0, "bytes": 0.0, "coll": 0.0}
    per_phase = []
    for ph in tp.phases:
        c = phase_cost(plan, tp, ph, cache=cache)
        per_phase.append({"label": ph.label, "count": ph.count, **c})
        for k in tot:
            tot[k] += c[k] * ph.count
    seconds = (tot["flops"] / hw["peak_flops"]
               + tot["bytes"] / hw["hbm_bw"]
               + tot["coll"] / hw["ici_bw"])
    return {**tot, "seconds": seconds, "phases": per_phase}


def graph_cost_salt(plan) -> str:
    """Digest of every task's phase-function digests: a cheap way for a
    placement artifact to notice a task edit without probing again."""
    h = hashlib.sha256()
    for tp in plan.tasks:
        for ph in tp.phases:
            h.update(structural_digest(ph.fn).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# whole sharded steps (the dry run's price list)
# ---------------------------------------------------------------------------

# the funcol collectives DTensor issues, by the reference's HLO names
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _kernel_flops(func, args) -> float:
    """FLOPs of the port's kernel operators (``repro_torch::*_fwd``), which
    ``torch.utils.flop_counter`` does not know: a full (unmasked) product
    count, as XLA's ``cost_analysis`` counts a masked dot."""
    name = func.overloadpacket._qualified_op_name
    if name == "repro_torch::flash_attention_fwd":
        q, k = args[0], args[1]
        B, Sq, nh, hd = q.shape
        return 4.0 * B * Sq * k.shape[1] * nh * hd
    if name in ("repro_torch::decode_attention_fwd",
                "repro_torch::decode_attention_lse_fwd"):
        q, k = args[0], args[1]
        return 4.0 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
    if name == "repro_torch::ssd_scan_fwd":
        xdt, Bm, chunk = args[0], args[2], args[5]
        B, S, H, P = xdt.shape
        N = Bm.shape[3]
        q = min(chunk, S)
        # intra-chunk C.B and its product with x, chunk states, the
        # inter-chunk output
        return 2.0 * B * S * H * (q * (N + P) + 2 * P * N)
    return 0.0


class _StepMode(_CostMode):
    """:class:`_CostMode` over the local shards of a sharded step: an op
    on DTensors is left to DTensor (``NotImplemented``), which desugars it
    into local ops and collectives seen here.  Also records each
    collective (kind, result bytes, group ranks) and the live bytes of
    the tensors the step makes (their storages, peak kept)."""

    def __init__(self):
        super().__init__()
        self.collectives: list = []
        self.live = self.peak = 0
        self._seen: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..dtensor import is_dtensor
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs each new op once at its
            # global shapes under a fake mode to learn the output's
            # metadata: not this rank's work (the step itself runs outside
            # any fake mode, on fake local shards)
            return func(*args, **kwargs)
        if any(is_dtensor(a) for a in tree_leaves((args, kwargs))):
            return NotImplemented
        kind = _COLLECTIVES.get(func.overloadpacket.__name__) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            out = func(*args, **kwargs)
            self.collectives.append(dict(
                kind=kind, bytes=_tensor_bytes(out),
                ranks=_group_ranks(args[-1])))
            self._track(out)
            return out
        if func.namespace == "repro_torch":
            out = func(*args, **kwargs)
            self.flops += _kernel_flops(func, args)
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        else:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        if not func.is_view:
            self._track(out)
        return out

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n


def _group_ranks(group_name: str) -> list:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def probe_compiled(fn: Callable, args: tuple = (), kwargs=None, *,
                   memo_key: Optional[str] = None, cache: Any = None,
                   pod_size: Optional[int] = None) -> dict:
    """Run ``fn(*args)`` once, a sharded step on DTensors whose local
    shards are fake (``FakeTensorMode``, a fake process group: nothing
    is computed or sent), and return its cost a rank.

    ``{"flops", "bytes", "coll", "arg_bytes", "temp_bytes",
    "collectives"}``: ``flops`` by ``torch.utils.flop_counter``'s formulas
    (and :func:`_kernel_flops` for the kernels) on the local shapes;
    ``bytes`` each local op's inputs and outputs once; ``coll`` the total
    of ``collectives`` (:func:`repro_torch.launch.dryrun.collective_bytes`
    of the traced collectives); ``arg_bytes`` the local shard bytes of the
    inputs; ``temp_bytes`` an estimate — the peak of the live bytes of
    the local tensors the step made, as the fake tensors' storages came
    and went, where XLA reports its buffer assignment.  With ``memo_key``
    the result is memoized in ``cache`` (default: the process compile
    cache; ``cache=False`` disables it), and a hit runs nothing.
    """
    from ..launch.dryrun import collective_bytes
    cc = default_cache() if cache is None else (cache or None)
    if memo_key is not None and cc is not None:
        hit = cc.memo_get(memo_key)
        if hit is not None:
            return hit
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        raise RuntimeError(
            "probe_compiled: call it outside a FakeTensorMode (its inputs "
            "may be fake tensors): inside one, the ops DTensor runs at "
            "global shapes to propagate its layouts look like the step's")
    arg_bytes = sum(_local_bytes(a) for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor))
    with _StepMode() as mode:
        out = fn(*args, **(kwargs or {}))
    del out
    coll = collective_bytes(mode.collectives, pod_size=pod_size)
    res = {"flops": float(mode.flops), "bytes": float(mode.bytes),
           "coll": float(coll["total_bytes"]), "arg_bytes": int(arg_bytes),
           "temp_bytes": int(mode.peak), "temp_bytes_is": "estimate",
           "collectives": coll}
    if memo_key is not None and cc is not None:
        cc.memo_put(memo_key, res)
    return res


def _local_bytes(t: torch.Tensor) -> int:
    from ..dtensor import is_dtensor
    t = t.to_local() if is_dtensor(t) else t
    return t.numel() * t.element_size()

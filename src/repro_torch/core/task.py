"""Task instantiation interface (paper Section 3.1.3, Listing 5).

A *task* is a plain Python function.  A *parent* task instantiates channels
and child tasks::

    def PageRank(...):
        vertex_req = repro_torch.channel(capacity=2)
        repro_torch.task() \
            .invoke(VertexHandler, vertex_req, ..., detach=True) \
            .invoke(Ctrl, vertex_req, ...)

mirroring ``tapa::task().invoke<tapa::detach>(...)``.  Children are spawned
immediately on ``invoke`` by the active engine; the parent joins all
non-detached children when its body returns (TAPA joins at the destructor of
the ``tapa::task()`` temporary — end-of-body is the Python analogue and is
also what ``with repro_torch.task() as t:`` gives explicitly).

Interface binding (Section 3.1.2, Table 2): a ``Channel`` argument is
converted to an :class:`IStream` or :class:`OStream` view according to the
callee's parameter annotation; unannotated parameters receive a lazy
``AutoStream`` that binds its direction on first use.  ``MMap`` /
``AsyncMMap`` arguments bind as external-memory interfaces (a raw ndarray
passed for an ``MMap``-annotated parameter is wrapped on the way in),
``Scalar`` wrappers unwrap to their value, and plain Python scalars are
recorded as scalar interfaces.  Every binding registers endpoints for
graph metadata extraction (Section 3.4) — the per-definition interface
table — and is validated to the one-producer/one-consumer rule for
channels, the one-writer rule for mmaps, and the one-port rule for
async_mmaps (Section 3.1.1).
"""

from __future__ import annotations

import inspect
import itertools
from typing import Any, Callable, Optional

import numpy as np
import torch

from .channel import Channel, IStream, OStream
from .context import current_builder_stack, current_runtime, current_task
from .errors import ChannelMisuse
from .interface import (AsyncMMap, Interface, InterfaceBinding, MMap,
                        Scalar)

_inst_uid = itertools.count()


class TaskInstance:
    """One instantiation of a task definition (paper Table 3 distinguishes
    #Tasks from #Task Instances; this is the latter)."""

    __slots__ = ("uid", "fn", "args", "kwargs", "detach", "name", "parent",
                 "children", "state", "error", "level", "interfaces",
                 "wait_site")

    def __init__(self, fn: Callable, args: tuple, kwargs: dict,
                 detach: bool, parent: Optional["TaskInstance"],
                 name: Optional[str] = None):
        self.uid = next(_inst_uid)
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.detach = detach
        self.name = name or f"{getattr(fn, '__name__', 'task')}#{self.uid}"
        self.parent = parent
        self.children: list[TaskInstance] = []
        self.state = "created"   # created/running/blocked/finished/failed
        self.error: Optional[BaseException] = None
        self.wait_site: Optional[str] = None  # "read <chan>" etc. while blocked
        self.level = 0 if parent is None else parent.level + 1
        # per-parameter interface table (kind/dtype/direction), filled by
        # bind_streams — the row data behind Graph.definitions[*].interfaces
        self.interfaces: list[InterfaceBinding] = []

    @property
    def definition(self) -> Callable:
        """The task *definition* this instance stems from.  Hierarchical
        code generation (Section 3.3) compiles per-definition, not
        per-instance."""
        return self.fn

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<TaskInstance {self.name} {self.state}>"


class AutoStream:
    """Direction-unbound stream view; binds to IStream/OStream on first use.

    Used when a child's parameter has no IStream/OStream annotation.
    """

    def __init__(self, chan: Channel, owner: TaskInstance):
        self._chan = chan
        self._owner = owner
        self._view: Any = None

    def _as(self, cls):
        if self._view is None:
            side = "consumer" if cls is IStream else "producer"
            self._chan._bind(side, self._owner)
            self._view = cls(self._chan)
        elif not isinstance(self._view, cls):
            raise ChannelMisuse(
                f"task {self._owner.name} uses channel {self._chan.name!r} "
                f"as both producer and consumer")
        return self._view

    @property
    def channel(self) -> Channel:
        return self._chan

    # consumer ops
    def empty(self): return self._as(IStream).empty()
    def read(self): return self._as(IStream).read()
    def read_burst(self, n): return self._as(IStream).read_burst(n)
    def read_transaction(self): return self._as(IStream).read_transaction()
    def peek(self): return self._as(IStream).peek()
    def eot(self): return self._as(IStream).eot()
    def open(self): return self._as(IStream).open()
    def try_read(self): return self._as(IStream).try_read()
    def try_read_burst(self, n): return self._as(IStream).try_read_burst(n)
    def try_peek(self): return self._as(IStream).try_peek()
    def try_eot(self): return self._as(IStream).try_eot()
    def try_open(self): return self._as(IStream).try_open()
    def __iter__(self): return iter(self._as(IStream))
    # producer ops
    def full(self): return self._as(OStream).full()
    def write(self, v): return self._as(OStream).write(v)
    def write_burst(self, seq): return self._as(OStream).write_burst(seq)
    def close(self): return self._as(OStream).close()
    def try_write(self, v): return self._as(OStream).try_write(v)
    def try_write_burst(self, seq):
        return self._as(OStream).try_write_burst(seq)
    def try_close(self): return self._as(OStream).try_close()


_ANN_KINDS = (("IStream", IStream), ("OStream", OStream), ("AsyncMMap", AsyncMMap),
              ("MMap", MMap), ("Scalar", Scalar))


def _annotation_kind(ann: Any) -> Optional[type]:
    """Map a parameter annotation to its interface class — IStream/OStream/
    MMap/AsyncMMap/Scalar (handles string annotations from
    ``from __future__ import annotations``; AsyncMMap is matched before
    MMap, which is a substring of it)."""
    if ann is inspect.Parameter.empty:
        return None
    if isinstance(ann, str):
        for token, cls in _ANN_KINDS:
            if token in ann:
                return cls
        return None
    origin = getattr(ann, "__origin__", ann)
    for _, cls in _ANN_KINDS:
        if origin is cls or (inspect.isclass(origin) and
                             issubclass(origin, cls)):
            return cls
    return None


_annotation_direction = _annotation_kind        # pre-interface-layer alias

_SCALAR_TYPES = (bool, int, float, complex, str, bytes, np.integer,
                 np.floating, np.bool_)


def _record(inst: TaskInstance, name: str, kind: str, dtype: Any,
            ref: Any) -> InterfaceBinding:
    b = InterfaceBinding(name, kind, dtype, ref, inst)
    inst.interfaces.append(b)
    return b


def _convert_arg(val: Any, ann: Any, inst: TaskInstance, name: str) -> Any:
    """Convert one argument to its bound interface view and record the
    binding in the instance's interface table."""
    if isinstance(val, Channel):
        d = _annotation_kind(ann)
        if d is IStream:
            val._bind("consumer", inst)
            _record(inst, name, "istream", val.dtype, val)
            return IStream(val)
        if d is OStream:
            val._bind("producer", inst)
            _record(inst, name, "ostream", val.dtype, val)
            return OStream(val)
        # direction unannotated: binds on first use, table resolves late
        _record(inst, name, "stream", val.dtype, val)
        return AutoStream(val, inst)
    if isinstance(val, (MMap, AsyncMMap)):
        b = _record(inst, name, val.iface_kind, str(val.dtype), val)
        val._bind_task(b)
        return val
    if isinstance(val, Scalar):
        _record(inst, name, "scalar", val.dtype, val)
        return val.value
    if isinstance(val, (np.ndarray, torch.Tensor)) and \
            _annotation_kind(ann) is MMap:
        # annotation-driven wrap: a raw array passed for an MMap parameter.
        # The wrapper is adopted from the engine (one per buffer per run)
        # so it joins interface_set and the one-writer rule holds across
        # tasks that received the same raw array.
        rt = current_runtime()
        wrapped = rt.adopt_mmap(val, name) if rt is not None \
            else MMap(val, name=name)
        b = _record(inst, name, "mmap", str(wrapped.dtype), wrapped)
        wrapped._bind_task(b)
        return wrapped
    if val is None:
        _record(inst, name, "null", "none", None)
        return val
    if isinstance(val, _SCALAR_TYPES):
        _record(inst, name, "scalar", type(val).__name__, None)
        return val
    if isinstance(val, (list, tuple)) and any(
            isinstance(v, (Channel, Interface)) for v in val):
        conv = [_convert_arg(v, ann, inst, f"{name}[{i}]")
                for i, v in enumerate(val)]
        return type(val)(conv) if isinstance(val, tuple) else conv
    _record(inst, name, "other", type(val).__name__, None)
    return val


def bind_streams(inst: TaskInstance) -> tuple[tuple, dict]:
    """Resolve the instance's channel/interface args into bound views,
    registering endpoints and the per-parameter interface table.  Called by
    engines just before running the body."""
    fn = inst.fn
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        params = []
    inst.interfaces = []
    args = []
    for i, a in enumerate(inst.args):
        ann = inspect.Parameter.empty
        name = f"arg{i}"
        if i < len(params):
            p = params[i]
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                ann = p.annotation
                name = p.name
            elif p.kind is p.VAR_POSITIONAL:
                ann = p.annotation
                name = f"{p.name}[{i - len(params) + 1}]"
        elif params and params[-1].kind is params[-1].VAR_POSITIONAL:
            ann = params[-1].annotation
            name = f"{params[-1].name}[{i - len(params) + 1}]"
        args.append(_convert_arg(a, ann, inst, name))
    by_name = {p.name: p.annotation for p in params}
    kwargs = {
        k: _convert_arg(v, by_name.get(k, inspect.Parameter.empty), inst, k)
        for k, v in inst.kwargs.items()
    }
    return tuple(args), kwargs


class TaskBuilder:
    """``repro_torch.task()`` — collects ``invoke`` calls and joins at body end.

    Children are spawned *immediately* by the active engine (so detached
    infinite tasks such as the paper's VertexHandler can serve requests
    while the parent is still invoking siblings).
    """

    def __init__(self):
        self._children: list[TaskInstance] = []
        self._joined = False
        rt = current_runtime()
        if rt is None:
            raise RuntimeError(
                "repro_torch.task() outside a running program; use repro_torch.run(...)")
        self._rt = rt
        self._parent = current_task()
        current_builder_stack().append(self)

    def invoke(self, fn: Callable, *args, detach: bool = False,
               name: Optional[str] = None, **kwargs) -> "TaskBuilder":
        # an explicit ``name`` is preserved exactly (no uid suffix) —
        # crash-fault sites and recovery chunk re-invocation
        # (ft/recovery.py) rely on stable instance names across restarts
        inst = TaskInstance(fn, args, kwargs, detach, self._parent, name)
        if self._parent is not None:
            self._parent.children.append(inst)
        self._children.append(inst)
        self._rt.spawn(inst)
        return self

    # ``invoke(fn, ...) * 4`` sugar is intentionally absent: the paper's
    # interface repeats .invoke once per instance; we keep that shape.

    def join(self) -> None:
        """Wait for all non-detached children (parent-finishes-last rule,
        Section 3.1.3)."""
        if self._joined:
            return
        self._joined = True
        stack = current_builder_stack()
        if self in stack:
            stack.remove(self)
        self._rt.join([c for c in self._children if not c.detach])

    # context-manager form
    def __enter__(self) -> "TaskBuilder":
        return self

    def __exit__(self, et, ev, tb) -> None:
        if et is None:
            self.join()
        else:
            # error path: don't mask the original exception with a join
            self._joined = True
            stack = current_builder_stack()
            if self in stack:
                stack.remove(self)


def task() -> TaskBuilder:
    """``tapa::task()`` (Listing 5)."""
    return TaskBuilder()


def builder_stack_depth() -> int:
    """Engines snapshot this before running a task body, so that nested
    (sequential-engine) elaboration only joins the body's own builders."""
    return len(current_builder_stack())


def join_pending_builders(depth: int = 0) -> None:
    """Join builders the current task body created but did not join —
    engines call this when a task body returns, emulating TAPA's
    end-of-full-expression destructor join."""
    stack = current_builder_stack()
    while len(stack) > depth:
        stack[-1].join()

"""Task-graph metadata extraction (paper Section 3.4, Table 3).

After elaboration/simulation the engine holds every :class:`TaskInstance`
and :class:`Channel`.  This module turns that into a queryable IR:

* the set of task *definitions* vs task *instances* (the distinction that
  drives hierarchical code generation, Section 3.3),
* the communication topology (which instance produces/consumes which
  channel, token "types", capacities),
* validation of the one-producer/one-consumer/same-parent rule
  (Section 3.1.1),
* a Graphviz/DOT export for inspection.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .channel import Channel
from .compile_cache import _enc, _stable_repr, structural_digest
from .engines import EngineBase, SimReport, ENGINES
from .errors import GraphValidationError
from .interface import AsyncMMap, MMap, Scalar
from .task import TaskInstance


@dataclass(frozen=True)
class InterfaceInfo:
    """One parameter row of a definition's interface table — the analogue
    of the argument metadata TAPA's Clang pass extracts from a kernel
    signature (paper Section 3.4 / Table 2): which interface *kind* each
    parameter binds (stream / mmap / async_mmap / scalar), its token or
    element dtype, and the observed transfer direction."""
    param: str
    kind: str        # istream/ostream/mmap/async_mmap/scalar/null/other
    dtype: str
    direction: str   # in/out/read/write/readwrite/unused


def _merge_interface_rows(insts: list) -> tuple:
    """Fold per-instance binding rows into one per-definition table.

    Instances of one definition may disagree benignly (an edge PE gets
    ``None`` where an interior PE gets a channel; an unused mmap binding
    records no direction) — ``null``/``unused`` defer to any concrete
    observation.  Genuinely conflicting kinds (istream in one instance,
    ostream in another) are preserved as ``mixed`` so ``validate`` can
    reject them.
    """
    order: list = []
    kinds: dict = {}
    dtypes: dict = {}
    dirs: dict = {}
    for inst in insts:
        for b in inst.interfaces:
            k = b.resolved_kind()
            d = b.resolved_direction()
            if b.param not in kinds:
                order.append(b.param)
                kinds[b.param], dtypes[b.param], dirs[b.param] = \
                    k, str(b.dtype), {d}
                continue
            cur = kinds[b.param]
            if cur in ("null", "stream") and k not in ("null", "stream"):
                kinds[b.param], dtypes[b.param] = k, str(b.dtype)
            elif k not in ("null", "stream", cur) and cur != "null":
                kinds[b.param] = "mixed"
            dirs[b.param].add(d)
    def direction(p):
        ds = dirs[p] - {"unused"}
        if not ds:
            return "unused"
        if ds == {"read", "write"} or "readwrite" in ds:
            return "readwrite"
        return ds.pop() if len(ds) == 1 else "mixed"
    return tuple(InterfaceInfo(p, kinds[p], dtypes[p], direction(p))
                 for p in order)


@dataclass(frozen=True)
class ChannelInfo:
    """One row of the graph's channel table — the typed, fixed-capacity
    FIFO record whole-graph synthesis sizes its ring buffers from
    (hlslib: channels must be typed hardware objects for the lowering to
    exist).  ``producer``/``consumer`` are instance names (None when
    unbound); ``dtype``/``shape`` are the declared element spec (None when
    undeclared — simulation tolerates it, synthesis refuses)."""
    name: str
    capacity: int
    dtype: Any
    shape: Optional[tuple]
    producer: Optional[str]
    consumer: Optional[str]


@dataclass(frozen=True)
class DefinitionInfo:
    """One task definition and all instances stamped out from it."""
    fn: Callable
    name: str
    n_instances: int
    instance_names: tuple
    defn_hash: str = ""
    # per-parameter interface table (paper Table 2 kinds), merged across
    # the definition's instances
    interfaces: tuple = ()


@dataclass
class Graph:
    """Elaborated task graph."""
    instances: list[TaskInstance]
    channels: list[Channel]
    interfaces: list = field(default_factory=list)   # MMap/AsyncMMap objects
    report: Optional[SimReport] = None
    _defs: dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @property
    def definitions(self) -> list[DefinitionInfo]:
        """Unique task definitions (paper Table 3 "#Tasks").

        Keyed by the *structural* hash from
        :mod:`repro_torch.core.compile_cache` — the same key hierarchical codegen
        dedups on — so two separately-created closures with the same body
        count as one definition, exactly as they compile as one.
        """
        if not self._defs:
            by_hash: dict[str, list[TaskInstance]] = {}
            # per-sweep digest memo: N instances of K definitions need K
            # content hashes (ids are stable while self.instances pins
            # the fn objects)
            digests: dict = {}
            for i in self.instances:
                d = digests.get(id(i.fn))
                if d is None:
                    d = digests[id(i.fn)] = structural_digest(i.fn)
                by_hash.setdefault(d, []).append(i)
            self._defs = {
                h: DefinitionInfo(
                    fn=insts[0].fn,
                    name=getattr(insts[0].fn, "__name__",
                                 repr(insts[0].fn)),
                    n_instances=len(insts),
                    instance_names=tuple(x.name for x in insts),
                    defn_hash=h,
                    interfaces=_merge_interface_rows(insts))
                for h, insts in by_hash.items()
            }
        return list(self._defs.values())

    @property
    def n_tasks(self) -> int:
        return len(self.definitions)

    @property
    def n_instances(self) -> int:
        return len(self.instances)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def dedup_factor(self) -> float:
        """instances / definitions — the repetition hierarchical codegen
        exploits (e.g. gaussian: 564/15 in the paper's Table 3)."""
        return self.n_instances / max(1, self.n_tasks)

    # ------------------------------------------------------------------
    @property
    def channel_info(self) -> list[ChannelInfo]:
        """The per-channel table (name/capacity/element spec/endpoints) —
        what synthesis consumes, and what Table 3's "#Channels" column
        summarizes."""
        return [
            ChannelInfo(
                name=c.name, capacity=c.capacity, dtype=c.dtype,
                shape=c.shape,
                producer=getattr(c.producer, "name", None),
                consumer=getattr(c.consumer, "name", None))
            for c in self.channels if c.iface is None]

    def structural_hash(self) -> str:
        """Stable digest of the whole graph's *structure*: every instance's
        definition hash plus its argument wiring — channels by dense index
        + capacity + element spec, mmaps/async_mmaps by aval and identity
        index, scalars and plain values by content — and the parent tree.

        Equal hashes mean "lowering this graph produces the same program
        for the same input avals": mmap buffer *values* and instance/
        channel *names* are excluded, so N graphs over N datasets share
        one whole-graph compile (the key ``repro_torch.core.synth`` caches on).
        """
        chan_idx = {id(c): i for i, c in enumerate(self.channels)}
        iface_idx = {id(m): i for i, m in enumerate(self.interfaces)}
        inst_idx = {id(i): n for n, i in enumerate(self.instances)}
        digests: dict[int, str] = {}
        h = hashlib.sha256()

        def enc_arg(v: Any) -> None:
            if isinstance(v, Channel):
                h.update(
                    f"chan:{chan_idx.get(id(v), -1)}:{v.capacity}:"
                    f"{v.dtype}:{v.shape}".encode())
            elif isinstance(v, AsyncMMap):
                # latency and depth shape the lowered latency queue (the
                # in-flight window is part of the compiled carry), so two
                # ports differing only in timing compile separately
                h.update(f"{v.iface_kind}:{iface_idx.get(id(v), -1)}:"
                         f"{v.dtype}:{tuple(v.shape)}:"
                         f"lat{v.latency}:d{v.depth}".encode())
            elif isinstance(v, MMap):
                h.update(f"{v.iface_kind}:{iface_idx.get(id(v), -1)}:"
                         f"{v.dtype}:{tuple(v.shape)}".encode())
            elif isinstance(v, Scalar):
                h.update(f"scalar:{_stable_repr(v.value)}".encode())
            elif isinstance(v, (list, tuple)):
                h.update(f"seq{len(v)}".encode())
                for x in v:
                    enc_arg(x)
            elif isinstance(v, dict):
                h.update(f"map{len(v)}".encode())
                for k in sorted(v, key=_stable_repr):
                    h.update(_stable_repr(k).encode())
                    enc_arg(v[k])
            else:
                _enc(h, v)

        for inst in self.instances:
            d = digests.get(id(inst.fn))
            if d is None:
                d = digests[id(inst.fn)] = structural_digest(inst.fn)
            h.update(b"inst")
            h.update(d.encode())
            h.update(f"p{inst_idx.get(id(inst.parent), -1)}"
                     f"d{int(inst.detach)}".encode())
            for a in inst.args:
                enc_arg(a)
            for k in sorted(inst.kwargs):
                h.update(k.encode())
                enc_arg(inst.kwargs[k])
        return h.hexdigest()

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Enforce Section 3.1.1: every channel has exactly one producer and
        one consumer, both instantiated under the same parent task; every
        mmap has at most one writer; no definition binds one parameter to
        conflicting interface kinds across its instances."""
        errs = []
        for c in self.channels:
            if c.iface is not None:
                continue    # async_mmap port channel: memory is an endpoint
            # static-depth rule: a channel's capacity is part of its type
            # (tapa::channel<T, capacity>) and must stay a positive static
            # int for the ring-buffer lowering to exist
            if not isinstance(c.capacity, int) or \
                    isinstance(c.capacity, bool) or c.capacity < 1:
                errs.append(f"channel {c.name!r} has non-static depth "
                            f"{c.capacity!r}")
            if c.producer is None:
                errs.append(f"channel {c.name!r} has no producer")
            if c.consumer is None:
                errs.append(f"channel {c.name!r} has no consumer")
            if c.producer is not None and c.consumer is not None:
                if c.producer is c.consumer:
                    errs.append(f"channel {c.name!r} loops back to "
                                f"{c.producer.name}")
                elif c.producer.parent is not c.consumer.parent:
                    errs.append(
                        f"channel {c.name!r} connects tasks from different "
                        f"parents ({c.producer.name} / {c.consumer.name})")
        for m in self.interfaces:
            if isinstance(m, MMap):
                writers = {b.inst.name for b in m._by_inst.values()
                           if "write" in b.direction}
                if len(writers) > 1:
                    errs.append(f"mmap {m.name!r} has multiple writers "
                                f"{sorted(writers)} (one-writer rule)")
        for d in self.definitions:
            for row in d.interfaces:
                if row.kind == "mixed" or row.direction == "mixed":
                    errs.append(
                        f"definition {d.name!r} binds parameter "
                        f"{row.param!r} to conflicting interface kinds "
                        f"across instances")
        if errs:
            raise GraphValidationError("; ".join(errs))

    # ------------------------------------------------------------------
    def to_dot(self, placement=None) -> str:
        """GraphViz rendering; pass a ``floorplan.Placement`` (or any
        object with parallel ``task_names`` / ``owners``) to color leaf
        tasks by their assigned device and bold the cut channels."""
        owner_of = {}
        if placement is not None:
            owner_of = dict(zip(placement.task_names, placement.owners))
        # one fill per device, cycled: readable up to ~8-way meshes
        palette = ["lightblue", "palegreen", "lightsalmon", "plum",
                   "khaki", "lightpink", "aquamarine", "wheat"]
        lines = ["digraph G {", "  rankdir=LR;"]
        for i in self.instances:
            shape = "box" if i.children else "ellipse"
            style = ""
            if i.name in owner_of:
                d = int(owner_of[i.name])
                style = (f', style=filled, '
                         f'fillcolor="{palette[d % len(palette)]}"')
                lines.append(f'  t{i.uid} [label="{i.name}\\ndev{d}", '
                             f'shape={shape}{style}];')
                continue
            lines.append(f'  t{i.uid} [label="{i.name}", shape={shape}];')
        for m in self.interfaces:
            lines.append(f'  m{m.uid} [label="{m.name}\\n{m.iface_kind}", '
                         f'shape=cylinder];')
        for c in self.channels:
            if c.iface is not None:
                continue    # drawn as one memory edge per port, below
            if c.producer is not None and c.consumer is not None:
                cut = (owner_of.get(c.producer.name) is not None
                       and owner_of.get(c.consumer.name) is not None
                       and owner_of[c.producer.name]
                       != owner_of[c.consumer.name])
                style = ', style=bold, color=red' if cut else ''
                lines.append(
                    f'  t{c.producer.uid} -> t{c.consumer.uid} '
                    f'[label="{c.name}/{c.capacity}"{style}];')
        for m in self.interfaces:
            if isinstance(m, AsyncMMap):
                if m.owner is not None:
                    lines.append(f'  t{m.owner.uid} -> m{m.uid} '
                                 f'[dir=both, style=dashed, '
                                 f'label="lat={m.latency}/d={m.depth}"];')
                continue
            for b in m._by_inst.values():
                d = b.resolved_direction()
                if d in ("write", "readwrite"):
                    lines.append(f'  t{b.inst.uid} -> m{m.uid} '
                                 f'[style=dashed];')
                if d in ("read", "readwrite", "unused"):
                    lines.append(f'  m{m.uid} -> t{b.inst.uid} '
                                 f'[style=dashed];')
        lines.append("}")
        return "\n".join(lines)

    def summary(self) -> str:
        return (f"tasks={self.n_tasks} instances={self.n_instances} "
                f"channels={self.n_channels} "
                f"interfaces={len(self.interfaces)} "
                f"dedup={self.dedup_factor():.1f}x")


def extract_graph(engine: EngineBase,
                  report: Optional[SimReport] = None) -> Graph:
    """Build the metadata IR from a finished engine run (Section 3.4)."""
    chans = sorted(engine.channel_set, key=lambda c: c.uid)
    ifaces = sorted(engine.interface_set, key=lambda i: i.uid)
    return Graph(instances=list(engine.instances), channels=chans,
                 interfaces=ifaces, report=report)


def elaborate(top: Callable, *args, engine: str = "coroutine",
              validate: bool = True, **kwargs) -> Graph:
    """Run the program once in simulation and return its task graph.

    TAPA extracts metadata with a Clang pass over source; the Python-native
    equivalent is an elaboration run.  Simulation doubles as the
    correctness-verification cycle (Fig. 2), so nothing is wasted.
    """
    eng = ENGINES[engine]()
    report = eng.run(top, *args, **kwargs)
    g = extract_graph(eng, report)
    if validate and report.ok:
        g.validate()
    return g

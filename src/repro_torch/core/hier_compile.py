"""Hierarchical code generation (paper Section 3.3), on PyTorch.

The paper's observation: HLS tools treat a task-parallel design as a
monolithic program and re-synthesize every *instance*, even when hundreds
of instances share a handful of *definitions* (gaussian: 564 instances of
15 tasks).  TAPA compiles each definition once and stitches instances, in
parallel — 6.8x faster codegen.

The port compiles a task graph of torch *stage definitions* (the
reference's counterpart compiles JAX stages with XLA):

* ``mode="monolithic"`` — one export + compile per *instance*, one after
  another (what a naive per-stage pipeline builder does, and what the
  paper's baseline tools do);
* ``mode="hierarchical"`` — one export + compile per unique *(definition,
  input-shape signature)*, with every instance sharing its definition's
  executable.  The exports run serially in the calling thread; on the
  card the AOTInductor compiles run in a ``spawn`` process pool
  (:func:`repro_torch.core.compile_cache.compile_artifacts`).

Definitions are keyed by the **structural hash** from
:mod:`repro_torch.core.compile_cache` — bytecode + constants + closure
values + aval signature + toolchain — so dedup survives re-created
closures and process restarts, and compiled artifacts persist in the
content-addressed store.  Passing the previous :class:`CompileReport` back
in enables **incremental recompilation**: only definitions whose hash
changed are recompiled (the paper's QoR-tuning loop).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Union

import torch

from .compile_cache import (CompileCache, aval_signature, compile_artifacts,
                            default_cache, instance_key, resolve_lowering,
                            runtime_value, structural_digest)


@dataclass
class StageInstance:
    """One instance of a torch stage definition in a compiled dataflow
    graph."""
    fn: Callable
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    name: str = ""
    executable: Any = None

    @property
    def key(self) -> str:
        """Structural cache key on the card (content digest, not
        ``id(fn)``); :func:`instance_key` with ``device=`` keys another
        device."""
        return instance_key(self.fn, self.args, self.kwargs)

    @property
    def definition_hash(self) -> str:
        """Digest of the definition alone (no input signature)."""
        return structural_digest(self.fn)

    @property
    def legacy_key(self) -> tuple:
        """Deprecated ``(id(fn), aval_signature)`` key.

        Object ids are reused after GC and differ across processes, causing
        both false sharing and missed dedup; use :attr:`key`.
        """
        warnings.warn("StageInstance.legacy_key is deprecated: id(fn) keys "
                      "are unstable across GC and processes; use .key",
                      DeprecationWarning, stacklevel=2)
        return (id(self.fn), aval_signature(self.args, self.kwargs))


@dataclass
class CompileReport:
    mode: str
    n_instances: int
    n_unique: int
    wall_s: float
    per_key_s: dict = field(default_factory=dict)
    # key -> "compiled" | "memory" | "disk" | "prev" (where it came from)
    sources: dict = field(default_factory=dict)
    executables: dict = field(default_factory=dict, repr=False)
    cache_stats: dict = field(default_factory=dict)
    device: Optional[torch.device] = None
    lowering: str = ""

    def _count(self, *srcs: str) -> int:
        return sum(1 for s in self.sources.values() if s in srcs)

    @property
    def n_compiled(self) -> int:
        """Actual compiles performed (the expensive part)."""
        return self._count("compiled")

    @property
    def n_cache_hits(self) -> int:
        return self._count("memory", "disk")

    @property
    def n_reused(self) -> int:
        """Definitions carried over unchanged from the previous report."""
        return self._count("prev")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"<CompileReport {self.mode} {self.wall_s:.3f}s "
                f"instances={self.n_instances} unique={self.n_unique} "
                f"compiled={self.n_compiled} hits={self.n_cache_hits} "
                f"reused={self.n_reused}>")


def diff_definitions(prev: Optional[CompileReport],
                     instances: list[StageInstance]) -> tuple[set, set]:
    """Split the instance key-set into (clean, dirty) against ``prev``.

    A key is *clean* when the previous report compiled it (same structural
    hash — same bytecode, constants, closure values, input signature and
    toolchain, on ``prev``'s device); anything else — a new definition or
    an edited one — is *dirty*.  Without ``prev`` every key is dirty and
    keyed on the card.
    """
    dev = prev.device if prev is not None else None
    low = prev.lowering if prev is not None else None
    keys = {instance_key(i.fn, i.args, i.kwargs, device=dev, lowering=low)
            for i in instances}
    if prev is None:
        return set(), keys
    clean = {k for k in keys if k in prev.executables}
    return clean, keys - clean


def _compile_one(insts: list, device: torch.device, lowering: str,
                 max_workers: Optional[int] = None) -> list:
    """Lower and compile each instance's definition on its own args, with
    inductor's own caches off (:func:`~.compile_cache.aoti_package`): the
    store is the only cache, so every "compiled" is a real compile."""
    return compile_artifacts([(i.fn, i.args, i.kwargs) for i in insts],
                             device=device, lowering=lowering,
                             max_workers=max_workers)


def compile_stages(instances: list[StageInstance], mode: str = "hierarchical",
                   max_workers: Optional[int] = None, *,
                   cache: Union[CompileCache, None, bool] = None,
                   prev: Optional[CompileReport] = None,
                   device: Any = None,
                   lowering: Optional[str] = None) -> CompileReport:
    """Compile every stage instance; attaches executables in place.

    ``cache``: a :class:`CompileCache`, ``None`` for the process default, or
    ``False`` to bypass persistence (pure in-process dedup).  ``prev``: a
    previous report — unchanged definitions reuse its executables without
    even a cache probe (incremental recompilation).  Monolithic mode never
    consults the cache: it *is* the paper's baseline.  ``device``: the
    card unless the caller names another (an error without one);
    ``lowering``: the device's artifact (AOTInductor on the card, the
    exported program on the CPU).  ``max_workers`` bounds the hierarchical
    mode's compile processes.
    """
    from .synth import resolve_device
    dev = resolve_device(device)
    lowering = resolve_lowering(dev, lowering)
    t0 = time.perf_counter()
    per_key: dict = {}
    sources: dict = {}
    executables: dict = {}
    cc: Optional[CompileCache]
    if mode == "monolithic" or cache is False:
        cc = None
    elif cache is None or cache is True:
        cc = default_cache()
    else:
        cc = cache

    # per-call digest memo: N instances of K definitions need K content
    # hashes, not N (safe within one call — the list pins the fn objects,
    # so ids can't be recycled; a cross-call memo would go stale on
    # in-place weight edits, see structural_digest)
    digests: dict[int, str] = {}

    def key_of(inst: StageInstance) -> str:
        d = digests.get(id(inst.fn))
        if d is None:
            d = digests[id(inst.fn)] = structural_digest(inst.fn)
        return instance_key(inst.fn, inst.args, inst.kwargs, digest=d,
                            device=dev, lowering=lowering)

    if mode == "monolithic":
        # paper-baseline behaviour: every instance compiled separately, "as
        # if they are completely unrelated" (S1), one after another
        for n, inst in enumerate(instances):
            t1 = time.perf_counter()
            inst.executable, = _compile_one([inst], dev, lowering, 1)
            k = f"{n}:{inst.name or 'inst'}"
            per_key[k] = time.perf_counter() - t1
            sources[k] = "compiled"
            # keyed by structural key too, so even a baseline report works
            # as prev= for an incremental follow-up
            executables[key_of(inst)] = inst.executable
        uniq = len({key_of(i) for i in instances})
    elif mode == "hierarchical":
        groups: dict[str, list[StageInstance]] = {}
        for inst in instances:
            groups.setdefault(key_of(inst), []).append(inst)
        uniq = len(groups)
        missing = []
        for key, insts in groups.items():
            t1 = time.perf_counter()
            if prev is not None and key in prev.executables:
                exe, source = prev.executables[key], "prev"
            elif cc is not None:
                exe, source = cc.get_with_source(key)
            else:
                exe, source = None, None
            if exe is None:
                missing.append(key)
                continue
            per_key[key], sources[key], executables[key] = \
                time.perf_counter() - t1, source, exe
        # the misses compile together: serial exports, then the packages
        # in parallel worker processes (the paper: "TAPA runs HLS in
        # parallel on multi-core machines")
        built = _compile_one([groups[k][0] for k in missing], dev, lowering,
                             max_workers) if missing else []
        for key, exe in zip(missing, built):
            if cc is not None:
                cc.put(key, exe)
            per_key[key] = exe.timing["export_s"] + \
                exe.timing["compile_s"] + exe.timing["load_s"]
            sources[key], executables[key] = "compiled", exe
        for key, insts in groups.items():
            for i in insts:
                i.executable = executables[key]
        sources = {k: sources[k] for k in groups}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return CompileReport(mode=mode, n_instances=len(instances),
                         n_unique=uniq, wall_s=time.perf_counter() - t0,
                         per_key_s=per_key, sources=sources,
                         executables=executables,
                         cache_stats=cc.stats.as_dict() if cc else {},
                         device=dev, lowering=lowering)


# ---------------------------------------------------------------------------
# running a compiled feed-forward dataflow graph
# ---------------------------------------------------------------------------

@dataclass
class DataflowProgram:
    """A compiled task graph: stages + channel wiring.

    ``wiring`` maps each stage to (input stage indices); stage i consumes
    the outputs of its listed predecessors (in order) plus its bound args.
    ``source_indices`` lists the stages fed by graph inputs, positionally;
    when omitted it defaults to every stage with no predecessors.  Calling
    the program with the wrong number of inputs raises — inputs are never
    silently dropped or misassigned.  The call returns the outputs of every
    *sink* stage (a stage no other stage consumes): the bare value for a
    single sink, a tuple for several.

    This executor covers feed-forward graphs (systolic arrays, stencil
    pipelines); graphs with feedback run under the simulation engines or
    the compiled engine.
    """
    instances: list[StageInstance]
    wiring: dict = field(default_factory=dict)   # idx -> list[pred idx]
    source_indices: Optional[list] = None        # stages fed by graph inputs

    def sources(self) -> list:
        if self.source_indices is not None:
            return list(self.source_indices)
        return [i for i in range(len(self.instances))
                if not self.wiring.get(i)]

    def sinks(self) -> list:
        consumed = {p for preds in self.wiring.values() for p in preds}
        return [i for i in range(len(self.instances)) if i not in consumed]

    def __call__(self, *graph_inputs):
        srcs = self.sources()
        if len(graph_inputs) != len(srcs):
            raise ValueError(
                f"DataflowProgram: got {len(graph_inputs)} graph input(s) "
                f"for {len(srcs)} source stage(s) {srcs}; pass exactly one "
                f"input per source (or set source_indices explicitly)")
        feed = dict(zip(srcs, graph_inputs))
        outputs: dict[int, Any] = {}
        for idx, inst in enumerate(self.instances):
            ins = [outputs[p] for p in self.wiring.get(idx, [])]
            if idx in feed:
                ins = [feed[idx]] + ins
            # mmap-bound args feed their *current* buffer at call time
            # (scalars their value); the artifact was lowered against
            # placeholders, so fresh data needs no recompilation
            bound = tuple(runtime_value(a) for a in inst.args)
            bkw = {k: runtime_value(v) for k, v in inst.kwargs.items()}
            if inst.executable is not None:
                outputs[idx] = inst.executable(*ins, *bound, **bkw)
            else:
                outputs[idx] = inst.fn(*ins, *bound, **bkw)
        outs = [outputs[i] for i in self.sinks()]
        return outs[0] if len(outs) == 1 else tuple(outs)


def build_dataflow(instances: list[StageInstance], wiring: dict,
                   source_indices: Optional[list] = None) -> DataflowProgram:
    """Wrap compiled stage instances into a runnable DataflowProgram.

    Convention: a fed stage's *leading* bound args are compile-time
    placeholders for its runtime inputs — one per wired predecessor, plus
    one if the stage receives a graph input.  The program gets *copies*
    with those placeholders stripped (at call time the graph supplies the
    real values); the caller's instances keep their compile-time args, so
    their cache keys stay valid for a later incremental
    ``compile_stages(..., prev=report)``.
    """
    prog = DataflowProgram(instances=list(instances), wiring=wiring,
                           source_indices=source_indices)
    fed = set(prog.sources())
    prog.instances = [
        replace(inst, args=inst.args[len(wiring.get(idx, ())) +
                                     (1 if idx in fed else 0):])
        for idx, inst in enumerate(instances)]
    return prog


def hashable_definition_count(instances: list[StageInstance], *,
                              device: Any = None) -> tuple:
    """``(instances, unique keys)`` on ``device`` (the card by default)."""
    return (len(instances),
            len({instance_key(i.fn, i.args, i.kwargs, device=device)
                 for i in instances}))

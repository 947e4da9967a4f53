"""Mesh floorplanner: assign task instances to partitions, price the cuts.

The counterpart of TAPA/AutoBridge's floorplan pass, as the reference's
``core/floorplan.py`` is: instead of assigning tasks to FPGA die regions
and pipelining the FIFOs that cross them, it assigns
:class:`~repro_torch.core.synth.StepTask` instances to the partitions of
a mesh, and every *cut* channel (producer and consumer on different
partitions) becomes a ring copied from the producer's partition to the
consumer's once a sweep (``synth._PartitionedProgram``).

The placement is an optimization, not a hash of the task name:

* each task's weight comes from :mod:`repro_torch.core.cost` (the FLOPs
  and bytes of one firing on meta tensors, converted to roofline seconds
  on the card's rates and multiplied by the firings; memoized per task
  definition, so an edit prices one cell again);
* each channel's weight is the bytes it moves over the whole run (static:
  every write is a full token of the channel's element spec, and the
  phase tables say how many writes happen);
* the objective is ``max_partition_load_seconds + cut_bytes / ici_bw``
  (balance compute, penalize interconnect traffic), minimized by greedy
  placement in plan order followed by deterministic single-task-move
  refinement passes (first improvement, the lowest partition index wins
  ties).

Placements are content-addressed artifacts: the JSON result is memoized
under ``Graph.structural_hash()`` + the mesh's width + the manual pins, so
a rerun or a sibling process places nothing again.  Manual placement:
``overrides={"task_name": partition}`` pins those tasks, the optimizer
places the rest around them, and the pins enter the key, so distinct
placements never collide.  Under the same ``cost_fn`` and ``hw`` this
module gives the reference's owners exactly.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from .compile_cache import _stable_repr, default_cache
from .cost import HW, task_cost
from .errors import SynthesisError
from .synth import canon_dtype

FLOORPLAN_SCHEMA = "fp1"

# both terms of the objective are in seconds (the shared HW table), so a
# tie between a second of load and a byte of cut is a real tie
_EPS = 1e-12


@dataclass(frozen=True)
class Placement:
    """A frozen task -> partition assignment and the evidence for it."""
    n_devices: int
    owners: tuple                 # partition of each plan.tasks entry
    task_names: tuple             # parallel to owners (display only)
    objective: dict               # max_load_s / loads_s / cut_bytes / ...
    source: str = "partitioned"   # "partitioned" | "memo"
    version: str = FLOORPLAN_SCHEMA

    def as_dict(self) -> dict:
        return {"version": self.version, "n_devices": self.n_devices,
                "owners": list(self.owners),
                "task_names": list(self.task_names),
                "objective": self.objective}


def placement_key(graph_hash: str, n_devices: int,
                  overrides: Optional[dict] = None) -> str:
    """Content address of a placement artifact: the graph's structure, the
    mesh's width, the manual pins and the schema.  The same inputs give
    the same artifact in any process."""
    h = hashlib.sha256()
    h.update(f"floorplan:{FLOORPLAN_SCHEMA}:{graph_hash}:"
             f"dev={int(n_devices)}:".encode())
    h.update(_stable_repr(tuple(sorted((overrides or {}).items()))).encode())
    return "place_" + h.hexdigest()


def channel_endpoints(plan) -> list:
    """``(producer_ti, consumer_ti)`` of each channel (-1 where absent,
    e.g. the member rings of an async port, which one task and the port
    service touch)."""
    prod = [-1] * len(plan.channels)
    cons = [-1] * len(plan.channels)
    for ti, tp in enumerate(plan.tasks):
        for ph in tp.phases:
            for ci in ph.writes:
                prod[ci] = ti
            for ci in ph.reads:
                cons[ci] = ti
    return list(zip(prod, cons))


def channel_traffic(plan) -> list:
    """The bytes each channel moves over the whole run.  Static: every
    push is one full token of the element spec, and the phase tables fix
    the number of pushes."""
    writes = [0] * len(plan.channels)
    for tp in plan.tasks:
        for ph in tp.phases:
            for ci, ntok in ph.writes.items():
                writes[ci] += ntok * ph.count
    out = []
    for ci, ch in enumerate(plan.channels):
        tok = int(np.prod(ch.shape, dtype=np.int64)) if ch.shape else 1
        out.append(writes[ci] * tok * canon_dtype(ch.dtype).itemsize)
    return out


def _edges(plan) -> list:
    """Cuttable edges: ``(producer_ti, consumer_ti, bytes)`` for every
    channel with both ends bound to tasks."""
    traffic = channel_traffic(plan)
    return [(p, c, traffic[ci])
            for ci, (p, c) in enumerate(channel_endpoints(plan))
            if p >= 0 and c >= 0 and p != c]


def _objective(owners, costs, edges, n_devices, ici_bw):
    """The objective over a (possibly partial) assignment; tasks whose
    owner is ``None`` are not counted yet."""
    loads = [0.0] * n_devices
    for ti, c in enumerate(costs):
        if owners[ti] is not None:
            loads[owners[ti]] += c
    cut = 0
    for p, c, b in edges:
        if owners[p] is not None and owners[c] is not None \
                and owners[p] != owners[c]:
            cut += b
    return max(loads) + cut / ici_bw, loads, cut


def _validate_overrides(names, overrides, n_devices):
    known = set(names)
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise SynthesisError(
            f"manual placement names unknown task(s) {unknown}; "
            f"known instances: {sorted(known)}")
    for name, dev in overrides.items():
        if not isinstance(dev, (int, np.integer)) \
                or not (0 <= int(dev) < n_devices):
            raise SynthesisError(
                f"manual placement pins task '{name}' to device {dev!r}, "
                f"outside the mesh's [0, {n_devices}) device range")


def plan_placement(plan, graph, n_devices: int, *,
                   overrides: Optional[dict] = None, cache: Any = None,
                   cost_fn: Optional[Callable] = None,
                   hw: Optional[dict] = None) -> Placement:
    """Place ``plan.tasks`` on ``n_devices`` partitions.

    ``overrides`` pins named instances; ``cost_fn(plan, tp) -> seconds``
    swaps the pricing model (tests use synthetic costs, to make the
    optimizer's choices assertable); ``cache=None`` memoizes the artifact
    in the default compile cache, ``cache=False`` does not memoize.
    """
    hw = hw or HW
    n_devices = int(n_devices)
    if n_devices < 1:
        raise SynthesisError(f"cannot floorplan onto {n_devices} devices")
    names = [tp.inst.name for tp in plan.tasks]
    overrides = dict(overrides or {})
    _validate_overrides(names, overrides, n_devices)

    cc = default_cache() if cache is None else (cache or None)
    key = placement_key(graph.structural_hash(), n_devices, overrides)
    if cc is not None:
        hit = cc.memo_get(key)
        if (hit is not None and hit.get("version") == FLOORPLAN_SCHEMA
                and hit.get("n_devices") == n_devices
                and len(hit.get("owners", ())) == len(names)):
            return Placement(n_devices=n_devices,
                             owners=tuple(int(d) for d in hit["owners"]),
                             task_names=tuple(hit["task_names"]),
                             objective=hit["objective"], source="memo")

    if cost_fn is None:
        def cost_fn(plan, tp):
            return task_cost(plan, tp, cache=cache, hw=hw)["seconds"]
    costs = [float(cost_fn(plan, tp)) for tp in plan.tasks]
    edges = _edges(plan)
    ici_bw = float(hw["ici_bw"])

    # greedy construction in plan order: pins first, then each free task
    # takes the partition with the least partial objective (the lowest
    # index wins ties, so the result is deterministic)
    owners: list = [overrides.get(name) for name in names]
    for ti in range(len(names)):
        if owners[ti] is not None:
            continue
        best_j, best_d = None, 0
        for d in range(n_devices):
            owners[ti] = d
            j, _, _ = _objective(owners, costs, edges, n_devices, ici_bw)
            if best_j is None or j < best_j - _EPS:
                best_j, best_d = j, d
        owners[ti] = best_d

    # refinement: deterministic single-task-move passes until a whole pass
    # finds no strict improvement
    for _ in range(4):
        improved = False
        for ti in range(len(names)):
            if names[ti] in overrides:
                continue
            best_j, _, _ = _objective(owners, costs, edges, n_devices,
                                      ici_bw)
            best_d = owners[ti]
            for d in range(n_devices):
                if d == best_d:
                    continue
                owners[ti] = d
                j, _, _ = _objective(owners, costs, edges, n_devices,
                                     ici_bw)
                if j < best_j - _EPS:
                    best_j, best_d = j, d
                    improved = True
                owners[ti] = best_d
        if not improved:
            break

    owners = [int(d) for d in owners]
    j, loads, cut = _objective(owners, costs, edges, n_devices, ici_bw)
    ep = channel_endpoints(plan)
    cut_channels = sorted(
        plan.channels[ci].name
        for ci, (p, c) in enumerate(ep)
        if p >= 0 and c >= 0 and owners[p] != owners[c])
    objective = {"objective_s": j, "max_load_s": max(loads),
                 "loads_s": loads, "cut_bytes": int(cut),
                 "cut_channels": cut_channels,
                 "task_cost_s": costs}
    artifact = {"version": FLOORPLAN_SCHEMA, "n_devices": n_devices,
                "owners": owners, "task_names": names,
                "objective": objective,
                "overrides": {k: int(v) for k, v in overrides.items()}}
    # through JSON and back, so that this process returns what a sibling
    # process reads back from the memo store
    artifact = json.loads(json.dumps(artifact))
    if cc is not None:
        cc.memo_put(key, artifact)
    return Placement(n_devices=n_devices, owners=tuple(artifact["owners"]),
                     task_names=tuple(artifact["task_names"]),
                     objective=artifact["objective"], source="partitioned")

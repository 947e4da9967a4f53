"""Multi-pod dry run: prove the distribution config is coherent.

The port's counterpart of the reference's ``launch/dryrun.py``.  For every
(architecture x input-shape x mesh) cell it runs the cell's step once on
a mesh that does not exist: a fake process group of 256 or 512 ranks
(``pod16x16``, ``pod2x16x16``), the inputs DTensors laid out by the
sharding rules whose local shards are fake tensors (``FakeTensorMode``),
so nothing is allocated, computed or sent; and records what one rank
would do — its FLOPs and bytes, the collectives DTensor issued (kind,
bytes, count), its inputs' bytes and an estimate of its temporaries
(:func:`repro_torch.core.cost.probe_compiled`).  Where the reference
parses the optimized HLO, the port traces the collectives the step
issues (:func:`collective_bytes` keeps the reference's conventions).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \
        --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models.config import InputShape, ModelConfig

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def collective_bytes(records: list, pod_size: Optional[int] = None) -> dict:
    """Sum transferred bytes per collective kind from traced records
    ``{"kind", "bytes", "ranks"}`` (one a collective a rank issued).

    Convention (the reference's): per-op bytes = result-shape bytes a
    rank; all-reduce counts 2x (ring AR = reduce-scatter + all-gather);
    ``n_<kind>`` counts.  With ``pod_size`` set (e.g. 256), collectives
    whose group spans a pod boundary are also summed as
    ``cross_pod_bytes``; a record without ``ranks`` is assumed to span
    one (the worst case, as the reference assumes of HLO with no
    printed groups).
    """
    per_kind = {k: 0 for k in _KINDS}
    counts = {k: 0 for k in _KINDS}
    cross_pod = 0
    for r in records:
        kind = r["kind"]
        if kind not in per_kind:
            continue
        b = int(r["bytes"]) * (2 if kind == "all-reduce" else 1)
        per_kind[kind] += b
        counts[kind] += 1
        if pod_size is not None:
            ranks = r.get("ranks")
            if not ranks or min(ranks) // pod_size != max(ranks) // pod_size:
                cross_pod += b
    out = {"total_bytes": sum(per_kind.values()),
           **{k: v for k, v in per_kind.items() if v},
           **{f"n_{k}": v for k, v in counts.items() if v}}
    if pod_size is not None:
        out["cross_pod_bytes"] = cross_pod
    return out


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """A fake process group of ``n_ranks`` ranks (this process is
    ``rank``) for the length of the block: collectives return at once
    and move nothing; destroyed at the end."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry run starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(cfg: ModelConfig, shape: InputShape, mesh, mesh_name: str,
             verbose: bool = True, use_kernel: bool = True,
             cache=False) -> dict:
    """Run one (arch, shape, mesh) cell's step on fake tensors over
    ``mesh`` (a ``DeviceMesh`` of a fake process group); return its
    record.  ``use_kernel`` takes the kernels' operators (their shape
    functions under fake tensors) for attention and the SSD scan, the
    port's path on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core.cost import probe_compiled
    from .steps import input_specs
    t0 = time.perf_counter()
    pod = mesh.size(0) if mesh.mesh_dim_names[0] == "pod" else None
    # the inputs are fake; the step runs outside the mode, so that what
    # DTensor computes about its shards on the host stays real
    with FakeTensorMode(allow_non_fake_inputs=True):
        spec = input_specs(cfg, shape, mesh, use_kernel=use_kernel)
    t_lower = time.perf_counter() - t0
    cost = probe_compiled(spec["fn"], spec["args"], cache=cache,
                          pod_size=None if pod is None
                          else mesh.size() // pod)
    t_run = time.perf_counter() - t0 - t_lower
    rec: dict = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "ok": True,
        "lower_s": round(t_lower, 2), "compile_s": round(t_run, 2),
        "n_devices": mesh.size(),
        "memory": {"argument_size_in_bytes": cost["arg_bytes"],
                   "temp_size_in_bytes": cost["temp_bytes"],
                   "temp_size_is": "estimate: peak live local bytes "
                                   "traced on fake tensors"},
        "cost": {"flops": cost["flops"], "bytes accessed": cost["bytes"]},
        "collectives": cost["collectives"],
    }
    if verbose:
        print(f"  memory: {rec['memory']}")
        print(f"  cost: flops={cost['flops']:.3e} bytes={cost['bytes']:.3e}")
        print(f"  collectives: {rec['collectives']}")
    return rec


def main(argv=None) -> int:
    from .mesh import PRODUCTION, make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT_DIR / "dryrun.json"))
    ap.add_argument("--force", action="store_true",
                    help="re-run cells already in the output file")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results: dict[str, dict] = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    n_fail = 0
    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        with fake_world(math.prod(PRODUCTION[multi][0])):
            mesh = make_production_mesh(multi_pod=multi)
            for arch in archs:
                cfg = get_config(arch)
                for shp in shapes:
                    shape = SHAPES[shp]
                    ok, why = shape_applicable(cfg, shape)
                    key = f"{cfg.name}|{shape.name}|{mesh_name}"
                    if key in results and results[key].get("ok") \
                            and not args.force:
                        print(f"[cached] {key}")
                        continue
                    if not ok:
                        results[key] = {"arch": cfg.name,
                                        "shape": shape.name,
                                        "mesh": mesh_name, "skipped": why,
                                        "ok": True}
                        print(f"[skip]   {key}: {why}")
                        continue
                    print(f"[run]    {key} ...", flush=True)
                    try:
                        rec = run_cell(cfg, shape, mesh, mesh_name)
                        results[key] = rec
                        print(f"[ok]     {key} run={rec['compile_s']}s")
                    except Exception:
                        n_fail += 1
                        results[key] = {"arch": cfg.name,
                                        "shape": shape.name,
                                        "mesh": mesh_name, "ok": False,
                                        "error": traceback.format_exc(-4)}
                        print(f"[FAIL]   {key}\n{traceback.format_exc(-4)}")
                    out_path.write_text(json.dumps(results, indent=1))
    out_path.write_text(json.dumps(results, indent=1))
    print(f"\nwrote {out_path} ({len(results)} cells, {n_fail} failures)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

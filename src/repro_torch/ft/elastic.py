"""Fault tolerance of training: stragglers, elastic re-mesh and the
restart protocol.

The port's copies of three parts of the reference's ``ft/elastic.py``:

* :class:`StragglerDetector` (``elastic.py:98-130``) — per-step wall-time
  EMA + deviation; a step whose time exceeds ``mean + z * std``
  persistently is flagged.  Pure Python.
* :func:`resume_or_init` (``elastic.py:167-179``) — the train driver's
  restart protocol: restore the latest complete, digest-verified
  checkpoint if one exists (placed by the mesh's shardings under
  ``--model-parallel``), else initialize fresh — so a crashed or
  preempted job is the same command again.

* :class:`ElasticMesh` (``elastic.py:133-164``) — rebuild the device
  mesh after losing ranks and re-shard state onto it.  Sharding specs
  are functions of the mesh (:mod:`repro_torch.distributed.sharding`), so
  elasticity is: a new ``DeviceMesh`` over the survivors -> the specs
  again -> each leaf gathered whole and placed by the new specs -> go on.
  ``shrink()`` keeps the model axis (its groups hold parameter shards)
  and lets the data axis take the loss.

  A ``DeviceMesh`` makes its groups with ``new_group``, which is
  collective over the whole default process group, so :meth:`remesh`
  is called by every rank of the world.  In the port that is a drill:
  the ranks named lost still take part in the call (and in the gather
  of :meth:`reshard`, on the old mesh) and end with no shard of the new
  mesh.  A real loss of processes restarts the group over the survivors
  (``torchrun``'s elastic restart), where ``remesh()`` over the whole new
  world is the same call, and the state comes from the last checkpoint
  (:func:`resume_or_init` with the new mesh's shardings).

:class:`~repro_torch.ft.preemption.PreemptionGuard` lives in
``preemption.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from ..ckpt import CheckpointManager
from ..tree import tree_map


class StragglerDetector:
    """EMA step-time monitor; flags persistent outliers."""

    def __init__(self, z: float = 3.0, patience: int = 3,
                 alpha: float = 0.1):
        self.z = z
        self.patience = patience
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var = 0.0
        self._strikes = 0
        self.flagged = False
        self.history: list[float] = []

    def observe(self, step_seconds: float) -> bool:
        """Feed one step time; returns True if this step is an outlier."""
        self.history.append(step_seconds)
        if self.mean is None:
            self.mean = step_seconds
            return False
        std = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
        outlier = step_seconds > self.mean + self.z * std
        if outlier:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.flagged = True
        else:
            self._strikes = 0
            # only track healthy steps in the baseline
            d = step_seconds - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return outlier


class ElasticMesh:
    """Rebuild the mesh after rank loss and re-shard state onto it."""

    def __init__(self, axis_names: tuple = ("data", "model")):
        self.axis_names = axis_names

    @staticmethod
    def shrink(n_devices: int, model_parallel: int) -> tuple[int, int]:
        """Largest (data, model) grid for the surviving ranks; the model
        axis is preserved (its groups hold parameter shards), the data
        axis absorbs the loss."""
        if n_devices < model_parallel:
            raise ValueError(
                f"cannot keep model_parallel={model_parallel} with only "
                f"{n_devices} devices")
        data = n_devices // model_parallel
        return data, model_parallel

    def remesh(self, ranks: Optional[list] = None, model_parallel: int = 1,
               device_type: str = "cuda"):
        """A ``(data, model)`` ``DeviceMesh`` over the first ``data * mp``
        of ``ranks`` (default: every rank of the world), data-major.  Every
        rank of the world calls it (module docstring); a rank outside the
        new mesh gets it with no coordinate."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else list(ranks)
        data, mp = self.shrink(len(ranks), model_parallel)
        grid = torch.tensor(ranks[:data * mp]).reshape(data, mp)
        return DeviceMesh(device_type, grid, mesh_dim_names=self.axis_names)

    @staticmethod
    def reshard(tree: Any, shardings: Any) -> Any:
        """Move state onto a new mesh by a host hop: each leaf gathered
        whole (a DTensor on the old mesh, every rank of which calls this)
        and placed by its ``NamedSharding`` of ``shardings`` (a tree of
        ``tree``'s structure) on the new mesh's device, as a checkpoint's
        restore with shardings places it.  A rank outside the new mesh
        holds no shard of the result."""
        from ..distributed.sharding import place
        from ..dtensor import is_dtensor

        def one(x, sh):
            whole = x.full_tensor() if is_dtensor(x) else x
            host = whole.detach().to("cpu", copy=True)
            dev = "cpu" if sh.mesh.device_type == "cpu" else \
                torch.device(sh.mesh.device_type,
                             torch.cuda.current_device())
            return place(host.to(dev), sh.spec, sh.mesh)
        return tree_map(one, tree, shardings)


def resume_or_init(mgr: CheckpointManager, init_fn: Callable[[], tuple],
                   params_like: Any, opt_like: Any, device=None,
                   param_shardings: Any = None,
                   opt_shardings: Any = None) -> tuple:
    """Restart protocol: ``(step, params, opt_state, extra)`` from the
    latest complete checkpoint (restored onto ``device``, default each
    ``like`` leaf's device, and placed by the shardings where they are
    given), else ``(0, *init_fn(), {})``."""
    got = mgr.restore_latest(params_like, opt_like, device=device,
                             param_shardings=param_shardings,
                             opt_shardings=opt_shardings)
    if got is not None:
        return got
    params, opt_state = init_fn()
    return 0, params, opt_state, {}

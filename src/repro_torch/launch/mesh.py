"""Mesh construction: the production meshes and the host's mesh.

The port's counterpart of the reference's ``launch/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` with named axes where the
reference has a ``jax.sharding.Mesh``.  Defined as functions (never
module-level constants), and ``torch.distributed`` is set up only inside
them: importing this module starts no process group.
"""

from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

# the process group make_host_mesh started (and so may destroy)
_started: list = []


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 = 512 ranks (pod, data, model); the 'pod' axis is outer
    data-parallel.  Needs a process group of exactly that many ranks: on
    one host a fake one (``launch.dryrun.fake_world``), where nothing
    runs on the ranks but the shapes."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} {axes} needs a world of {need} "
            f"ranks, but "
            + ("no process group is initialised" if have is None else
               f"the process group has {have}")
            + f"; on one host start a fake one first "
              f"(repro_torch.launch.dryrun.fake_world({need}))")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(model_parallel: int = 1, device=None):
    """A (world / model_parallel, model_parallel) ``("data", "model")``
    mesh over the default process group's world.

    Where no group is initialised it starts one: from ``torchrun``'s
    environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) when it is set,
    else a one-rank group on a free localhost port; NCCL on the card,
    gloo on the CPU (``device``, default: the card).  A group it started
    is destroyed by :func:`destroy_host_group`.
    """
    from torch.distributed.device_mesh import init_device_mesh
    from ..core.synth import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
        _started.append(dist.group.WORLD)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"a world of {n} rank(s) does not divide by "
                         f"model_parallel={model_parallel}")
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def destroy_host_group() -> None:
    """Destroy the process group :func:`make_host_mesh` started, if it is
    still the default one; a group the caller started is left alone."""
    if _started and dist.is_initialized() and \
            _started[-1] is dist.group.WORLD:
        dist.destroy_process_group()
    _started.clear()

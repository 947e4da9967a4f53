"""Sharding rules: parameters, batches and decode caches onto the mesh.

The port's copy of the reference's ``distributed/sharding.py``.

Axes
----
``model``  tensor parallelism (Megatron-style: attention heads / FFN width /
           vocab; expert dim for MoE when it divides).
``data``   data parallelism; also hosts FSDP-style parameter sharding for
           very large models and sequence sharding for B=1 long-context.
``pod``    (multi-pod only) an outer data-parallel axis by default.

Rules are *path-pattern based* over the parameter tree (paths joined by
``/`` as :func:`repro_torch.tree.named_leaves` gives them, ``layers/attn/wq``
and so on), so the same table covers every architecture family.
Divisibility is checked against the mesh's axis sizes; a rule that does
not divide falls back to the next candidate (or replication), so grok-1's
8 experts do not shard over a 16-way model axis — its FFN width does.

The mesh and the spec
---------------------
The spec functions read only the mesh's axis names and sizes: they take a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``) or an
:class:`AbstractMesh` of names and sizes, with which specs for the
production meshes need no process group (the reference's
``jax.sharding.AbstractMesh``).  A :class:`Spec` is the counterpart of
``PartitionSpec``: one entry a tensor dim, ``None``, an axis name, or a
tuple of names.  :func:`placements` turns a spec into DTensor placements,
one a mesh dim: a tensor dim whose entry is ``("data", "model")`` is
``Shard(i)`` on both mesh dims, data-major, as JAX splits it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..tree import map_named

Params = Any


class Spec(tuple):
    """A partition spec: ``Spec(None, "model")``; ``Spec()`` replicates a
    tensor of any rank (the reference's ``P()``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}" if len(self) != 1 else \
            f"Spec({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group behind them: specs for
    a mesh that does not exist (the dry run's production meshes).
    ``devices`` holds the devices of :func:`device_mesh`'s 1-D mesh."""
    axis_sizes: tuple
    axis_names: tuple
    devices: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None and not isinstance(mesh, AbstractMesh):
        raise ValueError("a DeviceMesh of the sharding rules needs "
                         "mesh_dim_names")
    return tuple(names) if names is not None else mesh.axis_names


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh),
                    (mesh.size(i) for i in range(mesh.ndim))))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    dp_axes: tuple = ("data",)            # ("pod","data") for multi-pod
    fsdp: bool = False                    # shard big params over dp too
    fsdp_min_elems: int = 4_000_000
    seq_axis: Optional[str] = None        # SP for B=1 long-context caches
    two_d: bool = False                   # weights sharded over dp+tp and
                                          # kept RESIDENT (serving: no
                                          # per-step weight all-gather)
    batch_axes: Optional[tuple] = None    # override activation batch axes

    @property
    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def batch_spec_axes(self):
        ax = self.batch_axes if self.batch_axes is not None else self.dp_axes
        if not ax:
            return None
        return ax if len(ax) > 1 else ax[0]

    @property
    def wide_axis(self):
        """The dp+tp combined axis used by two_d weight sharding."""
        return tuple(self.dp_axes) + (self.tp_axis,)


def for_mesh(mesh, fsdp: bool = False) -> ShardingPolicy:
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    return ShardingPolicy(dp_axes=dp_axes, fsdp=fsdp)


def device_mesh(n_devices: Optional[int] = None, axis: str = "dev",
                devices: Optional[list] = None) -> AbstractMesh:
    """A 1-D mesh over the first ``n_devices`` visible devices (the
    cards, or the CPU where there is none); ``n_devices=None`` takes
    every visible device.  Partitioned synthesis places its partitions in
    one process (``CompiledEngine(mesh=)``), so this mesh holds devices
    and no process group."""
    if devices is not None:
        devs, platform = list(devices), "given"
    elif torch.cuda.is_available():
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        platform = "cuda"
    else:
        devs, platform = [torch.device("cpu")], "cpu"
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(
            f"requested a {n}-device mesh but {len(devs)} device(s) are "
            f"visible (platform {platform!r}, "
            f"{torch.cuda.device_count()} card(s)); to place several "
            f"partitions on one card pass the devices explicitly "
            f"(devices=[torch.device('cuda:0')] * {n}), and for a mesh of "
            f"ranks start a process group (launch.mesh.make_host_mesh)")
    return AbstractMesh((n,), (axis,), tuple(devs[:n]))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _divides(dim: int, mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one a mesh dim, of ``spec`` on ``mesh``: a mesh
    dim named by tensor dim ``i``'s entry is ``Shard(i)``, any other is
    ``Replicate()``.  A tuple entry names its axes in mesh-dim order
    (data-major, as JAX splits a dim over several axes); another order
    raises, as does an axis named twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for i, ent in enumerate(spec):
        if ent is None:
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: entry {ent} names its axes out "
                             f"of mesh-dim order {names}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"spec {spec}: axis {names[d]!r} named "
                                 f"twice")
            out[d] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def place(t: torch.Tensor, spec: Spec, mesh):
    """``t`` (the whole tensor, the same on every rank) as a DTensor on
    ``mesh`` laid out by ``spec``: each rank keeps its own shard of its
    copy, and nothing is sent; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`place` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, specs, mesh)


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """This rank's shard shape of a tensor of ``shape`` laid out by
    ``spec``; each sharded dim must divide evenly (the spec rules shard
    only dims that do)."""
    out = list(shape)
    for i, ent in enumerate(spec):
        n = _axis_size(mesh, ent)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"evenly over {ent} ({n})")
        out[i] //= n
    return tuple(out)


def place_empty(like: Any, specs: Any, mesh) -> Any:
    """DTensors shaped and typed like ``like`` (a tree of tensors,
    ``meta`` ones included) laid out by ``specs``, each local shard
    uninitialised on the mesh's device type: under ``FakeTensorMode``
    (the dry run) they are fake, and nothing is allocated or sent."""
    from torch.distributed.tensor import DTensor
    if isinstance(like, dict):
        return {k: place_empty(v, specs[k], mesh) for k, v in like.items()}
    local = torch.empty(local_shape(tuple(like.shape), specs, mesh),
                        dtype=like.dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, placements(specs, mesh),
                              run_check=False, shape=like.shape,
                              stride=like.stride())


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, shape: tuple, mesh, pol: ShardingPolicy,
               stacked: bool) -> Spec:
    """Base spec for a parameter leaf; `stacked` marks a leading layer dim."""
    tp = pol.wide_axis if pol.two_d else pol.tp_axis
    dims = list(shape[1:]) if stacked else list(shape)

    def spec(*entries):
        entries = list(entries) + [None] * (len(dims) - len(entries))
        # drop shardings that do not divide
        return [a if (a is not None and _divides(dims[i], mesh, a)) else None
                for i, a in enumerate(entries)]

    if path.endswith("embed"):
        ent = spec(tp, None)
    elif path.endswith("lm_head") or path.endswith("patch_proj"):
        ent = spec(None, tp)
    elif any(path.endswith(s) for s in ("wq", "wk", "wv", "w1")):
        ent = spec(None, tp)
    elif any(path.endswith(s) for s in ("wo", "w2")):
        ent = spec(tp, None)
    elif path.endswith("b1"):
        ent = spec(tp)
    elif "moe" in path and path[-2:] in ("wg", "wu"):
        # [E, d, ff]: prefer expert parallelism; else shard ff
        if _divides(dims[0], mesh, tp):
            ent = spec(tp, None, None)
        else:
            ent = spec(None, None, tp)
    elif "moe" in path and path.endswith("wd"):
        if _divides(dims[0], mesh, tp):
            ent = spec(tp, None, None)
        else:
            ent = spec(None, tp, None)
    elif path.endswith("wg") or path.endswith("wu"):
        ent = spec(None, tp)
    elif path.endswith("wd"):
        ent = spec(tp, None)
    elif path.endswith("in_proj"):
        ent = spec(None, tp)
    elif path.endswith("out_proj"):
        ent = spec(tp, None)
    else:
        # norms, biases, router, conv, A_log, D, dt_bias, enc_pos, ...
        ent = [None] * len(dims)

    # FSDP: put the dp axis on the largest still-unsharded dim of big leaves
    if pol.fsdp and math.prod(shape) >= pol.fsdp_min_elems:
        dp = pol.dp_spec
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if ent[i] is None and _divides(dims[i], mesh, dp):
                ent[i] = dp
                break

    if stacked:
        ent = [None] + ent
    return Spec(*ent)


@functools.lru_cache(maxsize=16)
def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shapes and dtypes only),
    one tree a config (callers read it and make their own tensors)."""
    return lm.init_params(cfg, device="meta")


def param_specs(cfg: ModelConfig, mesh, pol: Optional[ShardingPolicy] = None,
                like: Optional[Params] = None) -> Params:
    """:class:`Spec` tree mirroring ``lm.init_params`` (``like``, a tree
    of the same shapes, saves building the ``meta`` one)."""
    pol = pol or for_mesh(mesh)

    def one(path: str, leaf):
        stacked = path.split("/")[0] in ("layers", "enc_layers")
        return _leaf_spec(path, tuple(leaf.shape), mesh, pol, stacked)

    return map_named(one, like if like is not None else abstract_params(cfg))


def param_shardings(cfg: ModelConfig, mesh,
                    pol: Optional[ShardingPolicy] = None) -> Params:
    """:func:`param_specs` on ``mesh``, a :class:`NamedSharding` a leaf."""
    return shardings(param_specs(cfg, mesh, pol), mesh)


def shardings(specs: Any, mesh) -> Any:
    """A :class:`NamedSharding` on ``mesh`` for each spec of ``specs``."""
    if isinstance(specs, dict):
        return {k: shardings(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_dim(mesh, batch_size: int, pol: ShardingPolicy):
    """The entry of a batch dim of ``batch_size``: the batch axes where
    they divide it, else ``data`` where it does, else ``None``."""
    dp = pol.batch_spec_axes
    return dp if _divides(batch_size, mesh, dp) else (
        "data" if _divides(batch_size, mesh, "data") else None)


def batch_spec(cfg: ModelConfig, mesh, batch_size: int,
               pol: Optional[ShardingPolicy] = None) -> dict:
    """Specs for a training/prefill batch dict."""
    pol = pol or for_mesh(mesh)
    bdim = batch_dim(mesh, batch_size, pol)
    d = {"tokens": Spec(bdim, None), "labels": Spec(bdim, None)}
    if cfg.vlm is not None:
        d["patches"] = Spec(bdim, None, None)
    if cfg.encdec is not None:
        d["frames"] = Spec(bdim, None, None)
    return d


def cache_specs(cfg: ModelConfig, mesh, batch_size: int,
                pol: Optional[ShardingPolicy] = None) -> dict:
    """Specs for the decode cache tree (mirrors lm.init_decode_cache).

    B >= dp: shard batch over dp; B == 1 (long-context): shard the cache
    *sequence* dim over the data axis (sequence parallelism) and heads over
    the model axis.
    """
    pol = pol or for_mesh(mesh)
    tp = pol.tp_axis
    bdim = batch_dim(mesh, batch_size, pol)
    seq_axis = pol.dp_spec if bdim is None else None   # SP fallback for B=1
    if pol.two_d:
        # resident-weight serving: batch replicated, cache SEQUENCE sharded
        # over every axis
        bdim, seq_axis = None, pol.wide_axis

    c: dict = {"len": Spec()}
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        nkv = cfg.n_kv_heads if cfg.family != "audio" else cfg.n_heads
        kvdim = tp if (not pol.two_d and _divides(nkv, mesh, tp)) else None
        c["k"] = Spec(None, bdim, seq_axis, kvdim, None)
        c["v"] = Spec(None, bdim, seq_axis, kvdim, None)
        if cfg.kv_quant and cfg.family != "audio":
            c["k_scale"] = Spec(None, bdim, seq_axis, kvdim)
            c["v_scale"] = Spec(None, bdim, seq_axis, kvdim)
        if cfg.family == "audio":
            c["xk"] = Spec(None, bdim, None, kvdim, None)
            c["xv"] = Spec(None, bdim, None, kvdim, None)
    elif cfg.family in ("ssm", "hybrid"):
        nh = cfg.ssm.n_heads(cfg.d_model)
        hdim = tp if _divides(nh, mesh, tp) else None
        c["ssm"] = Spec(None, bdim, hdim, None, None)
        c["conv"] = Spec(None, bdim, None, None)
        if cfg.family == "hybrid":
            kvdim = tp if _divides(cfg.n_kv_heads, mesh, tp) else None
            c["k"] = Spec(None, bdim, seq_axis, kvdim, None)
            c["v"] = Spec(None, bdim, seq_axis, kvdim, None)
    return c


def logical_axis_rules() -> list[tuple]:
    """Documented axis mapping (for debugging)."""
    return [
        ("batch", ("pod", "data")),
        ("vocab", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("mlp", ("model",)),
        ("experts", ("model",)),
        ("cache_seq", ("data",)),
    ]

"""Gradient compression with error feedback.

The port of the reference's ``distributed/compress.py``: each gradient
leaf is quantized to int8 with a per-leaf float32 scale before it crosses
the data-parallel group, a quarter of a float32 gradient's bytes, and the
quantization error is kept and added back on the next step (*error
feedback*: Seide et al., 1-bit SGD; Karimireddy et al., EF-SGD), which
preserves convergence.

On the port's side the reference's ``pmax`` and ``psum`` over a mapped
axis are all-reduces over a ``DeviceMesh`` dim's group
(``torch.distributed._functional_collectives``, MAX for the shared scale,
SUM of the payload widened to int32: 512 ranks x 127 < 2^31), and the
rounding is half to even, as ``jnp.round`` rounds, so equal float32
inputs give equal bits.  Every function takes plain tensors or DTensors;
a DTensor leaf is compressed on its local shard (the error accumulator
is laid out as the gradient is, so it adds no replicated memory).
"""

from __future__ import annotations

from typing import Any

import torch

from ..dtensor import is_dtensor
from ..tree import tree_map

Params = Any


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as the reference divides: by a Python
    number, a CUDA tensor is multiplied by the divisor's rounded
    reciprocal instead, which can differ in the last bit."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns ``(q, scale)``,
    ``scale`` a 0-d float32 tensor."""
    gf = _local(g).float()
    scale = _div(torch.clamp(gf.abs().max(), min=1e-30), 127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Params) -> Params:
    """Residual accumulator, one float32 leaf per gradient leaf (a DTensor
    leaf's accumulator is its local shard's shape)."""
    return tree_map(lambda p: torch.zeros(_local(p).shape,
                                          dtype=torch.float32,
                                          device=_local(p).device), params)


def compress_grads(grads: Params, err: Params) -> tuple[Params, Params]:
    """Error feedback and int8 quantization, locally.

    Returns ``(pairs, new_err)``: ``pairs`` the gradients' tree with a
    ``(q, scale)`` tuple as each leaf, ``new_err = corrected -
    dequant(q)`` where ``corrected = g + err``.  The caller sums the int32
    view of each ``q`` across the data-parallel group
    (:func:`compressed_psum`)."""
    def one(g, e):
        corrected = _local(g).float() + e
        q, scale = quantize_int8(corrected)
        return (q, scale), corrected - dequantize_int8(q, scale)
    return _unzip(tree_map(one, grads, err))


def _unzip(tree: Params) -> tuple[Params, Params]:
    """A tree of ``(a, b)`` leaves as the two trees of the a's and the
    b's (the trees are nested dicts, so a tuple is a leaf)."""
    return tree_map(lambda t: t[0], tree), tree_map(lambda t: t[1], tree)


def _group(mesh, dim) -> tuple:
    """The ``(mesh, dim)`` group the functional collectives take, ``dim``
    a mesh dim's name or index; and its size."""
    d = mesh.mesh_dim_names.index(dim) if isinstance(dim, str) else dim
    return (mesh, d), mesh.size(d)


def ef_compressed_mean(grads: Params, err: Params, mesh,
                       dim: Any = "data") -> tuple[Params, Params]:
    """Error-feedback int8 mean of the gradients over ``mesh``'s dim
    ``dim`` (the reference's ``axis``).

    The quantization scale is shared across the group (an all-reduce MAX
    of one scalar a leaf), so the int8 payloads sum exactly: the only
    error is each rank's own rounding, which error feedback re-injects on
    the next step.  Returns ``(mean float32, new_err)``, local shards for
    DTensor leaves."""
    import torch.distributed._functional_collectives as funcol
    group, n = _group(mesh, dim)

    def one(g, e):
        corrected = _local(g).float() + e
        amax = torch.clamp(corrected.abs().max(), min=1e-30)
        scale = _div(funcol.all_reduce(amax, "max", group), 127.0)
        q = torch.clamp(torch.round(corrected / scale), -127, 127)
        tot = funcol.all_reduce(q.to(torch.int32), "sum", group)
        return _div(tot.float() * scale, n), corrected - q * scale
    return _unzip(tree_map(one, grads, err))


def compressed_psum(pairs: Params, mesh, dim: Any = "data") -> Params:
    """Mean of quantized gradients (:func:`compress_grads`' pairs) over
    ``mesh``'s dim ``dim``: each ``q`` widened to int32 and summed, the
    scales averaged — the mean of the dequantized values when the scales
    are equal, a bounded approximation otherwise (the error lands in the
    feedback accumulator either way)."""
    import torch.distributed._functional_collectives as funcol
    group, n = _group(mesh, dim)

    def one(pair):
        q, scale = pair
        tot = funcol.all_reduce(q.to(torch.int32), "sum", group)
        s = _div(funcol.all_reduce(scale, "sum", group), n)
        return _div(tot.float() * s, n)
    return tree_map(one, pairs)


def compression_error(g: torch.Tensor) -> float:
    """Relative L2 error of one quantize/dequantize round trip (no
    error feedback)."""
    q, s = quantize_int8(g)
    gf = _local(g).float()
    back = dequantize_int8(q, s)
    return float(torch.linalg.norm(gf - back)
                 / torch.clamp(torch.linalg.norm(gf), min=1e-30))

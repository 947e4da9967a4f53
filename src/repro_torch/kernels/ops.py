"""Model-layout entry points of the kernels, with their gradients.

The port's counterpart of the reference's ``kernels/ops.py``
(``flash_attention`` ``:100``, ``decode_attention`` ``:120``,
``ssd_scan`` ``:224``).  Each takes the model's layout (``[B, S, heads,
hd]`` activations, ``[B, S_max, nkv, hd]`` caches, ``[B, S, H, P]`` SSD
inputs), and the kernels read that layout through strides, so no
transpose is made here.  Routing is the one rule of :mod:`.dispatch`: a
CUDA tensor launches the kernel, whatever its shape (the kernels mask
ragged edges themselves, so the reference's fallback to the jnp oracle
for shapes that do not tile has no counterpart), and a CPU or meta tensor
takes the kernel's plain version.

Gradients, as the reference's ``jax.custom_vjp`` rules give them:

* :func:`flash_attention` is a ``torch.autograd.Function``: the forward
  kernel saves ``(q, k, v, out, lse)`` and the backward is the
  reference's ``_flash_bwd`` (``ops.py:50-89``) in torch ops — the
  reference computes it outside any Pallas kernel too;
* :func:`ssd_scan` is one as well: the backward recomputes through the
  model's chunked SSD in torch ops
  (:func:`repro_torch.models.layers.ssd_chunked` with ``use_kernel=False``)
  and takes autograd's vector-Jacobian product, the state's cotangent
  included.  (The reference recomputes through the sequential
  ``ref.ssd_scan_ref``, ``ops.py:214``, although its kernel's docstring
  names ``ssd_chunked``; a sequential scan would be 2,048 eager steps a
  layer here.)
* :func:`decode_attention` is serving only: an input that needs a
  gradient raises ``NotImplementedError``.

The three kernels' forwards are operators of the ``repro_torch``
namespace (``torch.ops.repro_torch.flash_attention_fwd``,
``decode_attention_fwd``, ``ssd_scan_fwd``), so ``torch.export`` keeps
each as one node and an AOTInductor package calls it through the
dispatcher (:mod:`repro_torch.core.compile_cache`): a CUDA tensor
reaches the wrapper that launches the kernel (and counts the launch), a
CPU tensor its plain version, and a fake tensor the operator's shape
function.  The entry points below call the operators; a call that needs
a gradient goes through the ``autograd.Function`` on top of the same
operator.  The registration is Python's (``torch.library.custom_op``):
the wrappers are Python over ``ctypes``, and a package run in a process
that imported this module finds them in the dispatcher as a C++
registration would be found.

Under a mesh (DTensor inputs, the sharded train step), each entry point
runs its kernel on the local shards (:func:`repro_torch.dtensor.local_call`,
the counterpart of a ``local_map``): batch split on a mesh dim, or heads
split (attention's query and KV heads together, so every shard keeps the
whole group ratio; the SSD scan's heads, its groups split with them or
replicated when there is one), or replicated; flash-decode also runs on
a cache split along its sequence (long-context decode at B = 1), each
rank's ``(out, lse)`` merged by three all-reduces
(:func:`merge_partials`).  Any other placement raises and names it; a
backward (flash's, the SSD recompute) runs on the same local shards.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..dtensor import (is_dtensor, local_call, same_rows, settle,
                       shard_offset)
from .decode_attention import decode_attention_fwd
from .flash_attention import _masks, flash_attention_fwd
from .ssd_scan import ssd_scan_fwd, ssd_sequence

Tensor = torch.Tensor


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# the kernels' forwards as operators
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       window: Optional[int]) -> tuple[Tensor, Tensor]:
    return flash_attention_fwd(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    B, Sq, nh, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, nh, Sq),
                                             dtype=torch.float32)


@torch.library.custom_op("repro_torch::decode_attention_fwd",
                         mutates_args=())
def decode_attention_op(q: Tensor, k: Tensor, v: Tensor,
                        kv_len: Tensor) -> Tensor:
    return decode_attention_fwd(q, k, v, kv_len)


@decode_attention_op.register_fake
def _(q, k, v, kv_len):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::decode_attention_lse_fwd",
                         mutates_args=())
def decode_attention_lse_op(q: Tensor, k: Tensor, v: Tensor,
                            kv_len: Tensor) -> tuple[Tensor, Tensor]:
    return decode_attention_fwd(q, k, v, kv_len, return_lse=True)


@decode_attention_lse_op.register_fake
def _(q, k, v, kv_len):
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def ssd_scan_op(xdt: Tensor, dA: Tensor, Bm: Tensor, Cm: Tensor, s0: Tensor,
                chunk: int) -> tuple[Tensor, Tensor]:
    return ssd_scan_fwd(xdt, dA, Bm, Cm, s0, chunk=chunk)


@ssd_scan_op.register_fake
def _(xdt, dA, Bm, Cm, s0, chunk):
    B, S, H, P = xdt.shape
    f32 = torch.float32
    return xdt.new_empty((B, S, H, P), dtype=f32), \
        xdt.new_empty((B, H, P, Bm.shape[3]), dtype=f32)


def _ssd_scan(xdt, dA, Bm, Cm, s0, *, chunk: int) -> tuple:
    return ssd_scan_op(xdt, dA, Bm, Cm, s0, chunk)


def _forward_only(op: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op}: serving only, the port's kernel has no backward (nor "
            f"has the reference's)")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_backward(q, k, v, out, lse, dout, *, causal: bool,
                   window: Optional[int]) -> tuple:
    """The reference's ``_flash_bwd`` from saved ``(q, k, v, out, lse)``,
    fp32 math; returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, nh, hd = q.shape
    Sk, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, Sq, nkv, g, hd).float()
    kf, vf = k.float(), v.float()
    dof = dout.reshape(B, Sq, nkv, g, hd).float()
    of = out.reshape(B, Sq, nkv, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    mask = _masks(Sq, Sk, causal, window, q.device)
    p = torch.exp(s - lse.reshape(B, nkv, g, Sq)[..., None])
    p = torch.where(mask, p, 0.0)
    dv_row = (dof * of).sum(dim=-1).permute(0, 2, 3, 1)    # [B,nkv,g,Sq]
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - dv_row[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_op(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout,
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention, model layout, differentiable.

    q: [B, Sq, nh, hd]; k/v: [B, Sk, nkv, hd].  Returns [B, Sq, nh, hd].
    """
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        q = _q_like_kv(q, k, 2, 2)
        kv_rule, pick = _kv_heads(q, k, 2, 2)
        return local_call(
            "flash_attention",
            lambda qq, kk, vv: flash_attention(qq, pick(kk), pick(vv),
                                               causal=causal, window=window),
            (q, k, v), (_rule(0, 2), kv_rule, kv_rule), (_rule(0, 2),))
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, window)
    return flash_attention_op(q, k, v, causal, window)[0]


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode against a cache (serving only).

    q: [B, nh, hd]; k/v: [B, S_max, nkv, hd]; kv_len: [B] int32 valid
    lengths on q's device.  Returns [B, nh, hd].
    """
    if any(is_dtensor(t) for t in (q, k, v, kv_len)):
        return _local_decode(q, k, v, kv_len)
    _forward_only("decode_attention", q, k, v)
    return decode_attention_op(q, k, v, kv_len)


def _local_decode(q, k, v, kv_len):
    """:func:`decode_attention` on local shards: batch split, heads
    split, or the cache's sequence split (K/V ``Shard(1)``, the query
    and lengths replicated), mixed across mesh dims.  Over a sequence
    split each rank runs the kernel on its rows with its local lengths
    and its ``(out, lse)`` are merged over the split dims
    (:func:`merge_partials`); a query split on its heads over such a dim
    (``ShardingPolicy(two_d=True)``) is gathered first, ``[B, nh, hd]``."""
    from torch.distributed.tensor import Replicate, Shard
    seq = [d for d, p in enumerate(k.placements) if p == Shard(1)] \
        if is_dtensor(k) else []
    if seq and is_dtensor(q) and any(q.placements[d] == Shard(1)
                                     for d in seq):
        q = q.redistribute(q.device_mesh, [Replicate() if d in seq else p
                                           for d, p in
                                           enumerate(q.placements)])
    q = _q_like_kv(q, k, 1, 2)
    q, kv_len = same_rows(q, kv_len)
    kv_rule, pick = _kv_heads(q, k, 1, 2)
    kv_rule = {**kv_rule, "seq": Shard(1)}
    s0 = shard_offset(k, 1) if seq else 0

    def run(qq, kk, vv, ln):
        kk, vv = pick(kk), pick(vv)
        if not seq:
            return decode_attention(qq, kk, vv, ln)
        _forward_only("decode_attention", qq, kk, vv)
        ln = (ln - s0).clamp(0, kk.shape[1]).to(torch.int32)
        out, lse = decode_attention_lse_op(qq, kk, vv, ln)
        return merge_partials(out, lse, [(k.device_mesh, d) for d in seq],
                              qq.dtype)
    return local_call(
        "decode_attention", run, (q, k, v, kv_len),
        ({**_rule(0, 1), "seq": None}, kv_rule, kv_rule,
         {**_rule(0, None), "seq": None}), ({**_rule(0, 1), "seq": None},))


def merge_partials(out: torch.Tensor, lse: torch.Tensor, groups: list,
                   dtype: torch.dtype) -> torch.Tensor:
    """Attention results over disjoint pieces of one cache, one piece a
    rank, merged into the result over the whole cache: ``out`` [B, nh,
    hd] and ``lse`` [B, nh] (float32 and unrounded, -inf where a piece
    holds no valid key) as the kernel gives them with its ``lse``,
    ``groups`` the ``(mesh, dim)`` groups the pieces are split over.  An
    all-reduce MAX of ``lse`` (M), then all-reduce SUMs of ``w = exp(lse
    - M)`` and of ``w * out`` in float32 over each group; ``out = sum(w
    out) / sum(w)`` rounded once to ``dtype``, zeros for a row with no
    valid key anywhere, as the kernel gives them."""
    import torch.distributed._functional_collectives as funcol
    m = lse
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    w = torch.where(lse == -math.inf, 0.0, torch.exp(lse - m))
    acc = w[..., None] * out
    for g in groups:
        w = funcol.all_reduce(w, "sum", g)
        acc = funcol.all_reduce(acc, "sum", g)
    den = torch.where(w > 0, w, 1.0)[..., None]
    return (acc / den).to(dtype)


# ---------------------------------------------------------------------------
# SSD scan (Mamba-2)
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, s0, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, s0)
        ctx.chunk = chunk
        return ssd_sequence(_ssd_scan, x, dt, A, Bm, Cm, D, chunk, s0)

    @staticmethod
    def backward(ctx, dy, dfinal):
        from ..models.layers import ssd_chunked
        saved = ctx.saved_tensors
        want = [i for i in range(len(saved)) if ctx.needs_input_grad[i]]
        grads = [None] * (len(saved) + 1)
        if want:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(i in want)
                       for i, t in enumerate(saved)]
                y, final = ssd_chunked(*ins[:6], ctx.chunk,
                                       init_state=ins[6], use_kernel=False)
                got = torch.autograd.grad((y, final), [ins[i] for i in want],
                                          (dy, dfinal))
            for i, g in zip(want, got):
                grads[i] = g
        return tuple(grads)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256,
             init_state: Optional[torch.Tensor] = None) -> tuple:
    """Chunked SSD sequence mixing (kernel-backed), differentiable.

    x: [B, S, H, P]; dt: [B, S, H]; A: [H]; Bm/Cm: [B, S, G, N]; D: [H];
    init_state: [B, H, P, N] or None (zeros).  Returns ``(y [B, S, H, P]
    in x's dtype, final_state [B, H, P, N] float32)``.
    """
    if any(is_dtensor(t) for t in (x, dt, A, Bm, Cm, D, init_state)):
        return _local_ssd(x, dt, A, Bm, Cm, D, chunk, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    s0 = init_state if init_state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    if _needs_grad(x, dt, A, Bm, Cm, D, s0):
        return _SSD.apply(x, dt, A, Bm, Cm, D, s0, chunk)
    return ssd_sequence(_ssd_scan, x, dt, A, Bm, Cm, D, chunk, s0)


# ---------------------------------------------------------------------------
# the kernels on local shards (DTensor inputs)
# ---------------------------------------------------------------------------

def _rule(batch: Optional[int], heads: Optional[int]) -> dict:
    """An argument's placement under a batch split (``Shard(batch)``) and
    under a heads split (``Shard(heads)``); None: replicated."""
    from torch.distributed.tensor import Shard
    return {"batch": None if batch is None else Shard(batch),
            "heads": None if heads is None else Shard(heads)}


def _q_like_kv(q, kv, q_dim: int, kv_dim: int):
    """``q`` split on its heads wherever K/V split theirs over a mesh dim
    that ``q`` is replicated on (a decode step's query after a gathered
    projection, cross-attention's query): a local slice, nothing is
    sent."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_dtensor(q) and is_dtensor(kv)):
        return q
    q = settle(q)
    pl = [Shard(q_dim) if isinstance(p, Replicate) and isinstance(w, Shard)
          and w.dim == kv_dim else p
          for p, w in zip(q.placements, kv.placements)]
    return q if pl == list(q.placements) else \
        q.redistribute(q.device_mesh, pl)


def _kv_heads(q, kv, q_dim: int, kv_dim: int) -> tuple:
    """K/V's placement rule and its local slicer for a call on ``q``'s
    shards.  Where ``q`` splits its heads on a mesh dim over which ``kv``
    is replicated (GQA with fewer KV heads than the split has ranks, as
    Qwen3-0.6B's 8 on a 16-way model axis), each rank takes from its
    whole K/V the heads of its own query heads' groups, a local slice:
    nothing is sent, and the backward's gradient of K/V is partial."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_dtensor(q) and is_dtensor(kv)) or not any(
            isinstance(p, Shard) and p.dim == q_dim
            and isinstance(w, Replicate)
            for p, w in zip(q.placements, kv.placements)):
        return _rule(0, kv_dim), lambda t: t
    g = q.shape[q_dim] // kv.shape[kv_dim]
    n = q.shape[q_dim] // math.prod(
        q.device_mesh.size(d) for d, p in enumerate(q.placements)
        if isinstance(p, Shard) and p.dim == q_dim)
    h0 = shard_offset(q, q_dim)
    lo, hi = h0 // g, (h0 + n - 1) // g + 1
    if n % g and hi - lo != 1:
        raise NotImplementedError(
            f"{n} query heads a shard straddle KV groups of {g}: no whole "
            f"group a shard (placements {tuple(q.placements)})")
    k0 = shard_offset(kv, kv_dim)
    return _rule(0, None), lambda t: t.narrow(kv_dim, lo - k0, hi - lo)


def _local_ssd(x, dt, A, Bm, Cm, D, chunk, init_state) -> tuple:
    """:func:`ssd_scan` on local shards: batch split, or heads split (the
    groups split with them, or replicated when there is one group)."""
    grp = None if Bm.shape[2] == 1 else 2
    args = [x, dt, A, Bm, Cm, D]
    rules = [_rule(0, 2), _rule(0, 2), _rule(None, 0), _rule(0, grp),
             _rule(0, grp), _rule(None, 0)]
    if init_state is not None:
        args.append(init_state)
        rules.append(_rule(0, 1))

    def run(*a):
        return ssd_scan(*a[:6], chunk=chunk,
                        init_state=a[6] if len(a) > 6 else None)
    return local_call("ssd_scan", run, args, rules,
                      (_rule(0, 2), _rule(0, 1)))

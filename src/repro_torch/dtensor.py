"""DTensor helpers of the sharded path.

The port runs a sharded step as the plain step on DTensor parameters,
state and batch (``torch.distributed.tensor``): DTensor's operator-level
propagation stands where the reference has XLA's GSPMD.  The model code
stays the plain code; these helpers are the few places where it must see
a DTensor:

* :func:`is_dtensor` — without importing ``torch.distributed.tensor``: no
  DTensor exists before that module is imported;
* :func:`sharded_context` — plain tensors made inside a sharded step (a
  ``torch.arange`` of positions, a mask) are taken as replicated
  (``implicit_replication``);
* :func:`settle` — a pending partial placement reduced to ``Replicate``
  now, an explicit all-reduce: after each row-parallel product (an
  attention's ``wo``, an MLP's down projection, Mamba2's ``out_proj``),
  as Megatron reduces it; left partial, DTensor carries the pending sum
  through the norm into the next product, whose every model rank then
  computes the whole width.  Its backward reduces the gradient's pending
  partial the same way (the column-parallel products downstream leave
  one): left partial, the row-parallel product's backward gathers its
  weight and every model rank computes the whole width again;
* :func:`vocab_embedding`, :func:`vocab_pick` — a lookup into a
  vocab-split table or logits: each rank takes the rows it holds and the
  partial sums are reduced (DTensor's own rule, a masked partial, cannot
  take a gradient back in every torch release);
* :func:`like_placements` — a step's outputs laid out as its inputs were
  (the reference's ``out_shardings``);
* :func:`local_call` — a kernel-backed op run on the local shards of its
  DTensor inputs, for the placements its kernel can take
  (:mod:`repro_torch.kernels.ops`: batch or heads splits, and
  flash-decode's sequence split).
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Any, Callable, Sequence

import torch

from .tree import leaves, tree_map


def is_dtensor(x: Any) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def sharded_context(tree: Any):
    """``implicit_replication()`` when ``tree`` holds a DTensor, else a
    null context."""
    if not any(is_dtensor(t) for t in leaves(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every partial placement reduced to ``Replicate``, and
    its gradient's too."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return _Settle.apply(x)


def _reduced(x: torch.Tensor) -> torch.Tensor:
    if not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


class _Settle(torch.autograd.Function):
    # DTensor's own backward of a partial-to-replicate redistribution
    # passes a partial gradient on as it is

    @staticmethod
    def forward(ctx, x):
        return _reduced(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on every mesh dim (a DTensor), else ``x``."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def whole_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``x`` ``[..., n_heads * hd]`` ready to be viewed as heads: a DTensor
    whose last dim is split over more shards than divide ``n_heads`` (8
    KV heads' projection over a 16-way model axis) is gathered on that
    dim first, an explicit all-gather, since no view splits a head."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    n = math.prod(x.device_mesh.size(d) for d, s in enumerate(split) if s)
    if n_heads % n == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if s else p for s, p
                                          in zip(split, x.placements)])


def shard_offset(x: torch.Tensor, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim``
    (even splits, mesh dims in order: the first splits outermost)."""
    from torch.distributed.tensor import Shard
    mesh, n, off = x.device_mesh, x.shape[dim], 0
    for d, (p, c) in enumerate(zip(x.placements, mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(d)
            off += c * n
    return off


def vocab_embedding(tokens: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; over a vocab-split table (a DTensor
    sharded on dim 0) each rank looks up the rows it holds, zeros for the
    others, and the partial sums are reduced by one all-reduce (the
    row-parallel pattern: no table is gathered)."""
    import torch.nn.functional as F
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    v0 = shard_offset(table, 0)

    def look(tok, tab):
        idx = tok - v0
        mine = (idx >= 0) & (idx < tab.shape[0])
        out = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return out * mine[..., None].to(out.dtype)
    return _vocab_call("embedding", look, tokens, table,
                       {"batch": _shard(0), "heads": None},
                       {"batch": None, "heads": _shard(0)})


def vocab_pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits.gather(-1, labels[..., None])[..., 0]``; over vocab-split
    logits (a DTensor sharded on the last dim) each rank picks the labels
    it holds, zeros for the others, reduced by one all-reduce."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    last = logits.ndim - 1
    logits, labels = same_rows(logits, labels)
    v0 = shard_offset(logits, last)

    def pick(lab, lg):
        idx = lab - v0
        mine = (idx >= 0) & (idx < lg.shape[-1])
        out = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return out[..., 0] * mine.to(out.dtype)
    return _vocab_call("vocab_pick", pick, labels, logits,
                       {"batch": _shard(0), "heads": None},
                       {"batch": _shard(0), "heads": _shard(last)})


def vocab_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h @ head`` (``[..., d] @ [d, V]``); for rows split or replicated
    and a head split on its vocab columns or replicated (DTensors: the
    sharded step's last product), each rank multiplies its rows by its
    columns, the logits laid out rows by vocab.  DTensor's own choice for
    this product replicated both on a 256-rank mesh, every rank computing
    every logit.  Other layouts (an FSDP-split head) take DTensor's."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_dtensor(h) and is_dtensor(head)):
        return h @ head
    last = h.ndim - 1
    fits = all(
        (isinstance(p, Replicate) or p == Shard(0))
        and (isinstance(w, Replicate) or w == Shard(1))
        and not (p == Shard(0) and w == Shard(1))
        for p, w in zip(h.placements, head.placements))
    if not fits:
        return h @ head
    return local_call("vocab_logits", torch.matmul, (h, head),
                      ({"batch": _shard(0), "heads": None},
                       {"batch": None, "heads": _shard(1)}),
                      ({"batch": _shard(0), "heads": _shard(last)},))


def same_rows(a, b) -> tuple:
    """``a`` and ``b`` (DTensors or a tensor, batch first) split their
    rows alike: on a mesh dim where one splits them and the other is
    replicated, the replicated one takes its slice (nothing is sent)."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(b):
        from torch.distributed.tensor import distribute_tensor
        b = distribute_tensor(b, a.device_mesh,
                              [Replicate()] * a.device_mesh.ndim,
                              src_data_rank=None)
    rows = [Shard(0) if Shard(0) in (p, q) else None
            for p, q in zip(a.placements, b.placements)]

    def take(x):
        pl = [r if r is not None and isinstance(p, Replicate) else p
              for r, p in zip(rows, x.placements)]
        return x if pl == list(x.placements) else \
            x.redistribute(x.device_mesh, pl)
    return take(a), take(b)


def _shard(d: int):
    from torch.distributed.tensor import Shard
    return Shard(d)


def _vocab_call(op, fn, index, split, index_rule, split_rule):
    """``fn`` on the local shards: batch split, or vocab split (the
    ``heads`` kind of :func:`local_call`), the output a partial sum over
    the vocab shards, reduced here."""
    from torch.distributed.tensor import Partial
    out = local_call(op, fn, (index, split), (index_rule, split_rule),
                     ({"batch": _shard(0), "heads": Partial()},))
    return settle(out)


def rows_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (``[B, ...]``) laid out as ``like`` (the batch's tokens:
    rows split or replicated, nothing else split), where they differ.
    The residual stream is held to the batch's layout at each layer: left
    free, DTensor may split its rows over the model axis too, and a later
    product with a model-split weight then takes a strategy whose local
    result is whole-size (a partial logits tensor of every vocab row)."""
    if not (is_dtensor(x) and is_dtensor(like)) or \
            tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def like_placements(new: Any, old: Any) -> Any:
    """Each DTensor leaf of ``new`` redistributed to the placements of the
    matching leaf of ``old``; other leaves as they are."""
    def one(n, o):
        if is_dtensor(o) and is_dtensor(n) and \
                tuple(n.placements) != tuple(o.placements):
            return n.redistribute(o.device_mesh, o.placements)
        return n
    return tree_map(one, new, old)


def local_call(op: str, fn: Callable, args: Sequence, rules: Sequence,
               out_rules: Sequence):
    """``fn(*locals)`` on the local shards of ``args``, its outputs (a
    tensor, or a tuple) wrapped as DTensors again.

    ``rules[i]`` names the placement argument ``i`` takes under each split
    of a mesh dim: ``{"batch": Shard(d) or None, "heads": Shard(d) or
    None}`` (None: replicated under that split), and a third kind where
    the op takes one (flash-decode's ``"seq"``, the cache's sequence:
    ``fn`` merges over those dims itself).  Each mesh dim must be
    ``Replicate`` on every argument, or split every argument as its rule
    says for one kind; ``out_rules`` lay the outputs out the same way.
    A partial placement (a sum DTensor has not done yet) is reduced first
    (:func:`settle`).  Every split dim must divide
    evenly, so that each shard holds whole rows and whole head groups.
    Any other placement raises and names it: nothing is gathered, and the
    kernel does not give way to its plain version.  An argument that is
    not a DTensor counts as replicated.  An argument replicated across a
    split mesh dim takes its gradient as a partial sum over that dim.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    args = [settle(a) for a in args]
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    if any(is_dtensor(a) and a.device_mesh != mesh for a in args):
        raise ValueError(f"{op}: DTensor inputs on different meshes")
    names = mesh.mesh_dim_names or tuple(range(mesh.ndim))

    def placement(a, d):
        return a.placements[d] if is_dtensor(a) else Replicate()

    splits = []
    for d in range(mesh.ndim):
        got = [placement(a, d) for a in args]
        fits = [k for k in rules[0]
                if all((r[k] or Replicate()) == p
                       for r, p in zip(rules, got))]
        if all(isinstance(p, Replicate) for p in got):
            splits.append(None)
        elif fits:
            splits.append(fits[0])
        else:
            raise NotImplementedError(
                f"{op}: placements {got} on mesh dim {names[d]!r} are not "
                f"a split its kernel runs on (every input Replicate, or "
                f"split " + ", or ".join(
                    f"by {k} {[r[k] for r in rules]}" for k in rules[0])
                + ")")
    for a in args:
        for p in {p for p in getattr(a, "placements", ())
                  if isinstance(p, Shard)}:
            n = math.prod(mesh.size(e) for e, q in enumerate(a.placements)
                          if q == p)
            if a.shape[p.dim] % n:
                raise NotImplementedError(
                    f"{op}: dim {p.dim} of {tuple(a.shape)} does not split "
                    f"evenly over {n} shards (placements "
                    f"{tuple(a.placements)})")

    def local(a, rule):
        # an input replicated across a split mesh dim gets a partial
        # gradient from each shard (its sum over the shard's rows or
        # heads), which the backward must add up
        grad = [Partial() if k is not None and rule[k] is None else p
                for k, p in zip(splits, a.placements)]
        return a.to_local(grad_placements=grad)
    out = fn(*[local(a, r) if is_dtensor(a) else a
               for a, r in zip(args, rules)])

    def wrap(t, rule):
        pl = [Replicate() if k is None else (rule[k] or Replicate())
              for k in splits]
        return DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, r) for t, r in zip(out, out_rules))
    return wrap(out, out_rules[0])

"""Pipeline parallelism as a task graph, lowered to point-to-point sends
on a ``stage`` mesh.

The port of the reference's ``distributed/pipeline.py``:

1. The pipeline schedule *is* a task graph — each stage a task, each
   microbatch hand-off a bounded channel (capacity = microbatches in
   flight).  :func:`schedule_task_graph` builds it with the port's own
   channels and tasks, and its coroutine engine verifies it
   (deadlock-freedom, occupancy bounds, FIFO arrival) before anything
   runs on a device.

2. The verified schedule runs on the ranks of one mesh dim (``stage``):
   :func:`spmd_pipeline` is GPipe over ``T = M + S - 1`` steps, each step
   a stage's compute, then a neighbour shift ``i -> i+1``
   (``batch_isend_irecv`` on the stage group: gloo has no all-to-all, so
   DTensor's permute, which goes through one, is not used), the last
   stage retiring microbatch ``t - (S - 1)``, and the last stage's
   outputs broadcast by a masked all-reduce SUM at the end.  The shift is
   a ``torch.autograd.Function`` whose backward sends each gradient back
   along the same edge (``i+1 -> i``), so ``torch.autograd`` runs the
   reverse pipeline, as ``jax.grad`` does through the reference's
   ``ppermute``; the broadcast's backward passes its gradient on as it is,
   so a loss that every stage computes from the broadcast outputs is
   counted once.

Where the reference compiles the whole ``shard_map`` through its compile
cache, :func:`compile_pipeline` caches the *stage body* at one
microbatch's shapes (an exported program on the CPU, an AOTInductor
package on the card) and runs the time loop and the shifts around the
loaded executable: point-to-point sends cannot go into a ``torch.export``
artifact.  Its key is the reference's: the stage function's structural
digest, the schedule builder's digest, the axis, ``S``, ``M``, the mesh's
shape and ranks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import torch

from ..core import channel, task
from ..core.engines import ENGINES, SimReport
from ..dtensor import is_dtensor
from ..tree import tree_map


# ---------------------------------------------------------------------------
# 1. the schedule as a task graph (simulation / verification side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    channel_capacity: int = 2        # in-flight microbatches per hand-off

    @property
    def bubble_fraction(self) -> float:
        """GPipe bubble: (S-1) / (M + S - 1)."""
        S, M = self.n_stages, self.n_microbatches
        return (S - 1) / (M + S - 1)


def schedule_task_graph(pcfg: PipelineConfig,
                        engine: str = "coroutine",
                        payloads: Optional[list] = None) -> SimReport:
    """Run the pipeline schedule as a task-parallel program.

    Feeder -> Stage_0 -> ... -> Stage_{S-1} -> Collector, every hand-off a
    bounded channel.  Returns the report (``track_stats=True``):
    ``report.result`` holds the microbatch ids in arrival order (FIFO
    when the schedule is sound), ``report.channels`` each hand-off's
    ``(name, tokens, max_occupancy)``.
    """
    S, M = pcfg.n_stages, pcfg.n_microbatches
    payloads = payloads if payloads is not None else list(range(M))

    def Feeder(out):
        for p in payloads:
            out.write(p)
        out.close()

    def Stage(inp, out):
        for p in inp:                 # drain one transaction
            out.write(p)              # unit of work per microbatch
        out.close()

    def Collector(inp, sink: list):
        for p in inp:
            sink.append(p)

    def Top(sink):
        chans = [channel(capacity=pcfg.channel_capacity, name=f"mb{i}")
                 for i in range(S + 1)]
        t = task().invoke(Feeder, chans[0])
        for i in range(S):
            t = t.invoke(Stage, chans[i], chans[i + 1], name=f"stage{i}")
        t.invoke(Collector, chans[S], sink)

    sink: list = []
    rep = ENGINES[engine](track_stats=True).run(Top, sink)
    rep.result = sink
    return rep


# ---------------------------------------------------------------------------
# 2. the GPipe schedule on a stage mesh
# ---------------------------------------------------------------------------

def _exchange(x: torch.Tensor, group, stage: int, n: int,
              to: int) -> torch.Tensor:
    """Send ``x`` to stage ``stage + to`` and receive the tensor of stage
    ``stage - to`` (zeros where there is none), ``to`` = +1 or -1, one
    ``batch_isend_irecv`` on the stage group."""
    import torch.distributed as dist
    out = torch.zeros_like(x)
    ops = []
    if 0 <= stage + to < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, stage + to), group))
    if 0 <= stage - to < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, stage - to), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage ``i``'s tensor to stage ``i + 1`` (stage 0 receives zeros);
    the backward sends the gradient back along the same edges."""

    @staticmethod
    def forward(ctx, x, group, stage, n):
        ctx.group, ctx.stage, ctx.n = group, stage, n
        return _exchange(x, group, stage, n, +1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.stage, ctx.n, -1), None, \
            None, None


class _Broadcast(torch.autograd.Function):
    """The sum over the stage group of each stage's (masked) tensor.  Every
    stage holds the same result and computes the same loss from it; that
    loss counts once, so the gradient passes on as it is (an all-reduce
    in the backward would add S equal seeds).

    ``shifted``: every shift's result on this rank, which the forward
    does not read.  Their gradients are zeros; they put each shift in the
    backward's graph on every rank, so each edge's send meets its
    receive (stage 0 never reads what it receives, and without them its
    shifts, which carry its gradients from stage 1, would not run)."""

    @staticmethod
    def forward(ctx, x, group, *shifted):
        import torch.distributed as dist
        ctx.shifted = [(t.shape, t.dtype, t.device) for t in shifted]
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad, None, *(torch.zeros(s, dtype=d, device=v)
                              for s, d, v in ctx.shifted))


def spmd_pipeline(stage_fn: Callable, n_stages: int, n_microbatches: int,
                  axis: str = "stage") -> Callable:
    """Build one rank's pipeline body.

    ``stage_fn(stage_params, x) -> y`` is one stage's compute (``y`` of
    ``x``'s shape); the returned function ``pipe(stage_params, xs,
    mesh)`` takes this rank's stage parameters (its slice of the stacked
    tree, leading dim 1), ``xs`` ``[M, mb, ...]`` (the same on every
    stage) and the mesh whose dim ``axis`` holds the stages, and returns
    the outputs ``[M, mb, ...]`` on every stage after the final
    broadcast.  Each of the ``T = M + S - 1`` steps computes, then shifts
    the result one stage on: one channel slot an edge a step, as the
    verified task graph has it.
    """
    S, M = n_stages, n_microbatches
    T = M + S - 1

    def pipe(stage_params, xs, mesh):
        group = mesh.get_group(axis)
        stage = mesh.get_local_rank(axis)
        state = torch.zeros_like(xs[0])
        outputs = [torch.zeros_like(xs[0])] * M
        shifted = []
        for t in range(T):
            # stage 0 ingests microbatch t (clamped: what it computes past
            # M is never written to the outputs)
            inp = xs[min(t, M - 1)] if stage == 0 else state
            out = stage_fn(stage_params, inp)
            state = _Shift.apply(out, group, stage, S)
            shifted.append(state)
            if stage == S - 1 and t >= S - 1:    # retires t - (S - 1)
                outputs[t - (S - 1)] = out
        return _Broadcast.apply(torch.stack(outputs), group, *shifted)

    return pipe


def _stage_slice(stacked: Any, mesh, axis: str) -> Any:
    """This rank's stage parameters: the local shard of each DTensor leaf
    (:func:`shard_stage_params`), or its own row ``[stage:stage+1]`` of a
    whole stacked leaf."""
    stage = mesh.get_local_rank(axis)
    return tree_map(lambda t: t.to_local() if is_dtensor(t)
                    else t[stage:stage + 1], stacked)


def _apply(pipe: Callable, mesh, axis: str, stacked_params: Any,
           microbatches: torch.Tensor) -> torch.Tensor:
    return pipe(_stage_slice(stacked_params, mesh, axis), microbatches, mesh)


def compile_pipeline(mesh, stage_fn: Callable, stacked_params: Any,
                     microbatches: torch.Tensor, *, axis: str = "stage",
                     cache=None) -> tuple:
    """The GPipe schedule around a stage body compiled through the compile
    cache (:mod:`repro_torch.core.compile_cache`).

    The body is cached at one microbatch's shapes and this rank's stage
    parameters; the key hashes the *user's stage definition*
    (``structural_digest(stage_fn)``) plus the schedule builder's digest
    (editing :func:`spmd_pipeline` dirties cached pipelines), the axis,
    the schedule's geometry and the mesh's shape and ranks.  An unchanged
    pipeline loads from the store; an edited stage body compiles afresh.
    Returns ``(run, source)``: ``run(stacked_params, microbatches)`` as
    :func:`pipeline_apply` runs it, ``source`` ``"memory"``, ``"disk"``
    or ``"compiled"``.  The body is compiled for the microbatches'
    device.
    """
    from ..core.compile_cache import (default_cache, instance_key,
                                      structural_digest)
    S, M = mesh.size(mesh.mesh_dim_names.index(axis)), microbatches.shape[0]
    local = _stage_slice(stacked_params, mesh, axis)
    dev = microbatches.device
    args = (local, microbatches[0])
    extra = ("spmd_pipeline", structural_digest(spmd_pipeline), axis, int(S),
             int(M), tuple(zip(mesh.mesh_dim_names, mesh.shape)),
             (mesh.device_type, tuple(mesh.mesh.flatten().tolist())))
    cc = cache if cache is not None else default_cache()
    key = instance_key(stage_fn, args, extra=extra, device=dev)
    exe, source = cc.compile_cached(stage_fn, args, key=key, device=dev)
    return partial(_apply, spmd_pipeline(exe, S, M, axis), mesh, axis), source


def pipeline_apply(mesh, stage_fn: Callable, stacked_params: Any,
                   microbatches: torch.Tensor, *, axis: str = "stage",
                   verify: bool = True, cache=False) -> torch.Tensor:
    """Verify the schedule in simulation, then run the pipeline on the
    mesh's ``axis`` ranks (this process is one of them).

    ``stacked_params``: a tree whose leaves carry a leading ``[S, ...]``
    stage dim, as :func:`shard_stage_params` lays them out (DTensors,
    ``Shard(0)`` on ``axis``) or whole on every rank.  ``microbatches``:
    ``[M, mb, ...]``, the same on every rank.  Returns the outputs
    ``[M, mb, ...]``, a plain tensor, the same on every rank.  ``cache``:
    ``False`` runs the stage eagerly; ``None`` routes the stage body
    through the process-default compile cache; a cache instance uses
    that store (:func:`compile_pipeline`).
    """
    S, M = mesh.size(mesh.mesh_dim_names.index(axis)), microbatches.shape[0]
    if verify:
        rep = schedule_task_graph(PipelineConfig(S, M))
        if not rep.ok:
            raise RuntimeError(f"pipeline schedule failed simulation: "
                               f"{rep.error}")
        if rep.result != list(range(M)):
            raise RuntimeError(f"pipeline schedule is not FIFO: "
                               f"{rep.result}")
    if cache is not False:
        run, _ = compile_pipeline(mesh, stage_fn, stacked_params,
                                  microbatches, axis=axis, cache=cache)
        return run(stacked_params, microbatches)
    return _apply(spmd_pipeline(stage_fn, S, M, axis), mesh, axis,
                  stacked_params, microbatches)


def pipeline_loss_fn(mesh, stage_fn: Callable, loss_tail: Callable, *,
                     axis: str = "stage") -> Callable:
    """Differentiable pipeline loss: ``loss_tail(outputs, labels)`` on the
    last stage's outputs ``[M, mb, ...]``, the same value on every rank.
    ``torch.autograd`` of it runs the reverse pipeline (backward
    microbatches traverse the same edges in reverse); the gradients of
    DTensor stage parameters are ``Shard(0)`` DTensors."""
    def fn(stacked_params, microbatches, labels):
        S = mesh.size(mesh.mesh_dim_names.index(axis))
        pipe = spmd_pipeline(stage_fn, S, microbatches.shape[0], axis)
        outs = _apply(pipe, mesh, axis, stacked_params, microbatches)
        return loss_tail(outs, labels)
    return fn


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def stack_stage_params(per_stage: list) -> Any:
    """Stack per-stage parameter trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage)


def shard_stage_params(mesh, stacked: Any, axis: str = "stage") -> Any:
    """Each leaf a DTensor on ``mesh``, ``Shard(0)`` on ``axis`` (each
    rank holds its stage's row) and replicated on any other dim.  Every
    rank passes the whole stacked tree; nothing is sent."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pl = [Shard(0) if n == axis else Replicate()
          for n in mesh.mesh_dim_names]
    return tree_map(lambda x: distribute_tensor(x, mesh, pl,
                                                src_data_rank=None), stacked)

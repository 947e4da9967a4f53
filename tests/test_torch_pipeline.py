"""Pipeline parallelism (``repro_torch.distributed.pipeline``) against the
reference's ``repro.distributed.pipeline``.

Mirrors ``tests/test_distributed.py`` (``test_pipeline_schedule_sim_and_
bubble``, ``test_pipeline_deadlocks_without_capacity``,
``test_pipeline_spmd_equivalence``): the schedule as a task graph under
both packages' engines; GPipe on a 4-rank ``stage`` mesh of gloo
processes (S 4, M 8, mb 2, d 16) against the reference's ``shard_map``
pipeline on 4 forced host devices and ``jax.grad`` of its sequential
loss (one subprocess); ``compile_pipeline`` through the compile cache.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro
import repro_torch
from repro.distributed import pipeline as RP
from repro_torch.distributed import pipeline as P

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 300
S, M, MB, D = 4, 8, 2, 16
# the reference's own bound (test_pipeline_spmd_equivalence), outputs and
# gradients: float32 products in another order
TOL = 1e-5


def _env(**extra):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    env.update(extra)
    return env


# ---------------------------------------------------------------------------
# the schedule as a task graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_,M_,cap", [(4, 8, 2), (1, 4, 2), (3, 5, 1),
                                       (8, 16, 4)])
def test_schedule_matches_reference(S_, M_, cap):
    """``ok``, the FIFO arrival order and every hand-off's tokens and
    occupancy equal the reference's; occupancy within the capacity."""
    pcfg = P.PipelineConfig(S_, M_, cap)
    rep = P.schedule_task_graph(pcfg)
    ref = RP.schedule_task_graph(RP.PipelineConfig(S_, M_, cap))
    assert rep.ok and ref.ok
    assert rep.result == ref.result == list(range(M_))
    assert rep.channels == ref.channels
    assert all(occ <= cap for (_, _, occ) in rep.channels)
    assert pcfg.bubble_fraction == RP.PipelineConfig(S_, M_).bubble_fraction


def test_bubble_fraction():
    assert P.PipelineConfig(4, 8, 2).bubble_fraction == pytest.approx(3 / 11)


@pytest.mark.parametrize("pkg", [repro, repro_torch])
def test_pipeline_deadlocks_without_capacity(pkg):
    """A stage that needs a second slot it does not have: the simulator
    reports deadlock, under both packages; capacity 1 suffices for a
    stage that forwards after two reads."""
    def Feeder(o):
        for i in range(2):
            o.write(i)
        o.close()

    def Greedy(i, o):
        a = i.read()
        b = i.read()
        i.open()
        o.write(a + b)
        o.close()

    def Top(sink):
        c1 = pkg.channel(capacity=1)
        c2 = pkg.channel(capacity=1)
        pkg.task().invoke(Greedy, c1, c2).invoke(Feeder, c1) \
            .invoke(lambda i, s: s.extend(v for v in i), c2, sink)

    sink = []
    rep = pkg.run(Top, sink, engine="coroutine")
    assert rep.ok and sink == [1]

    def Hostage(i, o):
        o.write(99)
        o.write(100)
        o.close()

    def Top2():
        c1 = pkg.channel(capacity=1)
        c2 = pkg.channel(capacity=1)
        pkg.task().invoke(Hostage, c1, c2).invoke(Feeder, c1)

    rep2 = pkg.run(Top2, engine="coroutine")
    assert not rep2.ok and "deadlock" in rep2.error.lower()


def test_pipeline_apply_refuses_an_unsound_schedule(monkeypatch):
    """``verify``: a schedule that fails simulation is never run."""
    from repro_torch.core.engines import SimReport
    bad = SimReport(engine="coroutine", ok=False, wall_s=0.0, switches=0,
                    n_instances=0, n_channels=0, tokens=0, error="deadlock")
    monkeypatch.setattr(P, "schedule_task_graph", lambda pcfg: bad)

    class Mesh:
        mesh_dim_names = ("stage",)

        def size(self, d):
            return 2
    import torch
    with pytest.raises(RuntimeError, match="failed simulation"):
        P.pipeline_apply(Mesh(), None, {}, torch.zeros(3, 1))


# ---------------------------------------------------------------------------
# GPipe on 4 gloo ranks against the reference's shard_map
# ---------------------------------------------------------------------------

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import (pipeline_apply, pipeline_loss_fn,
                                        stack_stage_params)
S, M, mb, d = {dims!r}
rng = np.random.default_rng(0)
w = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
xs = rng.standard_normal((M, mb, d)).astype(np.float32)
ys = rng.standard_normal((M, mb, d)).astype(np.float32)
# Auto axes, as the reference was written for (jax.make_mesh's default
# axes are Explicit in newer jax)
mesh = jax.make_mesh((S,), ("stage",),
                     axis_types=(jax.sharding.AxisType.Auto,))
stacked = stack_stage_params([{{"w": jnp.asarray(w[i])}} for i in range(S)])

def stage_fn(p, x):
    return jnp.tanh(x @ p["w"][0])

out = pipeline_apply(mesh, stage_fn, stacked, jnp.asarray(xs))
lf = pipeline_loss_fn(mesh, stage_fn, lambda o, y: jnp.mean((o - y) ** 2))

def seq_loss(st, xs, ys):
    h = xs
    for i in range(S):
        h = jnp.tanh(h @ st["w"][i])
    return jnp.mean((h - ys) ** 2)

loss = lf(stacked, jnp.asarray(xs), jnp.asarray(ys))
g_pipe = jax.grad(lf)(stacked, jnp.asarray(xs), jnp.asarray(ys))
g_seq = jax.grad(seq_loss)(stacked, jnp.asarray(xs), jnp.asarray(ys))
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(w=w, xs=xs, ys=ys, out=np.asarray(out),
                     loss=float(loss), g_pipe=np.asarray(g_pipe["w"]),
                     g_seq=np.asarray(g_seq["w"])), f)
"""

WORKER = """
import pickle, sys
import torch
import torch.distributed as dist
rank, port, inp, outp, root = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.compile_cache import CompileCache
from repro_torch.distributed.pipeline import (
    compile_pipeline, pipeline_apply, pipeline_loss_fn, shard_stage_params,
    stack_stage_params)
S, M, mb, d = {dims!r}
ref = pickle.load(open(inp, "rb"))
mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("stage",))
w, xs, ys = (torch.from_numpy(ref[k]) for k in ("w", "xs", "ys"))
stacked = stack_stage_params([{{"w": w[i]}} for i in range(S)])


def stage_fn(p, x):
    return torch.tanh(x @ p["w"][0])


out = pipeline_apply(mesh, stage_fn, stacked, xs)
sharded = shard_stage_params(mesh, stacked)
out_sharded = pipeline_apply(mesh, stage_fn, sharded, xs)
leaf = sharded["w"].detach().requires_grad_(True)
lf = pipeline_loss_fn(mesh, stage_fn, lambda o, y: torch.mean((o - y) ** 2))
loss = lf({{"w": leaf}}, xs, ys)
(grad,) = torch.autograd.grad(loss, [leaf])
res = dict(out=out.numpy(), out_sharded=out_sharded.numpy(),
           loss=float(loss), grad=grad.full_tensor().numpy(),
           grad_placements=str(grad.placements),
           local=sharded["w"].to_local().shape)

# the stage body through the compile cache (a store a rank): compiled,
# then loaded by a second cache on the same root, then an edited body
cache = CompileCache(root=f"{{root}}/rank{{rank}}")
run, src1 = compile_pipeline(mesh, stage_fn, stacked, xs, cache=cache)
res["compiled_out"] = run(stacked, xs).numpy()
_, src2 = compile_pipeline(mesh, stage_fn, stacked, xs,
                           cache=CompileCache(root=f"{{root}}/rank{{rank}}"))


def stage_fn(p, x):                       # the body edited
    return torch.tanh(x @ p["w"][0]) * 0.5


run3, src3 = compile_pipeline(
    mesh, stage_fn, stacked, xs,
    cache=CompileCache(root=f"{{root}}/rank{{rank}}"))
res["sources"] = [src1, src2, src3]
res["edited_out"] = run3(stacked, xs).numpy()
res["edited_eager"] = pipeline_apply(mesh, stage_fn, stacked, xs,
                                     verify=False).numpy()
dist.destroy_process_group()
with open(outp, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    dims = (S, M, MB, D)
    ref = d / "ref.pkl"
    r = subprocess.run([sys.executable, "-c", REF.format(dims=dims),
                        str(ref)], capture_output=True, text=True,
                       timeout=TIMEOUT, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(dims=dims), str(rank),
         str(port), str(ref), str(d / f"rank{rank}.pkl"), str(d / "cc")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for rank in range(S)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, errs[0]
    out = pickle.loads(ref.read_bytes())
    out["ranks"] = [pickle.loads((d / f"rank{r}.pkl").read_bytes())
                    for r in range(S)]
    return out


def _seq(w, xs):
    h = xs.astype(np.float64)
    for i in range(w.shape[0]):
        h = np.tanh(h @ w[i])
    return h


def test_pipeline_apply_matches_reference(pipeline_runs):
    """Every rank's outputs within ``TOL`` of the reference's pipeline and
    of the stages applied in sequence; whole stacked parameters and
    ``Shard(0)`` DTensors give the same bits."""
    ref = pipeline_runs
    want = _seq(ref["w"], ref["xs"])
    for r in ref["ranks"]:
        assert np.abs(r["out"] - ref["out"]).max() < TOL
        assert np.abs(r["out"] - want).max() < TOL
        assert np.array_equal(r["out"], r["out_sharded"])
        assert tuple(r["local"]) == (1, D, D)


def test_pipeline_loss_gradients_match_reference(pipeline_runs):
    """``torch.autograd`` through ``pipeline_loss_fn`` (the reverse
    pipeline over the same edges): the loss once, equal on every rank;
    the gradients, ``Shard(0)`` DTensors, within ``TOL`` of ``jax.grad``
    of the reference's sequential loss and of its pipeline loss."""
    ref = pipeline_runs
    losses = {r["loss"] for r in ref["ranks"]}
    assert len(losses) == 1
    assert abs(losses.pop() - ref["loss"]) < TOL
    for r in ref["ranks"]:
        assert r["grad_placements"] == "(Shard(dim=0),)"
        assert np.abs(r["grad"] - ref["g_seq"]).max() < TOL
        assert np.abs(r["grad"] - ref["g_pipe"]).max() < TOL


def test_compile_pipeline_through_the_cache(pipeline_runs):
    """The stage body compiled once, loaded from the store by a second
    cache on the same root, compiled afresh when edited; the compiled
    pipeline's outputs are the eager pipeline's."""
    for r in pipeline_runs["ranks"]:
        assert r["sources"] == ["compiled", "disk", "compiled"]
        assert np.abs(r["compiled_out"] - r["out"]).max() < TOL
        assert np.abs(r["edited_out"] - r["edited_eager"]).max() < TOL
        assert np.abs(r["edited_out"] - r["out"]).max() > 0.1

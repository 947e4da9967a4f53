"""Fault tolerance of training (``repro_torch.ft``) against the
reference's ``repro.ft``: the preemption guard's handler lifecycle and the
elastic re-mesh after rank loss.

Mirrors ``tests/test_ft.py`` (the six ``PreemptionGuard`` cases, shrink,
the loss of 2 of 8 devices) and ``tests/test_distributed.py``
(``test_elastic_remesh_shrinks_data_axis``, ``test_preemption_guard_
trigger``).  The guard cases run against both packages' guards in this
process.  The device loss runs on 8 gloo processes (every rank takes part
in the re-mesh, as ``ElasticMesh.remesh`` documents), the reference's on 8
forced host devices in one subprocess, on the same values.
"""

import os
import pickle
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.ft as RF
import repro_torch.ft as TF

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 300
PACKAGES = {"reference": RF, "port": TF}


def _env(**extra):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    env.update(extra)
    return env


# ---------------------------------------------------------------------------
# PreemptionGuard, each case under both packages
# ---------------------------------------------------------------------------

@pytest.fixture(params=list(PACKAGES))
def Guard(request):
    return PACKAGES[request.param].PreemptionGuard


SIGS = (signal.SIGTERM, signal.SIGINT)


def test_guard_install_uninstall_restores_handlers_exactly(Guard):
    before = {s: signal.getsignal(s) for s in SIGS}
    g = Guard()
    assert g.installed
    for s in before:
        assert signal.getsignal(s) == g._handler
    g.uninstall()
    assert not g.installed
    for s, h in before.items():
        assert signal.getsignal(s) == h


def test_guard_uninstall_is_idempotent_and_reinstallable(Guard):
    before = {s: signal.getsignal(s) for s in SIGS}
    g = Guard()
    g.uninstall()
    g.uninstall()
    for s, h in before.items():
        assert signal.getsignal(s) == h
    g.install()
    assert g.installed
    g.uninstall()
    for s, h in before.items():
        assert signal.getsignal(s) == h


def test_guard_double_install_rejected(Guard):
    g = Guard()
    try:
        with pytest.raises(ValueError):
            g.install()
    finally:
        g.uninstall()


def test_nested_guards_lifo_restore(Guard):
    before = signal.getsignal(signal.SIGTERM)
    outer = Guard()
    inner = Guard()
    assert signal.getsignal(signal.SIGTERM) == inner._handler
    inner.uninstall()
    assert signal.getsignal(signal.SIGTERM) == outer._handler
    outer.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_guard_context_manager_and_trigger(Guard):
    before = signal.getsignal(signal.SIGINT)
    with Guard() as g:
        assert not g.requested
        g.trigger()
        assert g.requested
    assert not g.installed
    assert signal.getsignal(signal.SIGINT) == before


def test_guard_handler_sets_requested_without_raising(Guard):
    g = Guard(install=False)
    assert not g.installed
    g._handler(signal.SIGTERM, None)
    assert g.requested
    g.uninstall()


def test_guard_trigger_without_install(Guard):
    g = Guard(install=False)
    assert not g.requested
    g.trigger()
    assert g.requested


# ---------------------------------------------------------------------------
# ElasticMesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp", [(8, 2), (6, 2), (7, 2), (512, 16),
                                  (448, 16), (1, 1), (8, 8)])
def test_shrink_matches_reference(n, mp):
    got = TF.ElasticMesh.shrink(n, mp)
    assert got == RF.ElasticMesh.shrink(n, mp)
    assert got[1] == mp and got[0] == n // mp


@pytest.mark.parametrize("n,mp", [(1, 2), (8, 16)])
def test_shrink_refuses_to_split_the_model_axis(n, mp):
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.ElasticMesh.shrink(n, mp)


REF = """
import os, pickle, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ft import ElasticMesh

devs = jax.devices()
assert len(devs) == 8, len(devs)
em = ElasticMesh()
mesh = em.remesh(devs, model_parallel=2)
specs = {"w": P("data", "model"), "b": P("model")}
tree = {"w": jnp.arange(12 * 8, dtype=jnp.float32).reshape(12, 8),
        "b": jnp.arange(8, dtype=jnp.float32)}
tree = ElasticMesh.reshard(tree, {k: NamedSharding(mesh, s)
                                  for k, s in specs.items()})
mesh2 = em.remesh(devs[:6], model_parallel=2)
shd2 = {k: NamedSharding(mesh2, s) for k, s in specs.items()}
tree2 = ElasticMesh.reshard(tree, shd2)
out = jax.jit(lambda t: jax.tree.map(lambda x: x * 2, t),
              out_shardings=shd2)(tree2)
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(
        shapes=[mesh.devices.shape, mesh2.devices.shape],
        used={k: sorted(d.id for d in v.sharding.device_set)
              for k, v in tree2.items()},
        out={k: np.asarray(v) for k, v in out.items()}), f)
"""

WORKER = """
import pickle, sys
import torch
import torch.distributed as dist
rank, port, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=8)
from repro_torch.distributed.sharding import NamedSharding, Spec
from repro_torch.ft import ElasticMesh

em = ElasticMesh()
mesh = em.remesh(model_parallel=2, device_type="cpu")
specs = {"w": Spec("data", "model"), "b": Spec("model")}
tree = {"w": torch.arange(12 * 8, dtype=torch.float32).reshape(12, 8),
        "b": torch.arange(8, dtype=torch.float32)}
tree = ElasticMesh.reshard(tree, {k: NamedSharding(mesh, s)
                                  for k, s in specs.items()})
# ranks 6 and 7 are lost: every rank takes part in the re-mesh and the
# gather on the old mesh; the survivors hold the new shards
survivors = list(range(6))
mesh2 = em.remesh(survivors, model_parallel=2, device_type="cpu")
tree2 = ElasticMesh.reshard(tree, {k: NamedSharding(mesh2, s)
                                   for k, s in specs.items()})
res = dict(shapes=[tuple(mesh.mesh.shape), tuple(mesh2.mesh.shape)],
           coord=mesh2.get_coordinate(),
           local={k: tuple(v.to_local().shape) for k, v in tree2.items()},
           placements={k: str(v.placements) for k, v in tree2.items()})
if rank in survivors:
    out = {k: (v * 2).full_tensor().numpy() for k, v in tree2.items()}
    res["out"] = out
    res["local_values"] = {k: v.to_local().numpy() for k, v in tree2.items()}
dist.destroy_process_group()
with open(outp, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def device_loss(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    ref = d / "ref.pkl"
    r = subprocess.run(
        [sys.executable, "-c", REF, str(ref)], capture_output=True,
        text=True, timeout=TIMEOUT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert r.returncode == 0, r.stderr[-3000:]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(port),
         str(d / f"rank{rank}.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env()) for rank in range(8)]
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
    return pickle.loads(ref.read_bytes()), [
        pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(8)]


def test_elastic_mesh_survives_device_loss(device_loss):
    """Lose 2 of 8 ranks: the (4, 2) mesh remeshed over the 6 survivors is
    (3, 2), as the reference's; the resharded values are exact, each
    survivor's shard the slice its coordinate names, no shard on the lost
    ranks; a step on the new mesh (x * 2) equals the reference's."""
    ref, ranks = device_loss
    assert [tuple(s) for s in ref["shapes"]] == [(4, 2), (3, 2)]
    assert ref["used"] == {"w": list(range(6)), "b": list(range(6))}
    w = np.arange(12 * 8, dtype=np.float32).reshape(12, 8)
    b = np.arange(8, dtype=np.float32)
    for rank, r in enumerate(ranks):
        assert [tuple(s) for s in r["shapes"]] == [(4, 2), (3, 2)]
        if rank >= 6:
            assert r["coord"] is None, r
            assert all(np.prod(s) == 0 for s in r["local"].values()), r
            continue
        i, j = r["coord"]
        assert r["placements"] == {"w": "(Shard(dim=0), Shard(dim=1))",
                                   "b": "(Replicate(), Shard(dim=0))"}
        np.testing.assert_array_equal(r["local_values"]["w"],
                                      w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(r["local_values"]["b"],
                                      b[4 * j:4 * j + 4])
        for k in ("w", "b"):
            np.testing.assert_array_equal(r["out"][k], ref["out"][k])
            np.testing.assert_array_equal(r["out"][k],
                                          {"w": w, "b": b}[k] * 2)

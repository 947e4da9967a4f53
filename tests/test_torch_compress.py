"""int8 gradient compression with error feedback
(``repro_torch.distributed.compress``) against the reference's
``repro.distributed.compress``, on the same numpy inputs made from a seed.

Mirrors ``tests/test_distributed.py`` (``test_compression_roundtrip_error_
bounded``, ``test_error_feedback_reduces_bias``,
``test_compressed_psum_shard_map``): the quantization and the error
feedback on one process, against the reference bit for bit; the group
mean on 4 gloo processes over a ``data`` mesh dim, against the true mean
and the reference's ``shard_map`` on 4 forced host devices (one
subprocess).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compress as RC
from repro_torch.distributed import compress as C

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 300
# the error state corrected - q * scale: XLA may contract the product and
# the difference into one fused multiply-add, which rounds once where
# torch rounds twice; the two differ by at most one ULP of the largest
# |q * scale|, 127 scale
ERR_ULPS = 1
# the group mean: an exact int32 sum times the shared scale over n, in
# float32 on both sides (XLA may fold scale / n first): a few ULPs of the
# mean's magnitude
MEAN_ULPS = 2


def _env(**extra):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    env.update(extra)
    return env


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "b": {"x": (rng.standard_normal(17) * 1e-3).astype(np.float32),
                  "ties": np.array([0.5, 1.5, -2.5, 127.0, -127.0, 63.5],
                                   np.float32),
                  "zero": np.zeros(5, np.float32)}}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def _ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32))


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_reference_bitwise(dtype):
    """``(q, scale)`` equal the reference's bit for bit: float32 and bf16
    gradients, a leaf with exact halves (round half to even), one of
    zeros (the 1e-30 floor)."""
    for path, g in _leaves(_grads(0)):
        jg = jnp.asarray(g).astype(dtype)
        tg = torch.from_numpy(g).to(getattr(torch, dtype))
        rq, rs = RC.quantize_int8(jg)
        q, s = C.quantize_int8(tg)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(rq)), path
        assert s.item() == float(rs), path
        np.testing.assert_array_equal(
            C.dequantize_int8(q, s).numpy(),
            np.asarray(RC.dequantize_int8(rq, rs)))


def test_compress_grads_matches_reference():
    """Three steps of error feedback from the same gradients: each step's
    ``(q, scale)`` pairs equal the reference's bit for bit (pairs are
    the leaves of the returned tree), the error state within
    ``ERR_ULPS`` of it."""
    g = _grads(1)
    jerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), g)
    terr = C.init_error_state({"w": torch.from_numpy(g["w"]),
                               "b": {k: torch.from_numpy(v)
                                     for k, v in g["b"].items()}})
    tg = {"w": torch.from_numpy(g["w"]),
          "b": {k: torch.from_numpy(v) for k, v in g["b"].items()}}
    for _ in range(3):
        rq, jerr = RC.compress_grads(g, jerr)
        tq, terr = C.compress_grads(tg, terr)
        for (path, (q, s)), (_, (rqq, rss)) in zip(
                _leaves(tq), _leaves(rq)):
            assert isinstance(rqq, jax.Array), path
            assert np.array_equal(q.numpy(), np.asarray(rqq)), path
            assert s.item() == float(rss), path
        for (path, e), (_, re_), (_, (q, s)) in zip(
                _leaves(terr), _leaves(jerr), _leaves(tq)):
            assert np.abs(e.numpy() - np.asarray(re_)).max() <= \
                ERR_ULPS * _ulp(127 * s.numpy()), path


def test_compression_roundtrip_error_bounded():
    g = np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32)
    err = C.compression_error(torch.from_numpy(g))
    assert err < 0.01
    assert err == pytest.approx(RC.compression_error(jnp.asarray(g)),
                                rel=1e-6)


def test_error_feedback_reduces_bias():
    """With error feedback the mean of the sent gradients converges to the
    true one (< 1e-3 after 20 steps), as in the reference."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((32, 32)).astype(np.float32)
    tg = {"g": torch.from_numpy(g)}
    err = C.init_error_state(tg)
    sent = torch.zeros(32, 32)
    for _ in range(20):
        qs, err = C.compress_grads(tg, err)
        sent = sent + C.dequantize_int8(*qs["g"])
    rel = float(torch.linalg.norm(sent / 20 - tg["g"])
                / torch.linalg.norm(tg["g"]))
    assert rel < 1e-3


# ---------------------------------------------------------------------------
# four gloo processes against the reference's shard_map
# ---------------------------------------------------------------------------

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed import compress as C

rng = np.random.default_rng(0)
gs = rng.standard_normal((4, 8, 8)).astype(np.float32)
es = (rng.standard_normal((4, 8, 8)) * 0.01).astype(np.float32)
mesh = jax.make_mesh((4,), ("data",))

def body(g, e):
    out, new_err = C.ef_compressed_mean({"g": g[0]}, {"g": e[0]}, "data")
    return out["g"][None], new_err["g"][None]

mean, new_err = jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 2,
                              out_specs=(P("data"),) * 2,
                              check_vma=False)(gs, es)

def pbody(g):
    qs, _ = C.compress_grads({"g": g[0]}, {"g": jnp.zeros_like(g[0])})
    return C.compressed_psum(qs, "data")["g"][None]

psum = jax.shard_map(pbody, mesh=mesh, in_specs=P("data"),
                     out_specs=P("data"), check_vma=False)(gs)
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(gs=gs, es=es, mean=np.asarray(mean),
                     new_err=np.asarray(new_err), psum=np.asarray(psum)), f)
"""

WORKER = """
import pickle, sys
import torch
import torch.distributed as dist
rank, port, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import compress as C
ref = pickle.load(open(inp, "rb"))
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
g = torch.from_numpy(ref["gs"][rank])
e = torch.from_numpy(ref["es"][rank])
mean, new_err = C.ef_compressed_mean({"g": g}, {"g": e}, mesh, "data")
zero = C.init_error_state({"g": g})
mean0, _ = C.ef_compressed_mean({"g": g}, zero, mesh, "data")
qs, _ = C.compress_grads({"g": g}, zero)
psum = C.compressed_psum(qs, mesh, "data")
dist.destroy_process_group()
with open(outp, "wb") as f:
    pickle.dump(dict(mean=mean["g"].numpy(), new_err=new_err["g"].numpy(),
                     mean0=mean0["g"].numpy(), psum=psum["g"].numpy()), f)
"""


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    ref = d / "ref.pkl"
    r = subprocess.run([sys.executable, "-c", REF, str(ref)],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(port), str(ref),
         str(d / f"rank{rank}.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env()) for rank in range(4)]
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
                    for r in range(4)]
    return out


def test_ef_compressed_mean_on_four_ranks(group_runs):
    """Each rank's mean is within 0.02 of the true mean (zero error state,
    the reference's bound), equal on every rank, and within
    ``MEAN_ULPS`` of the reference's ``shard_map`` output on the same
    inputs with an error state; the new error state within ``ERR_ULPS``
    of the reference's."""
    want = group_runs["gs"].mean(0)
    means = [r["mean0"] for r in group_runs["ranks"]]
    for m in means:
        rel = np.linalg.norm(m - want) / np.linalg.norm(want)
        assert rel < 0.02, rel
        assert np.array_equal(m, means[0])
    for rank, r in enumerate(group_runs["ranks"]):
        ref_mean = group_runs["mean"][rank]
        assert np.all(np.abs(r["mean"] - ref_mean)
                      <= MEAN_ULPS * _ulp(ref_mean)), rank
        top = np.abs(group_runs["gs"] + group_runs["es"]).max()  # 127 scale
        assert np.abs(r["new_err"] - group_runs["new_err"][rank]).max() \
            <= ERR_ULPS * _ulp(top), rank


def test_compressed_psum_on_four_ranks(group_runs):
    """The mean of the quantized pairs, scales averaged, within
    ``MEAN_ULPS`` of the reference's on every rank."""
    for rank, r in enumerate(group_runs["ranks"]):
        ref = group_runs["psum"][rank]
        assert np.all(np.abs(r["psum"] - ref) <= MEAN_ULPS * _ulp(ref)), \
            rank

"""The sharded train step on a 2 x 2 mesh of gloo processes, against the
port's single-process step and the reference's sharded step;
``launch.train`` through a mesh (``--model-parallel``) and checkpoints
across meshes.

Mirrors the reference's ``tests/test_distributed.py``
(``test_sharded_train_step_matches_single_device``): reduced Qwen3 (and a
1024-wide one, whose moments ZeRO-1 splits over the data axis) and
reduced Mamba2 (the SSD kernel's entry point on local shards), and one
with a single KV head, which the model axis cannot split: its projection
is gathered whole and each rank takes its query heads' group; and the
moe family at float32, whose expert slots are a prefix sum over every
token of the batch, split over the data axis.  The
reference runs its sharded step once, in a subprocess on 4 forced host
devices, and hands its parameters, batch and metrics over; four port
processes (gloo, ``tcp://localhost``) run the port's unsharded step and
its sharded step from the same parameters.  Each process and subprocess
has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
CASES = {"qwen3": ("qwen3-0.6b", {}),
         "qwen3_wide": ("qwen3-0.6b", {"d_model": 1024}),
         "qwen3_one_kv_head": ("qwen3-0.6b", {"n_kv_heads": 1}),
         "mamba2": ("mamba2-130m", {}),
         "granite_moe_f32": ("granite-moe-1b-a400m", {"dtype": "float32"})}
TIMEOUT = 420
# The first AdamW step's moments are 0.1 g and 0.05 g^2 (float32) of the
# clipped gradient g.  Relative error of a leaf's moments (L2) and the
# share of elements whose m differs in sign: bf16 models compute g
# through bf16 products (rounding 2^-8 a product, compounded over the
# layers); float32 ones through float32 products in another order.
MOMENT_TOL = {"bfloat16": dict(m_rel=5e-2, v_rel=1e-1, flip_share=1e-2),
              "float32": dict(m_rel=1e-5, v_rel=1e-5, flip_share=1e-4)}
# A new weight is p0 - lr (dir + wd p0), dir = m^ / (sqrt(v^) + eps)
# (+-1 where |g| >> eps): two steps' weights may differ by lr |dir_a -
# dir_b| plus each side's float32 arithmetic and its rounding to the
# leaf's dtype, counted in ULPs of the largest of p0, the new weights and
# lr.
UPDATE_ULPS = 4


def _env(**extra):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.launch.steps import make_train_step
from repro.models import lm
from repro.optim import AdamWConfig, adamw_init, opt_state_specs

cases = {cases!r}
out = {{}}
# Auto axes: GSPMD propagates the shardings, as the reference was written
# for (jax.make_mesh's default axes are Explicit in newer jax)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for name, (arch, kw) in cases.items():
    cfg = get_config(arch).with_reduced(**kw)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = lm.init_params(cfg, jax.random.key(0))
    state = adamw_init(params, opt)
    toks = jax.random.randint(jax.random.key(1), (4, 32), 0, cfg.vocab)
    batch = {{"tokens": toks, "labels": jnp.roll(toks, -1, 1)}}
    step = make_train_step(cfg, opt)
    pol = shd.for_mesh(mesh)
    pshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                          shd.param_specs(cfg, mesh, pol))
    oshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                          opt_state_specs(cfg, mesh, pol))
    bshard = {{k: NamedSharding(mesh, v)
              for k, v in shd.batch_spec(cfg, mesh, 4, pol).items()}}
    with mesh:
        p2, s2, m2 = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                             out_shardings=(pshard, oshard, None))(
            jax.device_put(params, pshard), jax.device_put(state, oshard),
            {{k: jax.device_put(v, bshard[k]) for k, v in batch.items()}})
    out[name] = dict(params=jax.tree.map(np.asarray, params),
                     batch={{k: np.asarray(v) for k, v in batch.items()}},
                     new_params=jax.tree.map(np.asarray, p2),
                     m=jax.tree.map(np.asarray, s2["m"]),
                     v=jax.tree.map(np.asarray, s2["v"]),
                     loss=float(m2["loss"]),
                     grad_norm=float(m2["grad_norm"]))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

WORKER = """
import json, pickle, sys
import torch
import torch.distributed as dist
rank, port, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.steps import make_train_step
from repro_torch.models.weights import from_jax_params
from repro_torch.optim import AdamWConfig, adamw_init, opt_state_specs
from repro_torch.tree import named_leaves, map_named

cases = {cases!r}
ref = pickle.load(open(inp, "rb"))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
coord = dict(zip(("data", "model"), mesh.get_coordinate()))
sizes = {{"data": 2, "model": 2}}


def spec_slice(shape, spec):
    out = []
    for dim, ent in enumerate(spec):
        axes = () if ent is None else (ent if isinstance(ent, tuple)
                                       else (ent,))
        k, idx = 1, 0
        for a in axes:
            idx, k = idx * sizes[a] + coord[a], k * sizes[a]
        step = shape[dim] // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shards_ok(tree, specs):
    bad = []
    sp = dict(named_leaves(specs)) if isinstance(specs, dict) else None
    for name, t in named_leaves(tree):
        spec = sp[name] if sp is not None else specs
        full = t.full_tensor()
        local = t.to_local()
        if tuple(t.placements) != shd.placements(spec, mesh) or \\
                not torch.equal(local, full[spec_slice(full.shape, spec)]):
            bad.append(name)
    return bad


def rel(a, b):
    # ||a - b|| / ||b||; ||a|| where b is 0
    a, b = a.double(), b.double()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float(a.norm())


def ulp(mag, dtype):
    # the spacing of dtype at each magnitude
    bits = {{torch.bfloat16: 7, torch.float32: 23}}[dtype]
    _, e = torch.frexp(mag.double())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                       e - 1 - bits)


def direction(m, v, opt):
    # AdamW's first-step direction from the moments, as adamw_update
    # computes it (the bias corrections of step 1)
    return (m.double() / (1 - opt.b1)) / (
        torch.sqrt(v.double() / (1 - opt.b2)) + opt.eps)


def update_stats(p0, a, b, opt):
    # the step a = (params, m, v) held to the step b from the same p0: the
    # worst relative error of a leaf's moments; the share of elements
    # whose first moments' signs differ; the most that two new weights
    # differ beyond what their own moments' directions explain
    # (lr * |dir_a - dir_b|), in ULPs of the largest of the old weight,
    # the new ones and lr (the update's arithmetic rounds at that
    # magnitude); the share of a's weights that moved
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    p0 = dict(named_leaves(p0))
    a, b = ([dict(named_leaves(t)) for t in x] for x in (a, b))
    m_rel = v_rel = excess = 0.0
    flips = n = moved = 0
    for k in p0:
        pa, ma, va = (full(t[k]) for t in a)
        pb, mb, vb = (t[k] for t in b)
        m_rel, v_rel = max(m_rel, rel(ma, mb)), max(v_rel, rel(va, vb))
        flips += int((torch.sign(ma) != torch.sign(mb)).sum())
        n += pa.numel()
        gap = (pa.double() - pb.double()).abs() - opt.lr * (
            direction(ma, va, opt) - direction(mb, vb, opt)).abs()
        mag = torch.stack([p0[k].double().abs(), pa.double().abs(),
                           pb.double().abs()]).amax(0).clamp(min=opt.lr)
        excess = max(excess, float((gap / ulp(mag, pa.dtype)).max()))
        moved += int((pa != p0[k]).sum())
    return dict(m_rel=m_rel, v_rel=v_rel, flip_share=flips / n,
                excess_ulps=excess, moved_share=moved / n)


res = {{}}
for name, (arch, kw) in cases.items():
    cfg = get_config(arch).with_reduced(**kw)
    r = ref[name]
    params = from_jax_params(r["params"], device="cpu")
    batch = {{k: torch.from_numpy(v) for k, v in r["batch"].items()}}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt, use_kernel=True)
    p1, s1, m1 = step(params, state, batch)
    pol = shd.for_mesh(mesh)
    pspec = shd.param_specs(cfg, mesh, pol)
    ospec = opt_state_specs(cfg, mesh, pol)
    bspec = shd.batch_spec(cfg, mesh, 4, pol)
    pd = shd.place_tree(params, pspec, mesh)
    sd = shd.place_tree(state, ospec, mesh)
    bd = {{k: shd.place(v, bspec[k], mesh) for k, v in batch.items()}}
    bad_in = shards_ok(pd, pspec) + shards_ok(sd["m"], ospec["m"]) + \\
        shards_ok(bd, bspec)
    # the placed inputs hold the whole tensors' slices
    bad_in += [n for n, t in named_leaves(pd)
               if not torch.equal(t.full_tensor(),
                                  dict(named_leaves(params))[n])]
    p2, s2, m2 = step(pd, sd, bd)
    bad_out = shards_ok(p2, pspec) + shards_ok(s2["m"], ospec["m"]) + \\
        shards_ok(s2["v"], ospec["v"])
    vs_unsharded = update_stats(params, (p2, s2["m"], s2["v"]),
                                (p1, s1["m"], s1["v"]), opt)
    vs_ref = update_stats(params, (p2, s2["m"], s2["v"]), [
        from_jax_params(r[k], device="cpu")
        for k in ("new_params", "m", "v")], opt)
    zero1 = sum(1 for n, s in named_leaves(ospec["m"])
                if tuple(s) != tuple(dict(named_leaves(pspec))[n]))
    res[name] = dict(
        loss1=float(m1["loss"]), loss2=float(m2["loss"].to_local()),
        gnorm1=float(m1["grad_norm"]),
        gnorm2=float(m2["grad_norm"].to_local()),
        metric_placements=[str(m2[k].placements) for k in m2],
        vs_unsharded=vs_unsharded, vs_ref=vs_ref, dtype=cfg.dtype,
        bad_in=bad_in, bad_out=bad_out, zero1=zero1,
        ref_loss=r["loss"], ref_grad_norm=r["grad_norm"])
dist.destroy_process_group()
with open(outp, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The reference's sharded steps (one subprocess), then the port's
    four gloo processes on the same parameters and batches."""
    d = tmp_path_factory.mktemp("sharded")
    ref = d / "ref.pkl"
    r = subprocess.run([sys.executable, "-c", REF.format(cases=CASES),
                        str(ref)], capture_output=True, text=True,
                       timeout=TIMEOUT, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(cases=CASES), str(rank),
         str(port), str(ref), str(d / f"rank{rank}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for rank in range(4)]
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
    return [json.loads((d / f"rank{rank}.json").read_text())
            for rank in range(4)]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_unsharded_and_reference(sharded_runs, case):
    for rank, res in enumerate(sharded_runs):
        r = res[case]
        # the port's sharded step against its unsharded step: the same
        # math in another order (bf16 weights; float32 reductions)
        assert abs(r["loss1"] - r["loss2"]) < 1e-3, (rank, r)
        assert abs(r["gnorm1"] - r["gnorm2"]) < 1e-2 * r["gnorm1"], r
        # the updated weights and moments, against the unsharded step's
        # and the reference's: the moments within the dtype's tolerance,
        # every new weight within UPDATE_ULPS of what the two steps' own
        # moments give, and nearly every weight moved (lr = 1e-3 is
        # several ULPs of a 0.02 bf16 weight), so an update that is not
        # applied or a moment that is lost fails
        tol = MOMENT_TOL[r["dtype"]]
        for other in ("vs_unsharded", "vs_ref"):
            st = r[other]
            assert st["m_rel"] < tol["m_rel"], (rank, other, st)
            assert st["v_rel"] < tol["v_rel"], (rank, other, st)
            assert st["flip_share"] < tol["flip_share"], (rank, other, st)
            assert st["excess_ulps"] <= UPDATE_ULPS, (rank, other, st)
            assert st["moved_share"] > 0.9, (rank, other, st)
        # the reference's sharded step, within its own test's 1e-3
        assert abs(r["loss2"] - r["ref_loss"]) < 1e-3, (rank, r)
        assert abs(r["gnorm2"] - r["ref_grad_norm"]) < \
            1e-2 * r["ref_grad_norm"], (rank, r)
        # every local shard is the slice of the whole tensor its spec
        # names, before and after the step; metrics replicated
        assert r["bad_in"] == [] and r["bad_out"] == [], (rank, r)
        assert all(p == "(Replicate(), Replicate())"
                   for p in r["metric_placements"]), r
    # every rank saw the same metrics
    assert len({sharded_runs[i][case]["loss2"] for i in range(4)}) == 1


def test_zero1_splits_the_wide_model_moments(sharded_runs):
    assert sharded_runs[0]["qwen3_wide"]["zero1"] > 0
    assert sharded_runs[0]["qwen3"]["zero1"] == 0


# ---------------------------------------------------------------------------
# launch.train through a mesh, and checkpoints across meshes
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--arch", "qwen3-0.6b", "--reduced",
              "--batch", "2", "--seq", "32", "--log-every", "100"]


def test_train_model_parallel_one_resumes(tmp_path):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.kernels.dispatch import launch_counts, reset_launches
    from repro_torch.launch.train import train
    import torch.distributed as dist
    args = TRAIN_ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                         "--model-parallel", "1", "--use-kernel"]
    assert train(args) == 0
    assert not dist.is_initialized()          # its group is gone
    assert CheckpointManager(tmp_path).latest_step() == 3
    reset_launches()
    assert train(args) == 0                    # resumes, runs no step
    assert launch_counts() == {}
    assert CheckpointManager(tmp_path).latest_step() == 3


def test_host_mesh_refuses_a_world_that_does_not_divide():
    import torch.distributed as dist
    from repro_torch.launch.mesh import destroy_host_group, make_host_mesh
    try:
        mesh = make_host_mesh(1, device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.size(i) for i in range(2)) == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(3, device="cpu")
    finally:
        destroy_host_group()
    assert not dist.is_initialized()


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="needs a world of 256"):
        make_production_mesh()


def _two_ranks(args, timeout=TIMEOUT):
    """``launch.train`` as ``torchrun --nproc-per-node 2`` would start it:
    two processes, the rendezvous in the environment."""
    port = str(_free_port())
    code = ("import sys; from repro_torch.launch.train import train; "
            "sys.exit(train(sys.argv[1:]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="localhost", MASTER_PORT=port))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _leaves_equal(a, b):
    from repro_torch.tree import named_leaves
    fa, fb = dict(named_leaves(a)), dict(named_leaves(b))
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def test_checkpoints_cross_meshes(tmp_path):
    """A 2-rank tensor-parallel run saves whole tensors that an unsharded
    run restores and continues; an unsharded run's checkpoint resumes
    under the 2-rank mesh."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b").with_reduced()
    like = lm.init_params(cfg, device="meta")
    olike = adamw_init(like, AdamWConfig())

    a = tmp_path / "a"
    outs = _two_ranks(TRAIN_ARGS + ["--steps", "2", "--ckpt-dir", str(a),
                                    "--model-parallel", "2"])
    assert "mesh={'data': 1, 'model': 2}" in outs[0] and not outs[1]
    got = CheckpointManager(a).restore_latest(like, olike, device="cpu")
    assert got is not None and got[0] == 2
    assert train(TRAIN_ARGS + ["--steps", "3", "--ckpt-dir", str(a)]) == 0
    assert CheckpointManager(a).latest_step() == 3

    b = tmp_path / "b"
    assert train(TRAIN_ARGS + ["--steps", "2", "--ckpt-dir", str(b)]) == 0
    saved = CheckpointManager(b).restore_latest(like, olike, device="cpu")
    # (a 4-step schedule: its learning rate is not yet 0 at step 3)
    outs = _two_ranks(TRAIN_ARGS + ["--steps", "4", "--ckpt-dir", str(b),
                                    "--model-parallel", "2"])
    assert "resumed from checkpoint step 2" in outs[0]
    after = CheckpointManager(b).restore_latest(like, olike, device="cpu")
    assert after[0] == 4 and not _leaves_equal(saved[1], after[1])


def test_restore_places_by_shardings(tmp_path):
    """``restore_latest(param_shardings=, opt_shardings=)`` on a one-rank
    mesh: every leaf a DTensor laid out by its spec, equal to the saved
    whole tensor."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import destroy_host_group, make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, opt_state_specs
    from repro_torch.tree import leaves
    cfg = get_config("mamba2-130m").with_reduced()
    opt = AdamWConfig()
    params = lm.init_params(cfg, 3, device="cpu")
    state = adamw_init(params, opt)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, params, state)
    try:
        mesh = make_host_mesh(1, device="cpu")
        pshard = shd.shardings(shd.param_specs(cfg, mesh), mesh)
        oshard = shd.shardings(opt_state_specs(cfg, mesh), mesh)
        step, p, s, _ = mgr.restore_latest(
            lm.init_params(cfg, device="meta"), adamw_init(
                lm.init_params(cfg, device="meta"), opt), device="cpu",
            param_shardings=pshard, opt_shardings=oshard)
        assert step == 5
        assert all(isinstance(t, DTensor) for t in leaves(p) + leaves(s))
        assert all(torch.equal(a.full_tensor(), b)
                   for a, b in zip(leaves(p), leaves(params)))
        # a mesh run's save writes the whole tensors again
        mgr.save(6, p, s)
        got = CheckpointManager(tmp_path).restore_latest(
            params, state, device="cpu")
        assert got[0] == 6 and _leaves_equal(got[1], params)
    finally:
        destroy_host_group()

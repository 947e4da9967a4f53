"""Flash-decode over a cache split along its sequence (long-context decode
at B = 1): the kernel's log-sum-exp output, the merge of the ranks'
partial results, and a sharded decode step against the unsharded one and
the reference's.

The reference splits a B = 1 decode cache's sequence over the data axis
(``cache_specs``; every axis under ``ShardingPolicy(two_d=True)``) and
GSPMD partitions the attention.  The port runs flash-decode on each
rank's rows and merges the ``(out, lse)`` pairs by three all-reduces
(``kernels/ops.py`` ``merge_partials``).  A reduced float32 zamba2 (four
layers: the shared attention block twice, two cache blocks) decodes one
token from a random cache of 37 valid rows of 64: on a 2 x 2 mesh split
in two the second half holds 5 valid rows, split in four the last
quarter holds none.  Under ``two_d`` a reduced float32 Qwen3 (two
layers) decodes from the same kind of cache.  The reference runs each
decode unsharded and on the same 2 x 2 mesh, in one subprocess on 4
forced host devices; four gloo processes run the port's.
"""

import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (_SIGNATURES,
                                                  decode_attention_fwd,
                                                  decode_attention_plain)

SRC = str(Path(__file__).resolve().parents[1] / "src")
CSRC = Path(SRC) / "repro_torch" / "kernels" / "csrc" / "decode_attention.cu"
TIMEOUT = 420
# policy -> (arch, layers, two_d): zamba2's decode (the long-context cell's
# family: the shared block twice, two cache blocks) under the default
# policy; Qwen3's under two_d (the reference's two_d cache spec of the
# hybrid family names the model axis twice, which jax refuses: ROADMAP,
# differences in the reference)
CASES = {"default": ("zamba2-1.2b", 4, False),
         "two_d": ("qwen3-0.6b", 2, True)}
S_MAX, LEN, SEED = 64, 37, 0
# float32 throughout: the sharded decode sums the attention's pieces and
# the row-parallel products in another order than the unsharded one
LOGIT_TOL = 1e-5          # relative to the largest |logit|
# the plain (out, lse) against a float64 evaluation of the same masked
# softmax: float32 scores and sums
LSE_TOL = 1e-5


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


# ---------------------------------------------------------------------------
# the kernel's entry point and its plain (out, lse)
# ---------------------------------------------------------------------------

def test_c_entry_takes_the_lse_pointer():
    """The C entry ``decode_attention`` and the ctypes signature name the
    same number of arguments (the lse pointer after the scratch)."""
    src = CSRC.read_text()
    head = re.search(r"int decode_attention\((.*?)\)\s*\{", src, re.S)
    params = [p for p in head.group(1).split(",") if p.strip()]
    assert len(params) == len(_SIGNATURES["decode_attention"])
    assert "float* lse" in head.group(1)


@pytest.mark.parametrize("group", [1, 2, 8])
def test_plain_lse_matches_float64(group):
    """``decode_attention_plain(..., return_lse=True)``: the output is the
    plain output before its rounding (float32; rounded to bfloat16 it is
    the bfloat16 plain output bit for bit), and ``lse`` is the float64
    log-sum-exp of each row's scaled scores over its valid keys, -inf
    where there is none."""
    rng = np.random.default_rng(group)
    B, S, nkv, hd = 5, 70, 2, 64
    nh = nkv * group
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    lens = np.array([0, 1, 37, 64, 70], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out, lse = decode_attention_plain(*args, return_lse=True)
    assert torch.equal(out, decode_attention_plain(*args))
    got = decode_attention_fwd(*args, return_lse=True)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    half = [a.bfloat16() for a in args[:3]] + [args[3]]
    out16, _ = decode_attention_plain(*half, return_lse=True)
    assert out16.dtype == torch.float32
    assert torch.equal(out16.bfloat16(), decode_attention_plain(*half))
    s = np.einsum("bkgh,bskh->bkgs", q.reshape(B, nkv, group, hd)
                  .astype(np.float64), k.astype(np.float64)) / math.sqrt(hd)
    for b in range(B):
        n = lens[b]
        if n == 0:
            assert torch.all(lse[b] == -math.inf)
            assert torch.all(out[b] == 0)
            continue
        row = s[b, ..., :n]
        m = row.max(-1, keepdims=True)
        want = (m + np.log(np.exp(row - m).sum(-1, keepdims=True)))[..., 0]
        np.testing.assert_allclose(
            lse[b].numpy(), want.reshape(nh), rtol=0,
            atol=LSE_TOL * max(1, abs(want).max()))


def _merged_pieces(dtype):
    """One cache cut along its sequence into 2, 4 and 16 pieces, the plain
    version run on each with its local lengths and the pieces merged as
    ``merge_partials`` merges them over ranks (here by hand, one
    process), rounded once to ``dtype``: ``(n, merged, whole)`` a cut,
    ``whole`` the whole cache's output."""
    rng = np.random.default_rng(3)
    B, S, nh, nkv, hd = 3, 64, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype)
               for s in ((B, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd)))
    lens = torch.tensor([0, 37, 64], dtype=torch.int32)
    whole = decode_attention_plain(q, k, v, lens)
    for n in (2, 4, 16):
        w = S // n
        parts = [decode_attention_plain(
            q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w],
            (lens - i * w).clamp(0, w).to(torch.int32), return_lse=True)
            for i in range(n)]
        m = torch.stack([p[1] for p in parts]).amax(0)
        ws = [torch.where(p[1] == -math.inf, 0.0, torch.exp(p[1] - m))
              for p in parts]
        den = sum(ws)
        num = sum(x[..., None] * p[0] for x, p in zip(ws, parts))
        yield n, (num / torch.where(den > 0, den, 1.0)[..., None]).to(
            dtype), whole


def test_pieces_merge_to_the_whole_cache():
    """Float32 pieces merged: the whole cache's output within 1e-6, exact
    zeros for the row with no valid key."""
    for n, got, whole in _merged_pieces(torch.float32):
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
        assert torch.all(got[0] == 0)


def test_bf16_pieces_merge_with_one_rounding():
    """Bfloat16 inputs: the pieces come out float32 and unrounded, so the
    merge is rounded once, as the whole cache's output is.  The two differ
    by at most one bfloat16 step (2**-7 of the magnitude), where float32
    sums taken in another order fall on either side of a rounding point;
    a merge of pieces rounded to bfloat16 first would not hold to it."""
    for n, got, whole in _merged_pieces(torch.bfloat16):
        mag = torch.maximum(got.float().abs(), whole.float().abs())
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                          - 7)
        assert bool(((got.float() - whole.float()).abs() <= step).all()), n
        assert torch.all(got[0] == 0)


def test_other_placements_still_raise():
    """A cache split along the sequence unevenly, or on its head width,
    raises and names the placements; nothing is gathered."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))

        def dt(shape, pl):
            return DTensor.from_local(torch.zeros(shape), mesh, [pl],
                                      run_check=False)
        q = dt((1, 4, 64), Replicate())
        lens = DTensor.from_local(torch.ones(1, dtype=torch.int32), mesh,
                                  [Replicate()], run_check=False)
        uneven = DTensor.from_local(torch.zeros(1, 16, 2, 64), mesh,
                                    [Shard(1)], run_check=False,
                                    shape=(1, 62, 2, 64),
                                    stride=(62 * 128, 128, 64, 1))
        with pytest.raises(NotImplementedError, match="does not split"):
            ops.decode_attention(q, uneven, uneven, lens)
        width = dt((1, 64, 2, 16), Shard(3))
        with pytest.raises(NotImplementedError,
                           match="decode_attention: placements"):
            ops.decode_attention(q, width, width, lens)


# ---------------------------------------------------------------------------
# the decode step on a 2 x 2 mesh
# ---------------------------------------------------------------------------

REF = """
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import lm

cases, s_max, length, seed = {args!r}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for name, (arch, layers, two_d) in cases.items():
    cfg = dataclasses.replace(
        get_config(arch).with_reduced(n_layers=layers, dtype="float32"),
        attn_impl="kernel")
    params = lm.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    cache = {{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in lm.init_decode_cache(cfg, 1, s_max).items()
             if k != "len"}}
    cache["len"] = np.int32(length)
    token = np.array([7], np.int32)
    step = jax.jit(lambda p, t, c: lm.decode_step(p, cfg, t, c))
    logits, _ = step(params, token, {{k: jnp.asarray(v)
                                      for k, v in cache.items()}})
    pol = dataclasses.replace(shd.for_mesh(mesh), two_d=two_d)
    specs = shd.cache_specs(cfg, mesh, 1, pol)
    ps = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      shd.param_specs(cfg, mesh, pol))
    cs = {{k: NamedSharding(mesh, s) for k, s in specs.items()}}
    with mesh:
        lg, _ = jax.jit(lambda p, t, c: lm.decode_step(p, cfg, t, c),
                        in_shardings=(ps, None, cs))(
            jax.device_put(params, ps), token,
            {{k: jax.device_put(jnp.asarray(v), cs[k])
             for k, v in cache.items()}})
    out[name] = dict(params=jax.tree.map(np.asarray, params), cache=cache,
                     token=token, logits=np.asarray(logits),
                     logits_sharded=np.asarray(lg),
                     cache_spec={{k: tuple(s) for k, s in specs.items()}})
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

WORKER = """
import dataclasses, json, pickle, sys
import torch
import torch.distributed as dist
rank, port, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.weights import from_jax_params

cases, s_max, length, seed = {args!r}
refs = pickle.load(open(inp, "rb"))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
merges = []
real = ops.merge_partials


def counted(out, lse, groups, dtype):
    merges.append(len(groups))
    return real(out, lse, groups, dtype)
ops.merge_partials = counted
res = {{}}
for name, (arch, layers, two_d) in cases.items():
    ref = refs[name]
    cfg = dataclasses.replace(
        get_config(arch).with_reduced(n_layers=layers, dtype="float32"),
        attn_impl="kernel")
    params = from_jax_params(ref["params"], device="cpu")
    cache = {{k: torch.as_tensor(v) for k, v in ref["cache"].items()}}
    token = torch.from_numpy(ref["token"])
    step = make_decode_step(cfg)
    logits, new_cache = step(params, token, {{k: v.clone()
                                              for k, v in cache.items()}})
    pol = dataclasses.replace(shd.for_mesh(mesh), two_d=two_d)
    pspec = shd.param_specs(cfg, mesh, pol)
    cspec = shd.cache_specs(cfg, mesh, 1, pol)
    pd = shd.place_tree(params, pspec, mesh)
    cd = {{k: shd.place(v.clone(), cspec[k], mesh) for k, v in cache.items()}}
    del merges[:]
    lg, c2 = step(pd, token, cd)
    lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
    res[name] = dict(
        unsharded=logits.tolist(), ref=ref["logits"].tolist(),
        sharded=lg.tolist(), ref_sharded=ref["logits_sharded"].tolist(),
        merges=list(merges), n_attn=sum(1 for _ in range(layers)
                                        if cfg.family == "dense")
        or layers // cfg.hybrid.attn_period,
        cache_spec=[list(cspec[k]) for k in ("k", "v")],
        ref_cache_spec=[list(ref["cache_spec"][k]) for k in ("k", "v")],
        kv_placements=[str(cd[k].placements) for k in ("k", "v")],
        # the new row against the unsharded step's, relative to its
        # largest magnitude; every other row as it was
        new_row={{k: float((c2[k].full_tensor() - new_cache[k]).abs().max()
                          / new_cache[k][:, :, length].abs().max())
                 for k in ("k", "v")}},
        others_kept={{k: bool(torch.equal(
            torch.cat([c2[k].full_tensor()[:, :, :length],
                       c2[k].full_tensor()[:, :, length + 1:]], 2),
            torch.cat([cache[k][:, :, :length],
                       cache[k][:, :, length + 1:]], 2)))
            for k in ("k", "v")}})
dist.destroy_process_group()
with open(outp, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def seq_split_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_decode")
    args = (CASES, S_MAX, LEN, SEED)
    ref = d / "ref.pkl"
    r = subprocess.run([sys.executable, "-c", REF.format(args=args),
                        str(ref)], capture_output=True, text=True,
                       timeout=TIMEOUT, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER.format(args=args), str(rank),
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


def _close(a, b, tol=LOGIT_TOL):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


@pytest.mark.parametrize("policy", list(CASES))
def test_unsharded_decode_matches_reference(seq_split_runs, policy):
    r = seq_split_runs[0][policy]
    assert _close(r["unsharded"], r["ref"])


@pytest.mark.parametrize("policy", list(CASES))
def test_sequence_split_decode(seq_split_runs, policy):
    """The cache's sequence split over the data axis (default policy; the
    heads over the model axis) or over both axes (``two_d``): the logits
    equal the unsharded decode's and the reference's sharded decode's
    within ``LOGIT_TOL``, on every rank; each attention application
    merged its ranks' partials over the split dims; the new token's K/V
    landed in the cache shard that holds its row (within ``LOGIT_TOL`` of
    the unsharded step's: its projection sums in another order), every
    other row untouched."""
    for r in seq_split_runs:
        got = r[policy]
        assert got["cache_spec"] == got["ref_cache_spec"], got
        seq_dims = 2 if CASES[policy][2] else 1
        assert got["kv_placements"][0].count("Shard(dim=2)") == seq_dims
        assert got["merges"] == [seq_dims] * got["n_attn"], got["merges"]
        assert _close(got["sharded"], got["unsharded"]), policy
        assert _close(got["sharded"], got["ref_sharded"]), policy
        assert max(got["new_row"].values()) <= LOGIT_TOL, got["new_row"]
        assert got["others_kept"] == {"k": True, "v": True}


def test_production_long_context_cell_merges():
    """``zamba2-1.2b x long_500k x pod16x16`` (256 fake ranks, the
    reference's ``shape_applicable`` cell): ok; its merge collectives
    are three all-reduces an application of the shared block (6 of 38
    layers), ``[1, 2]``, ``[1, 2]`` and ``[1, 2, 64]`` float32 (32 heads
    over a 16-way model axis), against the same cell with the merge's
    collectives taken out; no cache all-gather."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import fake_world, run_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-1.2b")
    merges, real = [], ops.merge_partials

    def counted(out, lse, groups, dtype):
        merges.append(tuple(out.shape))
        return real(out, lse, groups, dtype)
    recs = []
    try:
        for merge in (counted, lambda out, lse, groups, dtype:
                      out.to(dtype)):
            ops.merge_partials = merge
            with fake_world(256):
                recs.append(run_cell(cfg, SHAPES["long_500k"],
                                     make_production_mesh(), "pod16x16",
                                     verbose=False))
    finally:
        ops.merge_partials = real
    rec, bare = recs
    apps = cfg.n_layers // cfg.hybrid.attn_period
    assert rec["ok"] and merges == [(1, 2, cfg.hd)] * apps
    coll, without = rec["collectives"], bare["collectives"]
    assert coll["n_all-reduce"] - without["n_all-reduce"] == 3 * apps
    assert coll["all-reduce"] - without["all-reduce"] == \
        2 * apps * 4 * (2 + 2 + 2 * cfg.hd)
    assert coll["all-gather"] == without["all-gather"]

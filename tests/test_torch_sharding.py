"""The port's sharding rules against the reference's, spec for spec.

Every leaf of ``param_specs``, ``opt_state_specs``, ``batch_spec`` and
``cache_specs`` must equal the reference's exactly, for every assigned
architecture (grok-1's 8 experts on a 16-way model axis included), on the
production meshes and the small host meshes, under the default, FSDP,
two-d and batch-axes policies and at batch sizes 1, 8 and 256.  Neither
side needs a device or a process group: the reference's rules run on a
``jax.sharding.AbstractMesh``, the port's on its ``AbstractMesh``.  Then
the spec's DTensor placements: the local shard each rank of a fake
process group holds is the reference's addressable shard for the same
device index.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.optim import opt_state_specs as ref_opt_state_specs

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.optim import opt_state_specs
from repro_torch.tree import named_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
POLICIES = ("default", "fsdp", "two_d", "batch_axes")
BATCHES = (1, 8, 256)


def _policy(mod, mesh, which):
    pol = mod.for_mesh(mesh, fsdp=which == "fsdp")
    if which == "two_d":
        return mod.ShardingPolicy(dp_axes=pol.dp_axes, two_d=True)
    if which == "batch_axes":
        return mod.ShardingPolicy(dp_axes=pol.dp_axes, batch_axes=())
    return pol


def _meshes(name):
    sizes, names = MESHES[name]
    return (jax.sharding.AbstractMesh(sizes, names),
            shd.AbstractMesh(sizes, names))


def _ref_named(tree):
    """``{path: spec tuple}`` of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _spec_tree_named(tree, prefix=""):
    if isinstance(tree, shd.Spec):
        return {prefix[:-1] or "leaf": tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_spec_tree_named(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(autouse=True, scope="module")
def _reference_abstract_params_once():
    """The reference's rules build its abstract parameters on every call
    (``jax.eval_shape`` of the init); the grid calls them for the same
    configs many times, so each config's is built once here."""
    from repro.models import lm as ref_lm
    real = ref_lm.abstract_params
    ref_lm.abstract_params = functools.lru_cache(maxsize=None)(real)
    yield
    ref_lm.abstract_params = real


@functools.lru_cache(maxsize=None)
def _configs(arch):
    return ref_get_config(arch), get_config(arch)


def test_same_architectures():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh, policy):
    rcfg, cfg = _configs(arch)
    rmesh, pmesh = _meshes(mesh)
    rpol, pol = _policy(ref_shd, rmesh, policy), _policy(shd, pmesh, policy)
    assert _spec_tree_named(shd.param_specs(cfg, pmesh, pol)) == \
        _ref_named(ref_shd.param_specs(rcfg, rmesh, rpol))
    assert _spec_tree_named(opt_state_specs(cfg, pmesh, pol)) == \
        _ref_named(ref_opt_state_specs(rcfg, rmesh, rpol))
    for B in BATCHES:
        assert _spec_tree_named(shd.batch_spec(cfg, pmesh, B, pol)) == \
            _ref_named(ref_shd.batch_spec(rcfg, rmesh, B, rpol)), B
        assert _spec_tree_named(shd.cache_specs(cfg, pmesh, B, pol)) == \
            _ref_named(ref_shd.cache_specs(rcfg, rmesh, B, rpol)), B


def test_grok_experts_do_not_split_sixteen_ways():
    """8 experts over a 16-way model axis: the FFN width splits instead."""
    _, cfg = _configs("grok_1_314b")
    _, mesh = _meshes("16x16")
    sp = shd.param_specs(cfg, mesh)["layers"]["moe"]
    assert tuple(sp["wg"]) == (None, None, None, "model")
    assert tuple(sp["wd"]) == (None, None, "model", None)


def test_logical_axis_rules_match():
    assert shd.logical_axis_rules() == ref_shd.logical_axis_rules()


def test_device_mesh_refuses_more_devices_than_visible():
    with pytest.raises(ValueError, match=r"requested a 3-device mesh but "
                                         r"1 device\(s\) are visible"):
        shd.device_mesh(3, devices=[torch.device("cpu")])
    m = shd.device_mesh(2, devices=[torch.device("cpu")] * 2)
    assert m.shape == {"dev": 2} and len(m.devices) == 2


# ---------------------------------------------------------------------------
# placements: the local shard is the reference's addressable shard
# ---------------------------------------------------------------------------

SHARD_CASES = [
    ((4, 2), ("data", "model"), (8, 12), (None, "model")),
    ((4, 2), ("data", "model"), (8, 12), ("data", None)),
    ((4, 2), ("data", "model"), (16, 6), (("data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 6),
     (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (16, 2),
     (("pod", "data", "model"), None)),
]


REF_SHARDS = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = []
for sizes, names, shape, entries in json.loads(sys.argv[1]):
    entries = [tuple(e) if isinstance(e, list) else e for e in entries]
    n = int(np.prod(sizes))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(sizes), tuple(names))
    x = jax.device_put(np.arange(int(np.prod(shape))).reshape(shape),
                       NamedSharding(mesh, P(*entries)))
    out.append({str(s.device.id): [[sl.start or 0, shape[d] if sl.stop is
                                    None else sl.stop]
                                   for d, sl in enumerate(s.index)]
                for s in x.addressable_shards})
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_shards():
    """The reference's addressable shard of each device id (mesh devices
    row-major, as a DeviceMesh orders its ranks), on forced host devices
    in a subprocess."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {"PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    r = subprocess.run([sys.executable, "-c", REF_SHARDS,
                        json.dumps(SHARD_CASES)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("REF "))
    return json.loads(line[4:])


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_local_shard_is_reference_shard(ref_shards, case):
    """The port's DTensor on a fake process group holds, on every rank,
    exactly the reference's addressable shard of the same device index,
    a dim over several axes split data-major included."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes, names, shape, entries = SHARD_CASES[case]
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    n = int(np.prod(sizes))
    for rank in range(n):
        want = full[tuple(slice(a, b) for a, b in ref_shards[case][str(rank)])]
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=n)
        try:
            mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
            dt = shd.place(full, shd.Spec(*entries), mesh)
            assert isinstance(dt, DTensor)
            assert torch.equal(dt.to_local(), want), rank
        finally:
            dist.destroy_process_group()


def test_placements_refuse_axes_out_of_mesh_order():
    mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="mesh-dim order"):
        shd.placements(shd.Spec(("model", "data")), mesh)

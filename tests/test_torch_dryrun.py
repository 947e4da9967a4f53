"""The port's dry run against the reference's (``tests/test_launch.py``,
``test_dryrun_cell_small_mesh``): a reduced Qwen3's train, prefill and
decode cells on a fake (4, 2) mesh of 8 ranks, the inputs' bytes a rank
equal to the reference's ``memory_analysis().argument_size_in_bytes`` for
the same cell (compiled in a subprocess on 8 forced host devices); the
other families' cells and long-context decode; the collective counter on
hand-made records; ``probe_compiled``'s memo; the CLI on the production
mesh of 256 ranks."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.core.compile_cache import CompileCache
from repro_torch.launch.dryrun import collective_bytes, fake_world, run_cell
from repro_torch.models.config import InputShape

SRC = str(Path(__file__).resolve().parents[1] / "src")
CELLS = {"tiny_train": InputShape("tiny_train", 128, 8, "train"),
         "tiny_pre": InputShape("tiny_pre", 128, 8, "prefill"),
         "tiny_dec": InputShape("tiny_dec", 128, 8, "decode")}

REF = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.launch.dryrun import run_cell
from repro.models.config import InputShape

cfg = get_config("qwen3-0.6b").with_reduced()
# Auto axes: GSPMD propagates the shardings, as the reference was written
# for (jax.make_mesh's default axes are Explicit in newer jax)
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for layers in (cfg.n_layers, 1):
    for name, (S, B, kind) in %r.items():
        rec = run_cell(cfg.with_reduced(n_layers=layers),
                       InputShape(name, S, B, kind), mesh, "test4x2",
                       verbose=False)
        out[name if layers == cfg.n_layers else name + "/1"] = rec
print("REF " + json.dumps(out))
"""
# The reference scans its layers, and XLA's cost analysis counts a loop's
# body once: its FLOPs and collective bytes are those of a one-layer model
# plus what lies outside the scan.  Cost is compared on a one-layer model,
# where both count the whole step, within a factor: the same products
# (XLA adds its own elementwise and cache-update work; the port counts
# the kernels' full products), and two partitioners that may pick other
# collectives (the reference gathers the decode logits it returns, which
# the port leaves split on the vocab).
FLOPS_FACTOR = 2.0
COLL_FACTOR = 4.0


def _mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def port_cells():
    cfg = get_config("qwen3-0.6b").with_reduced()
    with fake_world(8):
        mesh = _mesh()
        return {name: run_cell(cfg, shape, mesh, "test4x2", verbose=False)
                for name, shape in CELLS.items()}


@pytest.fixture(scope="module")
def port_cells_one_layer():
    cfg = get_config("qwen3-0.6b").with_reduced(n_layers=1)
    with fake_world(8):
        mesh = _mesh()
        return {name: run_cell(cfg, shape, mesh, "test4x2", verbose=False)
                for name, shape in CELLS.items()}


@pytest.fixture(scope="module")
def ref_cells():
    cells = {k: (v.seq_len, v.global_batch, v.kind) for k, v in CELLS.items()}
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    r = subprocess.run([sys.executable, "-c", REF % (cells,)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("REF "))
    return json.loads(line[4:])


@pytest.mark.parametrize("cell", list(CELLS))
def test_dryrun_cell_small_mesh(port_cells, cell):
    rec = port_cells[cell]
    assert rec["ok"] and rec["n_devices"] == 8 and rec["mesh"] == "test4x2"
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_match_reference(port_cells, ref_cells, cell):
    """The local shard bytes of every input, a rank: the port's placed
    DTensors against XLA's argument buffers for the same cell."""
    assert ref_cells[cell]["ok"]
    assert port_cells[cell]["memory"]["argument_size_in_bytes"] == \
        ref_cells[cell]["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_cost_matches_reference_one_layer(port_cells_one_layer, ref_cells,
                                          cell):
    """FLOPs and collective bytes a rank against the reference's for the
    same one-layer cell (see ``FLOPS_FACTOR``)."""
    port, ref = port_cells_one_layer[cell], ref_cells[cell + "/1"]
    assert ref["ok"]
    r = port["cost"]["flops"] / ref["cost"]["flops"]
    assert 1 / FLOPS_FACTOR < r < FLOPS_FACTOR, (port["cost"], ref["cost"])
    r = port["collectives"]["total_bytes"] / \
        ref["collectives"]["total_bytes"]
    assert 1 / COLL_FACTOR < r < COLL_FACTOR, (port["collectives"],
                                               ref["collectives"])


def test_train_cell_flops_are_a_rank_share():
    """Local shapes: the 8-rank cell's FLOPs are about an eighth of the
    one-rank cell's (the whole step), not the whole step's."""
    cfg = get_config("qwen3-0.6b").with_reduced()
    shape = CELLS["tiny_train"]
    with fake_world(8):
        f8 = run_cell(cfg, shape, _mesh(), "test4x2",
                      verbose=False)["cost"]["flops"]
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(1):
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        f1 = run_cell(cfg, shape, one, "test1x1",
                      verbose=False)["cost"]["flops"]
    assert f1 / 12 < f8 < f1 / 4, (f1, f8)


# ---------------------------------------------------------------------------
# collective_bytes on hand-made records
# ---------------------------------------------------------------------------

def test_collective_bytes_conventions():
    recs = [{"kind": "all-gather", "bytes": 8 * 128 * 2, "ranks": [0, 1]},
            {"kind": "all-reduce", "bytes": 256 * 4, "ranks": [0, 2]},
            {"kind": "collective-permute", "bytes": 4 * 64 * 2},
            {"kind": "all-to-all", "bytes": 2 * 16 * 4, "ranks": [0, 1]},
            {"kind": "add", "bytes": 999}]
    out = collective_bytes(recs)
    assert out["all-gather"] == 8 * 128 * 2
    assert out["all-reduce"] == 256 * 4 * 2          # 2x for ring AR
    assert out["collective-permute"] == 4 * 64 * 2
    assert out["all-to-all"] == 2 * 16 * 4
    assert out["total_bytes"] == 8 * 128 * 2 + 256 * 4 * 2 + 4 * 64 * 2 \
        + 2 * 16 * 4
    assert out["n_all-reduce"] == 1 and out["n_all-gather"] == 1
    assert "reduce-scatter" not in out and "n_reduce-scatter" not in out
    assert "cross_pod_bytes" not in out


def test_collective_bytes_cross_pod():
    recs = [{"kind": "all-reduce", "bytes": 100, "ranks": [0, 256]},
            {"kind": "all-gather", "bytes": 10, "ranks": [3, 4, 255]},
            {"kind": "reduce-scatter", "bytes": 7, "ranks": [300, 511]},
            {"kind": "all-gather", "bytes": 5}]      # no groups: worst case
    out = collective_bytes(recs, pod_size=256)
    assert out["cross_pod_bytes"] == 200 + 5
    assert out["total_bytes"] == 200 + 10 + 7 + 5
    assert out["n_all-gather"] == 2 and out["n_reduce-scatter"] == 1


def test_collective_bytes_empty():
    assert collective_bytes([]) == {"total_bytes": 0}
    assert collective_bytes([], pod_size=256) == {"total_bytes": 0,
                                                  "cross_pod_bytes": 0}


# ---------------------------------------------------------------------------
# probe_compiled's memo and the CLI
# ---------------------------------------------------------------------------

def test_probe_compiled_memo_hit_runs_nothing(tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.cost import probe_compiled
    from repro_torch.launch.steps import input_specs
    cfg = get_config("qwen3-0.6b").with_reduced()
    cc = CompileCache(root=tmp_path)
    with fake_world(8):
        mesh = _mesh()
        with FakeTensorMode(allow_non_fake_inputs=True):
            spec = input_specs(cfg, CELLS["tiny_dec"], mesh, use_kernel=True)
        first = probe_compiled(spec["fn"], spec["args"], memo_key="dec",
                               cache=cc)
        calls = []

        def never(*a):
            calls.append(a)
        again = probe_compiled(never, spec["args"], memo_key="dec", cache=cc)
    assert calls == [] and again == first and first["flops"] > 0
    assert set(first) >= {"flops", "bytes", "coll", "arg_bytes",
                          "temp_bytes"}
    assert first["coll"] == first["collectives"]["total_bytes"] > 0


def test_probe_compiled_refuses_a_fake_mode():
    """Inside a FakeTensorMode the ops DTensor runs at global shapes to
    propagate its layouts cannot be told from the step's own."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.cost import probe_compiled
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="outside a FakeTensorMode"):
            probe_compiled(lambda: None, cache=False)


def test_production_train_cell_fits_the_card():
    """``qwen3-0.6b x train_4k x pod16x16``: a rank's inputs and its
    temporaries fit the card's memory, and its FLOPs are those of its
    shard: the tokens of its data shard through a sixteenth of each
    product (the forward, the remat forward and a backward of two; the
    head has no remat) and its one query head's attention (the flash
    kernel's two full products, twice, and the backward's five)."""
    from repro_torch.configs import SHAPES
    from repro_torch.core.cost import HW
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config("qwen3-0.6b")
    shape = SHAPES["train_4k"]
    with fake_world(256):
        rec = run_cell(cfg, shape, make_production_mesh(), "pod16x16",
                       verbose=False)
    mem = rec["memory"]
    assert rec["ok"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < \
        HW["hbm_capacity"], mem
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    tokens = shape.global_batch * shape.seq_len // 16
    layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * d * f
    products = 2 * tokens * (4 * cfg.n_layers * layer + 3 * d * cfg.vocab)
    attention = 2 * tokens * shape.seq_len * hd * cfg.n_heads * \
        cfg.n_layers * (2 + 2 + 5)
    want = (products + attention) / 16
    assert 0.8 * want < rec["cost"]["flops"] < 1.25 * want, \
        (rec["cost"], want)


def test_dryrun_cli_production_mesh(tmp_path):
    """``--arch qwen3-0.6b --shape decode_32k --mesh single``: one record
    under ``arch|shape|mesh`` on 256 fake ranks; a rerun keeps it."""
    from repro_torch.launch.dryrun import main
    out = tmp_path / "dry.json"
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(out)]
    assert main(argv) == 0
    rec = json.loads(out.read_text())["qwen3-0.6b|decode_32k|pod16x16"]
    assert rec["ok"] and rec["n_devices"] == 256
    assert {"memory", "cost", "collectives"} <= set(rec)
    assert main(argv) == 0                   # cached: the record stays
    assert json.loads(out.read_text())[
        "qwen3-0.6b|decode_32k|pod16x16"] == rec


def test_dryrun_cli_records_skips(tmp_path):
    from repro_torch.launch.dryrun import main
    out = tmp_path / "dry.json"
    assert main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["qwen3-0.6b|long_500k|pod16x16"]
    assert rec["ok"] and "sub-quadratic" in rec["skipped"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_long_context_cell(arch, monkeypatch):
    """B = 1 long-context decode: the cache's sequence is split over the
    data axis.  Mamba2 keeps no K/V; zamba2's shared attention block runs
    flash-decode on each rank's rows of the cache and merges the ranks'
    ``(out, lse)``: three all-reduces an attention application, of
    ``[B, nh]``, ``[B, nh]`` and ``[B, nh, hd]`` float32 (nh the model
    shard's heads), counted against the same cell with the merge's
    collectives taken out; no all-gather as large as a cache shard."""
    from repro_torch.kernels import ops
    cfg = get_config(arch).with_reduced()
    shape = InputShape("tiny_long", 256, 1, "decode")
    merges = []
    real = ops.merge_partials

    def counted(out, lse, groups, dtype):
        merges.append((tuple(out.shape), len(groups)))
        return real(out, lse, groups, dtype)

    def local_only(out, lse, groups, dtype):
        return out.to(dtype)
    recs = []
    for merge in (counted, local_only):
        monkeypatch.setattr(ops, "merge_partials", merge)
        with fake_world(8):
            recs.append(run_cell(cfg, shape, _mesh(), "test4x2",
                                 verbose=False))
    rec, bare = recs
    assert rec["ok"] and bare["ok"]
    apps = len(merges)
    coll, without = rec["collectives"], bare["collectives"]
    if cfg.family == "ssm":
        assert apps == 0 and coll == without
        return
    # each application: the data axis (4 ranks) splits the sequence, the
    # model axis (2) the heads
    assert apps > 0 and all(
        m == ((1, cfg.n_heads // 2, cfg.hd), 1) for m in merges)
    B, nh, hd = 1, cfg.n_heads // 2, cfg.hd
    assert coll.get("n_all-reduce", 0) - without.get("n_all-reduce", 0) \
        == 3 * apps
    # all-reduce bytes count twice (a ring: reduce-scatter + all-gather)
    assert coll["all-reduce"] - without.get("all-reduce", 0) == \
        2 * apps * 4 * (B * nh + B * nh + B * nh * hd)
    assert coll.get("all-gather", 0) == without.get("all-gather", 0)
    shard = shape.seq_len // 4 * (cfg.n_kv_heads // 2) * cfg.hd * 2
    assert coll.get("all-gather", 0) < shard, (coll, shard)
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-small",
                                  "phi-3-vision-4.2b", "zamba2-1.2b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_families_dry_run(arch, kind):
    """Every other family's train, prefill and decode cells run on the fake
    (4, 2) mesh."""
    cfg = get_config(arch).with_reduced()
    with fake_world(8):
        rec = run_cell(cfg, InputShape("t", 64, 8, kind), _mesh(), "test4x2",
                       verbose=False)
    assert rec["ok"] and rec["cost"]["flops"] > 0

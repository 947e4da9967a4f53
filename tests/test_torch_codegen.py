"""Hierarchical code generation in the port (``repro_torch.core``
``compile_cache``, ``hier_compile``, ``invoke`` and the apps'
``compile_app``) against the reference's, on the CPU.

The port's artifact here is the exported program (``torch.export``), the
CPU's lowering; one test builds an AOTInductor package, the card's
artifact, on the CPU.  Every store test uses its own root under
``tmp_path``.  Mirrors ``tests/test_compile_cache.py`` (the serving
store's warmup waits for the port's captured decode step) and
``tests/test_hier_compile.py``, whose compile-heavy halves the reference
marks slow only for their XLA compiles.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import compile_cache as rcc
from repro.core import hier_compile as rhc
from repro_torch.core import compile_cache as pcc
from repro_torch.core import hier_compile as phc
from repro_torch.core.compile_cache import (CompileCache, instance_key,
                                            structural_digest)
from repro_torch.core.hier_compile import (DataflowProgram, StageInstance,
                                           build_dataflow, compile_stages,
                                           diff_definitions)

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"


def _both(case):
    """The digest equalities a case asserts, under both packages: each
    entry is (a, b, equal?) and must hold for the port's and the
    reference's ``structural_digest`` alike."""
    for a, b, equal in case:
        for digest in (pcc.structural_digest, rcc.structural_digest):
            assert (digest(a) == digest(b)) is equal, (digest, a, b)


# ---------------------------------------------------------------------------
# structural hash, case by case against the reference
# ---------------------------------------------------------------------------

def _make_stage(coef, shift):
    def stage(x):
        return x * coef + shift
    return stage


def test_recreated_closures_hash_equal():
    _both([(_make_stage(2.0, 1), _make_stage(2.0, 1), True)])


def test_edited_constant_dirties_hash():
    _both([(_make_stage(2.5, 1), _make_stage(2.0, 1), False),
           (_make_stage(2.0, 2), _make_stage(2.0, 1), False)])


def test_closure_array_content_hashed():
    """Closure-captured weights are part of the compiled program, numpy
    arrays and tensors alike."""
    def make(w):
        def stage(x):
            return x + w
        return stage

    w1, w2 = np.ones(4), np.ones(4) * 2
    _both([(make(w1), make(w1.copy()), True), (make(w1), make(w2), False)])
    t1 = torch.ones(4)
    assert structural_digest(make(t1)) == structural_digest(make(t1.clone()))
    assert structural_digest(make(t1)) != structural_digest(make(t1 * 2))


def test_referenced_global_data_hashed():
    src = "def f(x):\n    return np.dot(K, x)\n"
    fns = []
    for k in (np.eye(2), np.eye(2) * 3, np.eye(2)):
        ns = {"K": k, "np": np}
        exec(src, ns)
        fns.append(ns["f"])
    _both([(fns[0], fns[2], True), (fns[0], fns[1], False)])


def test_instance_key_includes_aval_signature():
    f = _make_stage(2.0, 1)
    a = np.zeros((4, 4), np.float32)
    b = np.zeros((8, 8), np.float32)
    c = np.zeros((4, 4), np.float64)
    key = functools.partial(instance_key, device=CPU)
    assert key(f, (a,)) == key(f, (a.copy(),))
    assert key(f, (a,)) != key(f, (b,))
    assert key(f, (a,)) != key(f, (c,))
    assert key(f, (a,)) != key(f, (a,), extra="x")
    # a tensor of the numpy array's shape and dtype keys alike (the
    # repaired aval signature), and the lowering is part of the key
    assert key(f, (torch.from_numpy(a),)) == key(f, (a,))
    assert key(f, (a,), lowering="aoti") != key(f, (a,))


def test_jit_wrapped_closures_unwrap_to_content():
    """Compile wrappers have no content of their own; the digest must
    reach through ``__wrapped__`` (``torch.compile``'s, ``jax.jit``'s) or
    different-weight models would share cache keys."""
    def make(w):
        def f(x):
            return x * w
        return f

    for wrap, digest in ((torch.compile, pcc.structural_digest),
                         (jax.jit, rcc.structural_digest)):
        assert digest(wrap(make(2.0))) == digest(wrap(make(2.0)))
        assert digest(wrap(make(2.0))) != digest(wrap(make(99.0)))


def test_bound_method_receiver_state_hashed():
    class Stepper:
        def __init__(self, w):
            self.w = w

        def step(self, x):
            return x * self.w

    _both([(Stepper(1.0).step, Stepper(1.0).step, True),
           (Stepper(1.0).step, Stepper(2.0).step, False)])


def test_global_read_from_nested_lambda_hashed():
    src = "def f(x):\n    g = lambda y: y * W\n    return g(x)\n"
    fns = []
    for w in (2.0, 99.0, 2.0):
        ns = {"W": w}
        exec(src, ns)
        fns.append(ns["f"])
    _both([(fns[0], fns[2], True), (fns[0], fns[1], False)])


def test_inplace_mutation_of_captured_array_dirties_digest():
    """The QoR loop edits weights in place on a live function object; the
    digest must not be memoized past the edit (numpy and tensor)."""
    for w in (np.ones(4), torch.ones(4)):
        def f(x):
            return x * w

        before = structural_digest(f)
        w[:] = 5.0
        assert structural_digest(f) != before


def test_callable_object_instance_state_hashed():
    class Scale:
        def __init__(self, c):
            self.c = c

        def __call__(self, x):
            return x * self.c

    def make(op):
        def stage(x):
            return op(x)
        return stage

    _both([(make(Scale(2.0)), make(Scale(2.0)), True),
           (make(Scale(2.0)), make(Scale(3.0)), False),
           (Scale(2.0), Scale(3.0), False)])


def test_opaque_callables_never_share_keys():
    _both([(np.add, np.multiply, False), (torch.add, torch.mul, False)])


def test_module_and_nonjittable_values_hash_safely():
    """Channels/engines/modules in closures must never crash the hasher."""
    import repro_torch.core as core

    def make(obj):
        def stage():
            return obj
        return stage

    for obj in (core, object(), {"nested": [core, (1, {2})]},
                lambda x: x + 1, torch.nn.Linear(2, 2)):
        assert isinstance(structural_digest(make(obj)), str)


def test_legacy_key_warns():
    for mod in (phc, rhc):
        inst = mod.StageInstance(fn=_make_stage(1.0, 0), args=())
        with pytest.warns(DeprecationWarning):
            inst.legacy_key


# ---------------------------------------------------------------------------
# the aval signature (repaired dtype names) and the key's toolchain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_aval_signature_matches_reference(dtype):
    """numpy arrays, tensors and interface arguments sign as the
    reference signs the same data (dtype names as numpy spells them)."""
    data = np.arange(12).reshape(3, 4).astype(dtype)
    ref = rcc.aval_signature(
        (data, jnp.asarray(data), repro.mmap(data.copy()),
         repro.async_mmap(data.copy(), depth=2), repro.scalar(3),
         [data, {"k": 2.5}]),
        {"w": data, "n": 7})
    port = pcc.aval_signature(
        (torch.from_numpy(data), data, repro_torch.mmap(data.copy()),
         repro_torch.async_mmap(torch.from_numpy(data.copy()), depth=2),
         repro_torch.scalar(3), [torch.from_numpy(data), {"k": 2.5}]),
        {"w": data, "n": 7})
    assert port == ref
    assert np.dtype(dtype).name in repr(port)


def test_key_covers_the_device_count(monkeypatch):
    """The reference keys executables without the device count (ROADMAP
    queue C: a 512-device process loads a 1-device executable); the port
    keys on it."""
    f = _make_stage(2.0, 1)
    x = np.zeros((4,), np.float32)
    one = instance_key(f, (x,), device=CPU)
    monkeypatch.setattr(pcc, "_device_count", lambda kind: 512)
    assert instance_key(f, (x,), device=CPU) != one


def test_lowering_choice():
    """The card compiles AOTInductor packages only: no exported-program
    fallback there; the CPU defaults to the exported program."""
    assert pcc.resolve_lowering(torch.device("cpu"), None) == "export"
    assert pcc.resolve_lowering(torch.device("cpu"), "aoti") == "aoti"
    assert pcc.resolve_lowering(torch.device("cuda"), None) == "aoti"
    with pytest.raises(ValueError, match="CPU only"):
        pcc.resolve_lowering(torch.device("cuda"), "export")
    with pytest.raises(ValueError, match="unknown lowering"):
        pcc.resolve_lowering(torch.device("cpu"), "xla")


# ---------------------------------------------------------------------------
# memo store and eviction (file I/O only)
# ---------------------------------------------------------------------------

def test_memo_roundtrip_and_corrupt_recovery(tmp_path):
    cc = CompileCache(root=tmp_path)
    key = "ab" + "0" * 62
    assert cc.memo_get(key) is None
    cc.memo_put(key, {"flops": 1.5, "bytes": 2})
    assert cc.memo_get(key) == {"flops": 1.5, "bytes": 2}
    assert cc.stats.memo_hits == 1
    p = cc._path(key, "memo")
    p.write_text("{not json")
    assert cc.memo_get(key) is None
    assert cc.stats.corrupt == 1
    assert not p.exists()


def test_lru_eviction_bound(tmp_path):
    import time
    cc = CompileCache(root=tmp_path, max_bytes=1 << 20)
    keys = [f"{i:02x}" + "0" * 62 for i in range(4)]
    for i, k in enumerate(keys):
        cc.memo_put(k, {"pad": "x" * 100})
        os.utime(cc._path(k, "memo"), (time.time() + i, time.time() + i))
    cc.max_bytes = 256
    cc.evict_to_fit()
    assert cc.disk_bytes() <= 256
    assert cc.stats.evictions >= 1
    assert cc._path(keys[-1], "memo").exists()
    assert not cc._path(keys[0], "memo").exists()


# ---------------------------------------------------------------------------
# the executable store (exported programs on the CPU)
# ---------------------------------------------------------------------------

def test_hit_miss_and_warm_restart(tmp_path):
    def make(c):
        def f(x):
            return torch.tanh(x) * c
        return f

    cc = CompileCache(root=tmp_path)
    x = torch.ones((8, 8))
    exe, src = cc.compile_cached(make(1.5), (x,), device=CPU)
    assert src == "compiled" and cc.stats.misses == 1
    exe2, src2 = cc.compile_cached(make(1.5), (x,), device=CPU)
    assert src2 == "memory" and exe2 is exe
    cc.clear_memory()                       # simulate process restart
    exe3, src3 = cc.compile_cached(make(1.5), (x,), device=CPU)
    assert src3 == "disk"
    torch.testing.assert_close(exe3(x), exe(x), rtol=0, atol=0)
    torch.testing.assert_close(exe(x), make(1.5)(x), rtol=0, atol=0)


def test_compiled_stage_checks_its_inputs(tmp_path):
    """A compiled stage refuses inputs of another shape or dtype, or
    another argument count, as an XLA executable does."""
    exe, _ = CompileCache(root=tmp_path).compile_cached(
        f_double, (torch.ones((4, 4)),), device=CPU)
    np.testing.assert_allclose(exe(np.ones((4, 4), np.float32)).numpy(), 2.0)
    for bad in ((torch.ones((4, 5)),),
                (torch.ones((4, 4), dtype=torch.int32),),
                (torch.ones((4, 4)), torch.ones((4, 4)))):
        with pytest.raises(TypeError, match="compiled stage takes"):
            exe(*bad)


def test_corrupt_executable_recovers(tmp_path):
    def f(x):
        return x * 3.0

    cc = CompileCache(root=tmp_path)
    x = torch.ones((4,))
    _, src = cc.compile_cached(f, (x,), device=CPU)
    assert src == "compiled"
    cc._path(instance_key(f, (x,), device=CPU)).write_bytes(b"garbage")
    cc.clear_memory()
    exe, src2 = cc.compile_cached(f, (x,), device=CPU)
    assert src2 == "compiled" and cc.stats.corrupt == 1
    np.testing.assert_allclose(exe(x).numpy(), 3.0)


def _tiny_fn(x):
    return x + 1


def test_cache_corruption_detected_and_recompiled(tmp_path):
    """The chaos harness corrupts an entry after its write: a fresh cache
    detects the digest mismatch, deletes the entry and recompiles."""
    from repro_torch.core.faults import FaultPlan
    args = (np.zeros((2,), np.float32),)
    chaos = CompileCache(root=tmp_path, faults=FaultPlan(cache_corrupt=1))
    exe, src = chaos.compile_cached(_tiny_fn, args, device=CPU)
    assert src == "compiled" and np.allclose(exe(*args).numpy(), 1.0)
    clean = CompileCache(root=tmp_path)
    exe2, src2 = clean.compile_cached(_tiny_fn, args, device=CPU)
    assert src2 == "compiled" and clean.stats.corrupt == 1
    assert np.allclose(exe2(*args).numpy(), 1.0)
    _, src3 = CompileCache(root=tmp_path).compile_cached(_tiny_fn, args,
                                                         device=CPU)
    assert src3 == "disk"


def test_cache_transient_io_retried(tmp_path):
    from repro_torch.core.faults import FaultPlan
    args = (np.zeros((3,), np.float32),)
    inj = FaultPlan(cache_io_errors=1).injector()
    CompileCache(root=tmp_path, faults=inj).compile_cached(
        _tiny_fn, args, device=CPU)
    assert any(e[0] == "io_error" for e in inj.log)
    _, src = CompileCache(root=tmp_path).compile_cached(_tiny_fn, args,
                                                        device=CPU)
    assert src == "disk"


def test_incremental_recompile_one_dirty_definition(tmp_path):
    def make(c):
        def f(x):
            return torch.tanh(x @ x.T) * c
        return f

    x = torch.ones((16, 16))

    def instances(coefs):
        return [StageInstance(fn=make(c), args=(x,), name=f"s{i}")
                for i, c in enumerate(coefs)]

    cc = CompileCache(root=tmp_path)
    prev = compile_stages(instances([1.0, 2.0, 3.0] * 4), cache=cc,
                          device=CPU)
    assert prev.n_unique == 3 and prev.n_compiled == 3
    edited = instances([1.0, 2.5, 3.0] * 4)
    clean, dirty = diff_definitions(prev, edited)
    assert len(clean) == 2 and len(dirty) == 1
    rep = compile_stages(edited, cache=CompileCache(root=tmp_path / "i"),
                         prev=prev, device=CPU)
    assert rep.n_reused == 2 and rep.n_compiled == 1
    assert all(i.executable is not None for i in edited)


def test_cross_process_reuse_and_gaussian_zero_compiles(tmp_path):
    """A second compile_app of gaussian in a *fresh process* pointed at
    the same root (``$REPRO_TORCH_COMPILE_CACHE``, ``HOME`` in
    ``tmp_path``) compiles nothing: every definition loads from disk."""
    body = textwrap.dedent("""
        import json, numpy as np
        from repro_torch.apps import gaussian
        g, rep, prog = gaussian.compile_app(iters=4, device="cpu")
        img = np.random.default_rng(0).standard_normal((12, 12)) \\
            .astype(np.float32)
        out = prog(img).numpy()
        ref = img
        for _ in range(4):
            ref = gaussian._stencil_ref(ref)
        assert float(np.abs(out - ref).max()) < 1e-4
        print("REPORT", json.dumps({
            "n_compiled": rep.n_compiled,
            "n_cache_hits": rep.n_cache_hits,
            "sources": sorted(set(rep.sources.values()))}))
    """)
    outs = []
    for _ in range(2):
        r = subprocess.run(
            [sys.executable, "-c", body], capture_output=True, text=True,
            timeout=300,
            env={**os.environ, "PYTHONPATH": SRC,
                 "REPRO_TORCH_COMPILE_CACHE": str(tmp_path),
                 "HOME": str(tmp_path)})
        assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
        line = [x for x in r.stdout.splitlines() if x.startswith("REPORT")]
        outs.append(json.loads(line[0][len("REPORT "):]))
    assert outs[0]["n_compiled"] == 3          # cold: 3 unique definitions
    assert outs[1]["n_compiled"] == 0          # warm process: all from disk
    assert outs[1]["sources"] == ["disk"]


def test_cnn_gcn_compiled_apps_match_reference(tmp_path):
    from repro.apps import cnn as rcnn
    from repro.apps import gcn as rgcn
    from repro_torch.apps import cnn, gcn

    cc = CompileCache(root=tmp_path)
    rep, prog, ref = cnn.compile_app(cache=cc, device=CPU)
    assert rep.n_unique == 2
    np.testing.assert_allclose(prog().numpy(), ref, atol=1e-3)
    rep2, prog2, ref2 = gcn.compile_app(cache=cc, device=CPU)
    np.testing.assert_allclose(prog2().numpy(), ref2, atol=1e-3)
    rep3, _, _ = cnn.compile_app(cache=cc, device=CPU)
    assert rep3.n_compiled == 0
    # the same data as the reference's stages
    _, _, rref = rcnn.compile_app(cache=rcc.CompileCache(root=tmp_path / "r"))
    _, _, rref2 = rgcn.compile_app(cache=rcc.CompileCache(root=tmp_path / "r"))
    np.testing.assert_array_equal(ref, rref)
    np.testing.assert_array_equal(ref2, rref2)


def test_aoti_package_round_trips_through_the_store(tmp_path):
    """The card's artifact on the CPU: one definition compiled by
    AOTInductor into a package, stored, loaded back from disk by a fresh
    cache, and run: equal to eager."""
    def stage(x):
        return torch.tanh(x) * 1.5 + x

    x = torch.randn((8, 8), generator=torch.Generator().manual_seed(0))
    exe, src = CompileCache(root=tmp_path).compile_cached(
        stage, (x,), device=CPU, lowering="aoti")
    assert src == "compiled" and exe.kind == "aoti"
    assert exe.payload[:2] == b"PK"              # a .pt2 (zip) package
    exe2, src2 = CompileCache(root=tmp_path).compile_cached(
        stage, (x,), device=CPU, lowering="aoti")
    assert src2 == "disk" and exe2.kind == "aoti"
    torch.testing.assert_close(exe2(x), stage(x))
    torch.testing.assert_close(exe(x.numpy()), stage(x))


# ---------------------------------------------------------------------------
# hierarchical compile and the dataflow program (test_hier_compile.py)
# ---------------------------------------------------------------------------

def f_double(x):
    return x * 2.0


def f_inc(x):
    return x + 1.0


def test_dedup_counts():
    x = torch.ones((8, 8))
    insts = [StageInstance(fn=f_double, args=(x,), name=f"d{i}")
             for i in range(5)]
    insts += [StageInstance(fn=f_inc, args=(x,), name="i0")]
    rep = compile_stages(insts, mode="hierarchical", cache=False, device=CPU)
    assert rep.n_instances == 6 and rep.n_unique == 2
    assert phc.hashable_definition_count(insts, device=CPU) == (6, 2)
    assert all(i.executable is not None for i in insts)
    assert insts[0].executable is insts[4].executable
    assert insts[0].executable is not insts[5].executable


def test_shape_signature_splits_definitions():
    insts = [StageInstance(fn=f_double, args=(torch.ones((4, 4)),)),
             StageInstance(fn=f_double, args=(torch.ones((8, 8)),))]
    rep = compile_stages(insts, mode="hierarchical", cache=False, device=CPU)
    assert rep.n_unique == 2


def test_monolithic_and_hierarchical_agree():
    x = torch.full((4, 4), 3.0)
    for mode in ("monolithic", "hierarchical"):
        chain = [StageInstance(fn=f_double, args=(x,), name="0"),
                 StageInstance(fn=f_inc, args=(x,), name="1"),
                 StageInstance(fn=f_double, args=(x,), name="2")]
        compile_stages(chain, mode=mode, cache=False, device=CPU)
        prog = build_dataflow(chain, {1: [0], 2: [1]})
        torch.testing.assert_close(prog(x), (x * 2 + 1) * 2)


def test_hierarchical_faster_or_equal_with_dedup():
    """12 instances of 2 definitions: the monolithic baseline compiles
    every instance, the hierarchical mode 2."""
    x = torch.ones((64, 64))

    def insts():
        return [StageInstance(fn=(f_double if i % 2 else f_inc), args=(x,))
                for i in range(12)]

    rep_m = compile_stages(insts(), mode="monolithic", device=CPU)
    rep_h = compile_stages(insts(), mode="hierarchical", cache=False,
                           device=CPU)
    assert rep_h.n_unique == 2 and rep_m.n_compiled == 12
    assert len(rep_h.per_key_s) == 2 and len(rep_m.per_key_s) == 12


def test_dataflow_multi_source_feeds_by_index():
    insts = [StageInstance(fn=f_double), StageInstance(fn=f_inc),
             StageInstance(fn=lambda a, b: a + b)]
    prog = DataflowProgram(instances=insts, wiring={2: [0, 1]})
    assert prog.sources() == [0, 1] and prog.sinks() == [2]
    a, b = torch.full((2, 2), 3.0), torch.full((2, 2), 10.0)
    torch.testing.assert_close(prog(a, b), a * 2 + b + 1)


def test_dataflow_arity_mismatch_raises():
    insts = [StageInstance(fn=f_double), StageInstance(fn=f_inc),
             StageInstance(fn=lambda a, b: a + b)]
    prog = DataflowProgram(instances=insts, wiring={2: [0, 1]})
    x = torch.ones((2, 2))
    with pytest.raises(ValueError, match="source stage"):
        prog(x)
    with pytest.raises(ValueError, match="source stage"):
        prog(x, x, x)


def test_dataflow_returns_all_sinks():
    insts = [StageInstance(fn=f_inc), StageInstance(fn=f_double),
             StageInstance(fn=lambda x: x - 1.0)]
    prog = DataflowProgram(instances=insts, wiring={1: [0], 2: [0]})
    assert prog.sinks() == [1, 2]
    x = torch.full((2, 2), 4.0)
    out_a, out_b = prog(x)
    torch.testing.assert_close(out_a, (x + 1) * 2)
    torch.testing.assert_close(out_b, x)


def test_dataflow_explicit_source_indices():
    insts = [StageInstance(fn=f_inc, args=(torch.ones((2, 2)),)),
             StageInstance(fn=f_double)]
    prog = DataflowProgram(instances=insts, wiring={1: [0]},
                           source_indices=[])
    np.testing.assert_allclose(prog().numpy(), 4.0)


def test_build_dataflow_preserves_compile_keys(tmp_path):
    def make(c):
        def f(x):
            return x * c
        return f

    x = torch.ones((4, 4))
    insts = [StageInstance(fn=make(2.0), args=(x,), name="s0"),
             StageInstance(fn=make(3.0), args=(x,), name="s1")]
    rep = compile_stages(insts, cache=CompileCache(root=tmp_path),
                         device=CPU)
    prog = build_dataflow(insts, {1: [0]})
    torch.testing.assert_close(prog(x), x * 6.0)
    assert insts[0].args == (x,)            # originals untouched
    rep2 = compile_stages(insts, cache=CompileCache(root=tmp_path / "b"),
                          prev=rep, device=CPU)
    assert rep2.n_reused == 2 and rep2.n_compiled == 0


def test_monolithic_report_works_as_prev():
    x = torch.ones((4, 4))
    rep_m = compile_stages([StageInstance(fn=f_double, args=(x,))],
                           mode="monolithic", device=CPU)
    rep = compile_stages([StageInstance(fn=f_double, args=(x,))],
                         cache=False, prev=rep_m, device=CPU)
    assert rep.n_reused == 1 and rep.n_compiled == 0


def test_incremental_prev_report_reuses_clean_definitions(tmp_path):
    def make(c):
        def f(x):
            return x * c
        return f

    x = torch.ones((8, 8))

    def insts(coefs):
        return [StageInstance(fn=make(c), args=(x,)) for c in coefs]

    prev = compile_stages(insts([1.0, 2.0]),
                          cache=CompileCache(root=tmp_path), device=CPU)
    assert prev.n_compiled == 2
    rep = compile_stages(insts([1.0, 5.0]),
                         cache=CompileCache(root=tmp_path / "b"), prev=prev,
                         device=CPU)
    assert rep.n_reused == 1 and rep.n_compiled == 1
    clean_key = instance_key(make(1.0), (x,), device=CPU)
    assert rep.executables[clean_key] is prev.executables[clean_key]


# ---------------------------------------------------------------------------
# parity with the reference: dedup, key partition, cold/warm/incremental
# counts, program outputs
# ---------------------------------------------------------------------------

def _stage_graph(np_mod, n_instances=24, dim=64):
    """``benchmarks/codegen_time.py``'s stage graph (feeder / PE /
    reducer), written against ``np_mod`` (jnp for the reference, torch
    for the port)."""
    def feeder(x):
        return np_mod.tanh(x) * 1.5

    def pe(x):
        return np_mod.tanh(x @ x.T) @ x

    def reducer(x):
        return np_mod.cumsum(x, 0) / (1.0 + np_mod.abs(x))

    defs = [feeder, pe, reducer]
    x = np.random.default_rng(0).standard_normal((dim, dim)) \
        .astype(np.float32) / 8
    return [(defs[i % 3], (x,), f"inst{i}") for i in range(n_instances)]


def _graph(pkg: str, name: str):
    """(instances, wiring or None, program inputs) of one parity graph,
    built by the reference (``pkg="ref"``) or the port."""
    from repro.apps import cnn as rcnn, gaussian as rgauss, gcn as rgcn
    from repro_torch.apps import cnn, gaussian, gcn
    ref = pkg == "ref"
    kw = {} if ref else {"device": CPU}
    img = np.random.default_rng(1).standard_normal((12, 12)) \
        .astype(np.float32)
    if name == "gaussian":
        insts, wiring = (rgauss.jax_stages() if ref
                         else gaussian.torch_stages())
        return insts, wiring, (img,)
    if name in ("cnn", "gcn"):
        mod = {"cnn": (rcnn, cnn), "gcn": (rgcn, gcn)}[name][0 if ref else 1]
        insts, wiring, _ = (mod.jax_stages() if ref
                            else mod.torch_stages(**kw))
        return insts, wiring, ()
    cls = rhc.StageInstance if ref else StageInstance
    spec = _stage_graph(jnp if ref else torch)
    conv = jnp.asarray if ref else torch.from_numpy
    return [cls(fn=f, args=tuple(conv(a) for a in args), name=n)
            for f, args, n in spec], None, ()


def _edit_first(insts):
    """One definition edited: every instance of the first definition
    rebound to a ``functools.partial`` of it (a new digest, the same
    computation)."""
    first = insts[0].fn
    new = functools.partial(first)
    for i in insts:
        if i.fn is first:
            i.fn = new
    return insts


def _partition(report) -> list:
    order: dict = {}
    return [order.setdefault(k, len(order)) for k in report["keys"]]


def _cycle(pkg: str, name: str, root: Path) -> dict:
    """Cold, warm (a new cache object on the same root, closures
    re-created) and incremental (one definition edited, the warm report
    passed as ``prev``) compiles of one graph, and the program's output."""
    mod, cc_cls = (rhc, rcc.CompileCache) if pkg == "ref" \
        else (phc, CompileCache)
    kw = {} if pkg == "ref" else {"device": CPU}
    out = {}
    prev = None
    for phase in ("cold", "warm", "incremental"):
        insts, wiring, inputs = _graph(pkg, name)
        if phase == "incremental":
            insts = _edit_first(insts)
        cache = cc_cls(root=root / ("inc" if phase == "incremental"
                                    else "main"))
        rep = mod.compile_stages(insts, cache=cache, prev=prev, **kw)
        keys = [i.key if pkg == "ref"
                else instance_key(i.fn, i.args, i.kwargs, device=CPU)
                for i in insts]
        out[phase] = dict(n_instances=rep.n_instances, n_unique=rep.n_unique,
                          n_compiled=rep.n_compiled,
                          n_cache_hits=rep.n_cache_hits,
                          n_reused=rep.n_reused, keys=keys)
        if phase == "cold":
            if wiring is None:
                res = [np.asarray(i.executable(*i.args)) for i in insts]
            else:
                res = mod.build_dataflow(
                    insts, wiring,
                    source_indices=None if inputs else [])(*inputs)
                res = [np.asarray(res)]
            out["outputs"] = res
        prev = rep
    return out


@pytest.mark.parametrize("name", ["gaussian", "cnn", "gcn", "stage_graph"])
def test_codegen_parity_with_reference(name, tmp_path):
    ref = _cycle("ref", name, tmp_path / "ref")
    port = _cycle("port", name, tmp_path / "port")
    for phase in ("cold", "warm", "incremental"):
        for k in ("n_instances", "n_unique", "n_compiled", "n_cache_hits",
                  "n_reused"):
            assert port[phase][k] == ref[phase][k], (phase, k)
        assert _partition(port[phase]) == _partition(ref[phase]), phase
    assert port["warm"]["n_compiled"] == 0
    assert port["incremental"]["n_compiled"] == 1
    for got, want in zip(port["outputs"], ref["outputs"], strict=True):
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# invoke
# ---------------------------------------------------------------------------

def test_invoke_one_call():
    def P(o: repro_torch.OStream, n):
        for i in range(n):
            o.write(i)
        o.close()

    def C(i: repro_torch.IStream, sink):
        for v in i:
            sink.append(v)

    def Top(sink):
        ch = repro_torch.channel()
        repro_torch.task().invoke(P, ch, 4).invoke(C, ch, sink)
        return sink

    assert repro_torch.invoke(Top, [], target="sim") == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="unknown target"):
        repro_torch.invoke(Top, [], target="fpga")


def test_invoke_compiled_compiles_each_leaf_definition(tmp_path,
                                                       monkeypatch):
    """``invoke(target="compiled")`` elaborates the graph, compiles each
    unique leaf stage definition once through the process's default cache
    (interface args keyed by aval, channels dropped) and returns the
    elaboration's result — as the reference's does on the same graph."""
    stats = {}
    for pkg, mod, cache in (
            ("ref", repro, rcc.CompileCache(root=tmp_path / "r")),
            ("port", repro_torch, CompileCache(root=tmp_path / "p"))):
        xp = jnp if pkg == "ref" else torch
        monkeypatch.setattr((rcc if pkg == "ref" else pcc), "_default",
                            cache)
        img = np.ones((6, 6), np.float32)

        def val(m):
            # the sim passes the mmap, the compiled stage its buffer
            return m.data if getattr(m, "iface_kind", None) == "mmap" else m

        def scale(m, c):
            return xp.asarray(val(m)) * c

        def shift(m):
            return xp.asarray(val(m)) + 1.0

        def Top(buf):
            t = mod.task()
            for k in range(3):
                t = t.invoke(scale, buf, 2.0, name=f"scale{k}")
            t.invoke(shift, buf, name="shift")
            return "done"

        kw = {} if pkg == "ref" else {"device": CPU}
        m = mod.mmap(img if pkg == "ref" else torch.from_numpy(img))
        assert mod.invoke(Top, m, target="compiled", **kw) == "done"
        stats[pkg] = (cache.stats.misses, cache.stats.puts)
        mod.invoke(Top, m, target="compiled", **kw)
        assert cache.stats.mem_hits == 2
    assert stats["port"] == stats["ref"] == (2, 2)


def test_invoke_compiled_on_stream_tasks_fails_as_the_reference():
    """The reference's compiled target calls each leaf with its channels
    dropped, so a task that takes a channel (gaussian's ``Source``) is
    called short of arguments; the port keeps that contract and fails
    with the reference's error (ROADMAP queue C)."""
    from repro.apps import gaussian as rgauss
    from repro_torch.apps import gaussian
    msgs = []
    for mod, build, kw in ((repro, rgauss.build, {}),
                           (repro_torch, gaussian.build, {"device": CPU})):
        top, args, _ = build(h=6, w=6, iters=1)
        with pytest.raises(TypeError) as e:
            mod.invoke(top, *args, target="compiled", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "Source() missing 1 required positional argument: 'w'" in msgs[1]

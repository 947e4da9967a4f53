"""Persistent content-addressed compile cache (paper Section 3.3, extended).

The port of the reference package's compile cache, in three parts:

1.  **Structural definition hash** — a stable digest of a Python
    function's bytecode, constants, referenced globals, closure cell
    *values* and defaults.  Two separately-created closures with the same
    body hash equal; an edited constant or captured weight hashes
    different, and the digest survives process restarts, which ``id(fn)``
    never could.  :mod:`repro_torch.core.graph` keys task definitions and
    the whole-graph structural hash on it.  Array data is hashed by
    content: numpy arrays and torch tensors alike (dtype + shape + bytes).

2.  **Two-level content-addressed store** — an in-memory dict in front of
    an on-disk store (``<root>/v1/ex/<hh>/<key>.exe``) of compiled stages.
    Torch has no ``serialize_executable``, so the artifact is chosen by
    the device (:data:`LOWERINGS`): on the card an AOTInductor package
    (``torch.export`` of the stage, compiled by
    ``torch._inductor.aoti_compile_and_package``; a hit loads the ``.pt2``
    with ``aoti_load_package``), the counterpart of a compiled XLA
    executable; on the CPU the exported program itself
    (``torch.export.save``/``load``), because the caller named the CPU —
    never as a fallback: an AOTInductor failure on the card raises.
    Entries are framed with their sha256, LRU-evicted against a size
    bound, and a corrupt entry is deleted and recompiled.

3.  **Result memo store** — small JSON payloads keyed by the same digests
    (``<root>/v1/memo/<hh>/<digest>.json``).

Keys (:func:`instance_key`) cover the definition digest, the inputs'
shapes and dtypes, and the toolchain: torch and CUDA versions, the
lowering, the device's type, name and compute capability, and the device
count — so an artifact built for one device count is never loaded in a
process with another.  The root is ``$REPRO_TORCH_COMPILE_CACHE``
(default ``~/.cache/repro-torch-compile-cache``), never the reference's
tree.
"""

from __future__ import annotations

import atexit
import hashlib
import io
import json
import os
import pickle
import platform
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

SCHEMA = "v1"
# the cached artifact by lowering: an AOTInductor package (the card's, and
# the CPU's when asked for) or the exported program (the CPU's default)
LOWERINGS = ("aoti", "export")

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")

# how deep to chase functions referenced from globals/closures before
# falling back to their qualified name (keeps the hash off library innards)
_MAX_FN_DEPTH = 4


# ---------------------------------------------------------------------------
# structural hashing
# ---------------------------------------------------------------------------

def _stable_repr(v: Any) -> str:
    """``repr`` with memory addresses stripped (stable across processes)."""
    return _ADDR_RE.sub("", repr(v))


def _obj_state(v: Any) -> Optional[dict]:
    """Instance attributes of an object (``__dict__`` or ``__slots__``),
    or None when it carries no inspectable state."""
    d = getattr(v, "__dict__", None)
    if d:
        return dict(d)
    slots = getattr(type(v), "__slots__", None)
    if slots:
        return {s: getattr(v, s, None) for s in slots
                if isinstance(s, str)}
    return None


def _enc_code(h, code: types.CodeType, depth: int, seen: set) -> None:
    h.update(b"code")
    h.update(code.co_code)
    h.update(_stable_repr(code.co_names).encode())
    h.update(_stable_repr(code.co_freevars).encode())
    h.update(str(code.co_argcount).encode())
    for c in code.co_consts:
        _enc(h, c, depth, seen)


def _code_names(code: types.CodeType, acc: set) -> None:
    """All names referenced by ``code`` and every nested code object —
    a constant read inside a nested lambda is still baked into the traced
    program, so its global must be value-hashed too."""
    acc.update(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _code_names(c, acc)


def _enc_fn(h, fn: Callable, depth: int, seen: set) -> None:
    if id(fn) in seen or depth > _MAX_FN_DEPTH:
        h.update(getattr(fn, "__qualname__", repr(type(fn))).encode())
        return
    seen.add(id(fn))
    if isinstance(fn, partial):
        h.update(b"partial")
        _enc_fn(h, fn.func, depth, seen)
        _enc(h, fn.args, depth, seen)
        _enc(h, fn.keywords, depth, seen)
        return
    code = getattr(fn, "__code__", None)
    if code is None:
        # no Python code object: unwrap before giving up — jit wrappers
        # expose __wrapped__, bound methods __func__ (+ the state their
        # behaviour depends on, __self__)
        wrapped = getattr(fn, "__wrapped__", None)
        if wrapped is not None and wrapped is not fn:
            h.update(b"wrapped")
            _enc_fn(h, wrapped, depth, seen)
            return
        inner = getattr(fn, "__func__", None)
        state = _obj_state(fn)
        if inner is not None and inner is not fn:
            _enc_fn(h, inner, depth + 1, seen)
            _enc(h, getattr(fn, "__self__", None), depth + 1, seen)
        elif state is not None:
            # callable object instance: behaviour = class __call__ code +
            # instance attributes (Scale(2.0) must never collide with
            # Scale(3.0))
            h.update(f"callable-obj:{type(fn).__qualname__}".encode())
            _enc(h, state, depth + 1, seen)
            call = getattr(type(fn), "__call__", None)
            if getattr(call, "__code__", None) is not None:
                _enc_fn(h, call, depth + 1, seen)
        elif depth == 0:
            # opaque top-level callable: a content digest is impossible,
            # so salt with the object identity — unstable keys cost a
            # recompile, shared keys would silently reuse the wrong
            # executable
            h.update(f"opaque:{type(fn).__qualname__}:{id(fn)}".encode())
        else:
            h.update(getattr(fn, "__qualname__",
                             _stable_repr(fn)).encode())
        return
    _enc_code(h, code, depth + 1, seen)
    _enc(h, getattr(fn, "__defaults__", None), depth + 1, seen)
    _enc(h, getattr(fn, "__kwdefaults__", None), depth + 1, seen)
    if getattr(fn, "__self__", None) is not None:     # bound with state
        _enc(h, fn.__self__, depth + 1, seen)
    # closure cell *values*: a re-created closure over the same data hashes
    # equal; an edited weight/constant hashes different
    closure = getattr(fn, "__closure__", None) or ()
    for name, cell in zip(code.co_freevars, closure):
        h.update(name.encode())
        try:
            _enc(h, cell.cell_contents, depth + 1, seen)
        except ValueError:          # empty cell (still being defined)
            h.update(b"<empty-cell>")
    # referenced module-level globals — including ones only nested code
    # objects touch: data is hashed by content, functions structurally,
    # modules by name (stage fns bake these into the program)
    gl = getattr(fn, "__globals__", {})
    names: set = set()
    _code_names(code, names)
    for name in sorted(names):
        if name in gl:
            v = gl[name]
            if isinstance(v, types.ModuleType):
                h.update(f"mod:{v.__name__}".encode())
            else:
                h.update(name.encode())
                _enc(h, v, depth + 1, seen)


def _enc(h, v: Any, depth: int = 0, seen: Optional[set] = None) -> None:
    seen = seen if seen is not None else set()
    iface = None if isinstance(v, type) else getattr(v, "iface_kind", None)
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        h.update(f"lit:{v!r}".encode())
    elif iface in ("mmap", "async_mmap"):
        # the typed-interface contract (paper S3.1.2): an mmap argument is
        # a *runtime* device buffer, so only its aval reaches the hash —
        # two instances differing in array values share one definition.
        # Async ports fold in latency/depth: they size the lowered queue.
        h.update(f"{iface}:{v.dtype}:{tuple(v.shape)}".encode())
        if iface == "async_mmap":
            h.update(f":lat{v.latency}:d{v.depth}".encode())
    elif iface == "scalar":
        h.update(b"scalar")
        _enc(h, v.value, depth, seen)
    elif isinstance(v, types.ModuleType):
        h.update(f"mod:{v.__name__}".encode())
    elif isinstance(v, types.CodeType):
        _enc_code(h, v, depth, seen)
    elif isinstance(v, (types.FunctionType, types.MethodType, partial)) \
            or callable(v) and not isinstance(v, type):
        _enc_fn(h, v, depth, seen)
    elif isinstance(v, type):
        # classes hash by qualified name — never by their descriptor
        # attributes (a class with shape/dtype __slots__ is not an array)
        h.update(f"cls:{v.__module__}.{v.__qualname__}".encode())
    elif isinstance(v, np.ndarray):
        h.update(f"nd:{v.dtype}:{v.shape}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, torch.Tensor):
        # tensors hash by content (dtype + shape + bytes): a captured
        # constant changes what a step body computes.  Meta tensors carry
        # no data, so only their shape and dtype reach the hash.
        h.update(f"tensor:{v.dtype}:{tuple(v.shape)}".encode())
        if v.device.type != "meta":
            t = v.detach().contiguous().cpu()
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif hasattr(v, "shape") and hasattr(v, "dtype"):
        # other array-likes (shape/dtype, plus content where numpy can
        # read it)
        h.update(f"arr:{v.dtype}:{tuple(v.shape)}".encode())
        try:
            h.update(np.asarray(v).tobytes())
        except (TypeError, ValueError):
            pass
    elif isinstance(v, (tuple, list)):
        h.update(f"seq:{len(v)}".encode())
        for x in v:
            _enc(h, x, depth, seen)
    elif isinstance(v, dict):
        h.update(f"map:{len(v)}".encode())
        for k in sorted(v, key=_stable_repr):
            _enc(h, k, depth, seen)
            _enc(h, v[k], depth, seen)
    elif isinstance(v, (set, frozenset)):
        h.update(b"set")
        for x in sorted(v, key=_stable_repr):
            _enc(h, x, depth, seen)
    else:
        h.update(f"obj:{type(v).__qualname__}".encode())
        # default reprs are address-only: hash instance state instead (a
        # bound method's behaviour depends on __self__'s attributes)
        state = _obj_state(v)
        if state and id(v) not in seen and depth <= _MAX_FN_DEPTH:
            seen.add(id(v))
            _enc(h, state, depth + 1, seen)
        else:
            h.update(_stable_repr(v).encode())


def structural_digest(fn: Callable) -> str:
    """Stable digest of a task *definition* (no input signature).

    Contract: equal digests mean "tracing this function produces the same
    computation for the same input avals".  Covered: bytecode, constants,
    defaults, closure cell values, bound-method receiver state, referenced
    module-level globals including those read from nested functions (data
    by content, functions structurally, modules by name).  NOT covered:
    attribute chains deeper than the recursion cap and impure reads (time,
    rng, I/O) — functions doing those must bypass the cache
    (docs/codegen.md).  Deliberately NOT memoized per function object: the
    QoR loop mutates captured arrays in place, and a memo would return the
    pre-edit digest.
    """
    h = hashlib.sha256()
    _enc_fn(h, fn, 0, set())
    return h.hexdigest()


def _dtype_name(dtype: Any) -> str:
    """A dtype as numpy (and the reference) spell it: ``torch.float32``
    and ``np.float32`` both become ``"float32"``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def aval_signature(args: tuple, kwargs: dict) -> tuple:
    """Shape/dtype signature of array-like args (interface aware:
    mmap/async_mmap sign by aval, scalars by value).  Dtypes are numpy's
    names, so a tensor, a numpy array and a reference array of one shape
    and dtype sign alike."""
    def one(x):
        k = getattr(x, "iface_kind", None)
        if k in ("mmap", "async_mmap"):
            return (k, tuple(x.shape), _dtype_name(x.dtype))
        if k == "scalar":
            return ("lit", repr(x.value))
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return ("arr", tuple(x.shape), _dtype_name(x.dtype))
        if isinstance(x, (list, tuple)):
            return ("seq", tuple(one(v) for v in x))
        if isinstance(x, dict):
            return ("map", tuple(sorted((k, one(v)) for k, v in x.items())))
        return ("lit", repr(x))
    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kwargs.items())))


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """``t`` lies on ``device`` (an index-less device: any of its kind's
    current one)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def lower_spec(v: Any, device: Any) -> Any:
    """Replace what a stage is bound to with what its lowering should see.
    Every array-like (an mmap/async_mmap, a numpy array, a tensor) becomes
    a zero placeholder of its shape and dtype on ``device``: a runtime
    input of the artifact, never a constant baked into it (a tensor
    already on ``device`` stands for itself: tracing reads its shape and
    dtype only, and the saved artifact keeps no example input).  Scalars
    unwrap to their value; containers are converted recursively."""
    k = getattr(v, "iface_kind", None)
    if k == "scalar":
        return v.value
    if isinstance(v, torch.Tensor) and _on(v, torch.device(device)):
        return v
    if k in ("mmap", "async_mmap") or isinstance(v, (np.ndarray,
                                                       torch.Tensor)):
        return torch.zeros(tuple(v.shape), dtype=_torch_dtype(v.dtype),
                           device=device)
    if isinstance(v, (list, tuple)):
        return type(v)(lower_spec(x, device) for x in v)
    if isinstance(v, dict):
        return {key: lower_spec(x, device) for key, x in v.items()}
    return v


def runtime_value(v: Any) -> Any:
    """Replace interface arguments with their runtime payload: the mmap's
    buffer / the scalar's value — what a compiled stage is actually fed
    (mirrors :func:`lower_spec`)."""
    k = getattr(v, "iface_kind", None)
    if k in ("mmap", "async_mmap"):
        return v.data
    if k == "scalar":
        return v.value
    if isinstance(v, (list, tuple)):
        return type(v)(runtime_value(x) for x in v)
    if isinstance(v, dict):
        return {key: runtime_value(x) for key, x in v.items()}
    return v


def resolve_lowering(device: torch.device, lowering: Optional[str]) -> str:
    """The artifact a compile on ``device`` makes: an AOTInductor package
    on the card (the only one there), the exported program on the CPU
    unless ``lowering="aoti"`` asks for a package."""
    if lowering is None:
        return "export" if device.type == "cpu" else "aoti"
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lowering {lowering!r}; use one of "
                         f"{LOWERINGS}")
    if lowering == "export" and device.type != "cpu":
        raise ValueError(f"the exported-program lowering runs on the CPU "
                         f"only; {device} compiles AOTInductor packages")
    return lowering


def _device_count(kind: str) -> int:
    """Devices of this type the process sees (a key component)."""
    return getattr(torch, kind).device_count()


def _toolchain(device: torch.device, lowering: str) -> str:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        name = torch.cuda.get_device_name(idx)
        cap = "sm_%d%d" % torch.cuda.get_device_capability(idx)
    else:
        name, cap = platform.machine(), ""
    return (f"torch:{torch.__version__}:cuda:{torch.version.cuda}:"
            f"{lowering}:{device.type}:{name}:{cap}:"
            f"n{_device_count(device.type)}:{SCHEMA}")


@dataclass(frozen=True)
class Dyn:
    """The dynamic axes of one tensor input of a compile: ``axes`` holds
    ``(axis, name, min, max)`` tuples; inputs that name the same axis
    share its size (``torch.export.Dim``).  A ``dynamic`` argument of
    :meth:`CompileCache.compile_cached` is a prefix of the arguments'
    structure with a ``Dyn`` (or ``None``, static) at each tensor or
    subtree."""
    axes: tuple


def _dynamic_leaves(dynamic: Any, args: tuple, kwargs: dict) -> list:
    """``dynamic`` broadcast to one ``Dyn`` or ``None`` a leaf of the
    flattened ``(args, kwargs)``."""
    _, spec = _flat(args, kwargs)
    out = pytree._broadcast_to_and_flatten(
        (tuple(dynamic), {k: None for k in sorted(kwargs)}), spec)
    if out is None:
        raise ValueError("dynamic: not a prefix of the arguments' "
                         "structure")
    return out


def instance_key(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
                 *, extra: Any = None, digest: Optional[str] = None,
                 device: Any = None, lowering: Optional[str] = None) -> str:
    """Full cache key: definition digest + aval signature + toolchain.

    An artifact is only valid for (definition, input avals, torch and
    CUDA versions, lowering, device type, name and capability, device
    count); all are folded into the key, so a toolchain upgrade, another
    card or another device count is a clean miss, never a wrong hit.
    ``device`` defaults to the card (an error without one: pass
    ``device="cpu"``).  ``digest``: a precomputed
    ``structural_digest(fn)`` — callers keying many instances of one
    definition pass it to skip the redundant content hash.
    """
    from .synth import resolve_device
    dev = resolve_device(device)
    h = hashlib.sha256()
    h.update((digest or structural_digest(fn)).encode())
    h.update(_stable_repr(aval_signature(args, kwargs or {})).encode())
    h.update(_toolchain(dev, resolve_lowering(dev, lowering)).encode())
    if extra is not None:
        _enc(h, extra)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the artifact: lowering, compiling, loading
# ---------------------------------------------------------------------------

class _Stage(torch.nn.Module):
    """A stage function as the module ``torch.export`` traces: its inputs
    are the tensor leaves of the lowered arguments; every other leaf (a
    Python scalar, a string) is a constant, as the key already says."""

    def __init__(self, fn: Callable, leaves: list, inputs: list, spec):
        super().__init__()
        self.fn, self.leaves, self.inputs, self.spec = \
            fn, leaves, inputs, spec

    def forward(self, *xs):
        leaves = list(self.leaves)
        for i, x in zip(self.inputs, xs):
            leaves[i] = x
        args, kwargs = pytree.tree_unflatten(leaves, self.spec)
        return self.fn(*args, **kwargs)


def _flat(args: tuple, kwargs: dict) -> tuple[list, Any]:
    return pytree.tree_flatten((tuple(args), dict(sorted(kwargs.items()))))


class Executable:
    """A compiled stage: its artifact's bytes, what the store keeps, and
    the loaded runner.  Called with the stage's runtime arguments (the
    lowered call's structure), it feeds their array leaves to the
    artifact as tensors on its device, each checked against the shape and
    dtype it was compiled for (any size on a dynamic axis, ``None`` in
    ``avals``), and ignores the constants, which the key pinned."""

    def __init__(self, kind: str, payload: bytes, inputs: list,
                 avals: list, n_leaves: int, device: Any,
                 timing: Optional[dict] = None):
        self.kind, self.payload, self.inputs, self.avals, self.n_leaves = \
            kind, payload, inputs, [tuple(a) for a in avals], n_leaves
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self._run = _load(kind, payload)
        # seconds of the export and of the package compile (0 on a load
        # from the store) and of the load the executable was built by
        self.timing = {"export_s": 0.0, "compile_s": 0.0, **(timing or {}),
                       "load_s": time.perf_counter() - t0}

    def entry(self) -> dict:
        return {"kind": self.kind, "payload": self.payload,
                "inputs": self.inputs, "avals": self.avals,
                "n_leaves": self.n_leaves, "device": str(self.device)}

    @classmethod
    def from_entry(cls, entry: dict) -> "Executable":
        return cls(entry["kind"], entry["payload"], entry["inputs"],
                   entry["avals"], entry["n_leaves"], entry["device"])

    def __call__(self, *args, **kwargs):
        leaves, _ = _flat(args, kwargs)
        if len(leaves) != self.n_leaves:
            raise TypeError(f"compiled stage takes {self.n_leaves} argument "
                            f"leaves, got {len(leaves)}")
        xs = [torch.as_tensor(leaves[i], device=self.device)
              for i in self.inputs]
        for x, (shape, dtype) in zip(xs, self.avals):
            if x.dim() != len(shape) or _dtype_name(x.dtype) != dtype or \
                    any(n is not None and n != m
                        for n, m in zip(shape, x.shape)):
                got = [(tuple(x.shape), _dtype_name(x.dtype)) for x in xs]
                raise TypeError(f"compiled stage takes inputs "
                                f"{self.avals}, got {got}")
        return self._run(*xs)


# torch.export's tracing, saving and loading, one at a time across threads:
# none is documented as thread-safe, and a save registers a process-wide
# pickle reducer for fake tensors while it runs (a second save at the same
# time refuses to replace it)
_export_lock = threading.Lock()


def _load(kind: str, payload: bytes) -> Callable:
    from ..kernels import ops  # noqa: F401  (registers the operators)
    if kind == "export":
        with _export_lock:
            return torch.export.load(io.BytesIO(payload)).module()
    import torch._inductor as inductor
    with tempfile.TemporaryDirectory(prefix="repro-torch-aoti-") as d:
        path = os.path.join(d, "stage.pt2")
        Path(path).write_bytes(payload)
        return inductor.aoti_load_package(path)


def _export(fn: Callable, args: tuple, kwargs: dict, device: torch.device,
            dynamic: Any = None):
    """``torch.export`` of ``fn`` on placeholders of its lowered args (no
    autograd: a compiled stage runs forward only), with the axes
    ``dynamic`` names (:class:`Dyn`) left symbolic.  Returns the program,
    without its example inputs, and ``(inputs, avals, n_leaves,
    examples)``: each input's ``(shape, stride, dtype)``, what a package
    compile needs in their place."""
    leaves, spec = _flat(lower_spec(tuple(args), device),
                         lower_spec(dict(kwargs), device))
    inputs = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    consts = [None if i in inputs else v for i, v in enumerate(leaves)]
    dyn = [None] * len(leaves) if dynamic is None else \
        _dynamic_leaves(dynamic, tuple(args), dict(kwargs))
    dims: dict = {}
    shapes = None
    if dynamic is not None:
        shapes = (tuple({axis: dims.setdefault(
            name, torch.export.Dim(name, min=lo, max=hi))
            for axis, name, lo, hi in dyn[i].axes} if dyn[i] else None
            for i in inputs),)
    with torch.no_grad():
        ep = torch.export.export(_Stage(fn, consts, inputs, spec),
                                 tuple(leaves[i] for i in inputs),
                                 dynamic_shapes=shapes)
    ep.example_inputs = None
    avals, examples = [], []
    for i in inputs:
        x, axes = leaves[i], {a[0] for a in dyn[i].axes} if dyn[i] else ()
        avals.append((tuple(None if a in axes else n
                            for a, n in enumerate(x.shape)),
                      _dtype_name(x.dtype)))
        examples.append((tuple(x.shape), tuple(x.stride()),
                         _dtype_name(x.dtype)))
    return ep, inputs, avals, len(leaves), examples


def _openmp_cxx() -> str:
    """The first C++ compiler of ``$CXX``, ``g++`` and ``c++`` that builds
    a shared object with ``-fopenmp``.  AOTInductor always compiles its
    C++ wrapper with OpenMP under GCC, so a ``$CXX`` without libgomp (a
    toolchain built without it) fails every package; this one is used
    instead.  Raises when none of them can."""
    cands = list(dict.fromkeys(
        c for c in (os.environ.get("CXX"), "g++", "c++") if c))
    with tempfile.TemporaryDirectory(prefix="repro-torch-cxx-") as d:
        src = Path(d, "omp.cpp")
        src.write_text("#include <omp.h>\n"
                       "int f() { return omp_get_max_threads(); }\n")
        for cxx in cands:
            try:
                r = subprocess.run([cxx, "-shared", "-fPIC", "-fopenmp",
                                    str(src), "-o", str(Path(d, "omp.so"))],
                                   capture_output=True)
            except OSError:
                continue
            if r.returncode == 0:
                return cxx
    raise RuntimeError(f"none of the C++ compilers {cands} builds with "
                       f"-fopenmp, which AOTInductor's wrapper needs; set "
                       f"CXX to one that does")


def aoti_package(ep_path: str, pkg_path: str, examples: list,
                 device: str) -> float:
    """Compile a saved exported program into an AOTInductor package with
    inductor's own caches off (they would turn a repeated compile of one
    definition into a hit), and return the compile's seconds.  The
    program is saved without example inputs; uninitialised tensors of
    each input's ``(shape, stride, dtype)`` on ``device`` stand in for
    them.  Runs in a worker process (:func:`compile_artifacts`), whose
    ``$CXX`` is :func:`_openmp_cxx`'s choice."""
    import torch._inductor as inductor
    from ..kernels import ops  # noqa: F401  (registers the operators)
    ep = torch.export.load(ep_path)
    ep.example_inputs = (tuple(
        torch.empty_strided(shape, stride, dtype=getattr(torch, dtype),
                            device=device)
        for shape, stride, dtype in examples), {})
    t0 = time.perf_counter()
    with inductor.config.patch(force_disable_caches=True):
        inductor.aoti_compile_and_package(ep, package_path=pkg_path)
    return time.perf_counter() - t0


_WORKER = """
import json, sys, traceback
from repro_torch.core.compile_cache import aoti_package
for line in sys.stdin:
    job = json.loads(line)
    try:
        out = {"s": aoti_package(*job)}
    except Exception:
        out = {"error": traceback.format_exc()}
    print("%s" + json.dumps(out), flush=True)
"""
_REPLY = "repro-torch-aoti "          # marks a worker's reply line


class _Worker:
    """One package-compile process: a fresh interpreter (no state of the
    caller's, no re-import of its ``__main__``) that takes
    :func:`aoti_package`'s arguments on stdin and answers each job with
    its seconds.  It
    lives until :func:`shutdown_workers`, so its first compile's one-time
    cost (imports, the toolchain's probes: 92-103 s a process with 4
    starting at once on an H100 host's 8 cores, PERF.md §6) is paid once
    a process, not once a call."""

    def __init__(self, cxx: str):
        self.lock = threading.Lock()
        self.log = tempfile.TemporaryFile(mode="w+")
        src = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, CXX=cxx, PYTHONPATH=os.pathsep.join(
            p for p in (src, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER % _REPLY], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True)

    def compile(self, *job) -> float:
        """Run one job; the caller holds :attr:`lock`."""
        self.proc.stdin.write(json.dumps(job) + "\n")
        self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith(_REPLY):
                out = json.loads(line[len(_REPLY):])
                if "error" in out:
                    raise RuntimeError(f"AOTInductor compile failed:\n"
                                       f"{out['error'][-4000:]}")
                return out["s"]
        self.log.seek(0)
        raise RuntimeError(f"AOTInductor compile process ended (rc "
                           f"{self.proc.wait()}):\n"
                           f"{self.log.read()[-4000:]}")

    def close(self) -> None:
        self.proc.stdin.close()
        self.proc.wait()
        self.log.close()


_workers: list = []
_workers_lock = threading.Lock()


def _get_workers(n: int) -> list:
    """The first ``n`` compile processes, started as needed (the C++
    compiler chosen once, when the first starts)."""
    with _workers_lock:
        _workers[:] = [w for w in _workers if w.proc.poll() is None]
        if len(_workers) < n:
            cxx = _openmp_cxx()
            _workers.extend(_Worker(cxx) for _ in range(n - len(_workers)))
        return _workers[:n]


def _compile_on_a_free_worker(*job) -> float:
    """Run ``job`` in the first compile process that is free (another
    thread's compiles may hold some), waiting for one."""
    while True:
        for w in list(_workers):
            if w.lock.acquire(blocking=False):
                try:
                    return w.compile(*job)
                finally:
                    w.lock.release()
        time.sleep(0.05)


def shutdown_workers() -> None:
    """Stop every package-compile process (also done at exit)."""
    with _workers_lock:
        for w in _workers:
            w.close()
        _workers.clear()


atexit.register(shutdown_workers)


def compile_artifacts(specs: list, *, device: Any, lowering: str,
                      max_workers: Optional[int] = None) -> list:
    """Lower and compile each ``(fn, args, kwargs)`` (or ``(fn, args,
    kwargs, dynamic)``, :class:`Dyn`) of ``specs`` into an
    :class:`Executable` on ``device``.

    The exports run one after another, one at a time across threads too
    (``_export_lock``), and so do their saves.
    Each AOTInductor package compiles as soon as its exported program is
    saved (while the next one exports), in the first free one of the
    worker processes, of which at least ``max_workers`` run (``None``:
    one a CPU core, at most one a spec).  A failed export or compile
    raises.
    """
    dev = torch.device(device)

    def export(fn, args, kwargs, *dynamic):
        t0 = time.perf_counter()
        with _export_lock:
            ep, *sig, examples = _export(fn, args, kwargs, dev, *dynamic)
        return ep, sig, examples, time.perf_counter() - t0

    if lowering == "export":
        out = []
        for spec in specs:
            ep, sig, _, export_s = export(*spec)
            buf = io.BytesIO()
            with _export_lock:
                torch.export.save(ep, buf)
            out.append(Executable("export", buf.getvalue(), *sig, dev,
                                  {"export_s": export_s, "compile_s": 0.0}))
        return out
    workers = max(1, min(max_workers or os.cpu_count() or 1, len(specs)))
    _get_workers(workers)
    with tempfile.TemporaryDirectory(prefix="repro-torch-aoti-") as d, \
            ThreadPoolExecutor(workers) as pool:
        jobs = []
        for j, spec in enumerate(specs):
            ep, sig, examples, export_s = export(*spec)
            ep_path = os.path.join(d, f"ep{j}.pt2")
            pkg_path = os.path.join(d, f"pkg{j}.pt2")
            with _export_lock:
                torch.export.save(ep, ep_path)
            jobs.append((sig, export_s, pkg_path, pool.submit(
                _compile_on_a_free_worker, ep_path, pkg_path, examples,
                str(dev))))
        out = []
        for sig, export_s, pkg_path, job in jobs:
            compile_s = job.result()        # the package is written
            out.append(Executable("aoti", Path(pkg_path).read_bytes(), *sig,
                                  dev, {"export_s": export_s,
                                        "compile_s": compile_s}))
        return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@dataclass
class CacheStats:
    mem_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    corrupt: int = 0
    serialize_failures: int = 0
    memo_hits: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _default_root() -> Path:
    return Path(os.environ.get(
        "REPRO_TORCH_COMPILE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "repro-torch-compile-cache")))


# Framed entries: magic + sha256(blob) + blob.  The digest makes any
# bit-level corruption (not just unpicklable truncation) detectable at read
# time, feeding the delete+recompile path.
_MAGIC = b"RCC1"
_DIGEST_LEN = 32


def _frame(blob: bytes) -> bytes:
    return _MAGIC + hashlib.sha256(blob).digest() + blob


def _unframe(data: bytes) -> bytes:
    if not data.startswith(_MAGIC):
        return data                     # legacy unframed entry
    digest = data[len(_MAGIC):len(_MAGIC) + _DIGEST_LEN]
    blob = data[len(_MAGIC) + _DIGEST_LEN:]
    if hashlib.sha256(blob).digest() != digest:
        raise ValueError("cache entry digest mismatch")
    return blob


class CompileCache:
    """Two-level (memory, disk) content-addressed store of compiled stages.

    Layout (versioned; a SCHEMA bump orphans old trees wholesale)::

        <root>/v1/ex/<key[:2]>/<key>.exe      pickled artifact entry
        <root>/v1/memo/<key[:2]>/<key>.json   memoized JSON results

    Disk entries carry their last-use time in mtime (bumped on every hit);
    eviction drops least-recently-used entries until the tree fits
    ``max_bytes``.  Any unreadable or unloadable entry is deleted and
    counted in ``stats.corrupt`` — a corrupt cache costs a recompile, never
    an error.
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 max_bytes: int = 512 << 20, disk: bool = True,
                 faults: Any = None):
        self.root = Path(root) if root is not None else _default_root()
        self.max_bytes = max_bytes
        self.disk = disk
        # chaos harness (repro_torch.core.faults): injected transient
        # write failures and post-write corruption; None in normal use
        if faults is not None and not hasattr(faults, "io_error"):
            faults = faults.injector()
        self.faults = faults
        self.stats = CacheStats()
        self._mem: dict[str, Any] = {}
        self._lock = threading.RLock()
        # running estimate of on-disk bytes; None until the first full
        # walk.  Keeps the per-put cost O(1): the tree is only re-walked
        # when the estimate crosses max_bytes.
        self._approx_bytes: Optional[int] = None

    # -- paths ---------------------------------------------------------------

    def _path(self, key: str, kind: str = "ex") -> Path:
        ext = "exe" if kind == "ex" else "json"
        return self.root / SCHEMA / kind / key[:2] / f"{key}.{ext}"

    def _entries(self) -> list:
        base = self.root / SCHEMA
        if not base.exists():
            return []
        out = []
        for p in base.rglob("*"):
            if p.is_file():
                try:
                    st = p.stat()
                    out.append((st.st_mtime, st.st_size, p))
                except OSError:
                    continue
        return out

    def disk_bytes(self) -> int:
        return sum(size for _, size, _ in self._entries())

    # -- executables ---------------------------------------------------------

    def get(self, key: str) -> Optional[Any]:
        exe, _ = self.get_with_source(key)
        return exe

    def get_with_source(self, key: str):
        """Return ``(executable, source)``; source in memory/disk/None."""
        with self._lock:
            exe = self._mem.get(key)
            if exe is not None:
                self.stats.mem_hits += 1
                return exe, "memory"
        if self.disk:
            p = self._path(key)
            if p.exists():
                try:
                    entry = pickle.loads(_unframe(p.read_bytes()))
                    if entry.get("schema") != SCHEMA:
                        raise ValueError("schema mismatch")
                    exe = Executable.from_entry(entry["payload"])
                    os.utime(p)                       # LRU bump
                    with self._lock:
                        self._mem[key] = exe
                        self.stats.disk_hits += 1
                    return exe, "disk"
                except Exception:
                    # corrupt / truncated / stale entry: delete + recompile
                    with self._lock:
                        self.stats.corrupt += 1
                    try:
                        p.unlink()
                    except OSError:
                        pass
        with self._lock:
            self.stats.misses += 1
        return None, None

    def put(self, key: str, executable: Any, meta: Optional[dict] = None
            ) -> None:
        with self._lock:
            self._mem[key] = executable
            self.stats.puts += 1
        if not self.disk:
            return
        if not isinstance(executable, Executable):
            # only compiled stages have an artifact to write; anything
            # else stays memory-only rather than fail the compile
            with self._lock:
                self.stats.serialize_failures += 1
            return
        blob = pickle.dumps({"schema": SCHEMA, "key": key,
                             "meta": meta or {},
                             "payload": executable.entry()})
        path = self._path(key)
        if self._write_atomic(path, _frame(blob), verify=True) and \
                self.faults is not None and self.faults.corrupt_cache():
            self._corrupt_entry(path)   # chaos: prove delete+recompile works
        self._maybe_evict()

    def compile_cached(self, fn: Callable, args: tuple = (),
                       kwargs: Optional[dict] = None, *,
                       key: Optional[str] = None, device: Any = None,
                       lowering: Optional[str] = None, extra: Any = None,
                       dynamic: Any = None):
        """Lower and compile ``fn`` on ``args`` through the cache.

        ``key``: a precomputed :func:`instance_key`; ``extra`` is folded
        into a key computed here (the reference's ``extra``), and so is
        ``dynamic`` (:class:`Dyn`: the axes one executable takes at any
        size in its range).  ``device`` defaults to the card (an error
        without one); ``lowering`` to the device's artifact
        (:func:`resolve_lowering`).  Returns ``(executable, source)``.
        """
        return self.compile_many([(fn, args, kwargs, extra, dynamic)],
                                 keys=[key], device=device,
                                 lowering=lowering)[0]

    def compile_many(self, jobs: list, *, keys: Optional[list] = None,
                     device: Any = None, lowering: Optional[str] = None,
                     max_workers: Optional[int] = None) -> list:
        """:meth:`compile_cached` of each ``(fn, args, kwargs, extra,
        dynamic)`` of ``jobs`` (``keys``: precomputed keys or ``None``s),
        the misses compiled together (:func:`compile_artifacts`: the
        packages of a cold store in parallel processes).  Returns
        ``[(executable, source)]`` in the jobs' order."""
        from .synth import resolve_device
        dev = resolve_device(device)
        lowering = resolve_lowering(dev, lowering)
        keys = list(keys or [None] * len(jobs))
        out, miss = [], []
        for i, (fn, args, kwargs, extra, dynamic) in enumerate(jobs):
            if keys[i] is None:
                keys[i] = instance_key(
                    fn, args, kwargs or {}, device=dev, lowering=lowering,
                    extra=extra if dynamic is None else (extra, dynamic))
            out.append(self.get_with_source(keys[i]))
            if out[-1][0] is None:
                miss.append(i)
        if miss:
            exes = compile_artifacts(
                [(jobs[i][0], jobs[i][1], jobs[i][2] or {}, jobs[i][4])
                 for i in miss], device=dev, lowering=lowering,
                max_workers=max_workers)
            for i, exe in zip(miss, exes):
                self.put(keys[i], exe)
                out[i] = (exe, "compiled")
        return out

    # -- memoized JSON results (QoR-tuning measurements) ---------------------

    def memo_get(self, key: str) -> Optional[Any]:
        if not self.disk:
            return None
        p = self._path(key, "memo")
        if not p.exists():
            return None
        try:
            out = json.loads(p.read_text())
            os.utime(p)
            with self._lock:
                self.stats.memo_hits += 1
            return out
        except Exception:
            with self._lock:
                self.stats.corrupt += 1
            try:
                p.unlink()
            except OSError:
                pass
            return None

    def memo_put(self, key: str, value: Any) -> None:
        if not self.disk:
            return
        self._write_atomic(self._path(key, "memo"),
                           json.dumps(value).encode())
        self._maybe_evict()

    # -- maintenance ---------------------------------------------------------

    def _write_atomic(self, path: Path, data: bytes,
                      verify: bool = False) -> bool:
        """Write-rename a disk entry; one retry on a transient ``OSError``.

        With ``verify=True`` the published entry is read back and compared
        to what was written (verify-after-write), so a torn or silently
        failed write is caught while the original data is still in hand.
        Returns False when both attempts failed (read-only FS etc.): the
        store degrades to memory-only, never errors.
        """
        for attempt in (0, 1):
            try:
                if self.faults is not None and self.faults.io_error("cache"):
                    raise OSError("injected transient cache IO failure")
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
                tmp.write_bytes(data)
                os.replace(tmp, path)   # readers never see partial entries
                if verify and path.read_bytes() != data:
                    raise OSError(f"verify-after-write mismatch for {path}")
                with self._lock:
                    if self._approx_bytes is not None:
                        self._approx_bytes += len(data)
                return True
            except OSError:
                if attempt:
                    return False        # read-only FS: memory level only
        return False

    def _corrupt_entry(self, path: Path) -> None:
        """Chaos-only: flip one byte mid-entry, making the published entry
        fail its digest check on the next read."""
        try:
            data = bytearray(path.read_bytes())
            if data:
                data[len(data) // 2] ^= 0xFF
                path.write_bytes(bytes(data))
        except OSError:
            pass

    def _maybe_evict(self) -> None:
        """Full-tree eviction only when the running estimate says the
        bound may be exceeded (a put is O(1) otherwise)."""
        with self._lock:
            approx = self._approx_bytes
        if approx is None or approx > self.max_bytes:
            self.evict_to_fit()

    def evict_to_fit(self) -> int:
        """Drop least-recently-used disk entries until under ``max_bytes``."""
        entries = self._entries()
        total = sum(size for _, size, _ in entries)
        dropped = 0
        for _, size, p in sorted(entries):          # oldest mtime first
            if total <= self.max_bytes:
                break
            try:
                p.unlink()
                total -= size
                dropped += 1
            except OSError:
                continue
        with self._lock:
            self.stats.evictions += dropped
            self._approx_bytes = total
        return dropped

    def clear_memory(self) -> None:
        """Drop the first level (what a process restart does for free)."""
        with self._lock:
            self._mem.clear()

    def clear(self) -> None:
        self.clear_memory()
        for _, _, p in self._entries():
            try:
                p.unlink()
            except OSError:
                pass
        with self._lock:
            self._approx_bytes = 0


# ---------------------------------------------------------------------------
# process-default cache
# ---------------------------------------------------------------------------

_default: Optional[CompileCache] = None
_default_lock = threading.Lock()


def default_cache() -> CompileCache:
    """Process-wide cache; root from ``$REPRO_TORCH_COMPILE_CACHE`` (or
    ``~/.cache/repro-torch-compile-cache``), bound from
    ``$REPRO_TORCH_COMPILE_CACHE_MAX_MB`` (default 512)."""
    global _default
    with _default_lock:
        if _default is None:
            mb = int(os.environ.get("REPRO_TORCH_COMPILE_CACHE_MAX_MB",
                                    "512"))
            _default = CompileCache(max_bytes=mb << 20)
        return _default


def set_default_cache(cache: Optional[CompileCache]) -> None:
    global _default
    with _default_lock:
        _default = cache

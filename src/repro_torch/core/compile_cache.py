"""Structural hashing of task definitions and graphs.

The hashing half of the reference package's compile cache: a stable
digest of a Python function's bytecode, constants, referenced globals,
closure cell *values* and defaults.  Two separately-created closures with
the same body hash equal; an edited constant or captured weight hashes
different, and the digest survives process restarts, which ``id(fn)``
never could.  :mod:`repro_torch.core.graph` keys task definitions and the
whole-graph structural hash on it.

Array data is hashed by content: numpy arrays and torch tensors alike
(dtype + shape + bytes).  The executable store, ``instance_key`` and
``lower_spec`` of the reference are not part of this module yet.
"""

from __future__ import annotations

import hashlib
import re
import types
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

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


def aval_signature(args: tuple, kwargs: dict) -> tuple:
    """Shape/dtype signature of array-like args (ShapeDtypeStruct and
    interface aware: mmap/async_mmap sign by aval, scalars by value)."""
    def one(x):
        k = getattr(x, "iface_kind", None)
        if k in ("mmap", "async_mmap"):
            return (k, tuple(x.shape), str(x.dtype))
        if k == "scalar":
            return ("lit", repr(x.value))
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return ("arr", tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return ("seq", tuple(one(v) for v in x))
        if isinstance(x, dict):
            return ("map", tuple(sorted((k, one(v)) for k, v in x.items())))
        return ("lit", repr(x))
    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kwargs.items())))


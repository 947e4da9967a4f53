"""Ambient runtime context.

Task bodies are plain Python functions that call blocking stream methods
(``read``/``write``/``peek``/...).  How a blocked operation suspends depends
on which engine is running the task: the sequential engine raises, the
thread engine waits on a condition variable, the coroutine engine performs a
cooperative hand-off.  Streams discover the active engine (and the current
task handle) through this thread-local context.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_tls = threading.local()


def current_runtime() -> Optional[Any]:
    return getattr(_tls, "runtime", None)


def current_task() -> Optional[Any]:
    return getattr(_tls, "task", None)


def set_context(runtime: Any, task: Any) -> None:
    _tls.runtime = runtime
    _tls.task = task


def clear_context() -> None:
    _tls.runtime = None
    _tls.task = None


def current_builder_stack() -> list:
    """Stack of TaskBuilder objects being populated in the current context.

    ``repro_torch.task()`` pushes onto this stack; the graph elaborator pops it to
    discover the children a parent task instantiated (Section 3.1.3).
    """
    if not hasattr(_tls, "builders"):
        _tls.builders = []
    return _tls.builders

"""Preemption: SIGTERM/SIGINT become a cooperative "finish and exit".

The port's copy of the reference's ``PreemptionGuard``
(``ft/elastic.py:45-97``), which has no JAX in it.  ``launch/serve.py``
wires it to the serving engine's ``stop_flag``: on a signal the scheduler
rejects queued admissions, finishes the in-flight slots and exits clean.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, exit clean.

    The handler lifecycle is explicit and re-entrant-safe: ``install()``
    saves the previous handlers exactly once, ``uninstall()`` restores
    them and forgets them (idempotent — a second call is a no-op, and a
    guard can be re-installed afterwards).  Nested guards therefore
    restore handlers correctly as long as they uninstall in LIFO order.
    Usable as a context manager: ``with PreemptionGuard() as g: ...``.
    """

    def __init__(self, install: bool = True):
        self.requested = False
        self.installed = False
        self._prev = {}
        if install:
            self.install()

    def install(self) -> None:
        if self.installed:
            raise ValueError("PreemptionGuard is already installed")
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:          # non-main thread (tests)
                pass
        self.installed = True

    def _handler(self, signum, frame):
        self.requested = True

    def trigger(self) -> None:
        """In-process preemption (tests / drills)."""
        self.requested = True

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, h in self._prev.items():
            signal.signal(sig, h)
        self._prev = {}
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        if not self.installed:
            self.install()
        return self

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

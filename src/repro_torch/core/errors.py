"""Exception types for the core runtime."""

from dataclasses import dataclass, field
from typing import Optional


class ReproError(Exception):
    """Base class for all repro errors."""


class Deadlock(ReproError):
    """No task can make progress, yet non-detached tasks remain unfinished.

    Raised by ThreadEngine/CoroutineEngine when every live task is blocked on
    a channel operation that can never be satisfied.
    """


@dataclass
class DeadlockReport:
    """Structured no-progress diagnostic, uniform across every engine.

    The CompiledEngine always reported its stalls this way (blocked tasks +
    channel occupancies); this extracts that shape so sequential/thread/
    coroutine deadlocks, watchdog trips and compiled stalls all carry the
    same payload (``SimReport.deadlock``).  ``reason`` is one of:

    * ``"deadlock"`` — every live task is blocked on an unsatisfiable op;
    * ``"sequential-read"`` — the sequential engine's documented failure
      (blocking read with no runnable producer);
    * ``"stall"`` — a lowered graph stopped firing before completion;
    * ``"watchdog"`` — the wall-clock watchdog expired (livelock / hang);
    * ``"tick-budget"`` — the logical-clock budget (``max_ticks``) expired.
    """

    engine: str
    reason: str
    blocked: list = field(default_factory=list)    # [(task, wait site)]
    occupancy: dict = field(default_factory=dict)  # channel name -> tokens
    clock: int = 0
    switches: int = 0
    wall_s: float = 0.0

    def format(self) -> str:
        b = "; ".join(f"{t} ({s})" for t, s in self.blocked) or "-"
        occ = {k: v for k, v in self.occupancy.items() if v}
        return (f"deadlock[{self.reason}] under {self.engine} engine: "
                f"blocked tasks: {b}; channel occupancy: {occ}; "
                f"clock={self.clock} switches={self.switches}")


class DeadlockError(Deadlock):
    """A :class:`Deadlock` carrying its :class:`DeadlockReport`."""

    def __init__(self, report: DeadlockReport):
        super().__init__(report.format())
        self.report = report


class InjectedFault(ReproError):
    """A failure injected by the chaos harness (``repro_torch.core.faults``).

    Raised from a task body at the firing chosen by the fault plan; engines
    surface it like any other task failure (``task error: ...``), which is
    exactly the point — injected faults exercise the real error paths.
    """


class TransientFault(ReproError):
    """An injected *retryable* failure (serving step, artifact IO)."""


class CrashFault(ReproError):
    """An injected process-crash analogue (``FaultPlan.crash``).

    Unlike :class:`InjectedFault` — which models a task *dying* and is
    surfaced as a structured task failure — a ``CrashFault`` models the
    whole simulation process disappearing mid-run.  It is the fault kind
    the recovery subsystem (:mod:`repro.ft.recovery`) exists for: a
    supervisor catches it, restores the latest :class:`GraphSnapshot`
    and re-runs from the snapshot instead of from scratch.
    """


class PoisonError(ReproError):
    """A serving request whose compute step is poisoned by the fault plan.

    The scheduler quarantines the named request (retired with an error
    status) instead of dying; carries ``rid`` so batched steps can identify
    the victim inside a group call.
    """

    def __init__(self, rid: int, msg: Optional[str] = None):
        super().__init__(msg or f"poisoned request {rid}")
        self.rid = rid


class SequentialSimulationError(Deadlock):
    """The sequential engine cannot simulate this program.

    Reproduces the paper's finding (Section 3.2 / Fig. 7) that sequential
    simulators fail on programs with feedback loops in the data paths
    (e.g. Cannon's algorithm, PageRank).
    """


class ChannelMisuse(ReproError):
    """A channel is wired to something other than exactly one producer and
    one consumer instantiated in the same parent task (Section 3.1.1)."""


class GraphValidationError(ReproError):
    """Task-graph metadata failed validation."""


class SynthesisError(ReproError):
    """A task graph cannot be lowered to a single compiled program.

    Raised by :mod:`repro_torch.core.synth` when the graph is outside the
    synthesizable subset — a task not in step-function form, a channel with
    no declared element spec, a data-dependent I/O rate, an async_mmap
    port, a read-and-written mmap, or a phase whose I/O can never fit the
    channel capacity.  The message names the offending task/channel: the
    contract is *refuse with a diagnostic, never miscompile*.
    """


class TaskKilled(BaseException):
    """Internal control-flow signal used to tear down detached tasks once all
    non-detached tasks have finished.  Derives from BaseException so that
    user-level ``except Exception`` blocks inside tasks do not swallow it.
    """


class EndOfTransaction(ReproError):
    """A blocking data read/peek encountered an EoT token.

    Matches TAPA semantics: an EoT token carries no data, so ``read()`` of a
    closed transaction is a programming error that must be surfaced, not
    silently returned.  Use ``eot()`` / ``try_read()`` to test first.
    """

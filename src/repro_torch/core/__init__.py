"""repro_torch.core — the paper's contribution on PyTorch.

C1: channels with peek/EoT/transactions + typed task interfaces
    (streams / mmap / async_mmap / scalar) + hierarchical instantiation
C2: universal software simulation (sequential / thread / coroutine engines)
C3: whole-graph synthesis to device ring buffers (``CompiledEngine``)
"""

from .channel import (EOT, Channel, IStream, OStream, channel, select,
                      READABLE, WRITABLE)
from .compile_cache import aval_signature, structural_digest
from .engines import (ENGINES, CoroutineEngine, EngineBase, SequentialEngine,
                      SimReport, ThreadEngine, run)
from .errors import (ChannelMisuse, CrashFault, Deadlock, DeadlockError,
                     DeadlockReport, EndOfTransaction, GraphValidationError,
                     InjectedFault, PoisonError, ReproError,
                     SequentialSimulationError, SynthesisError, TaskKilled,
                     TransientFault)
from .faults import FaultInjector, FaultPlan
from .graph import (ChannelInfo, DefinitionInfo, Graph, InterfaceInfo,
                    elaborate, extract_graph)
from .interface import (AsyncMMap, Interface, InterfaceBinding, MMap,
                        Scalar, async_mmap, mmap, scalar)
from .synth import (CompiledEngine, StepTask,   # registers ENGINES["compiled"]
                    elaborate_step_graph, to_torch_state)
from .task import TaskBuilder, TaskInstance, task

__all__ = [
    "EOT", "Channel", "IStream", "OStream", "channel", "select", "READABLE",
    "WRITABLE", "ENGINES", "CoroutineEngine", "EngineBase",
    "SequentialEngine", "SimReport", "ThreadEngine", "run", "ChannelMisuse",
    "Deadlock", "DeadlockError", "DeadlockReport", "EndOfTransaction",
    "FaultInjector", "FaultPlan", "GraphValidationError", "InjectedFault",
    "PoisonError", "ReproError", "TransientFault",
    "SequentialSimulationError", "TaskKilled", "DefinitionInfo", "Graph",
    "InterfaceInfo", "elaborate", "extract_graph", "TaskBuilder",
    "TaskInstance", "task", "aval_signature", "structural_digest",
    "AsyncMMap", "Interface", "InterfaceBinding", "MMap", "Scalar",
    "async_mmap", "mmap", "scalar",
    "ChannelInfo", "CompiledEngine", "StepTask", "SynthesisError",
    "CrashFault", "elaborate_step_graph", "to_torch_state",
]

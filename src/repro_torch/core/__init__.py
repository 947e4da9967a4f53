"""repro_torch.core — the paper's contribution on PyTorch.

C1: channels with peek/EoT/transactions + typed task interfaces
    (streams / mmap / async_mmap / scalar) + hierarchical instantiation
C2: universal software simulation (sequential / thread / coroutine engines)
C3: whole-graph synthesis to device ring buffers (``CompiledEngine``; over
    partitions placed on per-task costs with ``mesh=``), and
    hierarchical code generation of stage graphs through the compile cache
    (``compile_stages``, ``invoke(target="compiled")``)
"""

from .channel import (EOT, Channel, IStream, OStream, channel, select,
                      READABLE, WRITABLE)
from .compile_cache import (CacheStats, CompileCache, aval_signature,
                            default_cache, instance_key, lower_spec,
                            runtime_value, set_default_cache,
                            structural_digest)
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
from .hier_compile import (CompileReport, DataflowProgram, StageInstance,
                           build_dataflow, compile_stages, diff_definitions)
from .interface import (AsyncMMap, Interface, InterfaceBinding, MMap,
                        Scalar, async_mmap, mmap, scalar)
from .synth import (CompiledEngine, StepTask,   # registers ENGINES["compiled"]
                    elaborate_step_graph, to_torch_state)
from .cost import HW, task_cost
from .floorplan import Placement, placement_key, plan_placement
from .task import TaskBuilder, TaskInstance, task
from .invoke import invoke

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
    "CacheStats", "CompileCache", "default_cache", "set_default_cache",
    "instance_key", "lower_spec", "runtime_value", "CompileReport",
    "DataflowProgram", "StageInstance", "build_dataflow", "compile_stages",
    "diff_definitions", "invoke", "HW", "task_cost", "Placement",
    "placement_key", "plan_placement",
]

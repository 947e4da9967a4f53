"""repro_torch: task-parallel dataflow programming, simulation and
synthesis on PyTorch for one NVIDIA H100 — the port of the JAX package
``repro`` (which stays the reference), reproducing

    "Extending High-Level Synthesis for Task-Parallel Programs"
    (Chi, Guo, Choi, Wang, Cong — UCLA, 2020)

The public API mirrors the reference's::

    import repro_torch

    def Producer(out: repro_torch.OStream, n: int):
        for i in range(n):
            out.write(i)
        out.close()                      # end-of-transaction

    def Consumer(inp: repro_torch.IStream, result: list):
        for v in inp:                    # drains one transaction
            result.append(v)

    def Top(n, result):
        ch = repro_torch.channel(capacity=2)
        repro_torch.task() \\
            .invoke(Producer, ch, n) \\
            .invoke(Consumer, ch, result)

    report = repro_torch.run(Top, 8, [], engine="coroutine")

Step-form graphs (:class:`StepTask` leaves) also run under
``CompiledEngine``, which synthesizes them to ring buffers on the card
(``device=None`` means CUDA; pass ``device="cpu"`` to run on the CPU);
``CompiledEngine(mesh=N)`` places it over N partitions on per-task costs
(``plan_placement``), bit-identical to the single-device run.
``invoke(Top, ..., target="compiled")`` and ``compile_stages`` compile a
graph's stage definitions once each through the compile cache
(AOTInductor packages on the card, exported programs on the CPU).
"""

from .core import (EOT, Channel, IStream, OStream, channel, select, run,
                   task, invoke, StageInstance, compile_stages,
                   DataflowProgram, MMap, AsyncMMap, Scalar, mmap, async_mmap, scalar,
                   elaborate, Graph, InterfaceInfo, SimReport, ENGINES,
                   Deadlock, DeadlockError, DeadlockReport,
                   SequentialSimulationError, EndOfTransaction,
                   ChannelMisuse, ChannelInfo, CompiledEngine, StepTask,
                   SynthesisError, to_torch_state, HW, task_cost, Placement,
                   placement_key, plan_placement)

__all__ = [
    "EOT", "Channel", "IStream", "OStream", "channel", "select", "run",
    "task", "invoke", "StageInstance", "compile_stages", "DataflowProgram",
    "MMap", "AsyncMMap", "Scalar", "mmap", "async_mmap", "scalar",
    "elaborate", "Graph", "InterfaceInfo", "SimReport", "ENGINES",
    "Deadlock", "DeadlockError", "DeadlockReport",
    "SequentialSimulationError", "EndOfTransaction", "ChannelMisuse",
    "ChannelInfo", "CompiledEngine", "StepTask", "SynthesisError",
    "to_torch_state", "HW", "task_cost", "Placement", "placement_key",
    "plan_placement",
]

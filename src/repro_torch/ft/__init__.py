"""Fault tolerance of the port: the preemption guard, straggler detection,
the elastic re-mesh, the training restart protocol, and crash recovery
of task graphs (snapshots, the snapshot store, chunked and supervised
runs)."""

from .elastic import ElasticMesh, StragglerDetector, resume_or_init
from .preemption import PreemptionGuard
from .recovery import (GraphSnapshot, RestartPolicy, SnapshotStore,
                       capture_channel, capture_port, restore_channel,
                       restore_port, run_recoverable, run_supervised)

__all__ = ["ElasticMesh", "PreemptionGuard", "StragglerDetector",
           "resume_or_init", "GraphSnapshot", "RestartPolicy", "SnapshotStore",
           "capture_channel", "capture_port", "restore_channel",
           "restore_port", "run_recoverable", "run_supervised"]

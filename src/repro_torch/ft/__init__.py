"""Fault tolerance of the port: the preemption guard, straggler detection
and the training restart protocol."""

from .elastic import StragglerDetector, resume_or_init
from .preemption import PreemptionGuard

__all__ = ["PreemptionGuard", "StragglerDetector", "resume_or_init"]

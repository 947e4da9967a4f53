"""Fault tolerance of the port (so far: the preemption guard)."""

from .preemption import PreemptionGuard

__all__ = ["PreemptionGuard"]

"""Checkpointing and fault-tolerance policies for resumable jobs."""
from . import checkpoint, fault_tolerance

__all__ = ["checkpoint", "fault_tolerance"]

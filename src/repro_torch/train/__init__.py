"""The training substrate (optimizers, the train step, gradient
compression) and the checkpointing and fault-tolerance policies that the
resumable jobs use."""
from . import optimizer, train_loop, checkpoint, fault_tolerance, compression

__all__ = ["checkpoint", "compression", "fault_tolerance", "optimizer",
           "train_loop"]

"""Hand-written CUDA kernels of the port, registered per semiring.

Importing this package registers every kernel set with
:mod:`repro_torch.kernels.registry`; building a kernel waits for its
first launch on the card.
"""
from . import common, registry
from . import bovm  # noqa: F401  (registers the boolean kernel set)

"""Kernel registry: one tiling substrate, N semirings.

Each kernel package (``kernels/bovm``, ``kernels/counting``,
``kernels/tropical``) registers a :class:`KernelSet` — its sweep entry
points plus an on-chip budget estimator — keyed by the semiring name used
by
``repro_torch.core.sweep.Semiring``.  The core sweep layer looks its
kernels up here instead of importing a kernel module directly.
Registration happens on import of ``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelSet:
    """The kernel entry points one semiring contributes.

    ``forms`` maps a form name ("push"/"pull"/"push_f32" for boolean) to
    its kernel wrapper; ``fused_forms`` maps form names to multi-sweep
    wrappers with the uniform signature ``(frontier, operand, state,
    step, n_run, *, bs, max_sweeps)``.  ``smem_bytes`` estimates the
    shared memory one block of the form's kernel holds (the counterpart
    of the JAX package's ``vmem_bytes``); ``form="fused"`` prices the
    multi-sweep kernel, which ``core/sweep.py::resolve_fused_steps``
    gates on.  ``interpret_only`` names forms that may run only on CPU
    tensors (their plain versions): the core layer must not dispatch them
    on the card.  ``operand_index`` builds the live-word index
    (``common.WordIndex``) of the dense operand that a form's kernel reads
    through its ``index=`` keyword, ``lane_index`` the in-lane index
    (``common.LaneIndex``, the CSC of the CSR lanes) that the sparse
    form's kernel reads the same way; the prepared graphs build each
    once.  ``pack`` turns an (R, n) frontier into the (R, ceil(n / 32))
    words that a semiring's packed forms take (boolean: K1, K2, K3 and the
    mesh's OR combine).
    """
    semiring: str
    forms: Mapping[str, Callable]
    smem_bytes: Callable[..., int]
    notes: str = ""
    interpret_only: frozenset = frozenset()
    fused_forms: Mapping[str, Callable] = \
        dataclasses.field(default_factory=dict)
    operand_index: Optional[Callable] = None
    lane_index: Optional[Callable] = None
    pack: Optional[Callable] = None

    def dispatchable(self, form: str, *, interpret: bool) -> bool:
        """May ``form`` run at this execution mode?  ``interpret`` is true
        when the state lies on the CPU (the wrappers take their plain
        versions there)."""
        return interpret or form not in self.interpret_only


_REGISTRY: dict = {}


def _key(semiring) -> str:
    return semiring if isinstance(semiring, str) else semiring.name


def register(kernel_set: KernelSet) -> KernelSet:
    """Idempotent per name: re-registering the same semiring replaces it."""
    _REGISTRY[kernel_set.semiring] = kernel_set
    return kernel_set


def has(semiring) -> bool:
    return _key(semiring) in _REGISTRY


def get(semiring) -> KernelSet:
    """Look up the kernel set for a semiring (str or Semiring)."""
    key = _key(semiring)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"no kernels registered for semiring {key!r}; "
            f"available: {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))

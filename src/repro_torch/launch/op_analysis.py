"""Exact operation and byte counts of one call of a PyTorch callable
(the counterpart of ``analyze_jitted`` in ``repro/launch/hlo_analysis.py``;
the HLO text parser behind it has no counterpart).

:func:`analyze_callable` runs the callable once under a
``TorchDispatchMode`` and sees every aten op it dispatches:

  * flops: the sum of ``torch.utils.flop_counter``'s registered formulas
    (matmuls, convolutions, attention); other ops count none;
  * bytes: the ``nbytes`` of every tensor input and output of each op
    that is not a view (``OpOverload.is_view``) — the per-instruction
    operand-plus-output rule of the HLO counter.  An in-place op counts
    its tensor once read and once written.

The counts depend on the ops and the shapes alone, so they are
deterministic, and the same on the CPU and on the card for code that
dispatches the same ops on both (the plain sweep forms do).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


class OpStats(NamedTuple):
    flops: float
    bytes_accessed: float


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.nbytes for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def analyze_callable(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once and count its flops and bytes."""
    counter = _OpCounter()
    with counter:
        fn(*args, **kwargs)
    return OpStats(flops=float(counter.flops),
                   bytes_accessed=float(counter.bytes))

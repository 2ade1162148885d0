"""Unified sweep-engine options base (the port of ``repro/core/options.py``).

:class:`SweepOptions` holds the fields every engine understands (source
batching, form selection mode, kernel/dynamic resolution, sweep bound,
fused blocks, kernel tiles).  Engine configs subclass it and add only
their own knobs; :meth:`SweepOptions.to` projects a plain options object
onto an engine config, as the facade in ``repro_torch/api.py`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Tuple

__all__ = ["SweepOptions"]


@dataclasses.dataclass(frozen=True)
class SweepOptions:
    """Engine-agnostic sweep parameters (frozen, hashable).

    ``mode`` names a sweep *form* ("push"/"pull"/"sparse" boolean) or
    "auto" (cost-model selection).  The base class accepts any string;
    each engine subclass pins the set it dispatches via ``_mode_names``.
    """
    source_batch: int = 128          # sources per tile (multiple of 8)
    mode: str = "auto"               # "auto" | an engine form name
    use_kernel: Optional[bool] = None  # None -> kernels iff on CUDA
    dynamic: Optional[bool] = None   # per-sweep switch; None -> use_kernel
    max_steps: Optional[int] = None  # None -> n_nodes (hop bound)
    # fused multi-sweep blocks: 0 = off, K > 0 = K sweeps per kernel
    # launch, -1 = whole fixpoint in one launch (kernel path only)
    fused_steps: int = 0
    # kernel tiles (bs adapts to the source batch)
    bn: int = 128
    bk: int = 128
    # roofline tuning plan: not ported yet (the autotuner is Queue 1
    # item 12); must stay None
    tuning: Optional[Any] = None

    # subclasses pin the form names they dispatch; () = accept anything
    _mode_names: ClassVar[Tuple[str, ...]] = ()

    def __post_init__(self):
        if self.tuning is not None:
            raise NotImplementedError(
                "tuning= needs the roofline autotuner, which is not ported "
                "yet (ROADMAP Queue 1 item 12)")
        if self._mode_names and self.mode not in ("auto",) + self._mode_names:
            raise ValueError(f"mode {self.mode!r} not in "
                             f"{('auto',) + self._mode_names}")
        if self.source_batch % 8:
            raise ValueError(f"source_batch must be a multiple of 8, got "
                             f"{self.source_batch}")
        # above one stats/push tile the batch must tile exactly (bs = 128)
        if self.source_batch > 128 and self.source_batch % 128:
            raise ValueError(f"source_batch > 128 must be a multiple of "
                             f"128, got {self.source_batch}")
        if self.fused_steps < -1:
            raise ValueError(
                f"fused_steps must be -1 (whole fixpoint), 0 (off) or a "
                f"positive sweep count, got {self.fused_steps}")

    def to(self, cls, lenient: bool = False, **extra):
        """Project these options onto engine config class ``cls``.

        Copies every shared base field, overlays ``extra``, and lets
        ``cls.__post_init__`` validate.  With ``lenient=True`` a ``mode``
        the target engine does not dispatch falls back to "auto".
        """
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(SweepOptions)}
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in kw.items() if k in names}
        kw.update(extra)
        valid = getattr(cls, "_mode_names", ())
        if lenient and valid and kw.get("mode", "auto") not in \
                ("auto",) + tuple(valid):
            kw["mode"] = "auto"
        return cls(**kw)

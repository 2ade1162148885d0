"""The roofline terms of a piece of work on the card (the port of
``roofline_terms`` in ``repro/launch/roofline.py``).

The JAX module's ``analyze_cell`` / ``markdown_table`` / ``main`` read
the TPU dry-run's HLO dumps and have no counterpart here; the autotuner
(``core/autotune.py``) prices sweep forms with :func:`roofline_terms` on
the counts of :mod:`.op_analysis`.
"""
from __future__ import annotations

from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def roofline_terms(flops: float, bytes_accessed: float,
                   wire_bytes: float = 0.0, *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW, ici_bw: float = NVLINK_BW) -> dict:
    """The three roofline terms in seconds plus the dominant one:
    compute (``flops / peak_flops``), memory (``bytes_accessed /
    hbm_bw``) and collective (``wire_bytes / ici_bw``, the link between
    cards)."""
    t_comp = flops / peak_flops
    t_mem = bytes_accessed / hbm_bw
    t_coll = wire_bytes / ici_bw
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dominant}

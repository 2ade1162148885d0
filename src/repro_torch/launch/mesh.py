"""Hardware constants of the card the port targets, for the roofline
model (the counterpart of the constants in ``repro/launch/mesh.py``).

NVIDIA H100 SXM (``nvidia-smi``: "NVIDIA H100 80GB HBM3, 700.00 W"),
data-sheet rates at the 700 W limit.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989.4e12      # dense BF16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s per direction per card
                                # (the collective term's link rate)

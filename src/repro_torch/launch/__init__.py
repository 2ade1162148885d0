"""Launch-layer helpers of the port: the card's constants
(:mod:`.mesh`), the roofline terms (:mod:`.roofline`) and the op counter
that prices a PyTorch callable (:mod:`.op_analysis`) — what the
autotuner (``core/autotune.py``) builds its unit costs from."""
from . import mesh

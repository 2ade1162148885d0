from .kernel import (fused_counting_multisweep, fused_counting_sweep,
                     fused_smem_bytes, reset_launches)
from .ref import counting_sweep_ref, fused_counting_multisweep_ref

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: one K6 block at padded node count
    ``n`` holds its rows' packed unreached set and the active-k list on
    chip (the operand is streamed and the (dist, sigma) state stays in
    global memory) — the size ``resolve_fused_steps`` gates on.  The
    per-sweep kernel K5 sizes its few-KB sigma stage at launch."""
    if form != "fused":
        raise ValueError(f"only the fused form is priced, not {form!r}")
    return fused_smem_bytes(n)


registry.register(registry.KernelSet(
    semiring="counting",
    forms={"push": fused_counting_sweep},
    smem_bytes=smem_bytes,
    notes="f32 counting push on the CUDA cores (one product of "
          "frontier-masked sigma gives discovery and exact path counts; "
          "zero operand words cost no arithmetic); the sparse scatter-add "
          "stays PyTorch ops; the fused multi-sweep kernel keeps the "
          "(dist, sigma) pair in global memory and streams the operand",
    fused_forms={"push": fused_counting_multisweep},
))

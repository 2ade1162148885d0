from .kernel import (fused_boolean_multisweep, fused_smem_bytes, fused_sweep,
                     packed_pull_sweep, packed_push_sweep, reset_launches)
from .ref import (fused_boolean_multisweep_ref, packed_pull_ref,
                  packed_push_ref, sweep_ref)

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: the multi-sweep kernel at padded
    node count ``n`` (its on-chip state grows with n, the operand is
    streamed), the size ``resolve_fused_steps`` gates on.  The per-sweep
    kernels size their own few-KB tiles at launch."""
    if form != "fused":
        raise ValueError(f"only the fused form is priced, not {form!r}")
    return fused_smem_bytes(n)


registry.register(registry.KernelSet(
    semiring="boolean",
    forms={"push": packed_push_sweep, "push_f32": fused_sweep,
           "pull": packed_pull_sweep},
    smem_bytes=smem_bytes,
    notes="bit-packed push and pull word-AND/OR sweeps on the CUDA cores "
          "(no float GEMM on the boolean kernel path; the int8 GEMM push "
          "survives as push_f32) + the fused multi-sweep kernel",
    fused_forms={"push": fused_boolean_multisweep},
))

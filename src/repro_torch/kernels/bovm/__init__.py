from .kernel import (fused_boolean_multisweep, fused_smem_bytes, fused_sweep,
                     pack_frontier, packed_live_words, packed_pull_sweep,
                     packed_push_sweep, reset_launches)
from .ops import (KernelDawnResult, msbfs_kernel, msbfs_packed,
                  pack_adjacency_pull, sweep)
from .ref import (fused_boolean_multisweep_ref, packed_live_words_ref,
                  packed_pull_ref, packed_push_ref, sweep_ref)

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: one CTA of the multi-sweep kernel
    at padded node count ``n`` (its slice of the row tile's state and the
    tile's active-word list grow with n, the operand is streamed), the
    size ``resolve_fused_steps`` gates on.  The per-sweep kernels size
    their own tiles at launch."""
    if form != "fused":
        raise ValueError(f"only the fused form is priced, not {form!r}")
    return fused_smem_bytes(n)


registry.register(registry.KernelSet(
    semiring="boolean",
    forms={"push": packed_push_sweep, "push_f32": fused_sweep,
           "pull": packed_pull_sweep},
    smem_bytes=smem_bytes,
    notes="bit-packed push and pull word-AND/OR sweeps on the CUDA cores "
          "(no float GEMM on the boolean kernel path; the int8 "
          "tensor-core GEMM push survives as push_f32) + the fused "
          "multi-sweep kernel, one thread block cluster per row tile; "
          "push and pull read the packed operand's live-word index",
    fused_forms={"push": fused_boolean_multisweep},
    operand_index=packed_live_words,
    pack=pack_frontier,
))

from .kernel import (fused_minplus_multisweep, fused_minplus_sweep,
                     fused_smem_bytes, finite_words, reset_launches,
                     sparse_relax_sweep)
from .ref import (fused_minplus_multisweep_ref, finite_words_ref,
                  minplus_sweep_ref, sparse_relax_ref)

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: one K8 block holds the 32 x 32 tile
    that transposes the state on entry and exit, at any padded node count
    ``n`` (the node-major state, the candidates, the frontier's row masks
    and the work list live in global memory, and the operand's live words
    are read through L2) — the size ``resolve_fused_steps`` gates on.  The
    per-sweep kernels K7 and K9 hold at most one such tile."""
    if form != "fused":
        raise ValueError(f"only the fused form is priced, not {form!r}")
    return fused_smem_bytes(n)


registry.register(registry.KernelSet(
    semiring="tropical",
    forms={"dense": fused_minplus_sweep, "sparse": sparse_relax_sweep},
    smem_bytes=smem_bytes,
    notes="dense min-plus push on the CUDA cores (settled-bound tile "
          "skip; reads only the operand words the live-word index lists, "
          "once per 32 source rows) + the "
          "edge-parallel sparse relax over the frontier's CSR lanes "
          "(atomicMin on the float bits) + the fused multi-sweep kernel, "
          "which runs K7's push for the whole batch on a cooperative grid "
          "over the same index, the state node-major in global memory",
    # unlike the JAX package, the sparse relax is dispatched on the card:
    # min is order-free, so the atomic scatter gives the same bits
    interpret_only=frozenset(),
    fused_forms={"dense": fused_minplus_multisweep},
    operand_index=finite_words,
))

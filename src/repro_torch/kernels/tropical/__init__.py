from .kernel import (fused_minplus_multisweep, fused_minplus_sweep,
                     fused_smem_bytes, finite_words, in_lanes,
                     reset_launches, sparse_relax_sweep)
from .ref import (fused_minplus_multisweep_ref, finite_words_ref,
                  in_lanes_ref, in_lanes_sorted, minplus_sweep_ref,
                  sparse_relax_ref)

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: one K8 block holds the 32 x 32 tile
    that transposes the state on entry and exit, at any padded node count
    ``n`` (the node-major state, the candidates, the frontier's row masks
    and the work list live in global memory, and the operand's live words
    are read through L2) — the size ``resolve_fused_steps`` gates on.  K7's
    per-sweep blocks hold at most one such tile, K9's gather block
    37,376 B (a 32 x 32 tile of mins and of dist for each of its 4 row
    groups, and each warp's staged lanes)."""
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
          "sparse relax as a gather over each target's in-lanes (the "
          "lanes' CSC), the frontier-masked state node-major, no atomics "
          "+ the fused multi-sweep kernel, "
          "which runs K7's push for the whole batch on a cooperative grid "
          "over the same index, the state node-major in global memory",
    # unlike the JAX package, the sparse relax is dispatched on the card:
    # min is order-free, so the gather gives the same bits
    interpret_only=frozenset(),
    fused_forms={"dense": fused_minplus_multisweep},
    operand_index=finite_words,
    lane_index=in_lanes,
))

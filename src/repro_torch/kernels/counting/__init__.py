from .kernel import (fused_counting_multisweep, fused_counting_sweep,
                     fused_smem_bytes, nonzero_words, reset_launches)
from .ref import (counting_sweep_ref, fused_counting_multisweep_ref,
                  nonzero_words_ref)

from .. import registry


def smem_bytes(*, form: str = "fused", n: int = 1152, **_) -> int:
    """Shared memory one block of the form's kernel holds (the
    counterpart of the JAX package's ``vmem_bytes``).

    Only ``form="fused"`` is priced: one K6 block holds nothing in shared
    memory at any padded node count ``n`` (the state, the candidate sums
    and the work list live in global memory and the operand's live words
    are read through L2), so ``resolve_fused_steps`` admits every n_pad.
    The per-sweep kernel K5 holds one 4 KB transpose tile per epilogue
    block."""
    if form != "fused":
        raise ValueError(f"only the fused form is priced, not {form!r}")
    return fused_smem_bytes(n)


registry.register(registry.KernelSet(
    semiring="counting",
    forms={"push": fused_counting_sweep},
    smem_bytes=smem_bytes,
    notes="f32 counting push on the CUDA cores (one product of "
          "frontier-masked sigma gives discovery and exact path counts; "
          "it reads only the operand words the live-word index lists, "
          "once per 32 source rows, into node-major candidate sums); the "
          "sparse scatter-add stays PyTorch ops; the fused multi-sweep "
          "kernel runs the whole batch on a cooperative grid over the "
          "same index, once per sweep for all rows",
    fused_forms={"push": fused_counting_multisweep},
    operand_index=nonzero_words,
))

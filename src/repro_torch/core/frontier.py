"""Frontier representations for DAWN.

Two forms, as in the JAX package:

  * unpacked int8/bool  — the state of every sweep form;
  * bit-packed words    — 32 nodes per word, little-endian within the word
    (node ``32 w + b`` is bit ``b`` of word ``w``), the operand layout of
    the packed push/pull kernels.

torch has no shift for uint32 on the CPU, so packed words are carried as
int32 tensors holding the uint32 bit pattern (compare with other code
through ``.numpy().view(np.uint32)``).  The arithmetic runs in int64 and
is masked to 32 bits before the final wrapping cast.
"""
from __future__ import annotations

import torch

WORD = 32
UNREACHED = -1
_MASK32 = 0xFFFFFFFF


def packed_width(n: int) -> int:
    return (n + WORD - 1) // WORD


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int64, device=device)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n) bool/int -> (..., ceil(n/32)) int32 words (uint32 bits)."""
    n = x.shape[-1]
    w = packed_width(n)
    xb = (x != 0).to(torch.int64)
    pad = w * WORD - n
    if pad:
        xb = torch.nn.functional.pad(xb, (0, pad))
    xb = xb.reshape(x.shape[:-1] + (w, WORD))
    return (xb << _shifts(x.device)).sum(dim=-1).to(torch.int32)


def unpack_bits(p: torch.Tensor, n: int) -> torch.Tensor:
    """(..., w) int32 words -> (..., n) bool."""
    words = p.to(torch.int64) & _MASK32
    bits = (words[..., :, None] >> _shifts(p.device)) & 1
    flat = bits.reshape(p.shape[:-1] + (p.shape[-1] * WORD,))
    return flat[..., :n].to(torch.bool)


def popcount(p: torch.Tensor) -> torch.Tensor:
    """Number of set bits per packed row (frontier occupancy) -> int32."""
    x = p.to(torch.int64) & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & _MASK32) >> 24
    return x.sum(dim=-1).to(torch.int32)


def one_hot_frontier(sources: torch.Tensor, n: int,
                     dtype=torch.bool) -> torch.Tensor:
    """(S,) int source ids -> (S, n) boolean frontier matrix."""
    nodes = torch.arange(n, device=sources.device)
    return (nodes[None, :] == sources[:, None]).to(dtype)

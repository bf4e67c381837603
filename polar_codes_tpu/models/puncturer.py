"""Rate-matching puncturer.

Capability parity with PolarCode::Puncturer
(/root/reference/src/polarcode/puncturer.cpp:24-67,
include/polarcode/puncturer.h:34-100): for a target length M the parent
code has N = 2^ceil(log2 M); the first N-M *frozen* positions are dropped
from the codeword, the surviving `output_positions` are kept in order.
puncture = gather, depuncture = zero-fill scatter (neutral LLR 0 for the
punctured positions).

Batched: both directions are single static-index gathers/scatters over
[..., N] batches — index vectors are baked into the traced program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp


def round_up_power_of_two(value: int) -> int:
    return 1 << max(int(value) - 1, 0).bit_length()


class Puncturer:
    """Shortening-style rate matcher for one (M, frozen-set) code."""

    def __init__(self, block_length: int, frozen_bit_positions: Sequence[int]):
        self.block_length = int(block_length)
        self.parent_block_length = round_up_power_of_two(self.block_length)
        frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        n_punct = self.parent_block_length - self.block_length
        if n_punct > frozen.size:
            raise ValueError(
                "Number of required puncturing positions exceeds frozen bit "
                "positions!"
            )
        punctured = frozen[:n_punct]
        keep = np.ones(self.parent_block_length, dtype=bool)
        keep[punctured] = False
        self.output_positions = np.nonzero(keep)[0]
        self.punctured_positions = punctured

    def puncture(self, block):
        """[..., N_parent] -> [..., M]: keep output positions in order."""
        return jnp.asarray(block)[..., jnp.asarray(self.output_positions)]

    def depuncture(self, punctured, fill_value=0):
        """[..., M] -> [..., N_parent]: zero-fill dropped positions.

        For LLR inputs the fill 0 is the 'no information' neutral value the
        decoder expects at punctured positions."""
        x = jnp.asarray(punctured)
        if x.shape[-1] != self.block_length:
            raise ValueError(
                f"expected {self.block_length} values, got {x.shape[-1]}"
            )
        out = jnp.full(
            x.shape[:-1] + (self.parent_block_length,), fill_value, dtype=x.dtype
        )
        return out.at[..., jnp.asarray(self.output_positions)].set(x)

    def puncture_packed(self, packed_bytes: np.ndarray) -> np.ndarray:
        """Packed-byte variant (puncturePacked, puncturer.cpp:70-89):
        [..., N_parent/8] uint8 -> [..., M/8] uint8, MSB-first bits."""
        if self.parent_block_length % 8 or self.block_length % 8:
            raise ValueError("packed puncturing requires byte-aligned lengths")
        packed = np.asarray(packed_bytes, dtype=np.uint8)
        bits = np.unpackbits(packed, axis=-1)
        out = bits[..., self.output_positions]
        return np.packbits(out, axis=-1)

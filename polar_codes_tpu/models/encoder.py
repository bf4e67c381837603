"""Polar encoder: batched systematic / non-systematic butterfly encoding.

Capability parity with the reference's production encoder ButterflyFipPacked
(/root/reference/src/polarcode/encoding/butterfly_fip_packed.cpp:45-69) and
the Encoder base (/root/reference/src/polarcode/encoding/encoder.{h,cpp}):
CRC generation into the info tail, info-bit injection at non-frozen
positions, n butterfly stages, and the Vangala systematic trick
(transform -> reset frozen bits -> transform again).

Batched: operates on [..., K] / [..., N] {0,1} arrays where leading axes
are batch; each transform is the Kronecker-factored pair of GF(2) matrix
products of ops/butterfly.py (polar_transform_mxu) over the whole batch
instead of per-codeword AVX register shifts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax.numpy as jnp

from ..construction import frozen_bit_mask, info_indices
from ..ops.butterfly import butterfly_transform, polar_transform_mxu
from .detectors import Detector, Dummy


class PolarEncoder:
    """Batched polar encoder for one (N, frozen-set) code.

    All code structure (masks, index vectors) is host-side NumPy baked into
    the traced program as constants — the analogue of the reference's
    construction-time specialization.
    """

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
    ):
        n = block_length.bit_length() - 1
        if (1 << n) != block_length:
            raise ValueError(f"block length {block_length} is not a power of 2")
        self.block_length = block_length
        self.stages = n
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.frozen_mask = frozen_bit_mask(block_length, self.frozen)
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()

    # -- info <-> u-domain plumbing ----------------------------------------

    def inject(self, info_bits):
        """Scatter [..., K] info bits into a [..., N] u-vector (frozen = 0).

        Replaces PackedContainer::insertPackedInformationBits
        (bitcontainer.cpp:715-886); here it is one static-index scatter.
        """
        x = jnp.asarray(info_bits)
        if x.shape[-1] != self.info_length:
            raise ValueError(
                f"expected {self.info_length} info bits, got {x.shape[-1]}"
            )
        u = jnp.zeros(x.shape[:-1] + (self.block_length,), dtype=x.dtype)
        return u.at[..., jnp.asarray(self.info_pos)].set(x)

    def extract(self, block_bits):
        """Gather [..., N] -> [..., K] info bits at non-frozen positions."""
        return jnp.asarray(block_bits)[..., jnp.asarray(self.info_pos)]

    # -- encoding -----------------------------------------------------------

    def encode(self, info_bits, generate_crc: bool = True):
        """[..., K] info bits -> [..., N] codeword bits.

        With a non-dummy detector and generate_crc=True, the last
        detector.tail_bits of the info block are overwritten with the
        checksum first (ButterflyFipPacked::encode, :47).
        """
        x = jnp.asarray(info_bits)
        if x.shape[-1] != self.info_length:
            raise ValueError(
                f"expected {self.info_length} info bits, got {x.shape[-1]}"
            )
        if generate_crc and self.detector.tail_bits:
            x = self.detector.generate(x)
        # Two GF(2) matrix products per transform (ops/butterfly.py). On the
        # H100 this beat the n elementwise butterfly stages at N=1024 and
        # at N=131072 (PERF.md), so it is the only encode path.
        inv = jnp.asarray(1.0 - self.frozen_mask, jnp.float32)
        u = self.inject(x.astype(jnp.float32))
        code = polar_transform_mxu(u)
        if self.systematic:
            code = code * inv  # re-freeze: frozen rows back to 0
            code = polar_transform_mxu(code)
        return code.astype(jnp.uint8)

    def transform(self, bits):
        """Raw N-stage butterfly (involution); exposed for decoders that
        re-encode to recover u from a codeword estimate."""
        return butterfly_transform(bits)

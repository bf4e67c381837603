"""Error locator: genie-aided SC analysis of first-error positions.

Capability parity with ErrorLocator
(/root/reference/src/polarcode/decoding/errorlocator.h:93-129,
decodeFindFirstError) and the errorlocator app
(src/errorlocator/simulator.cpp): decode with every past decision forced to
the transmitted truth and record, per u-domain bit channel, whether the SC
decision LLR would have produced an error. The resulting first-error
histogram ranks bit channels by actual (not design-model) reliability and
feeds SCFlip node ranking.

Batched: forcing decisions to truth removes the sequential dependency's
data-dependence — one batched pass computes every decision LLR under the
genie, so the whole analysis is a single fused program over [batch, N].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..construction import frozen_bit_mask
from ..ops.butterfly import butterfly_transform
from ..ops.fg import f_minsum, g_update


class ErrorLocator:
    """Genie-aided SC first-error analyzer for one (N, frozen-set) code."""

    def __init__(self, block_length: int, frozen_bit_positions: Sequence[int]):
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.frozen_mask = frozen_bit_mask(block_length, self.frozen)

    def _genie_llrs(self, llr, x_bipolar):
        """Decision LLR of every u bit with all previous bits forced true.

        llr [..., span] channel LLRs; x_bipolar [..., span] true codeword in
        {+1,-1}. Returns u-domain decision LLRs [..., span]."""
        span = llr.shape[-1]
        if span == 1:
            return llr
        half = span // 2
        a, b = llr[..., :half], llr[..., half:]
        xl, xr = x_bipolar[..., :half], x_bipolar[..., half:]
        left = self._genie_llrs(f_minsum(a, b), xl * xr)
        right = self._genie_llrs(g_update(a, b, xl * xr), xr)
        return jnp.concatenate([left, right], axis=-1)

    def locate(self, llr, true_codeword) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """[..., N] LLRs + true codeword bits {0,1} ->
        (first_error [...], error_mask [..., N]).

        error_mask[i] = genie-aided SC decision at u-channel i would be
        wrong (frozen channels never err). first_error = lowest such i, or
        N if the frame is error-free (decodeFindFirstError semantics)."""
        llr = jnp.asarray(llr, dtype=jnp.float32)
        x = 1.0 - 2.0 * jnp.asarray(true_codeword, jnp.float32)
        u_llr = self._genie_llrs(llr, x)
        u_true = butterfly_transform(
            jnp.asarray(true_codeword, jnp.uint8)
        )  # involution: codeword -> u
        decision = (u_llr < 0).astype(jnp.uint8)
        err = (decision != u_true) & jnp.asarray(~self.frozen_mask)
        n_len = self.block_length
        idx = jnp.arange(n_len)
        first = jnp.min(
            jnp.where(err, idx, n_len), axis=-1
        )
        return first, err

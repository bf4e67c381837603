"""Depth-first bit-flip (SCFlip) decoder.

Capability parity with DepthFirst
(/root/reference/src/polarcode/decoding/depth_first.cpp:599-638): an SC
pass records each information decision's reliability; while the CRC fails
and trials remain, the weakest recorded decision is flipped and the frame
re-decoded (Afisiadis et al. SC-Flip, the reference's Manager explores the
same flip candidates through its configuration queue).

Batched form: the reference flips one node and re-decodes the suffix
of one frame; here every trial re-decodes the whole [batch, N] matrix with
a per-row flip sign injected at the trial's target bit — each row flips
*its own* t-th weakest decision (argsort of the recorded |decision LLR|).
Rows whose CRC already passed keep their first passing result; re-decoding
them costs nothing extra because the batch is decoded as one fused tensor
program either way. The decode tree collapses only Rate-0 subtrees so
every information decision is an addressable span-1 leaf.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fg import f_minsum, g_update
from .tree import CodeNode, NodeKind, build_tree
from .detectors import Detector, Dummy


def _sign(x):
    return jnp.where(jnp.signbit(x), -1.0, 1.0).astype(x.dtype)


class DepthFirstDecoder:
    """CRC-gated SC-Flip decoder with `trial_limit` decoding passes."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        trial_limit: int = 8,
    ):
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.trial_limit = max(int(trial_limit), 1)
        # bit-level decisions: only Rate-0 subtrees collapse
        self.tree: CodeNode = build_tree(
            block_length, self.frozen, allowed=frozenset({NodeKind.RATE0})
        )
        self.dtype = jnp.float32

    # ---- one SC pass with flip injection ----------------------------------

    def _decode_node(self, node, llr, flips, counter: List[int], rels):
        """Returns bipolar decisions [..., span]; appends per-decision |llr|
        to rels. flips [..., K] multiplies each info decision's sign."""
        if node.kind == NodeKind.RATE0:
            return jnp.ones_like(llr)
        if node.length == 1:  # info bit leaf
            k = counter[0]
            counter[0] += 1
            rels.append(jnp.abs(llr[..., 0]))
            return _sign(llr) * flips[..., k : k + 1]
        half = node.length // 2
        a, b = llr[..., :half], llr[..., half:]
        left = self._decode_node(node.left, f_minsum(a, b), flips, counter, rels)
        right = self._decode_node(
            node.right, g_update(a, b, left), flips, counter, rels
        )
        return jnp.concatenate([left * right, right], axis=-1)

    def _pass(self, llr, flips):
        counter, rels = [0], []
        bits = self._decode_node(self.tree, llr, flips, counter, rels)
        assert counter[0] == self.info_length
        return bits, jnp.stack(rels, axis=-1)  # [..., K] decision reliabilities

    def _extract(self, codeword):
        if self.systematic:
            return codeword[..., jnp.asarray(self.info_pos)]
        u = butterfly_transform(codeword)
        return u[..., jnp.asarray(self.info_pos)]

    # ---- public API --------------------------------------------------------

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[..., N] channel LLRs -> (info [..., K], codeword [..., N], ok)."""
        llr = jnp.asarray(llr, dtype=jnp.float32)
        lead = llr.shape[:-1]
        ones = jnp.ones(lead + (self.info_length,), dtype=jnp.float32)
        bits, rels = self._pass(llr, ones)
        codeword = jnp.signbit(bits).astype(jnp.uint8)
        if self.detector.tail_bits:
            ok = self.detector.check(self._extract(codeword))
        else:
            ok = jnp.ones(lead, dtype=bool)
        done = ok
        best = codeword
        if self.detector.tail_bits and self.trial_limit > 1:
            # per-row flip order: weakest decision first (Manager's node
            # reliability ranking, depth_first.h:29-37)
            order = jnp.argsort(rels, axis=-1)
            for t in range(self.trial_limit - 1):
                target = order[..., t]  # [...]: t-th weakest info decision
                flips = 1.0 - 2.0 * jax.nn.one_hot(
                    target, self.info_length, dtype=jnp.float32
                )
                bits_t, _ = self._pass(llr, flips)
                cw_t = jnp.signbit(bits_t).astype(jnp.uint8)
                ok_t = self.detector.check(self._extract(cw_t))
                take = ok_t & ~done
                best = jnp.where(take[..., None], cw_t, best)
                done = done | ok_t
        info = self._extract(best)
        return info, best, done

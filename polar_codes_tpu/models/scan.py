"""SCAN soft-output decoders: fixed-sweep SCAN and CRC-gated Fast-SSCAN.

Capability parity with Scan (/root/reference/src/polarcode/decoding/scan.cpp,
Fayyaz/Barry soft-cancellation) and FastSscanFloat (fastsscan_float.cpp:
tree-specialized SCAN with Rate-0/Rate-1 collapsed subtrees and a trial
limit that re-sweeps until the CRC passes).

Algorithmic form (written from the SCAN message-passing equations, not the
reference's flat evenIndex/oddIndex arrays): each tree node receives
channel-side LLRs alpha and returns u-side extrinsic LLRs beta, with the
right child's beta from the *previous* sweep feeding the left child's
alpha (the SCAN memory; the reference's mOdd/mEven arrays become a dict of
per-node beta tensors threaded functionally through the trace):

    alpha_l = f(alpha_a, alpha_b + beta_r_prev)
    beta_l  = scan(left, alpha_l)
    alpha_r = alpha_b + f(alpha_a, beta_l)
    beta_r  = scan(right, alpha_r)
    beta    = [f(beta_l, alpha_b + beta_r), beta_r + f(beta_l, alpha_a)]

Leaves: frozen subtrees return +inf (bits known), rate-1 subtrees return 0
(no extrinsic). Everything is batched over [..., span]; sweeps unroll at
trace time (iteration limit is static and small).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from ..ops.fg import f_minsum
from .tree import CodeNode, NodeKind, build_tree
from .detectors import Detector, Dummy


class ScanDecoder:
    """Iterative SCAN decoder with soft (extrinsic) output."""

    #: leaf kinds the SCAN tree may collapse (fastsscan_float.cpp leaf set
    #: minus the hard-decision-specific ones; REP/SPC recurse structurally)
    _ALLOWED = frozenset({NodeKind.RATE0, NodeKind.RATE1})

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        iterations: int = 1,
    ):
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.iterations = max(int(iterations), 1)
        self.tree: CodeNode = build_tree(
            block_length, self.frozen, allowed=self._ALLOWED
        )
        self.dtype = jnp.float32

    # ---- one sweep ---------------------------------------------------------

    def _sweep_node(
        self,
        node: CodeNode,
        alpha,
        memory: Dict[int, jnp.ndarray],
        new_memory: Dict[int, jnp.ndarray],
    ):
        if node.kind == NodeKind.RATE0:
            return jnp.full_like(alpha, jnp.inf)
        if node.kind == NodeKind.RATE1:
            return jnp.zeros_like(alpha)
        half = node.length // 2
        a, b = alpha[..., :half], alpha[..., half:]
        beta_r_prev = memory.get(id(node))
        if beta_r_prev is None:
            beta_r_prev = jnp.zeros_like(b)
        alpha_l = f_minsum(a, b + beta_r_prev)
        beta_l = self._sweep_node(node.left, alpha_l, memory, new_memory)
        alpha_r = b + f_minsum(a, beta_l)
        beta_r = self._sweep_node(node.right, alpha_r, memory, new_memory)
        new_memory[id(node)] = beta_r
        beta = jnp.concatenate(
            [f_minsum(beta_l, b + beta_r), beta_r + f_minsum(beta_l, a)],
            axis=-1,
        )
        return beta

    # ---- public API --------------------------------------------------------

    def decode_soft(self, llr, iterations: Optional[int] = None):
        """[..., N] channel LLRs -> (total codeword LLRs [..., N],
        extrinsic beta [..., N]) after the configured sweeps.

        beta is the reference's getExtrinsicChannelInformation output
        (scan.h, for iterative demapping/turbo equalization)."""
        llr = jnp.asarray(llr, dtype=jnp.float32)
        sweeps = self.iterations if iterations is None else iterations
        memory: Dict[int, jnp.ndarray] = {}
        beta = jnp.zeros_like(llr)
        for _ in range(sweeps):
            new_memory: Dict[int, jnp.ndarray] = {}
            beta = self._sweep_node(self.tree, llr, memory, new_memory)
            memory = new_memory
        total = llr + beta
        return total, beta

    def decode_to_codeword(self, llr):
        total, _ = self.decode_soft(llr)
        return (total < 0).astype(jnp.uint8)

    def _extract(self, codeword):
        if self.systematic:
            return codeword[..., jnp.asarray(self.info_pos)]
        u = butterfly_transform(codeword)
        return u[..., jnp.asarray(self.info_pos)]

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[..., N] channel LLRs -> (info [..., K], codeword [..., N], ok)."""
        codeword = self.decode_to_codeword(llr)
        info = self._extract(codeword)
        ok = (
            self.detector.check(info)
            if self.detector.tail_bits
            else jnp.ones(info.shape[:-1], dtype=bool)
        )
        return info, codeword, ok


class FastSScanDecoder(ScanDecoder):
    """Tree-specialized SCAN with CRC-gated trials (FastSscanFloat parity:
    fastsscan_float.cpp decode :309 / decodeAgain :320).

    Runs up to `iterations` sweeps; per batch row, the first sweep whose CRC
    checks freezes that row's output (batched analogue of the reference's
    per-block early exit)."""

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        llr = jnp.asarray(llr, dtype=jnp.float32)
        memory: Dict[int, jnp.ndarray] = {}
        lead = llr.shape[:-1]
        done = jnp.zeros(lead, dtype=bool)
        best_code = jnp.zeros(llr.shape, dtype=jnp.uint8)
        for sweep in range(self.iterations):
            new_memory: Dict[int, jnp.ndarray] = {}
            beta = self._sweep_node(self.tree, llr, memory, new_memory)
            memory = new_memory
            codeword = ((llr + beta) < 0).astype(jnp.uint8)
            if self.detector.tail_bits:
                ok = self.detector.check(self._extract(codeword))
            else:
                ok = jnp.ones(lead, dtype=bool)
            take = ok & ~done
            best_code = jnp.where(take[..., None], codeword, best_code)
            done = done | ok
            if sweep == self.iterations - 1:
                # rows that never passed keep the last sweep's estimate
                best_code = jnp.where(done[..., None], best_code, codeword)
        info = self._extract(best_code)
        return info, best_code, done

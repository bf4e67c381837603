"""Fast-SSC decoder (L=1), batched over codewords.

Capability parity with FastSscAvxFloat / FastSscFipChar
(/root/reference/src/polarcode/decoding/fastssc_avx_float.cpp,
fastssc_fip_char.cpp): min-sum f/g recursion over the trace-time-specialized
tree with Rate-0 / Rate-1 / Repetition / SPC leaf shortcuts, systematic or
non-systematic output, attached error detector.

Batched inversion: the reference walks the tree at runtime per codeword,
vectorizing *within* the codeword on AVX lanes; here the tree walk happens
once at trace time and every emitted op is batched over [batch, span].
Hard decisions travel as bipolar {+1,-1}
floats so combine is a multiply.

Two precision families, mirroring the reference's float/char split:
  dtype=float32 — exact reference semantics.
  dtype=int8    — LLRs quantized to int8; arithmetic in int16 with
                  saturation to [-127,127] (fi_adds_epi8 semantics).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..construction import info_indices
from ..ops.butterfly import butterfly_transform
from .tree import CodeNode, NodeKind, build_tree
from .detectors import Detector, Dummy
from .encoder import PolarEncoder


def _sign(x):
    """Bipolar sign with copysign semantics: -0.0 -> -1 (bit 1), +0.0 -> +1.

    Matches the reference's float-sign convention where the bit lives in the
    IEEE sign bit (avx_float.h:22-34)."""
    return jnp.where(jnp.signbit(x), -1.0, 1.0).astype(jnp.float32)


class FastSSCDecoder:
    """Successive-cancellation decoder with Fast-SSC leaf shortcuts."""

    def __init__(
        self,
        block_length: int,
        frozen_bit_positions: Sequence[int],
        systematic: bool = True,
        detector: Optional[Detector] = None,
        dtype=jnp.float32,
    ):
        self.block_length = block_length
        self.frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
        self.info_pos = info_indices(block_length, self.frozen)
        self.info_length = int(self.info_pos.size)
        self.systematic = systematic
        self.detector = detector if detector is not None else Dummy()
        self.dtype = jnp.dtype(dtype)
        self.tree: CodeNode = build_tree(block_length, self.frozen)
        self._encoder = PolarEncoder(
            block_length, self.frozen, systematic=False, detector=Dummy()
        )

    # ---- per-dtype arithmetic ------------------------------------------------

    def _f(self, a, b):
        if self.dtype == jnp.int8:
            sa, sb = jnp.sign(a.astype(jnp.int16)), jnp.sign(b.astype(jnp.int16))
            m = jnp.minimum(jnp.abs(a.astype(jnp.int16)), jnp.abs(b.astype(jnp.int16)))
            return (sa * sb * m).astype(jnp.int8)
        return _sign(a) * _sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))

    def _g(self, a, b, left_bipolar):
        if self.dtype == jnp.int8:
            s = b.astype(jnp.int16) + left_bipolar.astype(jnp.int16) * a.astype(
                jnp.int16
            )
            return jnp.clip(s, -127, 127).astype(jnp.int8)  # saturating adds_epi8
        return b + left_bipolar * a

    def _hard(self, llr):
        if self.dtype == jnp.int8:
            # int8 has no -0; llr >= 0 means bit 0 (fip_char convention)
            return jnp.where(llr < 0, -1, 1).astype(jnp.int8)
        return _sign(llr)

    def _bits01(self, bipolar):
        if self.dtype == jnp.int8:
            return (bipolar < 0).astype(jnp.uint8)
        return jnp.signbit(bipolar).astype(jnp.uint8)

    # ---- leaf decoders ------------------------------------------------

    def _decode_rate0(self, llr):
        one = jnp.ones((), dtype=llr.dtype) if self.dtype == jnp.int8 else 1.0
        return jnp.full_like(llr, one)

    def _decode_rate1(self, llr):
        return self._hard(llr)

    def _decode_rep(self, llr):
        if self.dtype == jnp.int8:
            s = jnp.sum(llr.astype(jnp.int32), axis=-1, keepdims=True)
            return jnp.broadcast_to(
                jnp.where(s < 0, -1, 1).astype(jnp.int8), llr.shape
            )
        s = jnp.sum(llr, axis=-1, keepdims=True)
        return jnp.broadcast_to(_sign(s), llr.shape)

    def _decode_spc(self, llr):
        hard = self._hard(llr)
        if self.dtype == jnp.int8:
            work = llr.astype(jnp.int32)
            parity_neg = jnp.sum((work < 0).astype(jnp.int32), axis=-1) % 2 == 1
            weakest = jnp.argmin(jnp.abs(work), axis=-1)
        else:
            parity_neg = jnp.prod(hard, axis=-1) < 0
            weakest = jnp.argmin(jnp.abs(llr), axis=-1)
        span = llr.shape[-1]
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, llr.shape, llr.ndim - 1)
            == weakest[..., None]
        )
        flip = jnp.where(onehot & parity_neg[..., None], -1, 1).astype(hard.dtype)
        return hard * flip

    # ---- tree recursion (trace-time) ----------------------------------------

    def _decode_node(self, node: CodeNode, llr):
        if node.kind == NodeKind.RATE0:
            return self._decode_rate0(llr)
        if node.kind == NodeKind.RATE1:
            return self._decode_rate1(llr)
        if node.kind == NodeKind.REP:
            return self._decode_rep(llr)
        if node.kind == NodeKind.SPC:
            return self._decode_spc(llr)
        half = node.length // 2
        a, b = llr[..., :half], llr[..., half:]
        # Rate-0 left shortcut (ZeroR semantics, fastssc_avx_float.cpp): f/g
        # collapse — left bits are all +1, so g degenerates to b + a.
        if node.left.kind == NodeKind.RATE0:
            left_bits = self._decode_rate0(a)
            right_bits = self._decode_node(node.right, self._g(a, b, left_bits))
            return jnp.concatenate([right_bits, right_bits], axis=-1)
        left_bits = self._decode_node(node.left, self._f(a, b))
        right_bits = self._decode_node(node.right, self._g(a, b, left_bits))
        # Rate-1 right shortcut (ROne): right bits are pure hard decisions
        combined = left_bits * right_bits
        return jnp.concatenate([combined, right_bits], axis=-1)

    # ---- public API ------------------------------------------------

    def decode_to_codeword(self, llr):
        """[..., N] channel LLRs -> [..., N] codeword bits {0,1}."""
        llr = jnp.asarray(llr, dtype=self.dtype)
        bipolar = self._decode_node(self.tree, llr)
        return self._bits01(bipolar)

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """[..., N] channel LLRs -> (info bits [..., K], codeword [..., N],
        detector-ok [...]).

        Non-systematic output recovers u by re-encoding the codeword estimate
        (the transform is an involution), mirroring the reference's internal
        re-encode (fastssc_avx_float.cpp:940-956)."""
        codeword = self.decode_to_codeword(llr)
        if self.systematic:
            info = codeword[..., jnp.asarray(self.info_pos)]
        else:
            u = butterfly_transform(codeword)
            info = u[..., jnp.asarray(self.info_pos)]
        ok = (
            self.detector.check(info)
            if self.detector.tail_bits
            else jnp.ones(info.shape[:-1], dtype=bool)
        )
        return info, codeword, ok

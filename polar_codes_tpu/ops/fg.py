"""SC decoding kernels: min-sum f, g, and combine.

Batched redesign of the reference's AVX float kernels
(/root/reference/include/polarcode/decoding/avx_float.h:55-302). All
functions are batched elementwise ops over the *last* axis (subcode span);
leading axes are batch (and list) dimensions.

Conventions:
- LLR > 0 <=> bit 0 (sign bit stores the bit, as in FloatContainer).
- Hard decisions travel in "bipolar" form {+1.,-1.} so that XOR == multiply
  and g's sign application is a multiply (no int<->float conversions).
"""

from __future__ import annotations

import jax.numpy as jnp


def f_minsum(a, b):
    """f(a,b) = sign(a)sign(b) * min(|a|,|b|)  (avx_float.h:55-68)."""
    sign = jnp.sign(a) * jnp.sign(b)
    return sign * jnp.minimum(jnp.abs(a), jnp.abs(b))


def g_update(a, b, left_bipolar):
    """g(a,b,u) = b + (1-2u)*a, with left bits in bipolar form (avx_float.h:71-98)."""
    return b + left_bipolar * a


def combine_bipolar(left, right):
    """Combine: left' = left XOR right in bipolar form = left*right (avx_float.h:190)."""
    return left * right


def f_minsum_i8(a, b):
    """int8 min-sum f with int16 intermediate (fip_char.h F semantics)."""
    a16, b16 = a.astype(jnp.int16), b.astype(jnp.int16)
    sign = jnp.sign(a16) * jnp.sign(b16)
    return (sign * jnp.minimum(jnp.abs(a16), jnp.abs(b16))).astype(jnp.int8)


def g_update_i8(a, b, left_bipolar):
    """int8 g with saturation to [-127,127] (fi_adds_epi8 semantics)."""
    s = b.astype(jnp.int16) + left_bipolar.astype(jnp.int16) * a.astype(
        jnp.int16
    )
    return jnp.clip(s, -127, 127).astype(jnp.int8)


def f_minsum_sat(a, b):
    """Saturating-integer min-sum f on bfloat16-stored integer LLRs.

    Bit-identical values to f_minsum_i8 (fip_char.h F semantics): every LLR
    is an integer in [-127, 127], which bfloat16 represents exactly; the
    arithmetic runs in float32 instead of int8/int16 vector ops, with half
    the f32 memory traffic at fusion boundaries."""
    a32, b32 = a.astype(jnp.float32), b.astype(jnp.float32)
    sign = jnp.sign(a32) * jnp.sign(b32)
    return (sign * jnp.minimum(jnp.abs(a32), jnp.abs(b32))).astype(a.dtype)


def g_update_sat(a, b, left_bipolar):
    """Saturating g on bfloat16-stored integer LLRs: clip to [-127, 127]
    (fi_adds_epi8 semantics, value-identical to g_update_i8)."""
    s = b.astype(jnp.float32) + left_bipolar.astype(jnp.float32) * a.astype(
        jnp.float32
    )
    return jnp.clip(s, -127.0, 127.0).astype(a.dtype)


def split_llr(llr):
    """Split [..., 2m] node LLRs into (upper a, lower b) halves [..., m]."""
    m = llr.shape[-1] // 2
    return llr[..., :m], llr[..., m:]


def merge_bits(left, right):
    """Concatenate child bipolar decisions back to the parent span."""
    return jnp.concatenate([combine_bipolar(left, right), right], axis=-1)

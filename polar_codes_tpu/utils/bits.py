"""Bit plumbing: packing, bipolar (sign) representation, GF(2) helpers.

Replaces the reference's BitContainer format conversions
(/root/reference/include/polarcode/bitcontainer.h) with three array
conventions used throughout this framework:

- "bits":    {0,1} integer arrays, last axis = bit position, MSB-first when
             packed (numpy packbits 'big' order, matching the reference's
             PackedContainer byte layout consumed by pypolar).
- "bipolar": float arrays in {+1,-1}; bit b <-> 1-2b. XOR becomes multiply,
             an elementwise float op; decoders carry hard decisions in
             this form (the float-sign trick of FloatContainer, batched).
- "llr":     float (or int8) log-likelihood ratios, positive <-> bit 0.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def packbits(bits, axis: int = -1):
    """Pack {0,1} bits to uint8 bytes, MSB-first (np.packbits semantics).

    Works on jnp or np arrays; length along `axis` must be a multiple of 8.
    """
    x = jnp.asarray(bits)
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n % 8:
        raise ValueError(f"bit count {n} not a multiple of 8")
    x = x.reshape(x.shape[:-1] + (n // 8, 8)).astype(jnp.uint8)
    weights = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.uint8)
    out = jnp.sum(x * weights, axis=-1, dtype=jnp.uint32).astype(jnp.uint8)
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def unpackbits(data, axis: int = -1):
    """Unpack uint8 bytes to {0,1} uint8 bits, MSB-first."""
    x = jnp.asarray(data, dtype=jnp.uint8)
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    shifts = jnp.array([7, 6, 5, 4, 3, 2, 1, 0], dtype=jnp.uint8)
    out = (x[..., None] >> shifts) & 1
    out = out.reshape(x.shape[:-1] + (x.shape[-1] * 8,))
    if axis != -1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def bipolar_from_bits(bits):
    """{0,1} -> {+1,-1} float32."""
    return 1.0 - 2.0 * jnp.asarray(bits, dtype=jnp.float32)


def bits_from_bipolar(bipolar):
    """{+1,-1} (or any signed float; sign decides) -> {0,1} uint8.

    Negative sign (including -0.0) means bit 1, matching the reference's
    float-sign convention (bitcontainer.h FloatContainer).
    """
    return jnp.signbit(jnp.asarray(bipolar)).astype(jnp.uint8)


def hard_decisions(llr):
    """LLR -> hard bits: llr < 0 (signbit) => 1."""
    return jnp.signbit(jnp.asarray(llr)).astype(jnp.uint8)


def polar_generator_matrix(n: int) -> np.ndarray:
    """F^{(x)n} with F = [[1,0],[1,1]], no bit reversal (host-side, GF(2)).

    Same convention as the reference's test fixture
    (python/polar_code_tools.py get_polar_generator_matrix): codeword
    x = u @ G mod 2 for natural-order u.
    """
    f = np.array([[1, 0], [1, 1]], dtype=np.uint8)
    g = np.array([[1]], dtype=np.uint8)
    for _ in range(n):
        g = np.kron(g, f)
    return g

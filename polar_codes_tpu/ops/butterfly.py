"""Polar butterfly transform (x = u F^{(x)n}, natural order, no bit reversal).

Batched redesign of the reference's AVX2 butterfly encoder
(/root/reference/src/polarcode/encoding/butterfly_fip.cpp:15-73): instead of
shifting bits inside 256-bit registers for one codeword, we operate on a
[batch, N] array; each stage is a
reshape + XOR (or multiply, in bipolar form) that XLA fuses into a handful of
vectorized ops. The transform is an involution and its stages commute, so
stage order is free.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def butterfly_transform(bits):
    """In-order polar transform on {0,1} bits, last axis length N = 2^n.

    Stage s: x[i] ^= x[i + 2^s] for every i whose s-th bit is 0 —
    the same pairing as ButterflyFipTransform (butterfly_fip.cpp:15-29).
    """
    x = jnp.asarray(bits)
    n_len = x.shape[-1]
    n = n_len.bit_length() - 1
    if (1 << n) != n_len:
        raise ValueError(f"block length {n_len} is not a power of 2")
    lead = x.shape[:-1]
    for s in range(n):
        half = 1 << s
        x = x.reshape(lead + (n_len // (2 * half), 2, half))
        upper = x[..., 0, :] ^ x[..., 1, :]
        x = jnp.stack([upper, x[..., 1, :]], axis=-2)
        x = x.reshape(lead + (n_len,))
    return x


@functools.lru_cache(maxsize=None)
def _transform_matrix(n_len: int) -> np.ndarray:
    """Host-side M with butterfly_transform(u) == (u @ M) % 2 ({0,1} u8).

    Row r is the transform of the r-th unit vector; linearity over GF(2)
    makes M the exact matrix of the stage recursion above."""
    m = np.eye(n_len, dtype=np.uint8)
    h = 1
    while h < n_len:
        m = m.reshape(n_len, n_len // (2 * h), 2, h)
        m[:, :, 0, :] ^= m[:, :, 1, :]
        m = m.reshape(n_len, n_len)
        h *= 2
    return m


def _mod2(y):
    """f32 integer-valued -> {0,1} f32 (y - 2*floor(y/2))."""
    return y - 2.0 * jnp.floor(y * 0.5)


def default_inner(n_len: int) -> int:
    """Kronecker factor split: inner length near sqrt(N), at least 128."""
    root = 1 << ((n_len.bit_length() - 1 + 1) // 2)
    return max(128, min(root, n_len))


def polar_transform_mxu(x01, n_inner: int | None = None):
    """In-order polar transform on {0,1} values via two matrix products.

    The transform matrix factors exactly: with N = No*Ni and codeword
    index i = o*Ni + j, M_N == kron(M_No, M_Ni) (butterfly stages s <
    log2(Ni) touch only j, the rest only o). So the N-stage butterfly —
    log2(N) memory round-trips as elementwise passes — becomes TWO dense
    GF(2) matmuls on [.., No, Ni]: contract j with M_Ni, then o with
    M_No, folding mod 2 between. Operands are {0,1} float32 at default
    precision: exact even where a GPU rounds them to TF32, with f32
    accumulation of sums <= max(Ni, No) << 2^24, so the result is
    bit-exact vs butterfly_transform on every backend (capability target
    butterfly_fip_packed.cpp:45-69 at the benchmark's N<=131072 range).

    x01: [..., N] {0,1} (any real dtype). Returns [..., N] f32 {0,1}.
    """
    x = jnp.asarray(x01)
    n_len = x.shape[-1]
    n = n_len.bit_length() - 1
    if (1 << n) != n_len:
        raise ValueError(f"block length {n_len} is not a power of 2")
    if n_inner is None:
        n_inner = default_inner(n_len)
    mdt = jnp.float32
    if n_inner >= n_len:
        # degenerate small N: one matmul
        m = jnp.asarray(_transform_matrix(n_len), mdt)
        y = jax.lax.dot_general(
            x.astype(mdt), m,
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return _mod2(y)
    n_outer = n_len // n_inner
    mi = jnp.asarray(_transform_matrix(n_inner), mdt)
    mo = jnp.asarray(_transform_matrix(n_outer), mdt)
    lead = x.shape[:-1]
    y = x.reshape(lead + (n_outer, n_inner)).astype(mdt)
    y = jax.lax.dot_general(  # [..., o, j] @ Mi[j, j'] — contract inner
        y, mi, (((y.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    y = _mod2(y).astype(mdt)
    y = jnp.einsum(  # contract outer: [..., o, j'], Mo[o, p] -> [..., p, j']
        "...oj,op->...pj", y, mo, preferred_element_type=jnp.float32
    )
    return _mod2(y).reshape(lead + (n_len,))


def butterfly_transform_bipolar(signs):
    """Same transform on {+1,-1} floats: XOR becomes multiply."""
    x = jnp.asarray(signs)
    n_len = x.shape[-1]
    n = n_len.bit_length() - 1
    if (1 << n) != n_len:
        raise ValueError(f"block length {n_len} is not a power of 2")
    lead = x.shape[:-1]
    for s in range(n):
        half = 1 << s
        x = x.reshape(lead + (n_len // (2 * half), 2, half))
        upper = x[..., 0, :] * x[..., 1, :]
        x = jnp.stack([upper, x[..., 1, :]], axis=-2)
        x = x.reshape(lead + (n_len,))
    return x

"""Exhaustive sweeps of the f/g/combine kernels.

Mirrors the reference's exhaustive 256x256 sign sweeps of the int8
kernels (/root/reference/test/polarcode/decodingtest.cpp:850-910): every
(a, b) int8 pair is checked against a scalar integer reference, for the
int8 kernels and for the bf16-stored saturating variants the char paths
use (fip_char value parity is claimed exact, so test it
exhaustively, not statistically).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from polar_codes_tpu.ops.fg import (
    combine_bipolar,
    f_minsum,
    f_minsum_i8,
    f_minsum_sat,
    g_update_i8,
    g_update_sat,
)


def _all_pairs(lo, hi):
    vals = np.arange(lo, hi + 1, dtype=np.int32)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    return a.ravel(), b.ravel()


class TestExhaustiveInt8:
    def test_f_minsum_i8_all_pairs(self):
        a, b = _all_pairs(-128, 127)
        ref = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
        got = f_minsum_i8(jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8))
        np.testing.assert_array_equal(
            np.asarray(got, np.int32), ref.astype(np.int8).astype(np.int32)
        )

    @pytest.mark.parametrize("u", [1, -1])
    def test_g_update_i8_all_pairs(self, u):
        a, b = _all_pairs(-128, 127)
        ref = np.clip(b + u * a, -127, 127)
        got = g_update_i8(
            jnp.asarray(a, jnp.int8),
            jnp.asarray(b, jnp.int8),
            jnp.full(a.shape, u, jnp.int8),
        )
        np.testing.assert_array_equal(np.asarray(got, np.int32), ref)

    def test_f_sat_bf16_matches_i8_all_pairs(self):
        # the saturating char path stores fip_char values in bf16; parity with
        # the int8 kernels must be exact over the full live range
        a, b = _all_pairs(-127, 127)
        ref = f_minsum_i8(jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8))
        got = f_minsum_sat(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        )
        np.testing.assert_array_equal(
            np.asarray(got, np.int32), np.asarray(ref, np.int32)
        )

    @pytest.mark.parametrize("u", [1.0, -1.0])
    def test_g_sat_bf16_matches_i8_all_pairs(self, u):
        a, b = _all_pairs(-127, 127)
        ref = g_update_i8(
            jnp.asarray(a, jnp.int8),
            jnp.asarray(b, jnp.int8),
            jnp.full(a.shape, int(u), jnp.int8),
        )
        got = g_update_sat(
            jnp.asarray(a, jnp.bfloat16),
            jnp.asarray(b, jnp.bfloat16),
            jnp.full(a.shape, u, jnp.bfloat16),
        )
        np.testing.assert_array_equal(
            np.asarray(got, np.int32), np.asarray(ref, np.int32)
        )


class TestCombineAndFloat:
    def test_combine_bipolar_is_xor(self):
        # all four sign combinations: bipolar multiply == GF(2) XOR
        left = jnp.asarray([1.0, 1.0, -1.0, -1.0])
        right = jnp.asarray([1.0, -1.0, 1.0, -1.0])
        got = combine_bipolar(left, right)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray([1.0, -1.0, -1.0, 1.0])
        )

    def test_f_minsum_float_signs_exhaustive_small_grid(self):
        # float f over a dense small-integer grid incl. +-0 inputs
        vals = np.concatenate(
            [np.arange(-8.0, 9.0), np.asarray([-0.0])]
        ).astype(np.float32)
        a, b = np.meshgrid(vals, vals, indexing="ij")
        got = np.asarray(f_minsum(jnp.asarray(a.ravel()), jnp.asarray(b.ravel())))
        ref = (
            np.sign(a.ravel()) * np.sign(b.ravel())
            * np.minimum(np.abs(a.ravel()), np.abs(b.ravel()))
        ).astype(np.float32)
        np.testing.assert_array_equal(got, ref)

"""Encoder tests vs GF(2) generator-matrix references, mirroring
qa_pypolar_encoder.py (Vangala EncoderA systematic reference)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from polar_codes_tpu.construction import frozen_bits, info_indices
from polar_codes_tpu.models.encoder import PolarEncoder
from polar_codes_tpu.models.detectors import CRC8
from polar_codes_tpu.ops.butterfly import (
    butterfly_transform,
    butterfly_transform_bipolar,
)
from polar_codes_tpu.utils.bits import (
    polar_generator_matrix,
    packbits,
    unpackbits,
    bipolar_from_bits,
    bits_from_bipolar,
)


def encode_matrix(u, g):
    return (u @ g) % 2


class TestButterflyTransform:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 10])
    def test_matches_generator_matrix(self, n, rng):
        n_len = 1 << n
        g = polar_generator_matrix(n)
        u = rng.integers(0, 2, (16, n_len)).astype(np.uint8)
        got = np.asarray(butterfly_transform(jnp.asarray(u)))
        want = encode_matrix(u, g)
        np.testing.assert_array_equal(got, want)

    def test_involution(self, rng):
        u = rng.integers(0, 2, (4, 64)).astype(np.uint8)
        twice = butterfly_transform(butterfly_transform(jnp.asarray(u)))
        np.testing.assert_array_equal(np.asarray(twice), u)

    def test_bipolar_matches_binary(self, rng):
        u = rng.integers(0, 2, (8, 128)).astype(np.uint8)
        binary = np.asarray(butterfly_transform(jnp.asarray(u)))
        bipolar = butterfly_transform_bipolar(bipolar_from_bits(jnp.asarray(u)))
        np.testing.assert_array_equal(np.asarray(bits_from_bipolar(bipolar)), binary)


class TestPolarEncoder:
    @pytest.mark.parametrize("n_len,k_len", [(8, 5), (32, 20), (128, 64), (256, 100)])
    def test_nonsystematic_matches_matrix(self, n_len, k_len, rng):
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        enc = PolarEncoder(n_len, frozen, systematic=False)
        g = polar_generator_matrix(int(np.log2(n_len)))
        info = rng.integers(0, 2, (10, k_len)).astype(np.uint8)
        got = np.asarray(enc.encode(jnp.asarray(info)))
        u = np.zeros((10, n_len), dtype=np.uint8)
        u[:, info_indices(n_len, frozen)] = info
        np.testing.assert_array_equal(got, encode_matrix(u, g))

    @pytest.mark.parametrize("n_len,k_len", [(8, 5), (64, 40), (256, 128)])
    def test_systematic_info_visible_in_codeword(self, n_len, k_len, rng):
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        enc = PolarEncoder(n_len, frozen, systematic=True)
        info = rng.integers(0, 2, (10, k_len)).astype(np.uint8)
        code = np.asarray(enc.encode(jnp.asarray(info)))
        np.testing.assert_array_equal(code[:, enc.info_pos], info)

    def test_systematic_matches_double_transform_reference(self, rng):
        """Vangala 'encode_systematic_matrix': x = ((uG with frozen reset)G)."""
        n_len, k_len = 64, 32
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        enc = PolarEncoder(n_len, frozen, systematic=True)
        g = polar_generator_matrix(6)
        info = rng.integers(0, 2, (20, k_len)).astype(np.uint8)
        u = np.zeros((20, n_len), dtype=np.uint8)
        info_pos = info_indices(n_len, frozen)
        u[:, info_pos] = info
        x = encode_matrix(u, g)
        x[:, frozen] = 0
        want = encode_matrix(x, g)
        got = np.asarray(enc.encode(jnp.asarray(info)))
        np.testing.assert_array_equal(got, want)

    def test_systematic_codeword_is_valid_codeword(self, rng):
        """Systematic output must lie in the code: re-encoding its u must
        reproduce it (involution check)."""
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        info = rng.integers(0, 2, (5, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        u = butterfly_transform(code)  # involution: u-domain word
        # frozen u positions must be zero
        assert np.all(np.asarray(u)[:, frozen] == 0)

    def test_crc_generation_in_tail(self, rng):
        n_len, k_len = 64, 40
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC8()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        info = rng.integers(0, 2, (6, k_len)).astype(np.uint8)
        code = np.asarray(enc.encode(jnp.asarray(info)))
        recovered = code[:, enc.info_pos]
        for row in recovered:
            assert det.check_np(row)

    def test_bad_info_length_raises(self):
        enc = PolarEncoder(64, frozen_bits(64, 32, 0.0))
        with pytest.raises(ValueError):
            enc.encode(jnp.zeros((2, 31), dtype=jnp.uint8))


def _stage_encode(enc, x):
    """Independent encode: uint8 XOR butterfly stages, both systematic
    passes, from info bits that already carry their checksum."""
    u = np.asarray(enc.inject(jnp.asarray(x, jnp.uint8)))
    code = np.asarray(butterfly_transform(jnp.asarray(u)))
    if enc.systematic:
        code = np.where(enc.frozen_mask, 0, code).astype(np.uint8)
        code = np.asarray(butterfly_transform(jnp.asarray(code)))
    return code


class TestKroneckerEncode:
    """encode() (two GF(2) matrix products per transform) equals the
    elementwise XOR butterfly stages bit for bit, systematic and not,
    including an odd batch and a leading batch axis."""

    @pytest.mark.parametrize("n_len,k_len,systematic",
                             [(256, 128, True), (256, 128, False),
                              (64, 40, True)])
    def test_matches_stage_butterfly(self, n_len, k_len, systematic, rng):
        from polar_codes_tpu.models.detectors import CRC16

        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=systematic,
                           detector=CRC16())
        info = jnp.asarray(rng.integers(0, 2, (37, k_len)).astype(np.uint8))
        got = np.asarray(jax.jit(enc.encode)(info))
        want = _stage_encode(enc, enc.detector.generate(info))
        np.testing.assert_array_equal(got, want)
        lead = np.asarray(enc.encode(info[:36].reshape(4, 9, k_len)))
        np.testing.assert_array_equal(lead.reshape(36, n_len), want[:36])


class TestMxuEncode:
    """Kronecker-factored matmul transform (ops/butterfly.py
    polar_transform_mxu): bit-exact vs the stage butterfly, also through
    the encoder at large N."""

    @pytest.mark.parametrize("n_len", [128, 1024, 4096])
    def test_transform_matches_butterfly(self, n_len, rng):
        from polar_codes_tpu.ops.butterfly import polar_transform_mxu

        u = rng.integers(0, 2, (8, n_len)).astype(np.uint8)
        got = np.asarray(
            polar_transform_mxu(jnp.asarray(u))
        ).astype(np.uint8)
        want = np.asarray(butterfly_transform(jnp.asarray(u)))
        np.testing.assert_array_equal(got, want)

    def test_transform_explicit_split(self, rng):
        from polar_codes_tpu.ops.butterfly import polar_transform_mxu

        u = rng.integers(0, 2, (4, 512)).astype(np.uint8)
        want = np.asarray(butterfly_transform(jnp.asarray(u)))
        for inner in (64, 128, 512):
            got = np.asarray(
                polar_transform_mxu(jnp.asarray(u), inner)
            ).astype(np.uint8)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n_len,k_len,systematic",
                             [(4096, 2048, True), (4096, 2048, False),
                              (8192, 4096, True)])
    def test_encoder_large_n_fastpath(self, n_len, k_len, systematic, rng):
        from polar_codes_tpu.models.detectors import CRC16

        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=systematic,
                           detector=CRC16())
        info = rng.integers(0, 2, (5, k_len)).astype(np.uint8)
        x = enc.detector.generate(jnp.asarray(info))
        np.testing.assert_array_equal(
            np.asarray(enc.encode(x, generate_crc=False)),
            _stage_encode(enc, x),
        )


class TestPackBits:
    def test_roundtrip_matches_numpy(self, rng):
        bits = rng.integers(0, 2, (3, 64)).astype(np.uint8)
        packed = np.asarray(packbits(jnp.asarray(bits)))
        np.testing.assert_array_equal(packed, np.packbits(bits, axis=-1))
        unpacked = np.asarray(unpackbits(jnp.asarray(packed)))
        np.testing.assert_array_equal(unpacked, bits)

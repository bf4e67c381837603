"""SCAN / Fast-SSCAN decoder and Puncturer tests (reference models:
scan.cpp round-trip in decodingtest.cpp:1210, puncturertest.cpp)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models.encoder import PolarEncoder
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.scan import ScanDecoder, FastSScanDecoder
from polar_codes_tpu.models.puncturer import Puncturer, round_up_power_of_two
from polar_codes_tpu.models.detectors import CRC8
from polar_codes_tpu.dsp import bpsk_modulate, add_awgn


class TestScan:
    @pytest.mark.parametrize("n_len,k_len", [(64, 40), (256, 128)])
    @pytest.mark.parametrize("systematic", [True, False])
    def test_noiseless_roundtrip(self, n_len, k_len, systematic, rng):
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=systematic)
        dec = ScanDecoder(n_len, frozen, systematic=systematic, iterations=1)
        info = rng.integers(0, 2, (16, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        decoded, codeword, _ = dec.decode(bpsk_modulate(code) * 8.0)
        np.testing.assert_array_equal(np.asarray(decoded), info)
        np.testing.assert_array_equal(np.asarray(codeword), np.asarray(code))

    def test_soft_output_finite_on_info_positions(self, rng):
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        dec = ScanDecoder(n_len, frozen, iterations=2)
        llr = rng.normal(0, 2, (4, n_len)).astype(np.float32)
        total, beta = dec.decode_soft(jnp.asarray(llr))
        total, beta = np.asarray(total), np.asarray(beta)
        assert total.shape == beta.shape == llr.shape
        assert not np.isnan(total).any()
        # extrinsic magnitudes should refine, not vanish
        assert np.abs(beta).max() > 0

    def test_awgn_performance_comparable_to_sc(self, rng):
        """SCAN-4 at 3.5 dB must be in SC's BLER ballpark (soft-output
        decoders trade a little hard-decision performance for soft info)."""
        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        sc = FastSSCDecoder(n_len, frozen, systematic=True)
        scan = ScanDecoder(n_len, frozen, systematic=True, iterations=4)
        info = rng.integers(0, 2, (256, k_len)).astype(np.uint8)
        tx = bpsk_modulate(enc.encode(jnp.asarray(info)))
        esn0 = 10 ** 0.35 * k_len / n_len
        rx = add_awgn(jax.random.PRNGKey(11), tx, esn0_linear=esn0)
        d_sc, _, _ = sc.decode(rx)
        d_scan, _, _ = scan.decode(rx)
        bler_sc = np.mean(np.any(np.asarray(d_sc) != info, axis=1))
        bler_scan = np.mean(np.any(np.asarray(d_scan) != info, axis=1))
        assert bler_scan <= max(2.0 * bler_sc, bler_sc + 0.08)

    def test_fastsscan_crc_trials(self, rng):
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC8()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = FastSScanDecoder(
            n_len, frozen, systematic=True, detector=det, iterations=4
        )
        info = rng.integers(0, 2, (32, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        decoded, _, ok = dec.decode(bpsk_modulate(code) * 8.0)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(decoded)[:, :-8], info[:, :-8])


class TestPuncturer:
    def test_round_up(self):
        assert round_up_power_of_two(1) == 1
        assert round_up_power_of_two(96) == 128
        assert round_up_power_of_two(128) == 128
        assert round_up_power_of_two(129) == 256

    def test_positions_drop_first_frozen(self):
        # M=6 -> parent 8; first 2 frozen positions are punctured
        frozen = [0, 1, 2, 4]
        p = Puncturer(6, frozen)
        assert p.parent_block_length == 8
        np.testing.assert_array_equal(p.punctured_positions, [0, 1])
        np.testing.assert_array_equal(p.output_positions, [2, 3, 4, 5, 6, 7])

    def test_too_few_frozen_raises(self):
        with pytest.raises(ValueError):
            Puncturer(5, [0])

    def test_puncture_depuncture_roundtrip(self, rng):
        frozen = sorted(rng.choice(64, size=32, replace=False))
        p = Puncturer(48, frozen)
        x = rng.normal(0, 1, (4, 64)).astype(np.float32)
        short = np.asarray(p.puncture(jnp.asarray(x)))
        assert short.shape == (4, 48)
        back = np.asarray(p.depuncture(jnp.asarray(short)))
        np.testing.assert_array_equal(back[:, p.output_positions], short)
        np.testing.assert_array_equal(back[:, p.punctured_positions], 0)

    def test_packed_matches_unpacked(self, rng):
        frozen = sorted(rng.choice(32, size=16, replace=False))
        p = Puncturer(24, frozen)
        bits = rng.integers(0, 2, (3, 32)).astype(np.uint8)
        packed = np.packbits(bits, axis=-1)
        got = np.unpackbits(p.puncture_packed(packed), axis=-1)
        want = np.asarray(p.puncture(jnp.asarray(bits)))
        np.testing.assert_array_equal(got, want)

    def test_end_to_end_punctured_decode(self, rng):
        """Encode at parent N, puncture to M, depuncture LLRs with neutral 0,
        decode: noiseless round-trip must survive rate matching."""
        n_len, k_len, m_len = 128, 56, 96
        frozen = frozen_bits(n_len, k_len, 0.0)
        p = Puncturer(m_len, frozen)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        info = rng.integers(0, 2, (16, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        short = p.puncture(bpsk_modulate(code) * 8.0)
        llr = p.depuncture(short)
        decoded, _, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)

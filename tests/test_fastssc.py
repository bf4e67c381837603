"""Fast-SSC decoder tests: tree specialization, bit-exactness vs a scalar
SC reference, noiseless round-trips, int8 path, and AWGN BER sanity
(mirroring decodingtest.cpp round-trip strategy)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from polar_codes_tpu.construction import frozen_bits, frozen_bit_mask
from polar_codes_tpu.models.encoder import PolarEncoder
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.tree import build_tree, NodeKind
from polar_codes_tpu.dsp import bpsk_modulate, add_awgn

from reference_sc import sc_decode


class TestTree:
    def test_leaf_kinds(self):
        # N=8, frozen {0,1,2,4}: classic example
        tree = build_tree(8, [0, 1, 2, 4])
        kinds = [leaf.kind for leaf in tree.leaves()]
        assert NodeKind.BRANCH not in kinds
        # left half (frozen 0,1,2 of 4) -> REP; right half (frozen 0) -> SPC
        assert kinds == [NodeKind.REP, NodeKind.SPC]

    def test_rate0_rate1(self):
        tree = build_tree(4, [0, 1, 2, 3])
        assert tree.kind == NodeKind.RATE0
        tree = build_tree(4, [])
        assert tree.kind == NodeKind.RATE1

    def test_node_count_reasonable(self):
        frozen = frozen_bits(1024, 512, 0.0)
        tree = build_tree(1024, frozen)
        # Fast-SSC specialization collapses most of the 2047-node full tree
        assert tree.node_count() < 500

    def test_info_accounting(self):
        frozen = frozen_bits(256, 100, 0.0)
        tree = build_tree(256, frozen)
        assert sum(l.info_count for l in tree.leaves()) == 100


class TestBitExactness:
    @pytest.mark.parametrize("n_len,k_len", [(16, 8), (64, 40), (128, 64), (256, 200)])
    @pytest.mark.parametrize("ctor", ["BB", "5G"])
    def test_matches_scalar_sc_on_random_llrs(self, n_len, k_len, ctor, rng):
        """Hard decisions must match plain min-sum SC bit-exactly on
        continuous (tie-free) LLR inputs."""
        frozen = frozen_bits(n_len, k_len, 1.0, ctor)
        mask = frozen_bit_mask(n_len, frozen)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        llrs = rng.normal(0, 2, (24, n_len)).astype(np.float32)
        got = np.asarray(dec.decode_to_codeword(jnp.asarray(llrs)))
        for row in range(24):
            _, x_ref = sc_decode(llrs[row].astype(np.float64), mask)
            np.testing.assert_array_equal(got[row], x_ref, err_msg=f"row {row}")


class TestRoundTrip:
    @pytest.mark.parametrize("n_len,k_len", [(8, 4), (64, 40), (256, 128), (1024, 512)])
    @pytest.mark.parametrize("systematic", [True, False])
    def test_noiseless(self, n_len, k_len, systematic, rng):
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=systematic)
        dec = FastSSCDecoder(n_len, frozen, systematic=systematic)
        info = rng.integers(0, 2, (32, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = bpsk_modulate(code) * 8.0
        decoded, codeword, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)
        np.testing.assert_array_equal(np.asarray(codeword), np.asarray(code))

    @pytest.mark.parametrize("n_len,k_len", [(64, 40), (1024, 512)])
    def test_noiseless_int8(self, n_len, k_len, rng):
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = FastSSCDecoder(n_len, frozen, systematic=True, dtype=jnp.int8)
        info = rng.integers(0, 2, (16, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = (bpsk_modulate(code) * 10).astype(jnp.int8)
        decoded, _, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)

    def test_awgn_ber_sanity(self, rng):
        """At Eb/N0 = 4 dB, (1024,512) SC must decode nearly all blocks."""
        n_len, k_len = 1024, 512
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        batch = 64
        info = rng.integers(0, 2, (batch, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        tx = bpsk_modulate(code)
        ebn0_db = 4.0
        esn0_lin = 10 ** (ebn0_db / 10) * k_len / n_len
        key = jax.random.PRNGKey(7)
        rx = add_awgn(key, tx, esn0_linear=esn0_lin)
        decoded, _, _ = dec.decode(rx)
        bler = np.mean(np.any(np.asarray(decoded) != info, axis=1))
        assert bler < 0.15  # SC @4dB is well below this

    def test_crc_flags_failures(self, rng):
        """Corrupted blocks must be flagged by the CRC check."""
        from polar_codes_tpu.models.detectors import CRC8

        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC8()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = FastSSCDecoder(n_len, frozen, systematic=True, detector=det)
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = bpsk_modulate(code) * 8.0
        _, _, ok = dec.decode(llr)
        assert np.asarray(ok).all()
        # corrupt row 0 beyond correction capability -> decoded info is wrong
        # -> CRC must fail for that row only
        llr_bad = np.asarray(llr).copy()
        llr_bad[0] = -llr_bad[0]  # global sign flip = complemented word
        decoded_bad, _, ok2 = dec.decode(jnp.asarray(llr_bad))
        ok2 = np.asarray(ok2)
        assert (np.asarray(decoded_bad)[0] != info[0]).any()
        assert not ok2[0]
        assert ok2[1:].all()


class TestDsp:
    def test_bpsk_roundtrip(self, rng):
        bits = rng.integers(0, 2, (4, 32)).astype(np.uint8)
        sym = bpsk_modulate(bits)
        np.testing.assert_array_equal(np.asarray(sym), 1.0 - 2.0 * bits)

    def test_ask_power_normalized(self, rng):
        from polar_codes_tpu.dsp import ask_modulate

        for bps in (1, 2, 3, 4):
            bits = rng.integers(0, 2, (1, 1 << 14)).astype(np.uint8)
            bits = bits[:, : (bits.shape[1] // bps) * bps]
            sym = np.asarray(ask_modulate(jnp.asarray(bits), bps))
            assert abs(np.mean(sym**2) - 1.0) < 0.05

    def test_ask_demod_roundtrip_hard(self, rng):
        from polar_codes_tpu.dsp import ask_modulate, ask_demodulate

        for bps in (2, 3):
            bits = rng.integers(0, 2, (2, 48)).astype(np.uint8)
            sym = ask_modulate(jnp.asarray(bits), bps)
            soft = np.asarray(ask_demodulate(sym, bps))
            hard = (soft < 0).astype(np.uint8)
            np.testing.assert_array_equal(hard, bits)

    def test_awgn_statistics(self):
        from polar_codes_tpu.dsp import add_awgn, awgn_sigma

        key = jax.random.PRNGKey(0)
        sig = jnp.zeros((1 << 16,))
        esn0_db = 3.0
        noisy = np.asarray(add_awgn(key, sig, esn0_db=esn0_db))
        sigma = float(awgn_sigma(esn0_db))
        assert abs(np.std(noisy) - sigma) / sigma < 0.02

    def test_rayleigh_statistics(self):
        from polar_codes_tpu.dsp import apply_rayleigh

        key = jax.random.PRNGKey(1)
        sig = jnp.ones((1 << 16,))
        out = np.asarray(apply_rayleigh(key, sig, esn0_db=40.0))
        # fade magnitude: E[|h|] = sqrt(pi/2) for unit-variance components
        assert abs(np.mean(out) - np.sqrt(np.pi / 2)) < 0.02

    def test_rayleigh_uncoded_ber_matches_closed_form(self):
        """Hard-decision BPSK over y = |h|x + n (rayleigh.cpp semantics):
        BER = (1 - sqrt(g/(1+g)))/2 with g = Es/N0 (|h|^2 is exponential
        with mean 2, so the per-symbol SNR |h|^2 g/2 has mean g)."""
        from polar_codes_tpu.dsp import apply_rayleigh

        for esn0_db in (0.0, 10.0):
            esn0 = 10.0 ** (esn0_db / 10.0)
            sig = jnp.ones((1 << 21,), jnp.float32)
            out = apply_rayleigh(
                jax.random.PRNGKey(42), sig, esn0_linear=esn0
            )
            ber = float(jnp.mean(out < 0))
            analytic = 0.5 * (1.0 - np.sqrt(esn0 / (1.0 + esn0)))
            assert abs(ber - analytic) / analytic < 0.02


class TestBatchedShapes:
    """The whole-batch decode at the widths the decoder serves: odd
    batches, leading batch axes and the int8 path."""

    @pytest.mark.parametrize("n_len,k_len", [(256, 128), (512, 300)])
    def test_odd_batch_matches_scalar_sc(self, n_len, k_len, rng):
        frozen = frozen_bits(n_len, k_len, 0.0)
        mask = frozen_bit_mask(n_len, frozen)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        llr = rng.normal(0, 2, (37, n_len)).astype(np.float32)
        got = np.asarray(jax.jit(dec.decode_to_codeword)(jnp.asarray(llr)))
        lead = np.asarray(jax.jit(dec.decode_to_codeword)(
            jnp.asarray(llr[:36].reshape(6, 6, n_len))))
        np.testing.assert_array_equal(lead.reshape(36, n_len), got[:36])
        for row in (0, 18, 36):
            _, x_ref = sc_decode(llr[row].astype(np.float64), mask)
            np.testing.assert_array_equal(got[row], x_ref,
                                          err_msg=f"row {row}")

    def test_int8_matches_float_payloads(self):
        """int8 on LLRs quantized x8 decodes the same payloads as float32
        on these seeded noisy blocks at 3 dB."""
        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        info = np.random.default_rng(9).integers(0, 2, (37, k_len))
        code = enc.encode(jnp.asarray(info.astype(np.uint8)))
        llr = add_awgn(jax.random.PRNGKey(9), bpsk_modulate(code),
                       esn0_linear=10.0 ** 0.3 * k_len / n_len)
        llr_q = np.clip(np.round(np.asarray(llr) * 8.0), -127, 127)
        f32 = FastSSCDecoder(n_len, frozen, systematic=True)
        i8 = FastSSCDecoder(n_len, frozen, systematic=True, dtype=jnp.int8)
        got = jax.jit(i8.decode)(jnp.asarray(llr_q.astype(np.int8)))[0]
        want = jax.jit(f32.decode)(jnp.asarray(llr_q.astype(np.float32)))[0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

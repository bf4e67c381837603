"""SCL decoder tests: L=1 degeneracy to SC, exactness vs a scalar bitwise
SCL on fully-enumerated trees, SPC best-path agreement, CA-SCL round trips,
and the statistical coding gain over plain SC (the property the reference
validates via testListDecoder round-trips, decodingtest.cpp:1137)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from polar_codes_tpu.construction import frozen_bits, frozen_bit_mask
from polar_codes_tpu.models.encoder import PolarEncoder
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.scl import SCLDecoder
from polar_codes_tpu.models.detectors import CRC8, CRC16
from polar_codes_tpu.dsp import bpsk_modulate, add_awgn

from reference_sc import sc_decode, scl_decode, _encode


class TestDegenerateList:
    @pytest.mark.parametrize("n_len,k_len", [(16, 8), (64, 40), (128, 64)])
    def test_list1_equals_sc(self, n_len, k_len, rng):
        """With L=1 every leaf keeps only its ML candidate: decisions must
        equal plain min-sum SC bit-exactly."""
        frozen = frozen_bits(n_len, k_len, 1.0)
        mask = frozen_bit_mask(n_len, frozen)
        dec = SCLDecoder(n_len, frozen, list_size=1)
        llrs = rng.normal(0, 2, (12, n_len)).astype(np.float32)
        cw, _, _ = dec.decode_paths(jnp.asarray(llrs))
        cw = np.asarray(cw)
        for r in range(12):
            _, x_ref = sc_decode(llrs[r].astype(np.float64), mask)
            np.testing.assert_array_equal(cw[r, 0], x_ref, err_msg=f"row {r}")


class TestExactness:
    def test_rep_tree_matches_bitwise_scl(self, rng):
        """N=8 with frozen {0,1,2,4,6} specializes to all-Repetition leaves,
        whose 2-candidate enumeration is complete: path metrics and the best
        path must match a scalar bitwise SCL exactly."""
        n_len, list_size = 8, 4
        frozen = [0, 1, 2, 4, 6]
        mask = frozen_bit_mask(n_len, frozen)
        dec = SCLDecoder(n_len, frozen, list_size=list_size)
        llr = rng.normal(0, 2, (32, n_len)).astype(np.float32)
        cw, metrics, _ = dec.decode_paths(jnp.asarray(llr))
        cw, metrics = np.asarray(cw), np.asarray(metrics)
        for t in range(32):
            u_ref, m_ref = scl_decode(llr[t].astype(np.float64), mask, list_size)
            x_ref = np.stack([_encode(u) for u in u_ref])
            np.testing.assert_allclose(
                np.sort(metrics[t])[::-1], np.sort(m_ref)[::-1], rtol=1e-5, atol=1e-5
            )
            np.testing.assert_array_equal(cw[t, np.argmax(metrics[t])], x_ref[0])

    def test_spc_best_path_matches_bitwise_scl(self, rng):
        """The SSCL-SPC candidate table (reference scl_avx_float.cpp:498-586)
        deliberately prices parity repair into every candidate (-m0), so
        runner-up metrics differ from bitwise SCL; the winning path must
        still agree."""
        n_len, list_size = 4, 4
        frozen = [0]
        mask = frozen_bit_mask(n_len, frozen)
        dec = SCLDecoder(n_len, frozen, list_size=list_size)
        llr = rng.normal(0, 2, (100, n_len)).astype(np.float32)
        cw, metrics, _ = dec.decode_paths(jnp.asarray(llr))
        cw, metrics = np.asarray(cw), np.asarray(metrics)
        for t in range(100):
            u_ref, _ = scl_decode(llr[t].astype(np.float64), mask, list_size)
            x_ref = _encode(u_ref[0])
            np.testing.assert_array_equal(cw[t, np.argmax(metrics[t])], x_ref)


class TestRoundTrip:
    @pytest.mark.parametrize("systematic", [True, False])
    @pytest.mark.parametrize("n_len,k_len,list_size", [(128, 64, 4), (1024, 512, 8)])
    def test_noiseless(self, n_len, k_len, list_size, systematic, rng):
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=systematic)
        dec = SCLDecoder(n_len, frozen, list_size=list_size, systematic=systematic)
        info = rng.integers(0, 2, (16, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = bpsk_modulate(code) * 8.0
        decoded, codeword, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)
        np.testing.assert_array_equal(np.asarray(codeword), np.asarray(code))

    def test_noiseless_ca_scl_crc16(self, rng):
        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC16()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = SCLDecoder(n_len, frozen, list_size=8, systematic=True, detector=det)
        info = rng.integers(0, 2, (16, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        decoded, _, ok = dec.decode(bpsk_modulate(code) * 8.0)
        assert np.asarray(ok).all()
        # payload (data before the CRC tail) must round-trip
        np.testing.assert_array_equal(
            np.asarray(decoded)[:, :-16], info[:, :-16]
        )

    def test_crc_flags_uncorrectable(self, rng):
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC8()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = SCLDecoder(n_len, frozen, list_size=4, systematic=True, detector=det)
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        llr = np.array(bpsk_modulate(enc.encode(jnp.asarray(info))) * 8.0)
        llr[0] = -llr[0]  # complemented word: uncorrectable
        _, _, ok = dec.decode(jnp.asarray(llr))
        ok = np.asarray(ok)
        assert not ok[0]
        assert ok[1:].all()


class TestCodingGain:
    def test_ca_scl8_beats_sc(self, rng):
        """At a noise level where SC loses a good fraction of blocks,
        CRC-aided SCL-8 must recover strictly more of them (the list-decoding
        gain the reference demonstrates in its compareall simulations)."""
        n_len, k_len = 128, 72
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC8()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        sc = FastSSCDecoder(n_len, frozen, systematic=True, detector=det)
        scl = SCLDecoder(n_len, frozen, list_size=8, systematic=True, detector=det)
        batch = 256
        info = rng.integers(0, 2, (batch, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        tx = bpsk_modulate(code)
        ebn0_db = 2.5
        esn0_lin = 10 ** (ebn0_db / 10) * k_len / n_len
        rx = add_awgn(jax.random.PRNGKey(3), tx, esn0_linear=esn0_lin)
        got_sc, _, _ = sc.decode(rx)
        got_scl, _, _ = scl.decode(rx)
        payload = info[:, :-8]  # last 8 bits are overwritten with the CRC
        err_sc = np.mean(np.any(np.asarray(got_sc)[:, :-8] != payload, axis=1))
        err_scl = np.mean(np.any(np.asarray(got_scl)[:, :-8] != payload, axis=1))
        assert err_sc > 0.02  # operating point is in the waterfall
        assert err_scl < err_sc * 0.7  # list gain


class TestInt8:
    def test_int8_matches_float_at_high_amplification(self, rng):
        """SclFipChar parity: int8 LLRs (amplified, saturating arithmetic)
        must reach float32 BLER at a quantization-friendly operating point."""
        from polar_codes_tpu.models.detectors import CRC16

        n_len, k_len, list_size = 256, 128, 8
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC16()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        d32 = SCLDecoder(n_len, frozen, list_size=list_size, systematic=True,
                         detector=det)
        d8 = SCLDecoder(n_len, frozen, list_size=list_size, systematic=True,
                        detector=det, dtype=jnp.int8)
        info = rng.integers(0, 2, (256, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        tx = bpsk_modulate(enc.encode(jnp.asarray(info)))
        rx = add_awgn(jax.random.PRNGKey(21), tx,
                      esn0_linear=10 ** 0.15 * k_len / n_len)
        rx8 = jnp.clip(jnp.round(rx * 10.0), -127, 127).astype(jnp.int8)
        g32, _, _ = d32.decode(rx)
        g8, _, _ = d8.decode(rx8)
        b32 = np.any(np.asarray(g32) != sent, axis=1).mean()
        b8 = np.any(np.asarray(g8) != sent, axis=1).mean()
        assert b8 <= b32 + 0.03

    def test_int8_noiseless(self, rng):
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = SCLDecoder(n_len, frozen, list_size=4, systematic=True,
                         dtype=jnp.int8)
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = (bpsk_modulate(code) * 20).astype(jnp.int8)
        decoded, _, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)


class TestBfloat16:
    def test_bf16_matches_float_bler(self, rng):
        """bfloat16 LLR/bit state (half the memory traffic of the
        memory-bound decode) must match float32 BLER up to bf16 rounding
        of the channel LLRs."""
        from polar_codes_tpu.models.detectors import CRC16

        n_len, k_len, list_size = 256, 128, 8
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC16()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        d32 = SCLDecoder(n_len, frozen, list_size=list_size, systematic=True,
                         detector=det)
        d16 = SCLDecoder(n_len, frozen, list_size=list_size, systematic=True,
                         detector=det, dtype=jnp.bfloat16)
        info = rng.integers(0, 2, (512, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        tx = bpsk_modulate(enc.encode(jnp.asarray(info)))
        rx = add_awgn(jax.random.PRNGKey(23), tx,
                      esn0_linear=10 ** 0.15 * k_len / n_len)
        g32, _, _ = d32.decode(rx)
        g16, _, _ = d16.decode(rx)
        b32 = np.any(np.asarray(g32) != sent, axis=1).mean()
        b16 = np.any(np.asarray(g16) != sent, axis=1).mean()
        assert b16 <= b32 + 0.02

    def test_bf16_noiseless(self, rng):
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = SCLDecoder(n_len, frozen, list_size=4, systematic=True,
                         dtype=jnp.bfloat16)
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        code = enc.encode(jnp.asarray(info))
        llr = bpsk_modulate(code) * 20
        decoded, _, _ = dec.decode(llr)
        np.testing.assert_array_equal(np.asarray(decoded), info)


class TestBatchLastLayout:
    """layout="batch_last" is the same math with batch as the minor axis;
    outputs must match batch_first bit-for-bit."""

    def test_layouts_agree_on_noisy_blocks(self, rng):
        n_len, k_len, list_size = 256, 128, 8
        frozen = frozen_bits(n_len, k_len, 0.0)
        det = CRC16()
        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        d_bf = SCLDecoder(n_len, frozen, list_size=list_size,
                          systematic=True, detector=det)
        d_bl = SCLDecoder(n_len, frozen, list_size=list_size,
                          systematic=True, detector=det, layout="batch_last")
        info = rng.integers(0, 2, (96, k_len)).astype(np.uint8)
        tx = bpsk_modulate(enc.encode(jnp.asarray(info)))
        rx = add_awgn(jax.random.PRNGKey(31), tx,
                      esn0_linear=10 ** 0.2 * k_len / n_len)
        for a, b in zip(d_bf.decode(rx), d_bl.decode(rx)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _noisy_codewords(n_len, k_len, blocks, ebn0_db, seed):
    """Non-systematic BB code, random payloads, BPSK over AWGN: returns
    (frozen, codewords [B, N] np, channel LLRs [B, N] np float32)."""
    frozen = frozen_bits(n_len, k_len, 0.0)
    enc = PolarEncoder(n_len, frozen, systematic=False)
    info = np.random.default_rng(seed).integers(0, 2, (blocks, k_len))
    code = enc.encode(jnp.asarray(info.astype(np.uint8)))
    esn0 = 10.0 ** (ebn0_db / 10.0) * k_len / n_len
    llr = add_awgn(jax.random.PRNGKey(seed), bpsk_modulate(code),
                   esn0_linear=esn0)
    return frozen, np.asarray(code), np.asarray(llr, np.float32)


class TestReferenceAgreement:
    """Regression anchors against the scalar bitwise SCL: on these fixed
    noisy blocks (seeded, moderate SNR) the list decoder's best path
    equals the bitwise decoder's best path, at the shapes and leaf mixes
    the list decoder serves. The SSCL candidate rules are not bitwise SCL
    in general; a change that moves a winner here moves real decisions."""

    @pytest.mark.parametrize(
        "n_len,k_len,list_size,blocks",
        [(256, 128, 8, 6), (256, 160, 4, 6), (512, 256, 8, 2)],
    )
    def test_best_path_matches_bitwise_scl(self, n_len, k_len, list_size,
                                           blocks):
        frozen, _, llr = _noisy_codewords(n_len, k_len, blocks, 2.5, 3)
        mask = frozen_bit_mask(n_len, frozen)
        dec = SCLDecoder(n_len, frozen, list_size=list_size,
                         systematic=False)
        cw, metrics, _ = jax.jit(dec.decode_paths)(jnp.asarray(llr))
        cw, metrics = np.asarray(cw), np.asarray(metrics)
        for r in range(blocks):
            u_ref, _ = scl_decode(llr[r].astype(np.float64), mask,
                                  list_size)
            np.testing.assert_array_equal(
                cw[r, np.argmax(metrics[r])], _encode(u_ref[0]),
                err_msg=f"row {r}",
            )

    def test_all_leaf_kinds(self):
        """A frozen set whose tree holds every leaf kind (rate-0, rate-1,
        repetition, SPC and ENUM)."""
        from polar_codes_tpu.models.tree import NodeKind

        n_len = 64
        # leaves: rep [0,16), rate0 [16,24), enum [24,28), rate1 [28,32),
        # enum [32,40), rate1 [40,48), spc [48,64)
        frozen = (list(range(15)) + list(range(16, 26))
                  + [32, 33, 34, 35, 36, 37, 38] + [48])
        dec = SCLDecoder(n_len, frozen, list_size=4, enum_span=8,
                         max_enum_k=3)
        kinds = set()

        def walk(node):
            kinds.add(node.kind)
            if node.kind == NodeKind.BRANCH:
                walk(node.left)
                walk(node.right)

        walk(dec.tree)
        assert {NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP,
                NodeKind.SPC, NodeKind.ENUM} <= kinds
        mask = frozen_bit_mask(n_len, frozen)
        enc = PolarEncoder(n_len, frozen, systematic=False)
        info = np.random.default_rng(4).integers(0, 2, (8, dec.info_length))
        code = enc.encode(jnp.asarray(info.astype(np.uint8)))
        llr = np.asarray(add_awgn(jax.random.PRNGKey(4), bpsk_modulate(code),
                                  esn0_db=1.0), np.float32)
        cw, metrics, _ = jax.jit(dec.decode_paths)(jnp.asarray(llr))
        cw, metrics = np.asarray(cw), np.asarray(metrics)
        for r in range(8):
            u_ref, _ = scl_decode(llr[r].astype(np.float64), mask, 4)
            np.testing.assert_array_equal(
                cw[r, np.argmax(metrics[r])], _encode(u_ref[0]),
                err_msg=f"row {r}",
            )

    def test_bf16_equals_float_on_exact_llrs(self, rng):
        """bf16 state is exact for small integer LLRs (every f/g value
        stays an integer below 2^8), so decisions and metrics equal the
        float32 decode."""
        n_len, k_len = 64, 32
        frozen = frozen_bits(n_len, k_len, 0.0)
        llr = rng.choice(np.array([-2.0, -1.0, 1.0, 2.0], np.float32),
                         (24, n_len))
        f32 = SCLDecoder(n_len, frozen, list_size=8, detector=CRC16())
        bf16 = SCLDecoder(n_len, frozen, list_size=8, detector=CRC16(),
                          dtype=jnp.bfloat16)
        got = jax.jit(bf16.decode_paths)(jnp.asarray(llr))
        want = jax.jit(f32.decode_paths)(jnp.asarray(llr))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    def test_int8_matches_float_payloads(self):
        """int8 (saturating) mode on LLRs quantized x8 decodes the same
        payloads as float32 on these seeded blocks at 2.5 dB."""
        n_len, k_len = 256, 128
        frozen, _, llr = _noisy_codewords(n_len, k_len, 32, 2.5, 5)
        llr_q = np.clip(np.round(llr * 8.0), -127, 127)
        f32 = SCLDecoder(n_len, frozen, list_size=8, detector=CRC8())
        i8 = SCLDecoder(n_len, frozen, list_size=8, detector=CRC8(),
                        dtype=jnp.int8)
        got = jax.jit(i8.decode)(jnp.asarray(llr_q.astype(np.int8)))[0]
        want = jax.jit(f32.decode)(jnp.asarray(llr_q.astype(np.float32)))[0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_odd_batch_equals_rowwise(self, rng):
        """An odd batch decodes exactly as each row decoded alone, and a
        [4, 9, N] batch as its flattened rows."""
        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        dec = SCLDecoder(n_len, frozen, list_size=4, detector=CRC16())
        fn = jax.jit(dec.decode)
        llr = rng.normal(1.0, 1.5, (37, n_len)).astype(np.float32)
        info = np.asarray(fn(jnp.asarray(llr))[0])
        one = jax.jit(lambda x: dec.decode(x[None])[0][0])
        for r in (0, 17, 36):
            np.testing.assert_array_equal(
                np.asarray(one(jnp.asarray(llr[r]))), info[r]
            )
        lead = np.asarray(fn(jnp.asarray(llr[:36].reshape(4, 9, n_len)))[0])
        np.testing.assert_array_equal(lead.reshape(36, -1), info[:36])

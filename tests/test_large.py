"""Scan-over-schedule large-N decoders (models/large.py).

Correctness anchors: LargeSCDecoder must equal plain SC (and therefore
Fast-SSC, Sarkis et al.) bit-for-bit on tie-free inputs; LargeSCLDecoder
implements textbook bitwise SCL and must match the scalar reference
(tests/reference_sc.py scl_decode) in metrics and best path. Bounded
compile is exercised by decoding N=32768 (SC) with a chunk-sized program.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.scl import SCLDecoder
from polar_codes_tpu.models.large import LargeSCDecoder, LargeSCLDecoder
from polar_codes_tpu.models.detectors import CRC16
from polar_codes_tpu.ops.butterfly import butterfly_transform
from reference_sc import scl_decode


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


class TestLargeSC:
    @pytest.mark.parametrize("chunk", [32, 128, 512])
    @pytest.mark.parametrize("fast", [True, False])
    def test_matches_fastssc(self, chunk, fast, rng):
        n_len, k_len = 512, 300
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        llr = rng.normal(0, 2, (16, n_len)).astype(np.float32)
        ref = FastSSCDecoder(n_len, frozen, systematic=True)
        dec = LargeSCDecoder(n_len, frozen, systematic=True, chunk=chunk,
                             fast_chunks=fast)
        cw_ref = np.asarray(ref.decode_to_codeword(jnp.asarray(llr)))
        cw = np.asarray(dec.decode_to_codeword(jnp.asarray(llr)))
        np.testing.assert_array_equal(cw, cw_ref)

    def test_fast_chunks_cover_all_classes(self, rng):
        """A construction whose chunking produces every pure class, and
        the fast path still equals Fast-SSC bit-for-bit (f32 min-sum)."""
        from polar_codes_tpu.models.large import _classify_chunks

        n_len, chunk = 256, 8
        # hand-built mask: chunk 0 all-frozen, chunk 1 rep (frozen except
        # last), chunk 2 spc (only first frozen), chunk 3 mixed, the rest
        # all-info (rate1)
        frozen = (
            list(range(0, 8))        # chunk 0: rate0
            + list(range(8, 15))     # chunk 1: rep
            + [16]                   # chunk 2: spc
            + [24, 26, 29]           # chunk 3: mixed
        )
        dec = LargeSCDecoder(n_len, frozen, systematic=True, chunk=chunk)
        cls = _classify_chunks(dec._mask_chunks)
        assert set(cls.tolist()) == {0, 1, 2, 3, 4}  # every class present
        ref = FastSSCDecoder(n_len, frozen, systematic=True)
        llr = rng.normal(0, 2, (32, n_len)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(dec.decode_to_codeword(jnp.asarray(llr))),
            np.asarray(ref.decode_to_codeword(jnp.asarray(llr))),
        )

    def test_int8_matches_scalar_saturating_sc(self, rng):
        """int8 mode = plain SC with fi_adds_epi8-saturating g (fip_char
        semantics). Note this differs from Fast-SSC's int8 leaf shortcuts
        at saturation boundaries (rep leaves sum without clipping), so the
        anchor is a scalar saturating SC, not FastSSCDecoder."""

        def sc_sat(llr, mask):
            n = len(llr)
            if n == 1:
                u = 0 if mask[0] else (1 if llr[0] < 0 else 0)
                return np.array([u], np.uint8), np.array([u], np.uint8)
            h = n // 2
            a, b = llr[:h], llr[h:]
            f = np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))
            ul, xl = sc_sat(f, mask[:h])
            g = np.clip(b + (1.0 - 2.0 * xl) * a, -127, 127)
            ur, xr = sc_sat(g, mask[h:])
            return (
                np.concatenate([ul, ur]),
                np.concatenate([xl ^ xr, xr]),
            )

        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        mask = np.zeros(n_len, bool)
        mask[frozen] = True
        llr = rng.integers(-100, 101, (16, n_len)).astype(np.int8)
        dec = LargeSCDecoder(
            n_len, frozen, systematic=True, dtype=jnp.int8, chunk=64
        )
        cw = np.asarray(dec.decode_to_codeword(jnp.asarray(llr)))
        for i in range(llr.shape[0]):
            _, x_ref = sc_sat(llr[i].astype(np.float64), mask)
            np.testing.assert_array_equal(cw[i], x_ref)

    def test_decode_api_and_detector(self, rng):
        n_len, k_len = 256, 128 + 16
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        det = CRC16()
        from polar_codes_tpu.models.encoder import PolarEncoder

        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = LargeSCDecoder(
            n_len, frozen, systematic=True, detector=det, chunk=64
        )
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        code = np.asarray(enc.encode(jnp.asarray(info)))
        llr = (1.0 - 2.0 * code) * 8.0
        out, cw, ok = dec.decode(jnp.asarray(llr.astype(np.float32)))
        np.testing.assert_array_equal(np.asarray(out), sent)
        assert bool(np.all(np.asarray(ok)))
        # global sign flip -> CRC flags every block
        _, _, bad = dec.decode(jnp.asarray(-llr.astype(np.float32)))
        assert not bool(np.any(np.asarray(bad)))

    def test_bounded_compile_n32768(self, rng):
        """The whole point: N=32768 decodes with a chunk-sized program."""
        n_len, k_len = 32768, 16384
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        dec = LargeSCDecoder(n_len, frozen, systematic=True, chunk=512)
        llr = rng.normal(0, 2, (2, n_len)).astype(np.float32)
        cw = np.asarray(dec.decode_to_codeword(jnp.asarray(llr)))
        assert cw.shape == (2, n_len)
        # noiseless round-trip sanity at this size
        from polar_codes_tpu.models.encoder import PolarEncoder

        enc = PolarEncoder(n_len, frozen, systematic=True)
        info = rng.integers(0, 2, (2, k_len)).astype(np.uint8)
        code = np.asarray(enc.encode(jnp.asarray(info)))
        clean = ((1.0 - 2.0 * code) * 10).astype(np.float32)
        out, _, _ = dec.decode(jnp.asarray(clean))
        np.testing.assert_array_equal(np.asarray(out), info)


class TestLargeSCL:
    @pytest.mark.parametrize("chunk,list_size", [(8, 4), (16, 8), (64, 2)])
    def test_matches_scalar_bitwise_scl(self, chunk, list_size, rng):
        n_len, k_len = 64, 40
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        mask = np.zeros(n_len, bool)
        mask[frozen] = True
        llr = rng.normal(0, 2, (4, n_len)).astype(np.float32)
        dec = LargeSCLDecoder(
            n_len, frozen, list_size=list_size, systematic=False, chunk=chunk,
            fast_chunks=False,  # the scalar anchor is exact per-bit SCL
        )
        cws, mets, _ = dec.decode_paths(jnp.asarray(llr))
        us = np.asarray(butterfly_transform(cws))
        mets = np.asarray(mets)
        for i in range(llr.shape[0]):
            u_ref, m_ref = scl_decode(llr[i], mask, list_size)
            np.testing.assert_allclose(
                np.sort(mets[i])[::-1], m_ref, atol=1e-4
            )
            best = np.argmax(mets[i])
            np.testing.assert_array_equal(us[i, best], u_ref[0])

    def test_ca_scl_roundtrip_noisy(self, rng):
        """(1024,512) CA-SCL-8 CRC16 at ~2 dB: bitwise SCL must be at
        least as good as the SSCL tree decoder on the same noise."""
        n_len, k_len, list_size = 1024, 512, 8
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        det = CRC16()
        from polar_codes_tpu.models.encoder import PolarEncoder
        from polar_codes_tpu.dsp import bpsk_modulate, add_awgn

        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        tree_dec = SCLDecoder(
            n_len, frozen, list_size=list_size, systematic=True, detector=det
        )
        scan_dec = LargeSCLDecoder(
            n_len,
            frozen,
            list_size=list_size,
            systematic=True,
            detector=det,
            chunk=128,
        )
        info = rng.integers(0, 2, (64, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        code = enc.encode(jnp.asarray(info))
        esn0 = 10.0 ** 0.2 * k_len / n_len
        llr = add_awgn(
            jax.random.PRNGKey(7), bpsk_modulate(code), esn0_linear=esn0
        )
        out_tree, _, _ = tree_dec.decode(llr)
        out_scan, _, _ = scan_dec.decode(llr)
        err_tree = np.any(np.asarray(out_tree) != sent, axis=1).sum()
        err_scan = np.any(np.asarray(out_scan) != sent, axis=1).sum()
        assert err_scan <= max(err_tree, 2)

    def test_systematic_and_crc_extraction(self, rng):
        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        det = CRC16()
        from polar_codes_tpu.models.encoder import PolarEncoder

        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        dec = LargeSCLDecoder(
            n_len, frozen, list_size=4, systematic=True, detector=det,
            chunk=32,
        )
        info = rng.integers(0, 2, (8, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        code = np.asarray(enc.encode(jnp.asarray(info)))
        llr = ((1.0 - 2.0 * code) * 6.0).astype(np.float32)
        out, _, ok = dec.decode(jnp.asarray(llr))
        np.testing.assert_array_equal(np.asarray(out), sent)
        assert bool(np.all(np.asarray(ok)))

    def test_fast_chunks_scl(self, rng):
        """fast_chunks=True (SSCL rules on pure chunks) must round-trip
        noiseless blocks and agree with the exact per-bit decoder on the
        vast majority of noisy blocks (the SSCL candidate restriction is
        the reference's own leaf rule; BLER-equivalent by construction)."""
        n_len, k_len, list_size = 512, 256, 8
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        det = CRC16()
        from polar_codes_tpu.models.encoder import PolarEncoder
        from polar_codes_tpu.dsp import bpsk_modulate, add_awgn
        from polar_codes_tpu.models.large import _classify_chunks, _MIXED

        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        fast = LargeSCLDecoder(n_len, frozen, list_size=list_size,
                               systematic=True, detector=det, chunk=32)
        exact = LargeSCLDecoder(n_len, frozen, list_size=list_size,
                                systematic=True, detector=det, chunk=32,
                                fast_chunks=False)
        # the shape actually exercises pure chunks
        assert (_classify_chunks(fast._mask_chunks) != _MIXED).sum() >= 4
        info = rng.integers(0, 2, (48, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        code = np.asarray(enc.encode(jnp.asarray(info)))
        clean = jnp.asarray(((1.0 - 2.0 * code) * 8.0).astype(np.float32))
        out, _, ok = fast.decode(clean)
        np.testing.assert_array_equal(np.asarray(out), sent)
        assert bool(np.all(np.asarray(ok)))
        esn0 = 10.0 ** 0.25 * k_len / n_len
        llr = add_awgn(jax.random.PRNGKey(3), bpsk_modulate(jnp.asarray(code)),
                       esn0_linear=esn0)
        out_f, _, ok_f = fast.decode(llr)
        out_e, _, ok_e = exact.decode(llr)
        err_f = np.any(np.asarray(out_f) != sent, axis=1).sum()
        err_e = np.any(np.asarray(out_e) != sent, axis=1).sum()
        assert err_f <= err_e + 2  # BLER-equivalent within small-sample slop
        agree = np.all(np.asarray(out_f) == np.asarray(out_e), axis=1).mean()
        assert agree >= 0.85

    def test_int8_mode_runs(self, rng):
        n_len, k_len = 256, 128
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        dec = LargeSCLDecoder(
            n_len, frozen, list_size=4, systematic=True, dtype=jnp.int8,
            chunk=64,
        )
        llr = rng.integers(-100, 101, (4, n_len)).astype(np.int8)
        cws, mets, act = dec.decode_paths(jnp.asarray(llr))
        assert np.asarray(cws).shape == (4, 4, n_len)
        assert bool(np.all(np.asarray(act)[:, 0]))

    def test_unroll_invariance_many_chunks(self, rng):
        """decode_paths must be identical across unroll values on a shape
        with n_chunks > unroll (N=256, chunk=8 -> 32 chunks), exercising
        the period==U and period>U dynamic branches of the statically
        unrolled outer scan that production N hits (r4 advisor item)."""
        n_len, k_len = 256, 140
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        llr = rng.normal(0, 2, (4, n_len)).astype(np.float32)
        ref_cw = ref_met = None
        for unroll in (1, 4, 32):
            dec = LargeSCLDecoder(
                n_len, frozen, list_size=4, systematic=False, chunk=8,
                unroll=unroll,
            )
            cws, mets, _ = dec.decode_paths(jnp.asarray(llr))
            cws, mets = np.asarray(cws), np.asarray(mets)
            if ref_cw is None:
                ref_cw, ref_met = cws, mets
            else:
                np.testing.assert_array_equal(cws, ref_cw)
                np.testing.assert_allclose(mets, ref_met, atol=1e-4)

    def test_bf16_carry_matches_f32_decisions(self, rng):
        """CPU regression pin for the bf16 LLR scan carry: at moderate
        noise the bf16-carry decoder must make the same decisions as f32
        carry (same winning codeword on every block, fixed seed). Guards
        the carry_dtype=bf16 path the large-N benchmark rows ship."""
        n_len, k_len = 1024, 512
        frozen = frozen_bits(n_len, k_len, 2.0, "BB")
        det = CRC16()
        info = rng.integers(0, 2, (32, k_len), dtype=np.uint8)
        from polar_codes_tpu.models.encoder import PolarEncoder

        enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
        cw = np.asarray(enc.encode(jnp.asarray(info)))
        noise = rng.normal(0, 0.55, cw.shape)
        llr = ((1.0 - 2.0 * cw) * 2 + noise).astype(np.float32)
        outs = {}
        for cd in (None, jnp.bfloat16):
            dec = LargeSCLDecoder(
                n_len, frozen, list_size=8, systematic=True, detector=det,
                chunk=256, carry_dtype=cd,
            )
            info, codeword, ok = dec.decode(jnp.asarray(llr))
            outs[cd] = (np.asarray(info), np.asarray(codeword),
                        np.asarray(ok))
        np.testing.assert_array_equal(outs[None][0], outs[jnp.bfloat16][0])
        np.testing.assert_array_equal(outs[None][1], outs[jnp.bfloat16][1])
        np.testing.assert_array_equal(outs[None][2], outs[jnp.bfloat16][2])
        # and the decode is actually working at this SNR
        assert outs[None][2].mean() > 0.8

    def test_tree_schedule_rejects_exact_and_int8(self):
        """Constructor gates (r4 advisor): schedule='tree' is inherently a
        fast-leaf approximation and has no int8-qualified path — both
        combos must fail loudly instead of silently substituting."""
        n_len = 256
        frozen = frozen_bits(n_len, 128, 0.0, "BB")
        with pytest.raises(ValueError, match="fast_chunks"):
            LargeSCLDecoder(n_len, frozen, list_size=4, schedule="tree",
                            fast_chunks=False)
        with pytest.raises(ValueError, match="int8"):
            LargeSCLDecoder(n_len, frozen, list_size=4, schedule="tree",
                            dtype=jnp.int8)

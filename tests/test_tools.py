"""Tools-layer tests: GF(2) helpers, 5G rate matching, strategies,
analysis CSV parsing, tree rendering."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from polar_codes_tpu import tools
from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models.encoder import PolarEncoder


class TestCodeTools:
    def test_generator_matrix_matches_butterfly(self, rng):
        from polar_codes_tpu.ops.butterfly import butterfly_transform

        n = 64
        g = tools.polar_generator_matrix(n)
        u = rng.integers(0, 2, (4, n)).astype(np.uint8)
        np.testing.assert_array_equal(
            (u @ g) % 2, np.asarray(butterfly_transform(jnp.asarray(u)))
        )

    def test_systematic_matrix_matches_encoder(self, rng):
        n_len, k_len = 64, 40
        frozen = frozen_bits(n_len, k_len, 0.0)
        g_sys = tools.systematic_encoder_matrix(n_len, frozen)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        u = rng.integers(0, 2, (6, k_len)).astype(np.uint8)
        want = np.asarray(enc.encode(jnp.asarray(u)))
        np.testing.assert_array_equal((u @ g_sys) % 2, want)
        # systematic property: info positions carry u verbatim
        info_pos = tools.info_indices_from_frozen(frozen, n_len)
        np.testing.assert_array_equal(((u @ g_sys) % 2)[:, info_pos], u)

    def test_bit_reverse(self):
        assert tools.bit_reverse(0b001, 3) == 0b100
        vec = tools.bit_reversed_vector(3)
        np.testing.assert_array_equal(vec, [0, 4, 2, 6, 1, 5, 3, 7])


class TestFiveGTools:
    def test_subblock_interleave_is_permutation(self):
        for n in (32, 128, 512):
            y = tools.nr_subblock_interleave(np.arange(n))
            assert sorted(y) == list(range(n))

    def test_rate_match_recover_roundtrip_puncture(self, rng):
        n = 128
        cw = rng.integers(0, 2, n).astype(np.uint8)
        for e_len in (96, 128):
            tx = tools.nr_rate_match(cw, e_len, mode="puncture")
            assert tx.shape[-1] == e_len
            llr = 1.0 - 2.0 * tx.astype(np.float64)
            rec = tools.nr_rate_recover(llr, n, mode="puncture")
            # transmitted positions agree in sign; punctured are neutral 0
            hard = rec < 0
            sent_mask = rec != 0
            np.testing.assert_array_equal(
                hard[sent_mask], cw.astype(bool)[sent_mask]
            )
            assert np.count_nonzero(sent_mask) == min(e_len, n)

    def test_rate_match_repetition_combines(self, rng):
        n = 32
        cw = rng.integers(0, 2, n).astype(np.uint8)
        tx = tools.nr_rate_match(cw, 48)
        assert tx.shape[-1] == 48
        llr = 1.0 - 2.0 * tx.astype(np.float64)
        rec = tools.nr_rate_recover(llr, n)
        hard = (rec < 0).astype(np.uint8)
        np.testing.assert_array_equal(hard, cw)
        # 16 positions were sent twice -> |llr| == 2
        assert np.count_nonzero(np.abs(rec) == 2.0) == 16

    def test_full_nr_chain_end_to_end(self, rng):
        """Whole 5G NR path in one test: 5G construction + CRC11NR +
        non-systematic encode + TS 38.212 rate matching (E < N puncture)
        + AWGN + LLR recovery + CA-SCL-8 decode."""
        import jax
        from polar_codes_tpu.models.scl import SCLDecoder
        from polar_codes_tpu.models.detectors import make_detector
        from polar_codes_tpu.dsp import bpsk_modulate, add_awgn

        n_len, k_len, e_len = 512, 140, 400
        det = make_detector(11, "crc")  # CRC11NR
        frozen = frozen_bits(n_len, k_len, 0.0, "5G")
        enc = PolarEncoder(n_len, frozen, systematic=False, detector=det)
        dec = SCLDecoder(n_len, frozen, list_size=8, systematic=False,
                         detector=det)
        info = rng.integers(0, 2, (256, k_len)).astype(np.uint8)
        sent = np.asarray(det.generate(jnp.asarray(info)))
        cw = np.asarray(enc.encode(jnp.asarray(info)))
        tx = tools.nr_rate_match(cw, e_len, mode="puncture")
        # noiseless round-trip through recover + decode is exact
        clean = tools.nr_rate_recover(
            100.0 * (1.0 - 2.0 * tx.astype(np.float64)), n_len,
            mode="puncture")
        d0, _, ok0 = dec.decode(jnp.asarray(clean, jnp.float32))
        np.testing.assert_array_equal(np.asarray(d0), sent)
        assert bool(np.asarray(ok0).all())
        # 3 dB Eb/N0 (referenced to the E transmitted bits): BLER well
        # under 10% and no missed detections (measured ~0 at this point)
        esn0 = 10.0 ** 0.3 * k_len / e_len
        y = add_awgn(jax.random.PRNGKey(9), bpsk_modulate(jnp.asarray(tx)),
                     esn0_linear=esn0)
        llr = tools.nr_rate_recover(np.asarray(y, np.float64), n_len,
                                    mode="puncture")
        d, _, ok = dec.decode(jnp.asarray(llr, jnp.float32))
        err = np.any(np.asarray(d) != sent, axis=1)
        assert err.mean() < 0.1
        assert not bool((np.asarray(ok) & err).any())


class TestStrategies:
    def test_factory_matches_construction(self):
        for kind in ("BB", "BE", "GA", "5G"):
            gen = tools.get_frozen_bit_generator(kind, 128, 64, 1.0)
            fb = gen.frozen_bit_positions()
            assert fb.size == 64
            assert gen.info_bit_positions().size == 64
            assert np.intersect1d(fb, gen.info_bit_positions()).size == 0

    def test_bb_agrees_with_frozen_bits(self):
        gen = tools.get_frozen_bit_generator("BB", 256, 100, 2.0)
        np.testing.assert_array_equal(
            gen.frozen_bit_positions(), frozen_bits(256, 100, 2.0, "BB")
        )


class TestAnalysis:
    def test_csv_roundtrip(self, tmp_path):
        from polar_codes_tpu.sim.montecarlo import JobResult, write_csv

        jobs = [
            JobResult(N=128, K=64, designSNR=0.0, errorDetection=8, L=4,
                      EbN0=e, BLER=0.1 / (i + 1), BER=0.01, RER=0.05,
                      runs=1000, errors=17)
            for i, e in enumerate((1.0, 2.0, 3.0))
        ]
        path = os.path.join(tmp_path, "t_single.csv")
        write_csv(path, jobs)
        rows = tools.read_results_csv(path)
        assert len(rows) == 3
        curves = tools.summarize_results(rows)
        (key,) = curves.keys()
        np.testing.assert_allclose(curves[key]["ebn0"], [1.0, 2.0, 3.0])
        assert curves[key]["bler"][0] == pytest.approx(0.1)

    def test_merge_results_weights_by_runs(self, tmp_path):
        from polar_codes_tpu.sim.montecarlo import JobResult, write_csv

        a = os.path.join(tmp_path, "a_single.csv")
        b = os.path.join(tmp_path, "b_single.csv")
        write_csv(a, [JobResult(N=128, K=64, designSNR=0, errorDetection=8,
                                L=4, EbN0=2.0, BLER=0.1, runs=1000,
                                errors=100)])
        write_csv(b, [JobResult(N=128, K=64, designSNR=0, errorDetection=8,
                                L=4, EbN0=2.0, BLER=0.4, runs=3000,
                                errors=1200)])
        merged = tools.merge_results([tools.read_results_csv(a),
                                      tools.read_results_csv(b)])
        assert len(merged) == 1
        # counts-weighted: (0.1*1000 + 0.4*3000) / 4000
        assert merged[0]["BLER"] == pytest.approx(0.325)
        assert merged[0]["Runs"] == 4000

    def test_parse_bench_name(self):
        got = tools.parse_bench_name("cascl_char_n1024_l8_crc0")
        assert got == {"family": "cascl", "dtype": "char", "N": 1024,
                       "L": 8, "variant": "crc0"}
        got = tools.parse_bench_name("encode_n131072_crc16")
        assert got == {"family": "encode", "dtype": "float", "N": 131072,
                       "variant": "crc16"}

    def test_grid_jsonl_load_compare(self, tmp_path):
        import json as _json

        path_a = os.path.join(tmp_path, "a.jsonl")
        path_b = os.path.join(tmp_path, "b.jsonl")
        rows_a = [dict(bench="cascl_char_n1024_l8", N=1024, K=512,
                       info_thr_mbps=800.0),
                  dict(bench="flaky_row", error="boom"),
                  dict(bench="flaky_row", N=64, K=32,
                       info_thr_mbps=5.0)]
        rows_b = [dict(bench="cascl_char_n1024_l8", N=1024, K=512,
                       info_thr_mbps=1200.0)]
        with open(path_a, "w") as fh:
            fh.write("\n".join(_json.dumps(r) for r in rows_a))
        with open(path_b, "w") as fh:
            fh.write("\n".join(_json.dumps(r) for r in rows_b))
        loaded_a = tools.load_benchmark_jsonl(path_a)
        # the measured retry must win over the earlier error row
        flaky = [r for r in loaded_a if r["bench"] == "flaky_row"][0]
        assert "error" not in flaky
        recs = tools.compare_grids(loaded_a,
                                   tools.load_benchmark_jsonl(path_b))
        assert len(recs) == 1
        assert recs[0]["ratio"] == pytest.approx(1.5)

    def test_overlay_figure_renders(self, tmp_path):
        from polar_codes_tpu.sim.montecarlo import JobResult, write_csv

        a = os.path.join(tmp_path, "a_single.csv")
        write_csv(a, [JobResult(N=128, K=64, designSNR=0, errorDetection=8,
                                L=4, EbN0=e, BLER=0.1 / (i + 1), runs=100)
                      for i, e in enumerate((1.0, 2.0))])
        out = os.path.join(tmp_path, "f.png")
        rows = tools.read_results_csv(a)
        tools.plot_bler_overlay(rows, rows, path=out)
        assert os.path.getsize(out) > 0

    def test_zero_rates_floored(self, tmp_path):
        from polar_codes_tpu.sim.montecarlo import JobResult, write_csv

        path = os.path.join(tmp_path, "z_single.csv")
        write_csv(path, [JobResult(N=64, K=32, designSNR=0, errorDetection=0,
                                   L=1, EbN0=5.0)])
        text = open(path).read()
        assert "1e-99" in text  # pcsim zero-rate floor (simulator.cpp:541)


class TestVisualize:
    def test_text_render(self):
        txt = tools.render_tree_text(64, 32, 0.0)
        assert "[0:64]" in txt
        assert any(k in txt for k in ("rep", "spc", "rate0", "rate1"))

    def test_figure_render(self, tmp_path):
        pytest.importorskip("matplotlib")
        out = os.path.join(tmp_path, "tree.png")
        tools.render_tree_figure(128, 64, 0.0, path=out)
        assert os.path.getsize(out) > 1000


class TestCheckpoint:
    def test_resume_reproduces_uninterrupted_run(self, tmp_path, rng):
        """A job interrupted mid-sweep and resumed must produce exactly the
        counters of an uninterrupted run (deterministic PRNG streams)."""
        import jax
        from polar_codes_tpu.models.fastssc import FastSSCDecoder
        from polar_codes_tpu.sim.montecarlo import MonteCarlo
        from polar_codes_tpu.sim.checkpoint import SweepCheckpoint

        n_len, k_len = 64, 32
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        mc = MonteCarlo(enc, dec, batch=64)
        key = jax.random.PRNGKey(3)

        ref = mc.run_job(1.0, 64 * 4, key=key, warmup=False)

        path = str(tmp_path / "ckpt.npz")
        cp1 = SweepCheckpoint(path)
        # simulate interruption: run only 2 of 4 chunks by lying about blocks
        mc.run_job(1.0, 64 * 2, key=key, warmup=False, checkpoint=cp1,
                   job_id="job")
        st = cp1.job_state("job")
        assert st["chunks_done"] == 2
        # the 2-chunk job wrote its completion marker; wipe it to emulate a
        # crash after chunk 2 of the real 4-chunk job
        st.pop("complete", None)
        st.pop("result", None)
        cp1.update("job", st)

        cp2 = SweepCheckpoint(path)
        resumed = cp2.job_state("job")
        assert resumed["chunks_done"] == 2
        got = mc.run_job(1.0, 64 * 4, key=key, warmup=False, checkpoint=cp2,
                         job_id="job")
        assert got.runs == ref.runs
        assert got.errors == ref.errors
        assert got.biterrors == ref.biterrors
        # completed job short-circuits on the next call
        again = mc.run_job(1.0, 64 * 4, key=key, warmup=False,
                           checkpoint=cp2, job_id="job")
        assert again.errors == got.errors


class TestRayleighChannel:
    def test_rayleigh_montecarlo_degrades_vs_awgn(self, rng):
        """Rayleigh fading at the same Es/N0 must cost BLER vs AWGN
        (reference rayleigh.cpp physics through the MC chain)."""
        import jax
        from polar_codes_tpu.models.fastssc import FastSSCDecoder
        from polar_codes_tpu.sim.montecarlo import MonteCarlo

        n_len, k_len = 128, 64
        frozen = frozen_bits(n_len, k_len, 0.0)
        enc = PolarEncoder(n_len, frozen, systematic=True)
        dec = FastSSCDecoder(n_len, frozen, systematic=True)
        key = jax.random.PRNGKey(4)
        awgn = MonteCarlo(enc, dec, batch=512, channel="awgn")
        ray = MonteCarlo(enc, dec, batch=512, channel="rayleigh")
        r_a = awgn.run_job(4.0, 1024, key=key, warmup=False)
        r_r = ray.run_job(4.0, 1024, key=key, warmup=False)
        assert r_r.BLER > r_a.BLER  # fading hurts at the same SNR
        assert r_a.BLER < 0.2


class TestReport:
    def test_html_report_from_csv_and_jsonl(self, tmp_path):
        """End-to-end HTML report over a sim CSV + a benchmark JSONL
        (reference analyze/plot scripts replacement, tools/report.py)."""
        import json

        from polar_codes_tpu.sim.montecarlo import JobResult, write_csv
        from polar_codes_tpu.tools.report import render_report

        jobs = [
            JobResult(N=128, K=64, designSNR=0.0, errorDetection=8, L=4,
                      EbN0=e, BLER=0.1 / 10 ** i, BER=0.01 / 10 ** i,
                      RER=0.05, runs=1000, errors=17)
            for i, e in enumerate((1.0, 2.0, 3.0))
        ]
        csv_path = os.path.join(tmp_path, "r_single.csv")
        write_csv(csv_path, jobs)
        bench_path = os.path.join(tmp_path, "bench.jsonl")
        with open(bench_path, "w") as fh:
            for n_len, secs in ((1024, 1e-3), (4096, 5e-3)):
                fh.write(json.dumps(dict(
                    bench=f"cascl_float_n{n_len}_l8", N=n_len,
                    K=n_len // 2, C=16, L=8, dtype="float", batch=1024,
                    platform="cpu", seconds_per_batch=secs,
                    code_thr_mbps=1024 * n_len / secs / 1e6,
                    info_thr_mbps=512 * n_len / secs / 1e6,
                    blocks_per_s=1024 / secs)) + "\n")
        out = os.path.join(tmp_path, "report.html")
        render_report([csv_path, bench_path], out)
        doc = open(out).read()
        assert doc.count("<svg") == 3  # BLER + BER lines, cascl bars
        assert "cascl_float_n1024_l8" in doc
        assert "NaN" not in doc
        # hover metadata on the line charts parses and is aligned
        import html as _html
        import re

        metas = re.findall(r"data-chart='([^']*)'", doc)
        assert len(metas) == 2
        for meta in metas:
            d = json.loads(_html.unescape(meta))
            assert len(d["xs"]) == len(d["xlabels"]) == 3
            for s in d["series"]:
                assert len(s["values"]) == 3
        # table view keeps every row reachable without hover
        assert doc.count("<table") == 2

"""Device peaks, the compile-cache helper and the benchmark grid's rows."""

import os

import jax
import pytest

from polar_codes_tpu.sim import benchmark
from polar_codes_tpu.utils import cache, profiling


class _Device:
    def __init__(self, platform, device_kind):
        self.platform, self.device_kind = platform, device_kind


H100 = _Device("gpu", "NVIDIA H100 80GB HBM3")


class TestPeaks:
    def test_known_kind(self):
        peak = profiling.device_peaks(H100)
        assert peak["bf16_flops_per_s"] == 989e12
        assert peak["f32_flops_per_s"] == 67e12
        assert peak["hbm_bytes_per_s"] == 3.35e12
        assert "data sheet" in peak["source"]

    def test_unknown_gpu_raises(self):
        with pytest.raises(ValueError, match="no published peaks"):
            profiling.device_peaks(_Device("gpu", "Some Other GPU"))

    def test_cpu_has_no_roofline(self):
        assert profiling.device_peaks(jax.devices("cpu")[0]) is None
        out = profiling.derive_roofline(1e9, 1e8, seconds=1e-3)
        assert "mfu" not in out and "bound" not in out
        assert out["achieved_flops_per_s"] == pytest.approx(1e12)

    def test_roofline_on_known_gpu(self):
        out = profiling.derive_roofline(67e9, 3.35e9, seconds=1e-3,
                                        device=H100)
        assert out["mfu"] == pytest.approx(1.0)
        assert out["hbm_util"] == pytest.approx(1.0)
        assert out["bound"] == "compute"  # 20 flop/B is the f32 ridge
        assert profiling.derive_roofline(1.0, 1.0, device=H100)[
            "bound"] == "memory"


class TestCompileCache:
    def test_environment_variable_wins(self, monkeypatch):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
        before = jax.config.jax_compilation_cache_dir
        assert cache.enable_compile_cache() == "/some/where"
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_inside_the_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = cache.enable_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert got == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestGridRows:
    @pytest.mark.parametrize("quick", [True, False])
    def test_no_kernel_rows_and_unique_names(self, quick):
        rows = benchmark.enumerate_rows(quick)
        names = [r["bench"] for r in rows]
        assert len(names) == len(set(names))
        assert not any("pallas" in n for n in names)
        assert {r["dtype"] for r in rows} <= {"float", "char"}

    def test_batch_budget_is_not_clamped(self):
        assert benchmark.bits_budget_batch(64) == (1 << 21) // 64
        assert benchmark.bits_budget_batch(131072) == 16


class TestTraceSummary:
    def test_union_of_intervals(self):
        assert profiling._union_ns([(0, 10), (5, 15), (20, 25)]) == 20
        assert profiling._union_ns([(3, 4), (0, 10)]) == 10
        assert profiling._union_ns([]) == 0

    def test_window_from_a_recorded_trace(self, tmp_path):
        fn = jax.jit(lambda x: (x @ x.T).sum())
        x = jax.numpy.ones((64, 64))
        fn(x).block_until_ready()
        with profiling.device_trace(str(tmp_path)):
            with profiling.annotate("test_window"):
                for _ in range(3):
                    fn(x).block_until_ready()
        out = profiling.trace_summary(str(tmp_path), "test_window")
        assert out["window_ns"] > 0
        for dev in out["devices"].values():
            assert 0.0 <= dev["busy_share"] <= 1.0
        with pytest.raises(ValueError, match="no host span"):
            profiling.trace_summary(str(tmp_path), "absent_window")

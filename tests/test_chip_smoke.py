"""chip_smoke.py's phases at tiny sizes on the CPU, and its device guard.

On the card the script compares the GPU against the CPU; here both sides
are the CPU, which checks the phases' plumbing, shapes and comparisons.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

CPU = jax.devices("cpu")[0]


def test_device_guard_fails_without_gpu(capsys):
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.phase_device()
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_near_ties():
    metrics = np.array([[-5.0, -5.00001, -9.0],
                        [-5.0, -6.0, -7.0],
                        [-5.0, -5.0, -1.0],
                        [-3.0, -3.0, -3.0]])
    ok = np.array([[True, True, False],
                   [True, True, True],
                   [True, False, True],
                   [True, False, False]])
    np.testing.assert_array_equal(cs.near_ties(metrics, ok),
                                  [True, False, False, False])


def test_flagship_phase():
    out = cs.phase_flagship(CPU, CPU, n=64, k=32, list_size=4, batch=64,
                            bler_band=(0.0, 1.0), reps=2)
    assert out["unexplained"] == 0 and out["mismatches"] == 0
    assert out["steady_s"] > 0 and 0.0 <= out["bler"] <= 1.0


def test_flagship_phase_rejects_bler_outside_band():
    with pytest.raises(cs.SmokeError, match="BLER"):
        cs.phase_flagship(CPU, CPU, n=64, k=32, list_size=2, batch=32,
                          bler_band=(0.9, 1.0), reps=1)


def test_simulator_phase():
    out = cs.phase_simulator(n=64, batch=32, workload=64 * 70,
                             bler_band=(0.0, 1.0))
    assert out["runs"] == out["want_runs"] == 96


def test_fastssc_check():
    out = cs.check_fastssc(CPU, CPU, n=64, batch=16, reps=1)
    assert set(out) == {"float", "int8"}


def test_scan_check():
    out = cs.check_scan(CPU, CPU, n=64, batch=16, reps=1)
    assert out["mismatched_elements"] == 0


def test_scflip_check():
    out = cs.check_scflip(CPU, CPU, n=64, batch=8, reps=1)
    assert out["mismatched_elements"] == 0


def test_large_check():
    out = cs.check_large(CPU, CPU, n=64, batch=4, reps=1, chunk=8)
    assert set(out) == {"sc", "scl8"}


def test_encoder_check():
    out = cs.check_encoder(CPU, CPU, n=64, batch=8, reps=1)
    assert set(out) == {"kron", "stages"}


def test_crc_cmac_check():
    assert cs.check_crc_cmac(CPU, k=64, batch=8, n_tags=4)["ok"]


def test_four_device_step():
    """The --four comparison on four of the test session's virtual CPU
    devices: psum totals, per-shard counters against 1-device runs."""
    out = cs.phase_four(n=64, batch=8, chunks=1)
    assert out["total"]["runs"] == 32
    assert out["walls"]["4"]["runs"] == 32


def test_result_line_format(capsys, monkeypatch):
    """The last line is the one JSON object the contract names."""
    class FakeGpu:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(cs, "phase_device", lambda: (FakeGpu(), ""))
    monkeypatch.setattr(cs, "phase_four", lambda: {})
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()] * 4)
    assert cs.main(["--four"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_flagship_phase_with_trace(tmp_path):
    out = cs.phase_flagship(CPU, CPU, n=64, k=32, list_size=2, batch=16,
                            bler_band=(0.0, 1.0), reps=1,
                            trace_dir=str(tmp_path))
    assert out["unexplained"] == 0
    assert list(tmp_path.rglob("*.xplane.pb"))

"""Multi-host (2-process) data parallelism test.

The reference has no distributed backend (SURVEY.md section 2.10); the
replacement here is a process-spanning mesh. Real clusters are not
available in CI, so this spawns TWO separate processes, each with 4 virtual
CPU devices, wires them with jax.distributed, builds the global 8-device
mesh, and runs one mesh-sharded Monte-Carlo counter step — validating the
exact code path (init_distributed / default_mesh / distribute_keys /
sharded_counter_step / host_aggregate) a 2-host cluster would execute, with
psum crossing the process boundary.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import jax

jax.config.update("jax_platforms", "cpu")
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from polar_codes_tpu.parallel import (
    default_mesh,
    host_aggregate,
    init_distributed,
)

init_distributed(
    coordinator_address=f"localhost:{port}", num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 4 * nproc, jax.device_count()
assert jax.local_device_count() == 4, jax.local_device_count()

from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models.encoder import PolarEncoder
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.detectors import CRC8
from polar_codes_tpu.sim.montecarlo import MonteCarlo

n_len, k_len, batch = 64, 40, 16
frozen = frozen_bits(n_len, k_len, 0.0, "BB")
det = CRC8()
enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
dec = FastSSCDecoder(n_len, frozen, systematic=True, detector=det)
mesh = default_mesh()  # global: spans both processes
assert mesh.devices.size == 4 * nproc

mc = MonteCarlo(enc, dec, batch=batch, mesh=mesh)
esn0 = mc.esn0_linear(2.0)
keys = mc._mesh_keys(jax.random.PRNGKey(7))
out = jax.block_until_ready(mc._fused(keys, esn0))
agg = host_aggregate({k: v for k, v in out.items()})
runs = int(agg["runs"])
expect = batch * mesh.devices.size
assert runs == expect, f"psum runs={runs}, expected {expect}"
print(f"MULTIHOST_OK proc={pid} runs={runs}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", ""
        )
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=560)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out[-2000:]}\n{err[-2000:]}"
        assert "MULTIHOST_OK" in out

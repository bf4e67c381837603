"""Run the reference's own qa_pypolar_* unittest suites against this repo's
pypolar, unmodified — the primary drop-in conformance gate (SURVEY §7.10).

Each suite is executed in a subprocess with PYTHONPATH set so that
`import pypolar` resolves to /root/repo/pypolar while the suites' NumPy
helper fixtures (polar_code_tools, channel_construction, ...) come from
/root/reference/python. Skipped when the reference checkout is absent.

Reference suites: /root/reference/python/qa_pypolar_{encoder,decoder,
detector,puncturer}.py (python/CMakeLists.txt:21-24 registers the same
four with CTest).
"""

import os
import subprocess
import sys

import pytest

REFERENCE_PY = "/root/reference/python"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUITES = [
    "qa_pypolar_encoder.py",
    "qa_pypolar_detector.py",
    "qa_pypolar_puncturer.py",
    "qa_pypolar_decoder.py",
]

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_PY),
    reason="reference checkout not available",
)


@pytest.mark.parametrize("suite", SUITES)
def test_reference_qa_suite(suite):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT, REFERENCE_PY, env.get("PYTHONPATH", "")]
    )
    # The suites only need the CPU: pin the platform both through the
    # environment and with jax.config.update as the first user statement,
    # so the child never claims an accelerator.
    env["JAX_PLATFORMS"] = "cpu"
    path = os.path.join(REFERENCE_PY, suite)
    wrapper = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys, runpy; sys.argv = [sys.argv[1]]; "
        "runpy.run_path(sys.argv[0], run_name='__main__')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", wrapper, path],
        env=env,
        cwd="/tmp",
        capture_output=True,
        text=True,
        timeout=1800,
    )
    assert proc.returncode == 0, (
        f"{suite} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"
    )

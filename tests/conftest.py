"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware via
xla_force_host_platform_device_count, the JAX analogue of the reference's
single-machine CTest strategy (SURVEY.md section 4). Tests marked `gpu`
need an NVIDIA GPU: they take the `gpu_device` fixture, which skips them
here (the decision is made inside the fixture, never at import time), and
run with `JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu` on a GPU
host.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# CPU unless the caller names an accelerator platform explicitly
# (JAX_PLATFORMS=cuda,cpu for the gpu-marked tests)
_ACCELERATOR_RUN = os.environ.get("JAX_PLATFORMS", "cpu") not in ("", "cpu")
if not _ACCELERATOR_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not _ACCELERATOR_RUN:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu, -m gpu)")
    return device


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running configuration test")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")

"""Decoders on an NVIDIA GPU against the same code on the CPU.

Skips where JAX has no GPU. On a GPU host:
    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polar_codes_tpu.construction import frozen_bits
from polar_codes_tpu.models.detectors import CRC16
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.scl import SCLDecoder

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("list_size", [1, 8])
def test_decode_matches_cpu(gpu_device, list_size):
    n_len, k_len = 1024, 512
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    dec = (SCLDecoder(n_len, frozen, list_size=list_size, detector=CRC16())
           if list_size > 1 else FastSSCDecoder(n_len, frozen,
                                                detector=CRC16()))
    llr = np.random.default_rng(0).normal(1.0, 1.2, (256, n_len))
    llr = llr.astype(np.float32)
    fn = jax.jit(dec.decode)
    got = fn(jax.device_put(jnp.asarray(llr), gpu_device))
    want = fn(jax.device_put(jnp.asarray(llr), jax.devices("cpu")[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

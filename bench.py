"""Headline benchmark: decoded info throughput of CA-SCL-8, N=1024, K=512.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mbit/s", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N}

The metric is decode-only throughput (payload bits per second of wall time
spent in the jitted SCL decode stage), matching the reference pcsim's
decode-timing semantics (simulator.cpp:920-936, cbps/pbps derivation
:967-982). Baseline = the reference C++ library's aggregate number measured
on a CPU host (BASELINE.json "published"); see BASELINE.md for the protocol.
"""

import json
import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from polar_codes_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from polar_codes_tpu.construction import frozen_bits
    from polar_codes_tpu.models.encoder import PolarEncoder
    from polar_codes_tpu.models.scl import SCLDecoder
    from polar_codes_tpu.models.detectors import CRC16
    from polar_codes_tpu.dsp import bpsk_modulate, add_awgn

    n_len, k_len, list_size = 1024, 512, 8
    ebn0_db = 2.0
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(n_len, frozen, systematic=True, detector=det)
    dec = SCLDecoder(
        n_len, frozen, list_size=list_size, systematic=True, detector=det,
    )

    # realistic noisy input at the 2 dB operating point
    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (batch, k_len)).astype(np.uint8)
    code = enc.encode(jnp.asarray(info))
    esn0 = 10.0 ** (ebn0_db / 10.0) * k_len / n_len
    llr = add_awgn(jax.random.PRNGKey(1), bpsk_modulate(code), esn0_linear=esn0)
    llr = jax.device_put(llr)

    # Timing: chained decodes inside jitted fori_loops, slope-differenced
    # to cancel the fixed per-call dispatch cost (utils/timing.py).
    from polar_codes_tpu.utils.timing import time_device_fn

    reps = int(os.environ.get("BENCH_REPS", "8"))
    best = time_device_fn(lambda x: dec.decode(x), llr, reps=reps)

    payload_bits = batch * (k_len - det.tail_bits)
    mbps = payload_bits / best / 1e6

    baseline = None
    try:
        with open("BASELINE.json") as f:
            baseline = json.load(f).get("published", {}).get(
                "ref_payload_mbps_cascl8_n1024"
            )
    except Exception:
        pass
    vs = mbps / baseline if baseline else 0.0
    device = jax.devices()[0]

    print(
        json.dumps(
            {
                "metric": "decoded_payload_throughput_cascl8_n1024_crc16",
                "value": round(mbps, 2),
                "unit": "Mbit/s",
                "vs_baseline": round(vs, 2),
                "platform": device.platform,
                "device_kind": device.device_kind,
                "device_count": len(jax.devices()),
            }
        )
    )


if __name__ == "__main__":
    main()

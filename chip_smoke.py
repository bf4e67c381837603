#!/usr/bin/env python3
"""Smoke test of the polar-code pipeline on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at full
width, on the GPU, and compares every result with the same code jitted on
the CPU (the repository's plain path):

  (a) device   the first JAX device must be a GPU; prints its kind and the
               card's name and power limit from nvidia-smi
  (b) flagship CA-SCL-8, N=1024, K=512, CRC16, systematic, BB at 0 dB:
               encode, BPSK, AWGN at Eb/N0 = 2 dB, decode of 4096 blocks;
               compile time, memory, steady decode time, BLER, and
               block-by-block agreement with the CPU decode
  (c) sim      the simulator CLI (`sim.cli.main`), about 10 batches of 1024
               through MonteCarlo with the default adaptive decoder
  (d) families Fast-SSC float/int8, SCAN-4, SCFlip, LargeSC and LargeSCL at
               N=32768, the encoder's two paths at N=1024 and 131072, CRC
               and native CMAC tags

    python chip_smoke.py                  # one GPU, phases (a)-(d)
    python chip_smoke.py --four           # the 4-GPU data-parallel
                                          # Monte-Carlo step only
    python chip_smoke.py --trace DIR      # also trace 3 flagship decodes

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}; a
failing phase raises, prints no such line and exits non-zero.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FLAGSHIP = dict(n=1024, k=512, list_size=8, ebn0_db=2.0, batch=4096)
BLER_BAND = (1e-4, 2e-2)
NEAR_TIE_RTOL = 1e-5
NEAR_TIE_MAX_SHARE = 1e-3


class SmokeError(RuntimeError):
    """A phase found a wrong result."""


def _check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def _import_repo():
    if not (ROOT / "polar_codes_tpu").is_dir():
        raise SmokeError(
            f"{ROOT} holds no polar_codes_tpu package: run chip_smoke.py "
            "from a checkout of the repository"
        )
    sys.path.insert(0, str(ROOT))


def _median_seconds(fn, *args, reps=20):
    """Median host-clock seconds of fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _compile(fn, *args):
    """(compiled executable, compile seconds) for args already placed on
    their device."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _compile_pair(fn, x, ref_fn, ref_x):
    """Compile fn(x) and ref_fn(ref_x) concurrently (XLA compiles outside
    the interpreter lock): (compiled, seconds, ref compiled, ref seconds)."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        ref_future = pool.submit(_compile, ref_fn, ref_x)
        compiled, compile_s = _compile(fn, x)
        ref_compiled, ref_compile_s = ref_future.result()
    return compiled, compile_s, ref_compiled, ref_compile_s


def _on(device, *arrays):
    import jax

    out = tuple(jax.device_put(a, device) for a in arrays)
    return out if len(out) > 1 else out[0]


def _flagship_code(n, k):
    from polar_codes_tpu.construction import frozen_bits
    from polar_codes_tpu.models.detectors import CRC16

    return frozen_bits(n, k, 0.0, "BB"), CRC16()


def _with_crc(det, info):
    """Host-side checksum fill of every row of info [B, K]."""
    import numpy as np

    return np.stack([det.generate_np(row) for row in info])


def _noisy_llr(enc, batch, ebn0_db, seed, device):
    """(sent info bits with CRC [B, K] np, channel LLRs [B, N] np): random
    payloads, encode, BPSK and AWGN computed on `device`."""
    import jax
    import numpy as np

    from polar_codes_tpu.dsp import add_awgn, bpsk_modulate

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (batch, enc.info_length)).astype(np.uint8)
    sent = _with_crc(enc.detector, info)
    esn0 = 10.0 ** (ebn0_db / 10.0) * enc.info_length / enc.block_length

    def channel(bits, key):
        return add_awgn(key, bpsk_modulate(enc.encode(bits)),
                        esn0_linear=esn0)

    bits, key = _on(device, info, jax.random.PRNGKey(seed))
    llr = jax.jit(channel)(bits, key)
    return sent, np.asarray(llr)


# ---- (a) device -------------------------------------------------------------


def phase_device():
    """The first JAX device, which must be a GPU, and the nvidia-smi line."""
    import jax

    device = jax.devices()[0]
    _check(
        device.platform == "gpu",
        f"no GPU: JAX's first device is {device.platform} "
        f"({device.device_kind})",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[a] device_kind={device.device_kind} "
          f"count={len(jax.devices())}")
    print(f"[a] nvidia-smi name,power.limit: {smi}")
    return device, smi


# ---- (b) flagship CA-SCL-8 --------------------------------------------------


def near_ties(metrics, ok_paths, rtol=NEAR_TIE_RTOL):
    """[B] bool: the two best CRC-passing path metrics lie within rtol
    (relative) of each other, so a different summation order may pick
    either path."""
    import numpy as np

    score = np.where(ok_paths, metrics, -np.inf)
    top2 = -np.sort(-score, axis=-1)[:, :2]
    both = np.isfinite(top2).all(axis=-1)
    top2 = np.where(both[:, None], top2, 0.0)
    gap = np.abs(top2[:, 0] - top2[:, 1])
    scale = np.maximum(np.abs(top2[:, 0]), 1e-30)
    return both & (gap <= rtol * scale)


def phase_flagship(device, ref_device, n=FLAGSHIP["n"], k=FLAGSHIP["k"],
                   list_size=FLAGSHIP["list_size"],
                   ebn0_db=FLAGSHIP["ebn0_db"], batch=FLAGSHIP["batch"],
                   bler_band=BLER_BAND, reps=20, seed=1, trace_dir=""):
    """CA-SCL decode on `device` against the same decoder on `ref_device`.

    With trace_dir, also a profiler trace of 3 steady decodes: device
    events per call and the device's busy share over the window."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from polar_codes_tpu.models.encoder import PolarEncoder
    from polar_codes_tpu.models.scl import SCLDecoder

    frozen, det = _flagship_code(n, k)
    enc = PolarEncoder(n, frozen, systematic=True, detector=det)
    dec = SCLDecoder(n, frozen, list_size=list_size, systematic=True,
                     detector=det)
    sent, llr_np = _noisy_llr(enc, batch, ebn0_db, seed, device)

    def reference(x):
        info_r, _, ok_r = dec.decode(x)
        cw, metrics, active = dec.decode_paths(x)
        ok_paths = det.check(cw[..., jnp.asarray(dec.info_pos)]) & active
        return info_r, ok_r, metrics, ok_paths

    llr, llr_ref = _on(device, llr_np), _on(ref_device, llr_np)
    compiled, compile_s, ref_fn, ref_compile_s = _compile_pair(
        dec.decode, llr, reference, llr_ref)
    mem = compiled.memory_analysis()
    info, _, ok = compiled(llr)
    info, ok = np.asarray(info), np.asarray(ok)
    steady_s = _median_seconds(compiled, llr, reps=reps)
    stats = device.memory_stats() or {}
    info_r, ok_r, metrics_r, ok_paths_r = (
        np.asarray(a) for a in ref_fn(llr_ref)
    )

    ties = near_ties(metrics_r, ok_paths_r)
    differ = np.any(info != info_r, axis=-1) | (ok != ok_r)
    bler = float(np.mean(np.any(info != sent, axis=-1)))
    out = dict(
        batch=batch, compile_s=compile_s, ref_compile_s=ref_compile_s,
        steady_s=steady_s, payload_mbps=batch * (k - det.tail_bits)
        / steady_s / 1e6, bler=bler, near_ties=int(ties.sum()),
        mismatches=int(differ.sum()),
        unexplained=int((differ & ~ties).sum()),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        memory_analysis=str(mem),
    )
    print(f"[b] flagship CA-SCL-{list_size} N={n} K={k} CRC16 "
          f"Eb/N0={ebn0_db} dB batch={batch}: " + json.dumps(out))
    if trace_dir:
        from polar_codes_tpu.utils.profiling import (
            annotate, device_trace, trace_summary,
        )

        calls = 3
        with device_trace(trace_dir):
            with annotate("flagship_decode_window"):
                for _ in range(calls):
                    jax.block_until_ready(compiled(llr))
        summary = trace_summary(trace_dir, "flagship_decode_window")
        for dev in summary["devices"].values():
            dev["events_per_call"] = dev["events"] / calls
        print("[trace] " + json.dumps(summary))
    _check(out["unexplained"] == 0,
           f"{out['unexplained']} blocks differ from the CPU decode "
           "outside near-ties")
    _check(out["near_ties"] <= NEAR_TIE_MAX_SHARE * batch,
           f"{out['near_ties']} near-tie blocks exceed "
           f"{NEAR_TIE_MAX_SHARE:.1%} of {batch}")
    _check(bler_band[0] <= bler <= bler_band[1],
           f"BLER {bler} outside {bler_band}")
    return out


# ---- (c) simulator CLI ------------------------------------------------------


def phase_simulator(n=1024, batch=1024, workload=1e7, bler_band=BLER_BAND):
    """The CLI's `single` job in-process; checks its pcsim-schema CSV row."""
    from polar_codes_tpu.sim import cli

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "smoke")
        argv = ["single", "-n", str(n), "-r", "0.5", "-l", "8",
                "-e", "crc16", "--snr-min", "2", "--snr-max", "2",
                "--snr-count", "1", "-w", repr(workload),
                "--batch", str(batch), "-o", prefix]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall_s = time.perf_counter() - t0
        with open(prefix + "_single.csv") as fh:
            rows = list(csv.reader(fh))
    _check(rc == 0, f"cli.main returned {rc}")
    _check(len(rows) == 2, f"expected header + 1 row, got {len(rows)}")
    header, row = rows
    _check(len(header) == 23 and len(row) == 23,
           f"CSV has {len(header)}/{len(row)} columns, expected 23")
    rec = dict(zip(header, row))
    blocks = max(1, int(workload // n))
    want_runs = math.ceil(blocks / batch) * batch
    runs, bler = int(rec["Runs"]), float(rec["BLER"])
    out = dict(runs=runs, want_runs=want_runs, bler=bler, wall_s=wall_s,
               payload_bitrate=float(rec["Payload Bitrate"]))
    print("[c] simulator: " + json.dumps(out))
    _check(runs == want_runs, f"runs {runs} != {want_runs}")
    _check(bler_band[0] <= bler <= bler_band[1],
           f"simulator BLER {bler} outside {bler_band}")
    return out


# ---- (d) every other family -------------------------------------------------


def _compare_family(name, build_fn, llr_np, device, ref_device, reps,
                    soft_atol=None):
    """Run fn on both devices from the same input; outputs must agree
    bit for bit (float outputs within soft_atol when given)."""
    import jax
    import numpy as np

    fn = build_fn()
    x, x_ref = _on(device, llr_np), _on(ref_device, llr_np)
    compiled, compile_s, ref_fn, _ = _compile_pair(fn, x, fn, x_ref)
    got = jax.tree.leaves(compiled(x))
    want = jax.tree.leaves(ref_fn(x_ref))
    mismatched = 0
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        _check(g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}")
        if soft_atol is not None and np.issubdtype(g.dtype, np.floating):
            close = np.isclose(g, w, rtol=0.0, atol=soft_atol)
            close |= (g == w)  # equal infinities
            mismatched += int((~close).sum())
        else:
            mismatched += int((g != w).sum())
    steady_s = _median_seconds(compiled, x, reps=reps)
    out = dict(compile_s=compile_s, steady_s=steady_s,
               batch=llr_np.shape[0], mismatched_elements=mismatched)
    print(f"[d] {name}: " + json.dumps(out))
    _check(mismatched == 0, f"{name}: {mismatched} elements differ from "
                            "the CPU path")
    return out


def _family_input(n, batch, seed, device):
    """(decoder-side code tuple, noisy float LLRs [B, N]) at Eb/N0 = 2 dB
    for the BB rate-1/2 CRC16 code of length n."""
    from polar_codes_tpu.models.encoder import PolarEncoder

    frozen, det = _flagship_code(n, n // 2)
    enc = PolarEncoder(n, frozen, systematic=True, detector=det)
    _, llr = _noisy_llr(enc, batch, 2.0, seed, device)
    return frozen, det, llr


def check_fastssc(device, ref_device, n=1024, batch=4096, reps=20):
    """Fast-SSC float and int8 (the CLI's int8 quantization, x10)."""
    import numpy as np
    import jax.numpy as jnp

    from polar_codes_tpu.models.fastssc import FastSSCDecoder

    frozen, det, llr = _family_input(n, batch, 3, device)
    llr_i8 = np.clip(np.round(llr * 10.0), -127, 127).astype(np.int8)
    out = {}
    for tag, dtype, x in (("float", jnp.float32, llr),
                          ("int8", jnp.int8, llr_i8)):
        dec = FastSSCDecoder(n, frozen, systematic=True, detector=det,
                             dtype=dtype)
        out[tag] = _compare_family(f"Fast-SSC {tag} N={n}", lambda: dec.decode,
                                   x, device, ref_device, reps)
    return out


def check_scan(device, ref_device, n=1024, batch=4096, reps=20):
    """SCAN-4: soft output within 1e-5 (elementwise min-sum), hard
    decisions (the signs decode() takes) exact."""
    from polar_codes_tpu.models.scan import ScanDecoder

    frozen, det, llr = _family_input(n, batch, 3, device)
    dec = ScanDecoder(n, frozen, systematic=True, detector=det,
                      iterations=4)

    def soft_and_hard(x):
        total, beta = dec.decode_soft(x)
        return total, beta, (total < 0).astype("uint8")

    return _compare_family(f"SCAN-4 soft+hard N={n}", lambda: soft_and_hard,
                           llr, device, ref_device, reps, soft_atol=1e-5)


def check_scflip(device, ref_device, n=1024, batch=4096, reps=20):
    """CRC-gated SCFlip with T=8 trials."""
    from polar_codes_tpu.models.depthfirst import DepthFirstDecoder

    frozen, det, llr = _family_input(n, batch, 3, device)
    dec = DepthFirstDecoder(n, frozen, systematic=True, detector=det,
                            trial_limit=8)
    return _compare_family(f"SCFlip T=8 N={n}", lambda: dec.decode, llr,
                           device, ref_device, reps)


def check_large(device, ref_device, n=32768, batch=8, reps=20, chunk=None,
                scl_unroll=1):
    """The bounded-compile scan decoders: LargeSC and LargeSCL-8.

    LargeSCL runs with scl_unroll chunk bodies per scan step: its default
    (16) builds a program whose CPU compile alone takes minutes."""
    from polar_codes_tpu.models.large import LargeSCDecoder, LargeSCLDecoder

    frozen, det, llr = _family_input(n, batch, 4, device)
    chunk_kw = {} if chunk is None else dict(chunk=chunk)
    sc = LargeSCDecoder(n, frozen, systematic=True, detector=det, **chunk_kw)
    scl = LargeSCLDecoder(n, frozen, list_size=8, systematic=True,
                          detector=det, unroll=scl_unroll, **chunk_kw)
    return dict(
        sc=_compare_family(f"LargeSC N={n}", lambda: sc.decode, llr,
                           device, ref_device, reps),
        scl8=_compare_family(f"LargeSCL-8 N={n}", lambda: scl.decode, llr,
                             device, ref_device, reps),
    )


def stage_encoder(enc):
    """The n elementwise butterfly stages on bipolar float32 (XOR becomes
    multiply), both systematic passes: the plain version of
    PolarEncoder.encode, whose Kronecker-factored matrix products it must
    equal bit for bit. Takes info bits that already carry their CRC."""
    import jax.numpy as jnp

    from polar_codes_tpu.ops.butterfly import butterfly_transform_bipolar

    def encode(x):
        u = jnp.ones(x.shape[:-1] + (enc.block_length,), jnp.float32)
        u = u.at[..., jnp.asarray(enc.info_pos)].set(
            1.0 - 2.0 * x.astype(jnp.float32))
        code = butterfly_transform_bipolar(u)
        if enc.systematic:
            code = jnp.where(jnp.asarray(enc.frozen_mask), 1.0, code)
            code = butterfly_transform_bipolar(code)
        return jnp.signbit(code).astype(jnp.uint8)

    return encode


def check_encoder(device, ref_device, n=1024, batch=4096, reps=20):
    """PolarEncoder.encode on `device` against the elementwise stages on
    `ref_device`, systematic with CRC16; the stages are timed on `device`
    too."""
    import numpy as np

    from polar_codes_tpu.models.encoder import PolarEncoder

    frozen, det = _flagship_code(n, n // 2)
    enc = PolarEncoder(n, frozen, systematic=True, detector=det)
    rng = np.random.default_rng(5)
    info = _with_crc(
        det, rng.integers(0, 2, (batch, enc.info_length)).astype(np.uint8)
    )
    stages = stage_encoder(enc)
    x, x_ref = _on(device, info), _on(ref_device, info)
    ref_fn, _ = _compile(stages, x_ref)
    want = np.asarray(ref_fn(x_ref))
    out = {}
    for path, fn in (("kron", lambda b: enc.encode(b, generate_crc=False)),
                     ("stages", stages)):
        compiled, compile_s = _compile(fn, x)
        got = np.asarray(compiled(x))
        steady_s = _median_seconds(compiled, x, reps=reps)
        out[path] = dict(compile_s=compile_s, steady_s=steady_s,
                         batch=batch,
                         mismatched_elements=int((got != want).sum()))
        print(f"[d] encode {path} N={n}: " + json.dumps(out[path]))
        _check(out[path]["mismatched_elements"] == 0,
               f"encode {path} N={n} differs from the CPU stages")
    return out


def check_crc_cmac(device, k=512, batch=4096, n_tags=64):
    """CRC16 generate/check on `device` against the host engine, and the
    native batched CMAC tags against the pure-Python AES engine."""
    import numpy as np

    from polar_codes_tpu.models.detectors import CMAC, CRC16
    from polar_codes_tpu.utils import hostcodec
    from polar_codes_tpu.utils.aes import aes_cmac

    det = CRC16()
    rng = np.random.default_rng(6)
    blocks = rng.integers(0, 2, (batch, k)).astype(np.uint8)
    gen = np.asarray(det.generate(_on(device, blocks)))
    want = _with_crc(det, blocks)
    _check((gen == want).all(), "CRC16 generate differs from the host")
    bad = gen.copy()
    bad[:, 0] ^= 1
    ok = np.asarray(det.check(_on(device, np.concatenate([gen, bad]))))
    _check(ok[:batch].all() and not ok[batch:].any(),
           "CRC16 check on the device is wrong")
    _check(hostcodec.cmac_available(), "native hostcodec CMAC unavailable")
    cmac = CMAC(32)
    msgs = rng.integers(0, 2, (n_tags, 480)).astype(np.uint8)
    tags = cmac.tags_batch(msgs)
    for row, tag in zip(msgs, tags):
        ref = aes_cmac(cmac._key, np.packbits(row).tobytes())
        want_bits = np.unpackbits(np.frombuffer(ref, np.uint8))[:32]
        _check((tag == want_bits).all(), "native CMAC tag differs")
    print(f"[d] CRC16 generate/check on {2 * batch} blocks and "
          f"{n_tags} native CMAC tags: ok")
    return dict(ok=True)


def phase_families(device, ref_device, reps=20):
    """Every family besides the flagship, once, at one real width."""
    return dict(
        fastssc=check_fastssc(device, ref_device, reps=reps),
        scan4=check_scan(device, ref_device, reps=reps),
        scflip=check_scflip(device, ref_device, reps=reps),
        large=check_large(device, ref_device, reps=reps),
        encode_n1024=check_encoder(device, ref_device, reps=reps),
        encode_n131072=check_encoder(device, ref_device, n=131072,
                                     batch=64, reps=reps),
        crc_cmac=check_crc_cmac(device),
    )


# ---- --four: data-parallel Monte-Carlo step --------------------------------


def phase_four(n_devices=4, n=1024, batch=1024, chunks=4, seed=7):
    """MonteCarlo(mesh=default_mesh(4)) with psum counters against a
    1-device run of every shard's key, and the wall time on 1 and on 4."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from polar_codes_tpu.parallel.mesh import default_mesh, distribute_keys
    from polar_codes_tpu.sim import cli
    from polar_codes_tpu.sim.montecarlo import MonteCarlo

    args = cli.build_parser().parse_args(
        ["single", "-n", str(n), "-r", "0.5", "-l", "8", "-e", "crc16",
         "--batch", str(batch), "--devices", str(n_devices)])
    enc, dec = cli.make_coders(n, n // 2, args, cli.parse_detector("crc16"))
    mesh = default_mesh(n_devices)
    mc = MonteCarlo(enc, dec, batch=batch, amplification=args.amplification,
                    mesh=mesh)
    esn0 = jnp.float32(mc.esn0_linear(2.0))
    keys = distribute_keys(jax.random.PRNGKey(seed), mesh)
    total = {k: int(v) for k, v in mc._fused(keys, esn0).items()}

    per_shard = jax.jit(shard_map(
        lambda ks: {k: v[None] for k, v in mc.device_step(ks[0], esn0)
                    .items()},
        mesh=mesh, in_specs=P("batch"), out_specs=P("batch"),
    ))(keys)
    per_shard = {k: np.asarray(v) for k, v in per_shard.items()}
    # the 1-card runs: the same simulator on a 1-device mesh, one shard
    # key at a time
    mc1 = MonteCarlo(enc, dec, batch=batch,
                     amplification=args.amplification,
                     mesh=default_mesh(1))
    host_keys = np.asarray(keys)
    single = [
        {k: int(v) for k, v in mc1._fused(
            _on(jax.devices()[0], host_keys[i:i + 1]), esn0).items()}
        for i in range(n_devices)
    ]
    print(f"[four] psum counters: {json.dumps(total)}")
    print(f"[four] per shard: "
          + json.dumps({k: v.tolist() for k, v in per_shard.items()}))
    print(f"[four] 1-device runs of the shard keys: {json.dumps(single)}")
    _check(total["runs"] == n_devices * batch,
           f"psum runs {total['runs']} != {n_devices} x {batch}")
    for i, s in enumerate(single):
        for key_name, value in s.items():
            _check(int(per_shard[key_name][i]) == value,
                   f"shard {i} {key_name}: {per_shard[key_name][i]} != "
                   f"1-device {value}")
    for key_name in total:
        _check(total[key_name] == sum(s[key_name] for s in single),
               f"psum {key_name} != sum of the 1-device runs")

    blocks = chunks * batch
    walls = {}
    for label, sim, n_blocks in (("1", mc1, blocks),
                                 (str(n_devices), mc, n_devices * blocks)):
        sim.run_job(2.0, batch, key=jax.random.PRNGKey(seed))  # compile
        t0 = time.perf_counter()
        res = sim.run_job(2.0, n_blocks, key=jax.random.PRNGKey(seed + 1),
                          warmup=False)
        wall_s = time.perf_counter() - t0
        walls[label] = dict(wall_s=wall_s, step_s=res.time, runs=res.runs,
                            bler=res.BLER, blocks_per_s=res.runs / wall_s)
    print("[four] wall time, same per-device batch: " + json.dumps(walls))
    return dict(total=total, walls=walls)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-GPU data-parallel step")
    parser.add_argument("--trace", default="",
                        help="directory for a profiler trace of 3 "
                             "flagship decodes")
    args = parser.parse_args(argv)
    try:
        _import_repo()
        import jax

        from polar_codes_tpu.utils.cache import enable_compile_cache

        device, _ = phase_device()
        enable_compile_cache()
        count = len(jax.devices())
        t_start = time.perf_counter()
        if args.four:
            _check(count >= 4, f"--four needs 4 GPUs, JAX sees {count}")
            t0 = time.perf_counter()
            phase_four()
            print(f"[four] phase seconds {time.perf_counter() - t0:.1f}")
            count = 4
        else:
            ref_device = jax.devices("cpu")[0]
            for name, phase in (
                ("b", lambda: phase_flagship(device, ref_device,
                                             trace_dir=args.trace)),
                ("c", phase_simulator),
                ("d", lambda: phase_families(device, ref_device)),
            ):
                t0 = time.perf_counter()
                phase()
                print(f"[{name}] phase seconds "
                      f"{time.perf_counter() - t0:.1f}")
        print(f"total seconds {time.perf_counter() - t_start:.1f}")
    except Exception as exc:  # every failure ends the run non-zero
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        raise SystemExit(1) from exc
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

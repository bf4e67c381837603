"""Batched Monte-Carlo BER/BLER simulator.

Capability parity with the pcsim worker chain
(/root/reference/src/simulation/simulator.cpp:632-1010): per job
(N, K, L, Eb/N0) it generates random payloads, encodes, modulates, applies
AWGN, decodes, and accumulates bit/block/reported error counters plus
decode-latency statistics; results carry pcsim's exact CSV schema
(simulator.cpp:519-562) including the 1e-99 floor for zero error rates.

Batched inversion: the reference's hot loop is one block per iteration per
thread; here one device step processes a [batch, N] block matrix, the whole
chain stays on device (jax.random payload + noise generation — nothing
leaves device memory between encode and error counting), and multi-chip scaling
shards the batch axis over a mesh with psum-aggregated counters
(parallel/mesh.py). Decode is a separately jitted + timed stage so the
reported latency/throughput matches the reference's decode-only timing
semantics (simulator.cpp:920-936).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.modem import Bpsk, Modem
from ..dsp.channel import add_awgn, apply_rayleigh
from ..parallel.mesh import sharded_counter_step


class Statistics:
    """min/max/mean/dev accumulator (reference src/simulation/statistics.h)."""

    def __init__(self):
        self.values: List[float] = []

    def insert(self, value: float):
        self.values.append(float(value))

    @property
    def min(self) -> float:
        return min(self.values) if self.values else 0.0

    @property
    def max(self) -> float:
        return max(self.values) if self.values else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    @property
    def dev(self) -> float:
        # sample deviation sqrt(sum/(size-1)), matching Statistics::evaluate
        # (reference statistics.cpp:58); 0.0 when undefined (<2 samples)
        if len(self.values) < 2:
            return 0.0
        return float(np.std(self.values, ddof=1))

    @property
    def sum(self) -> float:
        return float(np.sum(self.values)) if self.values else 0.0


@dataclass
class JobResult:
    """One CSV row; field names mirror DataPoint (simulator.h:75-121)."""

    N: int
    K: int
    designSNR: float
    errorDetection: int
    L: int
    EbN0: float
    bitsPerSymbol: int = 1
    BLER: float = 0.0
    BER: float = 0.0
    RER: float = 0.0
    runs: int = 0
    errors: int = 0
    biterrors: int = 0
    reportedErrors: int = 0
    time: float = 0.0
    blps: float = 0.0
    cbps: float = 0.0
    pbps: float = 0.0
    effectiveRate: float = 0.0
    ebps: float = 0.0
    amplification: float = 1.0
    time_min: float = 0.0
    time_max: float = 0.0
    time_mean: float = 0.0
    time_dev: float = 0.0


CSV_HEADER = (
    '"N","K","dSNR","C","L","Eb/N0","BPS","BLER","BER","RER","Runs","Errors",'
    '"Time","Blockspeed","Coded Bitrate","Payload Bitrate",'
    '"Effective Payload Bitrate","Encoder Bitrate","Amplification",'
    '"time min","time max","time mean","time deviation"'
)


def _rate_or_floor(x: float) -> str:
    """pcsim writes 1e-99 for zero rates so log plots never hit 0
    (simulator.cpp:541)."""
    return repr(x) if x > 0.0 else "1e-99"


def write_csv(path: str, jobs: Sequence[JobResult]):
    """pcsim-schema CSV (simulator.cpp:519-562)."""
    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for j in jobs:
            row = [
                j.N, j.K, j.designSNR, j.errorDetection, j.L, j.EbN0,
                j.bitsPerSymbol,
                _rate_or_floor(j.BLER), _rate_or_floor(j.BER),
                _rate_or_floor(j.RER),
                j.runs, j.errors, j.time, j.blps, j.cbps, j.pbps,
                j.effectiveRate, j.ebps, j.amplification,
                int(j.time_min * 1e9), int(j.time_max * 1e9),
                int(j.time_mean * 1e9), int(j.time_dev * 1e9),
            ]
            f.write(",".join(str(v) for v in row) + "\n")


class MonteCarlo:
    """Monte-Carlo runner for one (encoder, decoder, modem) chain.

    `encoder`/`decoder` are this package's codec objects for the same code;
    they must share the detector. `batch` is the number of codewords per
    device step. With `mesh` set, counters come from a mesh-sharded fused
    step (batch per device = batch) and timing covers the fused step; on a
    single device, encode and decode are separate jitted stages and the
    decode stage alone is timed, matching pcsim's semantics.
    """

    def __init__(
        self,
        encoder,
        decoder,
        modem: Optional[Modem] = None,
        batch: int = 1024,
        amplification: float = 1.0,
        mesh=None,
        design_snr: float = 0.0,
        channel: str = "awgn",
    ):
        self.encoder = encoder
        self.decoder = decoder
        self.modem = modem if modem is not None else Bpsk()
        self.batch = int(batch)
        self.amplification = float(amplification)
        self.mesh = mesh
        self.design_snr = float(design_snr)
        if channel not in ("awgn", "rayleigh"):
            raise ValueError(f"unknown channel {channel}")
        self.channel = channel
        self.detector = encoder.detector
        self._build()

    # -- traced stages ------------------------------------------------------

    def _make_llr(self, key, esn0_linear):
        """Payload generation through soft demodulation, fully on device."""
        k_info, k_noise = jax.random.split(key)
        info = jax.random.bernoulli(
            k_info, 0.5, (self.batch, self.encoder.info_length)
        ).astype(jnp.uint8)
        if self.detector.tail_bits:
            info = self.detector.generate(info)
        code = self.encoder.encode(info, generate_crc=False)
        tx = self.modem.modulate(code)
        if self.channel == "rayleigh":
            rx = apply_rayleigh(k_noise, tx, esn0_linear=esn0_linear)
        else:
            rx = add_awgn(k_noise, tx, esn0_linear=esn0_linear)
        llr = self.modem.demodulate(rx) * self.amplification
        if getattr(self.decoder, "dtype", jnp.float32) == jnp.int8:
            llr = jnp.clip(jnp.round(llr), -127, 127).astype(jnp.int8)
        return info, llr

    def _count(self, info, decoded, ok):
        err_bits = (decoded != info).astype(jnp.int32)
        biterrors = jnp.sum(err_bits)
        block_err = jnp.any(err_bits > 0, axis=-1)
        return {
            "runs": jnp.asarray(self.batch, jnp.int32),
            "biterrors": biterrors,
            "errors": jnp.sum(block_err.astype(jnp.int32)),
            "reported": jnp.sum((~ok).astype(jnp.int32)),
        }

    def _build(self):
        # host-orchestrated decoders (AdaptiveDecoder) jit internally and
        # expose decode_fused for traced contexts
        host_side = getattr(self.decoder, "decode_is_host_orchestrated", False)
        traced_decode = (
            self.decoder.decode_fused if host_side else self.decoder.decode
        )

        def gen(key, esn0_linear):
            return self._make_llr(key, esn0_linear)

        def dec(llr):
            decoded, codeword, ok = self.decoder.decode(llr)
            return decoded, ok

        def count(info, decoded, ok):
            return self._count(info, decoded, ok)

        self._gen = jax.jit(gen)
        self._dec = dec if host_side else jax.jit(dec)
        self._cnt = jax.jit(count)

        def fused(key, esn0_linear):
            info, llr = self._make_llr(key, esn0_linear)
            decoded, codeword, ok = traced_decode(llr)
            return self._count(info, decoded, ok)

        # one device's whole step (PRNG -> counters), unjitted: the mesh
        # path lifts it over the devices, callers may run it on one device
        self.device_step = fused
        if self.mesh is not None:
            self._fused = sharded_counter_step(fused, self.mesh)
        else:
            self._fused = jax.jit(fused)

    # -- job loop -----------------------------------------------------------

    def esn0_linear(self, ebn0_db: float) -> float:
        """Eb/N0 -> Es/N0 with code rate and bits/symbol (simulator.cpp:821)."""
        rate = self.encoder.info_length / self.encoder.block_length
        bps = getattr(self.modem, "bits_per_symbol", 1)
        return 10.0 ** (ebn0_db / 10.0) * rate * bps

    def run_job(
        self,
        ebn0_db: float,
        blocks: int,
        key: Optional[jax.Array] = None,
        warmup: bool = True,
        checkpoint=None,
        job_id: Optional[str] = None,
    ) -> JobResult:
        """Simulate >= `blocks` codewords at one Eb/N0 point.

        With `checkpoint` (sim.checkpoint.SweepCheckpoint), counters persist
        after every chunk and a restarted job resumes mid-sweep with
        identical PRNG streams."""
        if key is None:
            key = jax.random.PRNGKey(0)
        if checkpoint is not None and job_id is None:
            enc = self.encoder
            job_id = (
                f"n{enc.block_length}_k{enc.info_length}_"
                f"l{getattr(self.decoder, 'list_size', 1)}_snr{ebn0_db:.4f}"
            )
        esn0 = jnp.float32(self.esn0_linear(ebn0_db))
        chunks = max(1, math.ceil(blocks / self._global_batch()))
        stats = {"runs": 0, "biterrors": 0, "errors": 0, "reported": 0}
        tstat = Statistics()
        first_chunk = 0
        if checkpoint is not None:
            done = checkpoint.completed(job_id)
            if done is not None:
                return JobResult(**done)
            st = checkpoint.job_state(job_id)
            first_chunk = st["chunks_done"]
            for k in stats:
                stats[k] = st.get(k, 0)
            tstat.values = list(st["times"])

        if warmup:  # compile + cache warm, not counted (simulator.cpp:644-651)
            wkey = jax.random.fold_in(key, 0xDEAD)
            if self.mesh is not None:
                jax.block_until_ready(self._fused(self._mesh_keys(wkey), esn0))
            else:
                info, llr = self._gen(wkey, esn0)
                decoded, ok = self._dec(llr)
                jax.block_until_ready(self._cnt(info, decoded, ok))

        for i in range(first_chunk, chunks):
            ckey = jax.random.fold_in(key, i)
            if self.mesh is not None:
                t0 = time.perf_counter()
                out = jax.block_until_ready(
                    self._fused(self._mesh_keys(ckey), esn0)
                )
                dt = time.perf_counter() - t0
            else:
                info, llr = jax.block_until_ready(self._gen(ckey, esn0))
                t0 = time.perf_counter()
                decoded, ok = jax.block_until_ready(self._dec(llr))
                dt = time.perf_counter() - t0
                out = self._cnt(info, decoded, ok)
            tstat.insert(dt / self._global_batch())  # per-block decode time
            for k in stats:
                stats[k] += int(out[k])
            if checkpoint is not None:
                checkpoint.update(
                    job_id,
                    {"chunks_done": i + 1, "times": tstat.values, **stats},
                )

        enc = self.encoder
        k_len, n_len = enc.info_length, enc.block_length
        c_bits = self.detector.tail_bits
        r = JobResult(
            N=n_len, K=k_len, designSNR=self.design_snr,
            errorDetection=c_bits,
            L=getattr(self.decoder, "list_size", 1), EbN0=float(ebn0_db),
            bitsPerSymbol=getattr(self.modem, "bits_per_symbol", 1),
            runs=stats["runs"], errors=stats["errors"],
            biterrors=stats["biterrors"], reportedErrors=stats["reported"],
            amplification=self.amplification,
        )
        runs = max(r.runs, 1)
        r.BLER = r.errors / runs
        r.BER = r.biterrors / (runs * k_len)
        r.RER = r.reportedErrors / runs
        total_time = tstat.sum * self._global_batch()  # sum of per-block times
        r.time = total_time
        r.blps = runs / total_time if total_time else 0.0
        r.cbps = runs * n_len / total_time if total_time else 0.0
        r.pbps = runs * (k_len - c_bits) / total_time if total_time else 0.0
        r.effectiveRate = (
            (runs - r.errors) * (k_len - c_bits) / total_time
            if total_time
            else 0.0
        )
        r.ebps = self._measure_encoder_rate() * n_len
        r.time_min, r.time_max = tstat.min, tstat.max
        r.time_mean, r.time_dev = tstat.mean, tstat.dev
        if checkpoint is not None:
            from dataclasses import asdict

            checkpoint.mark_complete(job_id, asdict(r))
        return r

    def run_snr_sweep(
        self,
        ebn0_db_list: Sequence[float],
        blocks: int,
        key: Optional[jax.Array] = None,
    ) -> List[JobResult]:
        if key is None:
            key = jax.random.PRNGKey(0)
        return [
            self.run_job(snr, blocks, key=jax.random.fold_in(key, int(1e6) + i))
            for i, snr in enumerate(ebn0_db_list)
        ]

    # -- helpers ------------------------------------------------------------

    def _global_batch(self) -> int:
        if self.mesh is None:
            return self.batch
        return self.batch * self.mesh.devices.size

    def _mesh_keys(self, key):
        from ..parallel.mesh import distribute_keys

        return distribute_keys(key, self.mesh)

    def _measure_encoder_rate(self) -> float:
        """Encoded blocks/s of the jitted encoder (reference ebps).

        Uses the slope-differenced device timer: perf_counter around one
        jitted call measures the asynchronous enqueue plus the fixed
        dispatch cost, not the device work (see utils/timing.py)."""
        from ..utils.timing import time_device_fn

        info = jnp.zeros((self.batch, self.encoder.info_length), jnp.float32)

        def step(x):
            return self.encoder.encode(x.astype(jnp.uint8), generate_crc=False)

        dt = time_device_fn(step, info)
        return self.batch / dt if dt > 0 else 0.0

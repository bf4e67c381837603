"""Microbenchmark suite with per-row checkpoint/resume.

Capability parity with /root/reference/benchmark/main_benchmark.cpp:
encoder grids over N x CRC x systematic (:273-369) and decoder grids over
implementation x N x L x CRC (:371-503), reporting the same `CodeThr` /
`InfoThr` counters (coded / info bits per second, :233-239) plus
blocks-per-second. Results go to stdout and a JSON-lines file.

    python -m polar_codes_tpu.sim.benchmark --quick -o benchmarks.jsonl

Rows are enumerated declaratively up front and the output file doubles as
the checkpoint: on restart, rows whose `bench` name already appears in the
output are skipped, and new rows are appended, so an interrupted grid
resumes at the first missing row instead of truncating the artifact.

Timing uses the chained-fori_loop device timer (utils/timing.py), so the
numbers are decode/encode wall time on the device, batch included. Every
record names the device it ran on (platform, device_kind, device count).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def bits_budget_batch(n_len: int, budget_bits: int = 1 << 21) -> int:
    """One consistent batch policy for every row: ~budget_bits coded bits
    per timed step."""
    return max(budget_bits // n_len, 1)


def enumerate_rows(quick: bool):
    """Declarative grid: list of dicts describing every benchmark row.

    Mirrors main_benchmark.cpp dimension-for-dimension: encode N in
    {64..131072} x CRC/CMAC x systematic x dSNR (:273-369), Fast-SSC N in
    {64..8192} x {float,char}, CA-SCL N in {256..8192} x L in {1..32} x
    CRC in {0,8,16,32} x {float,char}, SCAN (:371-503). The reference
    sweeps every cross product; here each dimension is swept around the
    flagship shape (N=1024 L=8 CRC16) so the grid stays one device pass.
    """
    rows = []
    enc_ns = [256, 1024, 4096] if quick else [64, 256, 1024, 4096, 16384,
                                              32768, 131072]
    for n_len in enc_ns:
        for c_bits in ([0, 32] if quick else [0, 8, 16, 32]):
            if c_bits >= n_len // 2:
                continue
            rows.append(dict(kind="encode", N=n_len, K=n_len // 2,
                             C=c_bits, L=0, dtype="float"))

    if not quick:
        # CMAC tail rows (main_benchmark.cpp:330-340: cmac x {8..64} at
        # N=1024) and the systematic / design-SNR encode dimensions
        for c_bits in (8, 16, 32, 64):
            rows.append(dict(kind="encode", N=1024, K=512, C=c_bits,
                             L=0, dtype="float", det="cmac"))
        for n_len in (1024, 32768):
            rows.append(dict(kind="encode", N=n_len, K=n_len // 2, C=16,
                             L=0, dtype="float", systematic=False))
        rows.append(dict(kind="encode", N=1024, K=512, C=16, L=0,
                         dtype="float", dsnr=4.0))

    dec_ns = ([256, 1024] if quick
              else [64, 128, 256, 512, 1024, 2048, 4096, 8192])
    for n_len in dec_ns:
        for tag in ("float", "char"):
            rows.append(dict(kind="fastssc", N=n_len, K=n_len // 2,
                             C=0, L=1, dtype=tag))

    scl_ls = [2, 8] if quick else [1, 2, 4, 8, 16, 32]
    for n_len in ([1024] if quick else [256, 1024, 4096]):
        for list_size in scl_ls:
            for tag in ("float", "char"):
                if n_len == 4096 and list_size > 8:
                    continue  # unrolled-tree compile guard
                rows.append(dict(kind="cascl", N=n_len, K=n_len // 2,
                                 C=16, L=list_size, dtype=tag))

    if not quick:
        # N=8192 decode rows (main_benchmark.cpp:494-503)
        for list_size in (2, 8):
            rows.append(dict(kind="cascl", N=8192, K=4096, C=16,
                             L=list_size, dtype="float"))
        # CRC breadth at the flagship shape (the reference crosses
        # CRC in {0,8,16,32} with every decode row)
        for c_bits in (0, 8, 32):
            rows.append(dict(kind="cascl", N=1024, K=512, C=c_bits,
                             L=8, dtype="float"))
        # systematic=0 and design-SNR decode dimensions
        rows.append(dict(kind="cascl", N=1024, K=512, C=16, L=8,
                         dtype="float", systematic=False))
        rows.append(dict(kind="cascl", N=1024, K=512, C=16, L=8,
                         dtype="float", dsnr=4.0))
        # decode-N breadth: the reference crosses EVERY N in {64..8192}
        # with its L grid (main_benchmark.cpp:371-503); L in {2,8} plus a
        # char row fill the remaining Ns
        for n_len in (64, 128, 512, 2048):
            for list_size in (2, 8):
                rows.append(dict(kind="cascl", N=n_len, K=n_len // 2,
                                 C=16, L=list_size, dtype="float"))
            rows.append(dict(kind="cascl", N=n_len, K=n_len // 2, C=16,
                             L=8, dtype="char"))
        # construction variant (the reference benchmarks BE separately:
        # main_benchmark.cpp:460 — the frozen set changes the specialized
        # tree, so throughput differs from BB), across L
        for list_size in (2, 8, 16, 32):
            rows.append(dict(kind="cascl", N=1024, K=512, C=16,
                             L=list_size, dtype="float", ctor="BE"))
        rows.append(dict(kind="fastssc", N=1024, K=512, C=0, L=1,
                         dtype="float", ctor="BE"))
        # rate sweep: the reference sweeps K per N (:273-369); beyond the
        # flagship-N sweep, cover a low and high rate at N=256/4096
        for k_len in (256, 768):
            rows.append(dict(kind="cascl", N=1024, K=k_len, C=16, L=8,
                             dtype="float"))
        for n_len, ks in ((256, (64, 192)), (4096, (1024, 3072))):
            for k_len in ks:
                rows.append(dict(kind="cascl", N=n_len, K=k_len, C=16,
                                 L=8, dtype="float"))
        # pcsim "compareall" families (simulator.cpp:404-491): adaptive
        # fast->SCL escalation, SCFlip depth-first, Fast-SSCAN — so every
        # family PERF.md discusses has an artifact-backed row
        rows.append(dict(kind="adaptive", N=1024, K=512, C=16, L=8,
                         dtype="float"))
        rows.append(dict(kind="depthfirst", N=1024, K=512, C=16, L=8,
                         dtype="float"))
        for n_len in (256, 1024):
            rows.append(dict(kind="fastsscan", N=n_len, K=n_len // 2,
                             C=0, L=4, dtype="float"))

    for n_len in ([1024] if quick else [256, 1024]):
        rows.append(dict(kind="scan", N=n_len, K=n_len // 2, C=0, L=4,
                         dtype="float"))

    if not quick:
        # scan-over-schedule decoders at block lengths beyond the unrolled
        # trees' compile budget (main_benchmark.cpp runs N up to 131072)
        for n_len in (32768, 131072):
            rows.append(dict(kind="sc_scan", N=n_len, K=n_len // 2,
                             C=0, L=1, dtype="float"))
        rows.append(dict(kind="cascl_scan", N=32768, K=16384,
                         C=16, L=8, dtype="float"))
        # the design-scales claim measured: SCL at the largest encode N
        rows.append(dict(kind="cascl_scan", N=131072, K=65536, C=16,
                         L=8, dtype="float"))
    for row in rows:
        row["bench"] = row_name(row)
    return rows


def row_name(row):
    kind, n_len = row["kind"], row["N"]
    suffix = ""
    if row.get("ctor", "BB") != "BB":
        suffix += f"_{row['ctor'].lower()}"
    if kind in ("cascl", "fastssc") and row["K"] != n_len // 2:
        suffix += f"_k{row['K']}"
    # non-default grid dimensions get explicit name suffixes
    if not row.get("systematic", True):
        suffix += "_nonsys"
    if row.get("dsnr", 0.0):
        suffix += f"_dsnr{int(round(row['dsnr'] * 100))}"
    if kind == "cascl" and row["C"] != 16:
        suffix += f"_crc{row['C']}"
    if suffix and kind == "encode":
        det = row.get("det", "crc")
        return f"encode_n{n_len}_{det}{row['C']}" + suffix
    if kind == "encode" and row.get("det", "crc") != "crc":
        return f"encode_n{n_len}_{row['det']}{row['C']}"
    if suffix:
        base = (f"cascl_{row['dtype']}_n{n_len}" if kind == "cascl"
                else f"fastssc_{row['dtype']}_n{n_len}")
        if kind == "cascl":
            base += f"_l{row['L']}"
        return base + suffix
    if kind == "encode":
        return f"encode_n{n_len}_crc{row['C']}"
    if kind == "fastssc":
        return f"fastssc_{row['dtype']}_n{n_len}"
    if kind == "sc_scan":
        return f"sc_scan_{row['dtype']}_n{n_len}"
    if kind == "cascl":
        return f"cascl_{row['dtype']}_n{n_len}_l{row['L']}"
    if kind == "cascl_scan":
        return f"cascl_scan_{row['dtype']}_n{n_len}_l{row['L']}"
    if kind == "adaptive":
        return f"adaptive_{row['dtype']}_n{n_len}_l{row['L']}"
    if kind == "depthfirst":
        return f"depthfirst_n{n_len}_t{row['L']}"
    if kind == "fastsscan":
        return f"fastsscan_n{n_len}_i{row['L']}"
    return f"scan{row['L']}_n{n_len}"


def load_done(path):
    """Bench names that need no further runs: measured rows, plus rows
    that failed twice (a second identical failure would recur on every
    resume)."""
    done, errors = set(), {}
    if path and os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "bench" not in rec:
                    continue
                if "error" in rec:
                    errors[rec["bench"]] = errors.get(rec["bench"], 0) + 1
                else:
                    done.add(rec["bench"])
    done.update(b for b, n in errors.items() if n >= 2)
    return done


def run_row(row, batch_bits, out):
    import jax
    import jax.numpy as jnp

    from ..construction import frozen_bits
    from ..models.encoder import PolarEncoder
    from ..models.fastssc import FastSSCDecoder
    from ..models.scl import SCLDecoder
    from ..models.scan import ScanDecoder
    from ..models.detectors import make_detector
    from ..utils.timing import time_device_fn
    from ..utils.profiling import roofline

    rng = np.random.default_rng(0)
    device = jax.devices()[0]
    where = dict(platform=device.platform, device_kind=device.device_kind,
                 device_count=len(jax.devices()))
    n_len, k_len = row["N"], row["K"]
    batch = bits_budget_batch(n_len, batch_bits)
    kind = row["kind"]

    if kind == "encode":
        det = (make_detector(row["C"], row.get("det", "crc"))
               if row["C"] else None)
        frozen = frozen_bits(n_len, k_len, row.get("dsnr", 0.0),
                             row.get("ctor", "BB"))
        enc = PolarEncoder(
            n_len, frozen, systematic=row.get("systematic", True),
            detector=det,
        )
        bits = jnp.asarray(rng.integers(0, 2, (batch, k_len)), jnp.uint8)
        if row.get("det") == "cmac":
            # AES-CMAC is host work in the reference too (cmac.cpp runs
            # on the CPU); the row times the batched host CMAC plus the
            # device butterfly encode and reports the sum.
            import time as _time

            bits_np = np.asarray(bits)
            t0 = _time.perf_counter()
            tails = det.tags_batch(bits_np[:, : k_len - det.tail_bits])
            host_secs = _time.perf_counter() - t0
            bits = jnp.asarray(
                np.concatenate(
                    [bits_np[:, : k_len - det.tail_bits], tails], axis=1
                )
            )
            dev = time_device_fn(
                lambda x: enc.encode(x, generate_crc=False), bits, reps=8
            )
            secs = host_secs + dev
            roof = roofline(
                lambda x: enc.encode(x, generate_crc=False), bits,
                seconds=dev, model=enc, batch=batch,
            )
        else:
            secs = time_device_fn(lambda x: enc.encode(x), bits, reps=8)
            roof = roofline(lambda x: enc.encode(x), bits, seconds=secs,
                            model=enc, batch=batch)
    else:
        frozen = frozen_bits(n_len, k_len, row.get("dsnr", 0.0),
                             row.get("ctor", "BB"))
        dtype = jnp.int8 if row["dtype"] == "char" else jnp.float32
        if kind in ("sc_scan", "cascl_scan"):
            from ..models.large import LargeSCDecoder, LargeSCLDecoder

            # the scan decoders execute O(N) small sequential steps, so
            # batch is nearly free throughput: give the SC rows 8x and
            # the SCL rows 2x the bit budget
            if kind == "sc_scan":
                batch = max(8 * batch_bits // n_len, 32)
                dec = LargeSCDecoder(n_len, frozen, systematic=True,
                                     dtype=dtype)
            else:
                batch = max(2 * batch_bits // n_len, 16)
                det = make_detector(row["C"], "crc")
                dec = LargeSCLDecoder(n_len, frozen, list_size=row["L"],
                                      systematic=True, detector=det,
                                      dtype=dtype)
        elif kind == "adaptive":
            # pcsim compareall family: realistic 2 dB input (the adaptive
            # scheme's throughput IS its operating-point failure rate;
            # synthetic noise would escalate every block). Timing is the
            # device-true composite: fast pass at B plus each SCL stage
            # rerun at the REAL bucket size the decode produced — the sum
            # of the kernels the host-orchestrated decode launches.
            from ..models.adaptive import AdaptiveDecoder
            from ..dsp import bpsk_modulate, add_awgn

            det = make_detector(row["C"], "crc")
            dec = AdaptiveDecoder(n_len, frozen, list_size=row["L"],
                                  systematic=True, detector=det)
            enc2 = PolarEncoder(n_len, frozen, systematic=True,
                                detector=det)
            info_b = jnp.asarray(rng.integers(0, 2, (batch, k_len)),
                                 jnp.uint8)
            code = enc2.encode(info_b)
            esn0 = 10.0 ** 0.2 * k_len / n_len
            llr = jax.device_put(add_awgn(
                jax.random.PRNGKey(2), bpsk_modulate(code),
                esn0_linear=esn0))
            secs = time_device_fn(lambda x: dec._fast_fn(x)[2], llr,
                                  reps=8)
            cur_ok = np.array(dec._fast_fn(llr)[2])  # writable copy
            flat_np = np.asarray(llr)
            for stage_fn in dec._stage_fns:
                failed = np.nonzero(~cur_ok)[0]
                if not failed.size:
                    break
                bucket = min(1 << int(failed.size - 1).bit_length(),
                             batch)
                idx = np.zeros(bucket, np.int32)
                idx[: failed.size] = failed
                sub = jax.device_put(flat_np[idx])
                secs += time_device_fn(
                    lambda x, f=stage_fn: f(x)[2], sub, reps=8
                )
                cur_ok[failed] = np.asarray(stage_fn(sub)[2])[
                    : failed.size]
            rec = dict(bench=row["bench"], N=n_len, K=k_len, C=row["C"],
                       L=row["L"], dtype=row["dtype"], batch=batch,
                       **where, seconds_per_batch=secs,
                       code_thr_mbps=batch * n_len / secs / 1e6,
                       info_thr_mbps=batch * k_len / secs / 1e6,
                       blocks_per_s=batch / secs,
                       escalated_frac=float(
                           (~np.asarray(dec._fast_fn(llr)[2])).mean()))
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            return
        elif kind == "depthfirst":
            from ..models.depthfirst import DepthFirstDecoder

            dec = DepthFirstDecoder(
                n_len, frozen, systematic=True,
                detector=make_detector(row["C"], "crc"),
                trial_limit=row["L"],
            )
        elif kind == "fastsscan":
            from ..models.scan import FastSScanDecoder

            dec = FastSScanDecoder(n_len, frozen, systematic=True,
                                   iterations=row["L"])
        elif kind == "fastssc":
            dec = FastSSCDecoder(n_len, frozen, systematic=True, dtype=dtype)
        elif kind == "cascl":
            # C=0: no detector — pure ML list selection (the reference's
            # parity_size=0 grid dimension)
            det = make_detector(row["C"], "crc") if row["C"] else None
            dec = SCLDecoder(n_len, frozen, list_size=row["L"],
                             systematic=row.get("systematic", True),
                             detector=det, dtype=dtype)
        else:
            dec = ScanDecoder(n_len, frozen, systematic=True,
                              iterations=row["L"])
        llr = jnp.asarray(rng.normal(0, 2, (batch, n_len)), jnp.float32)
        if dtype == jnp.int8:
            llr = jnp.clip(jnp.round(llr * 8), -127, 127).astype(jnp.int8)
        llr = jax.device_put(llr)
        secs = time_device_fn(lambda x: dec.decode(x), llr, reps=8)
        roof = roofline(lambda x: dec.decode(x), llr, seconds=secs,
                        model=dec, batch=batch)

    rec = dict(bench=row["bench"], N=n_len, K=k_len, C=row["C"], L=row["L"],
               dtype=row["dtype"], batch=batch, **where,
               seconds_per_batch=secs,
               code_thr_mbps=batch * n_len / secs / 1e6,
               info_thr_mbps=batch * k_len / secs / 1e6,
               blocks_per_s=batch / secs)
    for key in ("flops", "bytes_accessed", "mfu", "hbm_util", "bound",
                "cost_model"):
        if key in roof:
            rec[key] = roof[key]
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def main(argv=None):
    p = argparse.ArgumentParser(prog="polar-bench", description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="smaller grids (a few minutes)")
    p.add_argument("--filter", default="",
                   help="only run benchmarks whose name contains this")
    p.add_argument("-o", "--output", default="benchmarks.jsonl")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    p.add_argument("--batch-bits", type=int, default=1 << 21,
                   help="approximate coded bits per timed step")
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing output rows (no resume)")
    p.add_argument("--list", action="store_true", dest="list_rows",
                   help="print the row names and exit")
    args = p.parse_args(argv)

    rows = enumerate_rows(args.quick)
    if args.filter:
        rows = [r for r in rows if args.filter in r["bench"]]
    if args.list_rows:
        for row in rows:
            print(row["bench"])
        return 0

    if args.fresh and args.output and os.path.exists(args.output):
        os.unlink(args.output)
    done = load_done(args.output)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()

    out = open(args.output, "a") if args.output else None
    try:
        for row in rows:
            if row["bench"] in done:
                continue
            try:
                run_row(row, args.batch_bits, out)
            except Exception as exc:  # noqa: BLE001
                # row failure: record it and keep the rest of the grid
                # going
                line = json.dumps(dict(
                    bench=row["bench"],
                    error=f"{type(exc).__name__}: {exc}"[:500],
                ))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profiling helpers: device traces, op annotations, and XLA cost analysis.

Parity with the reference's per-codec duration_ns counters
(/root/reference/include/polarcode/decoding/decoder.h:82 and the
Google-Benchmark counters in benchmark/main_benchmark.cpp:233-239):
`jax.profiler` traces for timeline inspection, and FLOP/byte counts (the
compiled executable's cost analysis, or the hand-derived models in
utils/costmodel.py) set against the device's published peaks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/Perfetto).

        with device_trace("traces/scl"):
            dec.decode(llr)[0].block_until_ready()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up inside profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def _union_ns(intervals) -> float:
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def trace_summary(log_dir: str, window: str) -> dict:
    """Device activity inside the host span(s) named `window`.

    Reads the newest .xplane.pb under `log_dir` (written by device_trace)
    and, for every device plane, counts the events on its "Stream" lines
    (kernels and copies) that overlap the window and the union of their
    intervals clipped to it: busy_share = busy_ns / window_ns. `lines`
    gives the event count of every line of the plane, so a reader can see
    what was counted."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = ProfileData.from_file(paths[-1])
    spans = [
        (ev.start_ns, ev.end_ns)
        for plane in data.planes if plane.name.startswith("/host")
        for line in plane.lines for ev in line.events if ev.name == window
    ]
    if not spans:
        raise ValueError(f"no host span named {window!r} in the trace")
    lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
    out = {"window_ns": hi - lo, "devices": {}}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines, intervals = {}, []
        for line in plane.lines:
            evs = [
                (max(ev.start_ns, lo), min(ev.end_ns, hi))
                for ev in line.events if ev.end_ns > lo and ev.start_ns < hi
            ]
            lines[line.name] = len(evs)
            if line.name.startswith("Stream"):
                intervals += evs
        busy = _union_ns(intervals)
        out["devices"][plane.name] = dict(
            events=len(intervals), busy_ns=busy,
            busy_share=busy / (hi - lo) if hi > lo else 0.0, lines=lines,
        )
    return out


def cost_analysis(fn: Callable, *args) -> dict:
    """Compile fn(*args) and return XLA's own cost model numbers.

    Returns {"flops", "bytes_accessed", "transcendentals", ...} (keys as
    reported by the backend; empty dict if the backend reports none)."""
    compiled = jax.jit(fn).lower(*args).compile()
    try:
        costs = compiled.cost_analysis()
    except Exception:
        return {}
    if costs is None:
        return {}
    if isinstance(costs, (list, tuple)):
        costs = costs[0] if costs else {}
    return dict(costs)


# Published peaks, keyed by the exact `device_kind` JAX reports. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates without
# sparsity, at the full 700 W power limit (a card capped lower cannot hold
# its top clock under load; report the limit beside any share). The codec
# kernels are float32 elementwise work, so "mfu" is taken against the
# float32 rate outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        bf16_flops_per_s=989e12,
        f32_flops_per_s=67e12,
        hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 data sheet, SXM5, dense",
    ),
}


def device_peaks(device=None) -> Optional[dict]:
    """Published peaks of `device` (default: the first JAX device).

    None for the CPU, which has no roofline here; an accelerator missing
    from PEAKS is an error, never a default."""
    device = jax.devices()[0] if device is None else device
    if device.platform == "cpu":
        return None
    peak = PEAKS.get(device.device_kind)
    if peak is None:
        raise ValueError(
            f"no published peaks for device kind {device.device_kind!r}; "
            "add its data-sheet rates to utils.profiling.PEAKS"
        )
    return peak


def derive_roofline(flops: float, nbytes: float,
                    seconds: Optional[float] = None, device=None) -> dict:
    """Achieved/peak ratios from given FLOP/byte counts (any source)."""
    out = {"flops": flops, "bytes_accessed": nbytes}
    if nbytes > 0:
        out["arithmetic_intensity"] = flops / nbytes
    peak = device_peaks(device)
    if peak and nbytes > 0:
        ridge = peak["f32_flops_per_s"] / peak["hbm_bytes_per_s"]
        out["bound"] = (
            "compute" if out["arithmetic_intensity"] >= ridge else "memory"
        )
    if seconds and seconds > 0:
        out["achieved_flops_per_s"] = flops / seconds
        out["achieved_bytes_per_s"] = nbytes / seconds
        if peak:
            out["mfu"] = flops / seconds / peak["f32_flops_per_s"]
            out["hbm_util"] = nbytes / seconds / peak["hbm_bytes_per_s"]
    return out


def roofline(fn: Callable, *args, seconds: Optional[float] = None,
             model=None, batch: Optional[int] = None) -> dict:
    """Cost analysis + achieved/peak ratios for one call of fn(*args).

    With `seconds` (a measured per-call time, e.g. from
    utils.timing.time_device_fn) adds achieved FLOP/s, bytes/s, MFU and
    HBM utilization plus the roofline verdict ("compute"/"memory" bound).

    `model` (a decoder/encoder instance) + `batch` enable the
    hand-derived fallback (utils/costmodel.py): when the compiler reports
    no flops but a cost model exists for the model's class, the analytic
    counts are used and the result carries cost_model="analytic" (else
    "xla").
    """
    costs = cost_analysis(fn, *args)
    flops = float(costs.get("flops", 0.0) or 0.0)
    nbytes = float(costs.get("bytes accessed", 0.0) or 0.0)
    source = "xla"
    fallback_reason = None
    if model is not None and batch and flops <= 0.0:
        try:
            analytic = analytic_costs(model, batch)
        except Exception as exc:  # formula bug: record, don't hide
            analytic = None
            fallback_reason = f"{type(exc).__name__}: {exc}"
        if analytic is not None:
            flops = analytic["flops"]
            nbytes = analytic["bytes_accessed"]
            source = "analytic"
    out = derive_roofline(flops, nbytes, seconds)
    out["cost_model"] = source
    if fallback_reason is not None:
        # A costmodel formula raised: the row falls back to the XLA
        # counts — say so rather than letting cost_model="xla" look
        # intentional.
        out["cost_model_fallback_reason"] = fallback_reason
    return out


def analytic_costs(model, batch: int) -> Optional[dict]:
    """Dispatch to the hand-derived per-family count (utils/costmodel.py)
    by model class; None when no formula exists for the class.

    Formula errors propagate to the caller (roofline() records them as
    cost_model_fallback_reason) instead of being swallowed."""
    from . import costmodel

    name = type(model).__name__
    if name == "SCLDecoder":
        return costmodel.scl_costs(model, batch)
    if name == "FastSSCDecoder":
        return costmodel.fastssc_costs(model, batch)
    if name == "PolarEncoder":
        return costmodel.encode_costs(model, batch)
    if name in ("ScanDecoder", "FastSScanDecoder"):
        return costmodel.scan_costs(model, batch)
    if name in ("LargeSCDecoder", "LargeSCLDecoder"):
        return costmodel.large_costs(model, batch)
    return None

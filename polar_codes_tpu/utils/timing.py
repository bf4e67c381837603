"""Device timing that is honest under async dispatch.

JAX returns from a call before the device has finished, so a wall-clock
loop around calls measures the enqueue. The fix: chain `reps` executions
of the function inside ONE jitted fori_loop with a data dependency between
iterations (so XLA cannot hoist the body), reduce the outputs to a scalar,
and fetch that scalar — the fetch cannot complete before all work ran.

Every jitted call also pays a fixed dispatch and transfer cost, so a
single timed call overstates small kernels. We time the chained loop at
`reps` and `2*reps` iterations and take the slope — the constant cancels
exactly. The rep count is refined FROM THE MEASURED SLOPE (not from the
overhead-polluted pilot estimate) until the differenced window is well
above the per-call jitter; without this, sub-100us kernels end up with a
window smaller than the jitter and the slope collapses to noise. The trip
count is a traced argument, so every rep choice shares one compiled
executable.
"""

from __future__ import annotations

import os
import time
from typing import Callable

_DEBUG = bool(os.environ.get("POLAR_TIMING_DEBUG"))

import jax
import jax.numpy as jnp


def _outputs_to_scalar(out) -> jnp.ndarray:
    total = jnp.float32(0)
    for leaf in jax.tree.leaves(out):
        total = total + jnp.sum(jnp.asarray(leaf).astype(jnp.float32))
    return total


def _default_perturb(x, acc):
    if jnp.issubdtype(x.dtype, jnp.floating):
        return x + jnp.asarray(1e-12, x.dtype) * acc.astype(x.dtype)
    # integer/bool inputs: flip nothing but keep the dependency via a
    # data-dependent zero (acc != acc is always False -> xor 0)
    zero = (acc != acc).astype(x.dtype)
    return x ^ zero if x.dtype != jnp.bool_ else x ^ (acc != acc)


# Target differenced-window length. The slope probe runs a 2x window as
# well, so one measurement costs about 3x the target per try. Windows much
# shorter than ~30 ms drown in per-call jitter.
_TARGET_WINDOW_S = 0.08
_MIN_WINDOW_S = 0.03
_MAX_REPS = 1 << 16


def time_device_fn(
    fn: Callable,
    x,
    reps: int = 10,
    tries: int = 3,
    perturb: Callable = None,
) -> float:
    """Seconds per execution of fn(x) on device, fixed-overhead-corrected."""
    if perturb is None:
        perturb = _default_perturb

    @jax.jit
    def many(x0, n):
        def body(i, carry):
            acc, cur = carry
            out = fn(cur)
            acc = acc + _outputs_to_scalar(out)
            return acc, perturb(x0, acc)

        acc, _ = jax.lax.fori_loop(0, n, body, (jnp.float32(0), x0))
        return acc

    def run(n):
        return float(many(x, jnp.int32(n)))

    def slope(n):
        samples = []
        for _ in range(tries):
            t0 = time.perf_counter()
            run(n)
            t1 = time.perf_counter()
            run(2 * n)
            t2 = time.perf_counter()
            samples.append(((t2 - t1) - (t1 - t0)) / n)
        if _DEBUG:
            print(f"[timing] slope(n={n}): "
                  + " ".join(f"{s * 1e3:.3f}ms" for s in samples),
                  flush=True)
        # median, not min: differencing makes noise two-sided (a slow
        # FIRST run drives the sample negative), so min() latches onto
        # underestimates and even negative garbage.
        samples.sort()
        return samples[len(samples) // 2]

    run(1)  # compile + warm (one executable serves every rep count)
    t0 = time.perf_counter()
    run(1)
    est = time.perf_counter() - t0  # overhead-polluted upper bound
    if est > _TARGET_WINDOW_S:
        # seconds-scale kernels: a single-rep slope is accurate enough
        # (jitter is tens of ms against a window of seconds)
        reps = 1
    else:
        reps = int(min(_MAX_REPS,
                       max(reps, _TARGET_WINDOW_S / max(est, 1e-7))))

    per_rep = slope(reps)
    # refine: grow reps until the measured window clears the jitter floor
    for _ in range(4):
        if per_rep > 0 and reps * per_rep >= _MIN_WINDOW_S:
            break
        if reps >= _MAX_REPS:
            break
        if per_rep > 0:
            # cap growth at 8x per step: a noisy underestimate of
            # per_rep must not balloon reps into a needlessly long
            # device loop
            reps = int(min(_MAX_REPS, reps * 8,
                           max(reps * 2, _TARGET_WINDOW_S / per_rep)))
        else:
            reps = min(_MAX_REPS, reps * 8)
        per_rep = slope(reps)
    return max(per_rep, 1e-9)

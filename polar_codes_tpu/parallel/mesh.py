"""Mesh construction and the sharded Monte-Carlo counter step.

The simulator's data parallelism is one 1-D mesh axis over the codeword
batch: every device runs the identical trace on its own batch shard with an
independent PRNG key, and the scalar error counters are psum-reduced across
the axis. Codec kernels never communicate — all collective use is confined
to this driver layer (SURVEY.md section 5, "distributed communication").

Multi-host: `init_distributed` wires `jax.distributed.initialize`, after
which `default_mesh` spans ALL processes' devices (psum rides the intra-host
interconnect within a host and the network across hosts) and
`distribute_keys` / `host_aggregate` handle the host-local <-> global array
boundary. The 2-process CPU configuration is exercised by
tests/test_multihost.py — the replacement for testing clusters without
cluster hardware (SURVEY.md section 4 "fake backends" analogue).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host wiring: call once per process before building a mesh.

    Where no cluster environment describes the job (a single GPU host, or
    tests), pass all three explicitly, e.g. coordinator_address=
    "localhost:<port>". Replaces the reference's single-process thread pool
    (simulator.cpp:87-116) at the host level: each process owns its local
    chips, one global mesh spans them all.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)


def default_mesh(
    n_devices: Optional[int] = None, axis_name: str = "batch"
) -> Mesh:
    """1-D mesh over the first n (default: all) global devices.

    After init_distributed, jax.devices() is the global (all-process)
    device list, so the same call builds the cluster-wide mesh."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else int(n_devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]), (axis_name,))


def distribute_keys(key, mesh: Mesh, axis_name: str = "batch"):
    """Per-device PRNG keys as a global array sharded over the mesh axis.

    Single-process: a plain [n, 2] key array. Multi-process: every process
    computes the same split host-side (same seed) and a global array is
    assembled from per-shard callbacks, so each device receives its own
    key without any cross-host transfer of key material.
    """
    n = mesh.devices.size
    keys = jax.random.split(key, n)
    if jax.process_count() == 1:
        return keys
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.make_array_from_callback(
        keys.shape, sharding, lambda idx: np.asarray(keys)[idx]
    )


def host_aggregate(tree):
    """Bring (replicated) global results to every host as NumPy values.

    Cross-host aggregation (SURVEY.md section 5 plan). psum results from a
    sharded_counter_step are replicated over the global mesh, so each
    process reads its local replica; host-local values go through
    multihost_utils.process_allgather. Identity on a single process."""
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(np.asarray, tree)
    from jax.experimental import multihost_utils

    def to_host(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            # global array: replicated outputs -> read the local replica
            return np.asarray(x.addressable_data(0))
        return np.asarray(multihost_utils.process_allgather(x))

    return jax.tree_util.tree_map(to_host, tree)


def sharded_counter_step(
    step_fn: Callable[..., Dict[str, jax.Array]],
    mesh: Mesh,
    axis_name: str = "batch",
):
    """Lift a per-device Monte-Carlo step into a mesh-wide one.

    step_fn(key, *args) runs one batch on a single device and returns a dict
    of scalar counters. The lifted function takes a key array with one key
    per mesh device (jax.random.split(key, n_devices)) plus the same *args
    (replicated), runs the step on every device's shard, and returns
    psum-aggregated counters. This is the device-mesh analogue of the
    reference's per-thread SimulationWorker + shared DataPoint
    accumulation.
    """

    def inner(keys, *args):
        stats = step_fn(keys[0], *args)
        return {k: jax.lax.psum(v, axis_name) for k, v in stats.items()}

    def lifted(keys, *args):
        in_specs = (P(axis_name),) + tuple(P() for _ in args)
        fn = shard_map(inner, mesh=mesh, in_specs=in_specs, out_specs=P())
        return fn(keys, *args)

    return jax.jit(lifted)

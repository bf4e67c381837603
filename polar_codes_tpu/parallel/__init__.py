"""Device-mesh parallelism for the Monte-Carlo simulator.

Device-mesh replacement for the reference's only multi-worker parallelism —
the std::thread pool with an atomic job counter
(/root/reference/src/simulation/simulator.cpp:87-116): here the batch axis
is sharded over a jax.sharding.Mesh, per-device PRNG streams come from
splitting a key array (replacing the mutex-guarded shared LCG, random.h:30),
and error counters are reduced with psum across devices (replacing per-job field
accumulation).
"""

from .mesh import (
    default_mesh,
    distribute_keys,
    host_aggregate,
    init_distributed,
    sharded_counter_step,
)

__all__ = [
    "default_mesh",
    "distribute_keys",
    "host_aggregate",
    "init_distributed",
    "sharded_counter_step",
]

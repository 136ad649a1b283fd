"""Meshes of processes, collectives, distributed inference and resampling
(counterpart of modppl_tpu/parallel/__init__.py): particle and chain data
parallelism over a ``(dp, sp)`` mesh, one process a shard, collective
resampling with a fixed reduction order (bitwise the same at any shard
count), distributed logsumexp, and the runtime bring-up."""

from modppl_tpu_torch.parallel.mesh import (
    constrain_particles,
    data_sharding,
    global_mesh,
    initialize_runtime,
    make_mesh,
    particle_sharding,
    replicated,
)
from modppl_tpu_torch.parallel.resample import (
    RESAMPLERS,
    fused_systematic_resample_or_none,
    gather_particles,
    multinomial_parents,
    residual_parents,
    stratified_parents,
    systematic_parents,
)
from modppl_tpu_torch.parallel.sharded_smc import (
    make_resample_step,
    sharded_batched_particle_filter,
)

__all__ = [
    "make_mesh", "global_mesh", "initialize_runtime",
    "particle_sharding", "data_sharding", "replicated", "constrain_particles",
    "RESAMPLERS", "systematic_parents", "multinomial_parents",
    "stratified_parents", "residual_parents", "gather_particles",
    "fused_systematic_resample_or_none",
    "sharded_batched_particle_filter", "make_resample_step",
]

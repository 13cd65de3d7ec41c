"""Multi-device parallelism: particle data-parallelism over
torch.distributed (one process a device; parallel/launch.py starts them)."""
from .sharding import (Group, Layout, boundcond_sharded, gather_particles,
                       make_sharded_advance, make_sharded_conccalc,
                       make_sharded_depo_scatter, pad_particles,
                       particle_mesh, reduce_acc_partials, replicate,
                       shard_particles, split_sharded, zero_acc_partials)

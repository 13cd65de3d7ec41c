"""Multi-device parallelism over torch.distributed (one process a device;
parallel/launch.py starts them): particle data-parallelism
(parallel/sharding.py) and the met fields' tiles (parallel/domain.py,
parallel/tiles.py)."""
from .sharding import (Group, Layout, boundcond_sharded,
                       free_after_kill_mask, gather_particles,
                       make_sharded_advance, make_sharded_conccalc,
                       make_sharded_depo_scatter, pad_particles,
                       particle_mesh, reduce_acc_partials, replicate,
                       shard_particles, split_sharded, zero_acc_partials)

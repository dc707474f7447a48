"""Multi-card parallelism on ``torch.distributed``: meshes of ranks, the
sharded lifecycle step and grouped verify, and the coefficient-sharded NTTs.

Port of the JAX package's ``parallel/`` (``shard_map`` over a device mesh
there).  One process drives one device; the process group's backend follows
the device (NCCL on the card, gloo on the CPU):

* **dp**: the batch of keys / aggregation groups split over ranks;
* **tp**: the rank axis of sk/sig split over ranks, with A·x and the verify's
  observed sum all-reduced over it;
* **sp**: the polynomial coefficient axis split over ranks
  (``distributed_ntt``);
* aggregation: per-rank partial weighted sums all-reduced over dp.

A rank takes and returns its own shards (``sharded.shard`` cuts a global
array as JAX's PartitionSpecs do).  ``distributed.initialize`` joins a
torchrun world; ``_launch.launch`` starts a world of n processes on one host.
"""
from .mesh import make_mesh
from .sharded import prepare_real, sharded_lifecycle_step

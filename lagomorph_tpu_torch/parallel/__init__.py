"""Device-mesh and multi-process parallelism.

Port of ``lagomorph_tpu/parallel``.  Two execution models, as the JAX
package has:

* one process drives a mesh of devices (:class:`.mesh.Mesh`, an ordered
  tuple of torch devices with a ``"data"`` axis; one device may appear more
  than once): batches are split over it and the atlas replicated
  (:func:`shard_batch`, :func:`replicate`), or each volume is split along
  X (:func:`spatial_sharding`, the halo-exchange shooting of
  :mod:`.sharded_epdiff` and the pencil fluid solve of
  :mod:`.sharded_fft`);
* several processes, one device each, over ``torch.distributed``
  (:mod:`.distributed`): each owns an interleaved shard of the subjects,
  and the builders sum losses and the atlas gradient with ``all_reduce``.
"""
from .mesh import (
    get_mesh,
    data_sharding,
    replicated_sharding,
    spatial_sharding,
    shard_batch,
    replicate,
    pad_batch_to_multiple,
)
from .distributed import (
    process_shard_indices,
    shard_sizes,
    put_global,
    local_shard,
    allsum_hosts,
)
from .sharded_fft import (
    sharded_fluid_operator,
    ShardedFluidMetric,
)
from .sharded_epdiff import (
    sharded_expmap,
    sharded_atlas_loss,
)

__all__ = [
    "get_mesh",
    "data_sharding",
    "replicated_sharding",
    "spatial_sharding",
    "shard_batch",
    "replicate",
    "pad_batch_to_multiple",
    "process_shard_indices",
    "shard_sizes",
    "put_global",
    "local_shard",
    "allsum_hosts",
    "sharded_fluid_operator",
    "ShardedFluidMetric",
    "sharded_expmap",
    "sharded_atlas_loss",
]

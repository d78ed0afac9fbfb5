from ttts_tpu_torch.parallel.mesh import (  # noqa: F401
    data_axis_size,
    initialize_distributed,
    is_primary,
    make_mesh,
    multihost_requested,
    replicate,
    shard_batch,
    with_sharding,
)

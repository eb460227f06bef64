from lip2speech_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    active_mesh,
    batch_sharding,
    make_mesh,
    pad_batch_to_multiple,
    replicated,
    shard_batch,
    use_mesh,
)

from basd_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_shard,
    create_mesh,
    mesh_from_config,
)

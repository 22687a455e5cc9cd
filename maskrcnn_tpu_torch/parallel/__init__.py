from .distributed import (  # noqa: F401
    broadcast_parameters,
    images_per_process,
    init_distributed,
    reduce_gradients,
)
from .mesh import create_mesh, gather_state, shard_model, sharded_dims  # noqa: F401

from .distributed import (  # noqa: F401
    broadcast_parameters,
    images_per_process,
    init_distributed,
    reduce_gradients,
)

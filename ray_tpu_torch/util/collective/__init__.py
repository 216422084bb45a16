from .collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    init_collective_group,
    reducescatter,
)

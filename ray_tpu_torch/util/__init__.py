from .placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from .scheduling_strategies import PlacementGroupSchedulingStrategy  # noqa: F401
from .actor_pool import ActorPool  # noqa: F401
from .queue import Queue  # noqa: F401

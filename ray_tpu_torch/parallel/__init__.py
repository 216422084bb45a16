"""Multi-device layouts of the port on torch.distributed: the mesh and
its sharding rules (`mesh`), the ring's neighbour exchange (`ring`), the
sequence- and data-parallel train step (`step`) and the launcher of
multi-process worlds (`launch`). Ring attention itself is
`ops.ring_attention`."""
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    LOGICAL_RULES,
    MeshSpec,
    logical_to_spec,
    mesh_axes_for_logical,
    pad_to_multiple,
    spec_for_param,
    to_placements,
    with_logical_constraint,
)

"""Multi-device layouts of the port on torch.distributed: the mesh and
its sharding rules (`mesh`), the ring's and the pipeline's neighbour
exchange (`ring`), the all-reduces in place and differentiable
(`collectives`), the sequence-, data- and expert-parallel train step
(`step`), the GPipe pipeline (`pipeline`) and the launcher of
multi-process worlds with the functions its ranks run (`launch`). Ring
attention itself is `ops.ring_attention`; expert parallelism is
`models.mixtral`'s mesh branch; `ray_tpu_torch.dryrun` runs every
strategy together."""
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
from .pipeline import (  # noqa: F401
    local_stage,
    pipeline_spec,
    pipelined,
    sequential_reference,
    stack_stage_params,
)

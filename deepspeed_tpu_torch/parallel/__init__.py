from .mesh import (  # noqa: F401
    MESH_AXES,
    DeviceMesh,
    MeshShape,
    axis_size,
    build_mesh,
    ensure_global_mesh,
    get_global_mesh,
    get_global_mesh_shape,
    reset_global_mesh,
    set_global_mesh,
)
from .topology import (  # noqa: F401
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    PipelineParallelGrid,
    ProcessTopology,
)

"""Process-group communication of the port (``deepspeed_tpu/comm``)."""
from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_into_tensor,
    all_reduce,
    all_to_all_single,
    barrier,
    broadcast,
    destroy_process_group,
    get_data_parallel_world_size,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    reduce_scatter,
    reduce_scatter_tensor,
)
from deepspeed_tpu_torch.comm.mesh import (  # noqa: F401
    MeshConfig,
    MeshManager,
    get_mesh_manager,
    initialize_mesh,
    reset_mesh,
)

"""dp and tp over torch.distributed (port of sdtpu/parallel/): the mesh,
the sharding rules, the tensor-parallel primitives and the launcher."""

from sdtpu_torch.parallel.launch import init_from_env, local_device, spawn  # noqa: F401
from sdtpu_torch.parallel.mesh import Mesh, broadcast_object, make_mesh  # noqa: F401
from sdtpu_torch.parallel.sharding import (  # noqa: F401
    gather_batch,
    gather_params,
    param_specs,
    shard_batch,
    shard_params,
)
from sdtpu_torch.parallel.tp import (  # noqa: F401
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    scatter_to_tp,
)

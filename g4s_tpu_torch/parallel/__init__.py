from g4s_tpu_torch.parallel.mesh import (  # noqa: F401
    RankGrid, device_mesh_shape, init_from_env, init_ranks,
)
from g4s_tpu_torch.parallel.halo import (  # noqa: F401
    halo_copy_ghost, halo_exchange_add, halo_exchange_axis,
)
from g4s_tpu_torch.parallel.collectives import (  # noqa: F401
    pdot, pmax, pmin, pnorm2, psum_scalar,
)

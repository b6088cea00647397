from g4s_tpu_torch.models.citcoms.config import (  # noqa: F401
    CitcomConfig, load_config, parse_flat_config, config_from_table,
)
from g4s_tpu_torch.models.citcoms.mesh import (  # noqa: F401
    RegionalMesh, build_regional_mesh, initial_temperature,
)
from g4s_tpu_torch.models.citcoms.driver import (  # noqa: F401
    CitcomModel, State, state_from_numpy,
)
from g4s_tpu_torch.models.citcoms.full_driver import (  # noqa: F401
    FullSphereModel,
)
from g4s_tpu_torch.models.citcoms.exchanger import CoupledRun  # noqa: F401

"""DeePMD (counterpart of g4s_tpu/models/deepmd): every descriptor of the
reference (se_e2_a, se_e2_r, se_atten, se_a_ebd, se_t, hybrid, loc_frame,
se_a_mask; the cell-list env mat and se_a_ef), networks, the energy model
with forces and virial, training (the energy Trainer with its hand-written
optax-exact Adam, multi-task and data-parallel steps; DOS, dipole/polar
and spin training), checkpoints (g4s_tpu_torch.ckpt), freeze, DeepPot
inference, NVT MD, model compression (se_e2_a), DPLR (dplr), the ASE
calculator (calculator), the i-PI driver (ipi) and NVNMD (nvnmd).
"""
from g4s_tpu_torch.models.deepmd.descriptor import (  # noqa: F401
    DescriptorSpec, env_mat, env_mat_celllist, atomic_descriptor_ef,
    compute_stats,
)
from g4s_tpu_torch.models.deepmd.model import (  # noqa: F401
    ModelSpec, init_params, total_energy, energy_force_virial,
)
from g4s_tpu_torch.models.deepmd.data import DataSystem, load_system  # noqa: F401
from g4s_tpu_torch.models.deepmd.train import (  # noqa: F401
    Trainer, LossConfig, LRConfig, make_dp_train_step,
)
from g4s_tpu_torch.models.deepmd.freeze import (  # noqa: F401
    freeze, load_frozen, params_from_numpy, params_to_numpy,
)
from g4s_tpu_torch.models.deepmd.infer import DeepPot, calc_model_devi  # noqa: F401
from g4s_tpu_torch.models.deepmd.dplr import (  # noqa: F401
    DipoleChargeModifier, ewald_recp,
)
from g4s_tpu_torch.models.deepmd.calculator import DP, calc_ase_free  # noqa: F401
from g4s_tpu_torch.models.deepmd.ipi import IPIDriver  # noqa: F401
from g4s_tpu_torch.models.deepmd.nvnmd import (  # noqa: F401
    NvnmdSpec, build_map, init_nvnmd_params, load_wrapped, wrap_model,
)

WATER_SPEC = ModelSpec(
    DescriptorSpec(rcut=6.0, rcut_smth=0.5, sel=(46, 92), ntypes=2),
    embed_neurons=(25, 50, 100), axis_neuron=16,
    fit_neurons=(240, 240, 240))

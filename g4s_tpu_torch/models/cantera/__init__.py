"""Cantera on the port (counterpart of g4s_tpu/models/cantera): the YAML
mechanism loader, NASA7/NASA9/Shomate thermo with the Redlich-Kwong and
Peng-Robinson real-gas phases, mass-action kinetics through the graph
engine (mxv/vxm), the constant-volume and constant-pressure reactors,
reactor networks and the shock-tube protocol; equilibrium (element
potentials, VCS with condensed species, HP and UV), mixture-averaged,
multicomponent and specialty transport, surface phases and interface
kinetics, SolutionArray, and the 1-D flames (burner, free, counterflow,
impinging jet) with their steady solves; the integrator is
g4s_tpu_torch.ops.odeint.bdf_solve. The phase models: IAPWS-95 water
(water), HKFT standard states and the variable Debye parameter (hkft),
Pitzer (hmw) and Debye-Huckel (electrolyte) electrolytes, condensed,
lattice and solution phases (condensed), the tpx pure fluids
(purefluid), the two-temperature plasma (plasma) and VCS multiphase
equilibrium with solution phases (vcs_multiphase). ops/odeint.py also
holds the banded Newton path (bdf_solve(bandwidth=)), forward
sensitivities, the DAE solver, and the lockstep batched BDF behind
ShockTubeBenchmark.run_ntc_sweep_batched.
"""
from g4s_tpu_torch.models.cantera.mech import (  # noqa: F401
    Mechanism, load_mechanism, mechanism_from_reference, R_GAS, P_REF,
)
from g4s_tpu_torch.models.cantera.kinetics import (  # noqa: F401
    build_kinetics, net_production_rates, rates_of_progress,
    forward_rate_constants, equilibrium_constants,
)
from g4s_tpu_torch.models.cantera.thermo import (  # noqa: F401
    GasState, cp0_R, h0_RT, s0_R, rk_mix, rk_molar_volume, rk_pressure,
    pr_mix, pr_molar_volume, pr_pressure, pr_departures,
)
from g4s_tpu_torch.models.cantera.reactor import (  # noqa: F401
    IdealGasConstPressureReactor, IdealGasConstVolumeReactor,
)
from g4s_tpu_torch.models.cantera.network import (  # noqa: F401
    ReactorNet, Reservoir, Wall, MassFlowController, Valve,
)
from g4s_tpu_torch.models.cantera.shock_tube import (  # noqa: F401
    ShockTubeBenchmark, ignition_delay, stoich_mixture, NTC_TEMPERATURES,
)
from g4s_tpu_torch.models.cantera.equilibrium import equilibrate_tp  # noqa: F401
from g4s_tpu_torch.models.cantera.solution_array import SolutionArray  # noqa: F401
from g4s_tpu_torch.models.cantera.transport import (  # noqa: F401
    load_transport, mixture_viscosity, thermal_conductivity,
    mixture_diffusion_coeffs,
)
from g4s_tpu_torch.models.cantera.surface import (  # noqa: F401
    InterfaceKinetics, SurfacePhase, load_interface,
    net_production_rates_interface, advance_coverages)
from g4s_tpu_torch.models.cantera.electrolyte import (  # noqa: F401
    DebyeHuckelPhase, load_debye_huckel,
    molality_activity_coefficients, ionic_strength)

"""CitcomS-style flat `name=value` config parsing (the port's copy of
g4s_tpu/models/citcoms/config.py, which imports nothing of JAX; the port
keeps its own so it imports nothing of g4s_tpu).

Semantics of citcoms/lib/Parsing.c:87-176 (whole file tokenized into a
key->value table, later lookups pull typed values with defaults) with the
defaults used by the Cookbook2 benchmark path (citcoms/lib/Instructions.c
input_* calls; viscosity defaults Viscosity_structures.c:62-145). Unlike the
reference we resolve everything once into a typed dataclass; the full
resolved config can be dumped for reproducibility like the reference's pid
file (Instructions.c:1885 print_all_config_parameters).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, List


def parse_flat_config(text: str) -> Dict[str, str]:
    """Tokenize `name=value` pairs; '#'/';' start comments; whitespace
    separates entries; later duplicates win (reference searches its arg
    list backwards, Parsing.c:604)."""
    table: Dict[str, str] = {}
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0].split(";", 1)[0]
        for tok in line.split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                table[k.strip()] = v.strip()
    return table


def load_flat_config(path) -> Dict[str, str]:
    with open(path) as f:
        return parse_flat_config(f.read())


def _get(table, key, default, cast):
    if key in table and table[key] != "":
        return cast(table[key])
    return default


def _get_vec(table, key, n, default, cast=float) -> List:
    if key not in table:
        return [default] * n
    vals = [cast(v) for v in table[key].split(",")]
    return (vals + [default] * n)[:n]


_BOOL = {"on": True, "off": False, "1": True, "0": False,
         "true": True, "false": False, "yes": True, "no": False}


@dataclasses.dataclass
class CitcomConfig:
    # mesher (Instructions.c:330-380)
    nodex: int = 9
    nodey: int = 9
    nodez: int = 9
    nprocx: int = 1
    nprocy: int = 1
    nprocz: int = 1
    theta_min: float = 0.0
    theta_max: float = 0.0
    fi_min: float = 0.0
    fi_max: float = 0.0
    radius_inner: float = 0.55
    radius_outer: float = 1.0

    # control
    minstep: int = 1
    maxstep: int = 1000
    storage_spacing: int = 10
    checkpoint_frequency: int = 100
    datadir: str = "."
    datafile: str = "citcom"
    output_format: str = "ascii"      # ascii | ascii-gz | vtk (Output.c:41)
    vtk_format: str = "binary"        # binary | ascii (Output_vtk.c)
    rayleigh: float = 0.0
    Q0: float = 0.0
    inputdiffusivity: float = 1.0

    # anelastic (TALA) continuity + heating (get_elt_c refstate choice 1)
    disptn_number: float = 0.0          # Di; 0 = Boussinesq
    gruneisen: float = 1.2
    surfaceT: float = 0.0               # nondim surface temperature Ts

    # phase transitions (Phase_change.c phase_change_input:66-99)
    Ra_410: float = 0.0
    clapeyron410: float = 0.0
    transT410: float = 0.0
    width410: float = 0.0058
    z_410: float = 0.06434
    Ra_670: float = 0.0
    clapeyron670: float = 0.0
    transT670: float = 0.0
    width670: float = 0.0058
    z_670: float = 0.1036
    Ra_cmb: float = 0.0
    clapeyroncmb: float = 0.0
    transTcmb: float = 0.0
    widthcmb: float = 0.0058
    z_cmb: float = 0.45

    # thermochemical convection (Composition_related.c / Tracer_setup.c)
    tracer: bool = False
    tracers_per_element: int = 10
    chemical_buoyancy: bool = False
    buoyancy_ratio: float = 1.0
    z_interface: float = 0.7

    # lithosphere age BCs (Lith_age.c lith_age_input:47-66)
    lith_age: bool = False
    lith_age_file: str = ""
    lith_age_depth: float = 0.0471
    mantle_temp: float = 1.0
    lith_age_uniform_myr: float = 60.0
    therm_diff: float = 1.0e-6          # m^2/s, for Myr nondim (scalet)

    # time-dependent boundary-condition FILE SEQUENCES re-read per step
    # (Citcom.c:254-272; Regional_read_input_from_files.c:40-310):
    # epoch files named <prefix><age_My> are bracketed around the current
    # age and linearly interpolated
    start_age: float = 40.0             # My (Problem_related.c:155)
    reset_startage: bool = False
    lith_age_time: bool = False         # Lith_age.c:59
    vbcs_file: bool = False             # Problem_related.c:479 role
    vel_bound_file: str = ""
    tbcs_file: bool = False
    temp_bound_file: str = ""
    mat_control: bool = False
    mat_file: str = ""

    # dimensional constants for observables (Instructions.c:700-790 defaults)
    density: float = 3340.0
    density_above: float = 1030.0
    density_below: float = 6600.0
    grav_acc: float = 9.81
    radius_km: float = 6371.0
    grav_const: float = 6.67e-11
    therm_exp: float = 3.0e-5
    ref_temperature: float = 2700.0
    llmax: int = 20

    # solver (Instructions.c:650-680)
    solver_type: str = "cgrad"
    accuracy: float = 1.0e-4
    inner_accuracy_scale: float = 1.0
    check_pressure_convergence: bool = True
    piterations: int = 100
    vlowstep: int = 250
    vhighstep: int = 1
    precond: bool = True
    # multigrid (Instructions.c:342-360, General_matrix_functions.c:152)
    mgunitx: int = 1
    mgunity: int = 1
    mgunitz: int = 1
    levels: int = 1
    mg_cycle: int = 1
    down_heavy: int = 1
    up_heavy: int = 1

    # bc (Instructions.c:442-480)
    topvbc: int = 0
    topvbxval: float = 0.0
    topvbyval: float = 0.0
    botvbc: int = 0
    botvbxval: float = 0.0
    botvbyval: float = 0.0
    toptbc: int = 1
    toptbcval: float = 0.0
    bottbc: int = 1
    bottbcval: float = 1.0

    # ic (Initial_temperature.c:55-120)
    tic_method: int = 0
    num_perturbations: int = 0
    perturbl: List[int] = dataclasses.field(default_factory=lambda: [1])
    perturbm: List[int] = dataclasses.field(default_factory=lambda: [1])
    perturblayer: List[int] = dataclasses.field(default_factory=lambda: [1])
    perturbmag: List[float] = dataclasses.field(default_factory=lambda: [0.0])

    # viscosity (Viscosity_structures.c:62-145)
    num_mat: int = 1
    visc0: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    TDEPV: bool = True
    rheol: int = 3
    viscT: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    viscE: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    viscZ: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    SDEPV: bool = False
    sdepv_expt: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    sdepv_misfit: float = 0.001
    VMIN: bool = False
    visc_min: float = 1.0e-3
    VMAX: bool = False
    visc_max: float = 1.0e3
    VISC_UPDATE: bool = True
    PDEPV: bool = False
    pdepv_a: List[float] = dataclasses.field(default_factory=lambda: [1e20])
    pdepv_b: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    pdepv_y: List[float] = dataclasses.field(default_factory=lambda: [1e20])
    pdepv_eff: bool = True
    CDEPV: bool = False
    cdepv_ff: List[float] = dataclasses.field(
        default_factory=lambda: [1.0, 1.0])
    # anisotropic viscosity (Anisotropic_viscosity.c; radial director)
    ANIVISC: bool = False
    anivisc_mode: str = "orthotropic"   # orthotropic | ti
    ani_vis2_factor: float = 0.0        # delta_vis = 1 - eta_S/eta
    anivisc_gamma: float = 0.0          # ti normal-viscosity contrast

    # advection (Advection_diffusion.c:80-92)
    ADV: bool = True
    filter_temp: bool = False
    monitor_max_T: bool = True
    finetunedt: float = 0.9
    fixed_timestep: float = 0.0
    adv_gamma: float = 0.5
    adv_sub_iterations: int = 2

    @property
    def nel(self) -> int:
        return (self.nodex - 1) * (self.nodey - 1) * (self.nodez - 1)

    @property
    def nno(self) -> int:
        return self.nodex * self.nodey * self.nodez

    def dump(self) -> str:
        """pid-file-style dump of every resolved parameter."""
        out = io.StringIO()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            elif isinstance(v, bool):
                v = "on" if v else "off"
            out.write(f"{f.name}={v}\n")
        return out.getvalue()


def config_from_table(table: Dict[str, str]) -> CitcomConfig:
    c = CitcomConfig()
    num_mat = _get(table, "num_mat", 1, int)
    npert = _get(table, "num_perturbations", 0, int)
    for f in dataclasses.fields(CitcomConfig):
        name = f.name
        key = {"solver_type": "Solver", "precond": "precond",
               "filter_temp": "filter_temp", "inputdiffusivity":
               "inputdiffusivity"}.get(name, name)
        if key not in table:
            continue
        cur = getattr(c, name)
        if isinstance(cur, bool):
            setattr(c, name, _BOOL.get(table[key].lower(), cur))
        elif isinstance(cur, int):
            setattr(c, name, int(float(table[key])))
        elif isinstance(cur, float):
            setattr(c, name, float(table[key]))
        elif isinstance(cur, list):
            if name.startswith("perturb"):
                n = npert
            elif name == "cdepv_ff":
                n = len(cur)        # flavor count, not num_mat
            else:
                n = num_mat
            n = max(n, 1)
            cast = int if name in ("perturbl", "perturbm", "perturblayer") else float
            default = 1.0 if name in ("visc0", "sdepv_expt") else 0.0
            setattr(c, name, _get_vec(table, key, n, default, cast))
        else:
            setattr(c, name, table[key])
    c.num_mat = num_mat
    c.num_perturbations = npert
    # material vectors are always sized num_mat (allocate_visc_vars), with
    # N0 defaulting to 1.0 (Viscosity_structures.c:119-121)
    n = max(num_mat, 1)
    for name, dflt in (("visc0", 1.0), ("viscT", 0.0), ("viscE", 0.0),
                       ("viscZ", 0.0), ("sdepv_expt", 1.0),
                       ("pdepv_a", 1e20), ("pdepv_b", 0.0),
                       ("pdepv_y", 1e20)):
        vec = list(getattr(c, name))
        setattr(c, name, (vec + [dflt] * n)[:n])
    return c


def load_config(path) -> CitcomConfig:
    return config_from_table(load_flat_config(path))

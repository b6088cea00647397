"""Time-dependent boundary-condition FILE SEQUENCES (counterpart of
g4s_tpu/models/citcoms/bc_files.py; the readers are the port's own copy).

The reference main loop re-reads plate-reconstruction inputs every step
(bin/Citcom.c:254-272) through
`regional_read_input_files_for_timesteps` (Regional_read_input_from_
files.c:40-310): the current age in My (find_age_in_MY,
Problem_related.c:171-194: age = start_age -/+ elapsed*scalet by time
direction) selects the bracketing EPOCH FILES `<prefix><floor(age)>` and
`<prefix><floor(age)+1>`, whose fields are linearly interpolated in age.
Sequences supported, as in the reference:

  velocity  (action 1)  `vel_bound_file` — nox*noy lines of "vtheta vfi"
            in cm/yr, applied as essential top-surface velocity BCs
            scaled by data.scalev (Instructions.c:915).
  lith age  (action 2)  `lith_age_file` + lith_age_time=1 — surface age
            field in My, /scalet to diffusion time.
  material  (action 3)  `mat_file` — per-element material numbers from
            `<prefix><age>.0`.
  surface T (action 5)  `temp_bound_file` — surface temperatures applied
            as essential top TBCs.

Negative ages use file 0 with no interpolation (Regional_read_input_
from_files.c:105-119, 261-270).

`step_bcs` stamps the files' fields into host copies of the model's base
masks and values and moves each of the four arrays to the device once.
"""

from __future__ import annotations

import numpy as np
import torch

_MYR_S = 1.0e6 * 365.25 * 24 * 3600


def scalet(cfg) -> float:
    """Nondim time -> My (Instructions.c:913)."""
    R = cfg.radius_km * 1e3
    return (R * R / cfg.therm_diff) / _MYR_S


def scalev(cfg) -> float:
    """cm/yr -> nondim velocity (Instructions.c:915)."""
    R = cfg.radius_km * 1e3
    return (R / cfg.therm_diff) / (100 * 365.25 * 24 * 3600)


def find_age_in_my(cfg, elapsed_time: float, *, timedir: float = 1.0):
    """Problem_related.c:171-194."""
    if timedir >= 0:
        return cfg.start_age - elapsed_time * scalet(cfg)
    return cfg.start_age + elapsed_time * scalet(cfg)


def _bracket(age: float):
    """(age1, age2, weight, pos_age): files to read and the
    interpolation weight toward file2 (R_r_i_from_files.c:105-119)."""
    if age < 0.0:
        return 0.0, 0.0, 0.0, False
    a1 = float(int(age))
    a2 = a1 + 1.0
    return a1, a2, (age - a1) / (a2 - a1), True


def _epoch_path(prefix: str, age: float, suffix: str = "") -> str:
    return f"{prefix}{age:.0f}{suffix}"


def _read_columns(path: str, n: int, ncol: int) -> np.ndarray:
    vals = np.loadtxt(path, dtype=np.float64, ndmin=2)
    flat = vals.reshape(-1)[: n * ncol]
    if flat.size < n * ncol:
        raise ValueError(f"{path}: expected {n * ncol} values, "
                         f"got {flat.size}")
    return flat.reshape(n, ncol)


def _interp_files(prefix, age, n, ncol, suffix=""):
    a1, a2, w, pos = _bracket(age)
    v1 = _read_columns(_epoch_path(prefix, a1, suffix), n, ncol)
    if not pos:
        return v1
    v2 = _read_columns(_epoch_path(prefix, a2, suffix), n, ncol)
    return v1 + (v2 - v1) * w


def read_velocity_boundary(cfg, mesh, age: float, *, timedir: float = 1.0):
    """Action 1: (nsf, 2) nondim (vtheta, vfi) at the top surface."""
    nsf = cfg.nodex * cfg.nodey
    vb = _interp_files(cfg.vel_bound_file, age, nsf, 2)
    return vb * timedir * scalev(cfg)


def read_lith_age_t(cfg, age: float):
    """Action 2: (nsf,) surface ages in DIFFUSION time units
    (E->age_t = My / scalet)."""
    nsf = cfg.nodex * cfg.nodey
    ages_my = _interp_files(cfg.lith_age_file, age, nsf, 1)[:, 0]
    return ages_my / scalet(cfg)


def read_mat_from_file(cfg, age: float, nel: int):
    """Action 3: per-element material numbers (file1 only interpolation
    is nearest in the reference too — VIP are integer classes)."""
    a1, a2, w, pos = _bracket(age)
    v1 = _read_columns(_epoch_path(cfg.mat_file, a1, ".0"), nel, 1)[:, 0]
    if not pos or w < 0.5:
        return v1.astype(np.int32)
    return _read_columns(_epoch_path(cfg.mat_file, a2, ".0"),
                         nel, 1)[:, 0].astype(np.int32)


def read_temperature_boundary(cfg, age: float):
    """Action 5: (nsf,) nondim surface temperatures."""
    nsf = cfg.nodex * cfg.nodey
    return _interp_files(cfg.temp_bound_file, age, nsf, 1)[:, 0]


def uses_bc_files(cfg) -> bool:
    """Whether some file sequence is configured (bin/Citcom.c:254-272)."""
    return bool((cfg.vbcs_file and cfg.vel_bound_file)
                or (cfg.tbcs_file and cfg.temp_bound_file)
                or (cfg.lith_age and cfg.lith_age_time
                    and cfg.lith_age_file))


def step_bcs(model, elapsed_time: float, *, timedir: float = 1.0):
    """Per-step BC overrides for CitcomModel.step_with_bcs: (tbc_mask,
    tbc_val, vbc_mask, vbc_val) on the model's device with the
    time-dependent surface fields stamped in, or None when no file
    sequence is configured (bin/Citcom.c:254-272)."""
    cfg = model.cfg
    use_v = cfg.vbcs_file and cfg.vel_bound_file
    use_t = cfg.tbcs_file and cfg.temp_bound_file
    use_age = cfg.lith_age and cfg.lith_age_time and cfg.lith_age_file
    if not (use_v or use_t or use_age):
        return None
    age = find_age_in_my(cfg, elapsed_time, timedir=timedir)
    m = model.mesh
    nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
    tbc_mask, tbc_val, vbc_mask, vbc_val = (
        a.copy() for a in model.host_bcs)
    # node layout: node = (iy*nox + ix)*noz + iz, top surface iz=noz-1
    top = (np.arange(noy * nox) * noz) + (noz - 1)
    if use_v:
        vb = read_velocity_boundary(cfg, m, age, timedir=timedir)
        vbc_val[top, 0] = vb[:, 0]
        vbc_val[top, 1] = vb[:, 1]
        vbc_val[top, 2] = 0.0
        vbc_mask[top] = True
    if use_t:
        tb = read_temperature_boundary(cfg, age)
        tbc_val[top] = tb
        tbc_mask[top] = True
    if use_age:
        from g4s_tpu_torch.models.citcoms import lith_age as la
        age_nd = read_lith_age_t(cfg, age)
        tbc_mask, tbc_val = la.lith_age_tbc(
            cfg, m, age_nd, tbc_mask, tbc_val)
    dev = model.device
    return (torch.from_numpy(np.ascontiguousarray(tbc_mask)).to(dev),
            torch.as_tensor(tbc_val, dtype=model.dtype, device=dev),
            torch.from_numpy(np.ascontiguousarray(vbc_mask)).to(dev),
            torch.as_tensor(vbc_val, dtype=model.dtype, device=dev))

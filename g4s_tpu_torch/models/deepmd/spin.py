"""Atomic-spin model support (counterpart of g4s_tpu/models/deepmd/spin.py;
deepmd/utils/spin.py + the spin branches of se_a.py/ener.py).

The reference represents each magnetic atom by an extra VIRTUAL particle
displaced from the real atom along its spin:

    x_virtual = x_real + virtual_len[t] * S / spin_norm[t]

and trains an ordinary energy/force model on the augmented system whose
type table appends one virtual type per spin-carrying real type. Forces on
virtual atoms are the magnetic forces (dE/d x_virtual; LAMMPS fix
precession uses them as dE/dS up to the virtual_len/spin_norm scale).

So training needs only the sel/ntypes expansion below and the standard
trainer; augment and split_forces are the coordinate and force algebra
for inference with real (coord, spin) inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class SpinSpec(NamedTuple):
    use_spin: Tuple[bool, ...]      # per REAL type
    virtual_len: Tuple[float, ...]  # per spin-carrying type, in order
    spin_norm: Tuple[float, ...]

    @property
    def ntypes_spin(self) -> int:
        return sum(self.use_spin)


def expand_sel(sel, spin: SpinSpec):
    """Append the spin types' sel for the virtual types
    (se_a.py:197-199 sel_a_spin)."""
    sel = list(sel)
    return tuple(sel + [sel[i] for i, u in enumerate(spin.use_spin) if u])


def expand_ntypes(ntypes: int, spin: SpinSpec) -> int:
    return ntypes + spin.ntypes_spin


def _spin_types(spin: SpinSpec):
    return [i for i, u in enumerate(spin.use_spin) if u]


def augment(coord, spin_vec, types, spin: SpinSpec):
    """(coord (N,3), spin (N,3) zero on non-magnetic atoms, types (N,))
    -> (coord_aug (N+M,3), types_aug (N+M,)) with one virtual particle per
    magnetic atom, ordered real-then-virtual (the data layout of the
    reference's spin example). spin_vec may be an array or a tensor;
    gradients flow from coord_aug to both coord and spin_vec."""
    types_np = np.asarray(torch.as_tensor(types).cpu())
    spin_vec = torch.as_tensor(spin_vec, dtype=coord.dtype,
                               device=coord.device)
    ntypes_real = len(spin.use_spin)
    vcoords, vtypes = [], []
    for k, t in enumerate(_spin_types(spin)):
        m_np = types_np == t
        m = torch.as_tensor(m_np, device=coord.device)
        disp = spin_vec[m] * (spin.virtual_len[k] / spin.spin_norm[k])
        vcoords.append(coord[m] + disp)
        vtypes.append(np.full(int(m_np.sum()), ntypes_real + k, np.int32))
    coord_aug = torch.cat([coord] + vcoords, dim=0)
    types_aug = np.concatenate([types_np] + vtypes)
    return coord_aug, torch.as_tensor(types_aug, device=coord.device)


def split_forces(forces, types_aug, spin: SpinSpec):
    """Split augmented-system forces into (atomic forces on real atoms,
    magnetic forces dE/dS per magnetic atom). dE/dS = f_virtual *
    virtual_len/spin_norm by the chain rule through `augment`."""
    types_np = np.asarray(torch.as_tensor(types_aug).cpu())
    ntypes_real = len(spin.use_spin)
    real = torch.as_tensor(types_np < ntypes_real, device=forces.device)
    f_mag = []
    for k, _t in enumerate(_spin_types(spin)):
        m = torch.as_tensor(types_np == ntypes_real + k,
                            device=forces.device)
        f_mag.append(forces[m] * (spin.virtual_len[k] / spin.spin_norm[k]))
    return forces[real], (torch.cat(f_mag, dim=0) if f_mag
                          else forces.new_zeros((0, 3)))

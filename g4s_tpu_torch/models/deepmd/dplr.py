"""DPLR: long-range electrostatics for DeePMD models (counterpart of
g4s_tpu/models/deepmd/dplr.py).

The reference's components:
  - ewald_recp (deepmd/source/lib/src/ewald.cc, exposed by
    source/op/ewald_recp.cc): the reciprocal-space Ewald sum
        E = C/(2 pi V) * sum_{m != 0} exp(-pi^2 |m|^2 / beta^2)/|m|^2
            * |S(m)|^2,   S(m) = sum_j q_j e^{2 pi i m . s_j}
    with C = 14.39964535475697 eV A / e^2 and the same K-grid rule
    (KK_d = ceil-to-even(L_d / spacing)).
  - DipoleChargeModifier (deepmd/infer/data_modifier.py): a trained
    dipole model predicts Wannier-centroid displacements for selected
    atom types; ion charges sit on atoms and model charges on the
    centroids; the reciprocal-space energy of that charge system corrects
    the short-range DP energy. The correction is a function of the
    coordinates, so torch.autograd gives the forces the reference pushes
    back through hand-built gradient graphs, and the virial through the
    strain.

The structure factors are one (n_atoms, n_k) cos/sin product, as in the
reference. Everything here is float64, whatever the dipole model's dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from g4s_tpu_torch.sparse.containers import resolve_device

ELECTROSTATIC_CONVERSION = 14.39964535475696995031   # eV A / e^2

F64 = torch.float64


def ewald_kgrid(box, spacing: float = 4.0) -> np.ndarray:
    """KK per axis: L/spacing, rounded up to even (ewald.cc cmpt_k)."""
    if isinstance(box, torch.Tensor):
        box = box.detach().cpu().numpy()
    box = np.asarray(box, np.float64).reshape(3, 3)
    KK = np.zeros(3, np.int64)
    for d in range(3):
        ll = np.sqrt((box[d] ** 2).sum())
        k = int(ll / spacing)
        if k * spacing < ll:
            k += 1
        if k % 2:
            k += 1
        KK[d] = k
    return KK


def _mvecs(KK) -> np.ndarray:
    """All integer m vectors with |m_d| <= KK_d/2, excluding 0 (host)."""
    g = np.meshgrid(*[np.arange(-k // 2, k // 2 + 1) for k in KK],
                    indexing="ij")
    m = np.stack([x.ravel() for x in g], axis=1)
    return m[np.any(m != 0, axis=1)].astype(np.float64)


def _ewald_recp_energy(coord, charge, box, beta: float, kk):
    m = torch.as_tensor(_mvecs(kk), device=coord.device)   # (n_k, 3)
    rec = torch.linalg.inv_ex(box)[0]                  # rows: recip (no 2pi)
    frac = coord @ rec                                 # (n, 3)
    phase = 2.0 * np.pi * frac @ m.T                   # (n, n_k)
    sr = charge @ torch.cos(phase)                     # (n_k,)
    si = charge @ torch.sin(phase)
    # rows of inv(box)^T are the (no-2pi) reciprocal vectors b_d with
    # a_i . b_j = delta_ij
    rm = m @ rec.T                                     # (n_k, 3)
    nm2 = torch.sum(rm * rm, dim=1)
    w = torch.exp(-np.pi ** 2 * nm2 / (beta * beta)) / nm2
    vol = torch.abs(torch.linalg.det(box))
    e = torch.sum(w * (sr * sr + si * si)) / (2.0 * np.pi * vol)
    return e * ELECTROSTATIC_CONVERSION


def _energy_force_virial(energy_of, coord, box):
    """(E, -dE/dx, -dE/d(strain)) of energy_of(coord, box), coordinates and
    box strained together for the virial."""
    with torch.enable_grad():
        x = coord.detach().requires_grad_(True)
        strain = torch.zeros((3, 3), dtype=F64, device=coord.device,
                             requires_grad=True)
        one = torch.eye(3, dtype=F64, device=coord.device) + strain
        e = energy_of(x @ one, box @ one)
        g_x, g_s = torch.autograd.grad(e, (x, strain))
    return e.detach(), -g_x, -g_s


def _f64(x, device):
    return torch.as_tensor(x, dtype=F64, device=device)


def ewald_recp(coord, charge, box, *, beta: float = 2.0,
               spacing: float = 4.0, device="cuda"):
    """Reciprocal-space Ewald energy, forces, virial (ewald.cc parity).

    coord (n, 3) A; charge (n,) e; box (3, 3) rows = cell vectors; all
    taken in float64 on `device`. Returns (energy eV, force (n, 3) eV/A,
    virial (3, 3)) tensors."""
    device = resolve_device(device)
    box = _f64(box, device).reshape(3, 3)
    kk = tuple(int(k) for k in ewald_kgrid(box, spacing))
    coord = _f64(coord, device)
    charge = _f64(charge, device)
    return _energy_force_virial(
        lambda x, b: _ewald_recp_energy(x, charge, b, float(beta), kk),
        coord, box)


def ewald_real_and_self(coord, charge, box, *, beta: float = 2.0,
                        rcut: float = 6.0, n_images: int = 1,
                        device="cuda"):
    """Real-space + self terms (a test oracle for the full electrostatics;
    the modifier itself uses only the reciprocal part, as the reference's
    EwaldRecp op does). Returns the energy in eV, a float64 tensor."""
    device = resolve_device(device)
    coord = _f64(coord, device)
    charge = _f64(charge, device)
    box = _f64(box, device)
    n = coord.shape[0]
    qq = charge[:, None] * charge[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=device)
    e = torch.zeros((), dtype=F64, device=device)
    for i in range(-n_images, n_images + 1):
        for j in range(-n_images, n_images + 1):
            for k in range(-n_images, n_images + 1):
                off = _f64([i, j, k], device) @ box
                d = coord[:, None, :] - coord[None, :, :] + off
                r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-300)
                mask = r < rcut
                if i == j == k == 0:
                    mask = mask & ~eye
                e = e + 0.5 * torch.sum(torch.where(
                    mask, qq * torch.special.erfc(beta * r) / r, 0.0))
    e_self = -beta / np.sqrt(np.pi) * torch.sum(charge * charge)
    return (e + e_self) * ELECTROSTATIC_CONVERSION


class DipoleChargeModifier:
    """Long-range correction from a trained dipole (Wannier) model
    (deepmd/infer/data_modifier.py role), on the device of the dipole
    model's parameters.

    model_charge_map[t]: charge placed at the predicted Wannier centroid
    of each atom of type t; sys_charge_map[t]: ionic charge on each atom.
    eval(coord, box, types) returns (dE, dF, dV), float64 tensors: the
    corrections to ADD to the short-range DP model's outputs.
    """

    def __init__(self, dipole_params, tensor_nets, spec,
                 model_charge_map: Sequence[float],
                 sys_charge_map: Sequence[float],
                 ewald_h: float = 4.0, ewald_beta: float = 2.0):
        from g4s_tpu_torch.models.deepmd.model import params_to
        self.params = params_to(dipole_params, dtype=F64)
        self.nets = params_to(tensor_nets, dtype=F64)
        self.device = self.params["stats"]["davg"].device
        self.spec = spec
        self.model_q = _f64(np.asarray(model_charge_map, np.float64),
                            self.device)
        self.sys_q = _f64(np.asarray(sys_charge_map, np.float64),
                          self.device)
        self.h = float(ewald_h)
        self.beta = float(ewald_beta)

    def _energy(self, coord, box, types, kk):
        from g4s_tpu_torch.models.deepmd.fit_tensor import atomic_dipole
        dip = atomic_dipole(self.params, self.nets, self.spec,
                            coord, box, types)         # (n, 3) displacement
        wc = coord + dip
        all_pos = torch.cat([coord, wc], dim=0)
        all_q = torch.cat([self.sys_q[types], self.model_q[types]])
        return _ewald_recp_energy(all_pos, all_q, box, self.beta, kk)

    def eval(self, coord, box, types):
        coord = _f64(coord, self.device).reshape(-1, 3)
        box = _f64(box, self.device).reshape(3, 3)
        types = torch.as_tensor(types, device=self.device).long()
        kk = tuple(int(k) for k in ewald_kgrid(box, self.h))
        return _energy_force_virial(
            lambda x, b: self._energy(x, b, types, kk), coord, box)

"""Chemical equilibrium by Gibbs minimization (counterpart of
g4s_tpu/models/cantera/equilibrium.py).

Reference capability: cantera/src/equil (ChemEquil — element-potential
method; VCS multiphase). Used by Solution.equilibrate and the
set_equivalence_ratio setup paths.

Element-potential formulation (same as ChemEquil): at constant T, P the
equilibrium mole fractions satisfy

    x_k = exp( -g_k(T)/RT + sum_e A_ke lambda_e + ln(P0/P) * 0 ... )

with A the element-composition matrix and lambda the element potentials.
We solve for (lambda, log n_tot) with damped Newton on the element
conservation equations, all in f64 numpy (host-side setup path, like the
reference's use). The standard chemical potentials come from the port's
thermo on the device the caller names (`device=`, default "cuda"),
computed once per call and read back once; the Newton iterations are the
reference's numpy, step for step."""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from g4s_tpu_torch.models.cantera.mech import Mechanism, P_REF, R_GAS
from g4s_tpu_torch.models.cantera.thermo import h0_RT, s0_R
from g4s_tpu_torch.sparse.containers import resolve_device


def _g0_RT(mech: Mechanism, T: float, device) -> np.ndarray:
    """mu0_k/RT = h0/RT - s0/R at T, on `device` in f64, read back."""
    t = torch.as_tensor(float(T), dtype=torch.float64,
                        device=resolve_device(device))
    return (h0_RT(mech, t) - s0_R(mech, t)).cpu().numpy()


def _h0_RT(mech: Mechanism, T: float, device) -> np.ndarray:
    t = torch.as_tensor(float(T), dtype=torch.float64,
                        device=resolve_device(device))
    return h0_RT(mech, t).cpu().numpy()


def element_matrix(mech: Mechanism) -> Tuple[np.ndarray, list]:
    els = sorted({e for c in mech.compositions for e in c})
    A = np.zeros((mech.nspec, len(els)))
    for k, comp in enumerate(mech.compositions):
        for e, n in comp.items():
            A[k, els.index(e)] = n
    return A, els


def equilibrate_tp(mech: Mechanism, T: float, P: float, x0: np.ndarray,
                   *, max_iter: int = 200, tol: float = 1e-12,
                   device="cuda") -> np.ndarray:
    """Equilibrium mole fractions at fixed (T, P) from initial composition
    x0 (which fixes the element abundances)."""
    A, els = element_matrix(mech)
    ne = len(els)
    x0 = np.asarray(x0, np.float64)
    x0 = x0 / x0.sum()
    b = A.T @ x0                       # element moles per mole of mixture
    keep = b > 0
    A = A[:, keep]
    b = b[keep]
    ne = b.size

    # dimensionless standard chemical potential at (T, P): mu/RT
    g_RT = _g0_RT(mech, T, device)
    g_RT = g_RT + np.log(P / P_REF)

    # exclude species containing elements absent from the mixture
    feasible = (np.asarray([sum(c.values()) for c in mech.compositions]) > 0)
    full_A, _ = element_matrix(mech)
    absent = full_A[:, ~keep].sum(axis=1) > 0
    feasible &= ~absent

    # Element-potential system (ChemEquil formulation):
    #   stationarity:  ln x_k = (A lam)_k - g_k(T,P)
    #   constraints :  N * A^T x = b   (ne eqs)   and   sum x = 1
    # unknowns: lam (ne) and ln N.
    lam = np.zeros(ne)
    lnN = 0.0

    def fractions(lam):
        expo = A @ lam - g_RT
        expo = np.where(feasible, np.clip(expo, -300, 300), -np.inf)
        return np.exp(expo)

    # initialize lambda from a least-squares fit through the initial comp
    mask = x0 > 1e-20
    if mask.sum() >= 1:
        rhs = g_RT[mask] + np.log(np.maximum(x0[mask], 1e-30))
        lam, *_ = np.linalg.lstsq(A[mask], rhs, rcond=None)

    for it in range(max_iter):
        x = fractions(lam)
        N = np.exp(lnN)
        Atx = A.T @ x
        res = np.concatenate([N * Atx - b, [x.sum() - 1.0]])
        if np.abs(res).max() < tol:
            break
        J = np.zeros((ne + 1, ne + 1))
        J[:ne, :ne] = N * (A.T @ (x[:, None] * A))
        J[:ne, ne] = N * Atx
        J[ne, :ne] = Atx
        try:
            step = np.linalg.solve(J + 1e-14 * np.eye(ne + 1), -res)
        except np.linalg.LinAlgError:
            step = np.linalg.lstsq(J, -res, rcond=None)[0]
        scale = min(1.0, 3.0 / (np.abs(step).max() + 1e-30))
        lam = lam + scale * step[:ne]
        lnN = lnN + scale * step[ne]
    x = fractions(lam)
    return x / x.sum()


def equilibrium_temperature_uv(reactor, y, *, tol=1e-10):
    """Adiabatic constant-UV equilibrium of a reactor state (the final
    state an ignition integrates to) — iterate (T from U conservation,
    composition from TP-equilibrium at the evolving T). The reactor's
    energy, pressure and cv run on its device, f64, one read each."""
    mech = reactor.mech
    dev = reactor.device

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    y = np.asarray(y.detach().cpu().numpy() if torch.is_tensor(y) else y,
                   np.float64)
    T = float(y[0])
    conc = np.maximum(np.asarray(y[1:]), 0.0)
    U0 = float(reactor._U_vol(t(T), t(conc)))
    ctot = conc.sum()
    for _ in range(60):
        P = float(reactor.gas.pressure(t(T), t(conc)))
        x = equilibrate_tp(mech, T, P, conc / ctot, device=dev)
        conc_eq = x * ctot
        # adjust T so U matches
        for _ in range(30):
            U = float(reactor._U_vol(t(T), t(conc_eq)))
            cv = float(reactor.gas.cv_mole(t(T), t(conc_eq))) * ctot
            dT = (U0 - U) / cv
            T += dT
            if abs(dT) < 1e-10 * T:
                break
        if np.abs(conc - conc_eq).max() < tol * ctot:
            conc = conc_eq
            break
        conc = conc_eq
    return T, conc


class CondensedSpecies:
    """A pure stoichiometric condensed phase (StoichSubstance role) for
    multiphase equilibrium: fixed composition, activity 1, g0/RT from
    NASA7 polynomials."""

    def __init__(self, name, composition: dict, nasa_ranges, nasa_coeffs):
        self.name = name
        self.composition = dict(composition)
        self.ranges = np.asarray(nasa_ranges, np.float64)
        self.coeffs = np.asarray(nasa_coeffs, np.float64)  # (n_ranges-1, 7)

    @staticmethod
    def from_yaml(path, species_name):
        from g4s_tpu_torch.models.cantera.mech import _yaml_load
        doc = _yaml_load(path)
        sp = next(s for s in doc["species"] if s["name"] == species_name)
        th = sp["thermo"]
        assert th["model"] == "NASA7"
        return CondensedSpecies(species_name, sp["composition"],
                                th["temperature-ranges"], th["data"])

    def g_RT(self, T: float) -> float:
        i = int(np.clip(np.searchsorted(self.ranges, T) - 1, 0,
                        self.coeffs.shape[0] - 1))
        a = self.coeffs[i]
        h = (a[0] + T * (a[1] / 2 + T * (a[2] / 3 + T * (a[3] / 4
             + T * a[4] / 5))) + a[5] / T)
        s = (a[0] * np.log(T) + T * (a[1] + T * (a[2] / 2 + T * (a[3] / 3
             + T * a[4] / 4))) + a[6])
        return float(h - s)


def vcs_equilibrate_tp(mech: Mechanism, condensed, T: float, P: float,
                       x0: np.ndarray, *, max_outer: int = 30,
                       max_iter: int = 200, tol: float = 1e-12,
                       device="cuda"):
    """Multiphase (gas + pure condensed) equilibrium at fixed (T, P) —
    the VCS role (cantera/src/equil/vcs_solve.cpp) for the common
    gas-plus-stoichiometric-condensed-phases case.

    Algorithm: element-potential solve over the gas; VCS-style phase
    stability test for every inactive condensed species
    (phi_c = g_c/RT - a_c . lambda < 0 => supersaturated => activate);
    with an active set, the Newton system gains one unknown (n_c) and
    one equation (a_c . lambda = g_c/RT) per active phase; phases whose
    moles go negative deactivate. Returns (x_gas, n_condensed dict,
    lambda dict) with n_condensed in moles per mole of initial mixture.
    """
    A, els = element_matrix(mech)
    x0 = np.asarray(x0, np.float64)
    x0 = x0 / x0.sum()
    b_full = A.T @ x0
    keep = b_full > 0
    A = A[:, keep]
    b = b_full[keep]
    els_kept = [e for e, k in zip(els, keep) if k]
    ne = b.size

    g_RT = _g0_RT(mech, T, device)
    g_RT = g_RT + np.log(P / P_REF)
    full_A, _ = element_matrix(mech)
    feasible = (np.asarray([sum(c.values()) for c in mech.compositions]) > 0)
    feasible &= ~(full_A[:, ~keep].sum(axis=1) > 0)

    # condensed phases projected on the kept elements (infeasible if they
    # contain absent elements)
    cond = []
    for c in condensed:
        a_c = np.zeros(ne)
        ok = True
        for e, n in c.composition.items():
            if e in els_kept:
                a_c[els_kept.index(e)] = n
            else:
                ok = False
        if ok:
            cond.append((c, a_c, c.g_RT(T)))

    def fractions(lam):
        expo = A @ lam - g_RT
        expo = np.where(feasible, np.clip(expo, -300, 300), -np.inf)
        return np.exp(expo)

    # start from the gas-only solution
    x = equilibrate_tp(mech, T, P, x0, max_iter=max_iter, tol=tol,
                       device=device)
    mask = x > 1e-25
    lam, *_ = np.linalg.lstsq(A[mask],
                              g_RT[mask] + np.log(x[mask]), rcond=None)
    lnN = 0.0
    active: list = []

    for outer in range(max_outer):
        # Newton on (lam, lnN, n_active)
        na = len(active)
        n_act = np.array([max(n, 1e-12) for _, _, _, n in active]) \
            if na else np.zeros(0)
        for it in range(max_iter):
            x = fractions(lam)
            N = np.exp(lnN)
            Atx = A.T @ x
            elem = N * Atx + sum(n_act[i] * active[i][1]
                                 for i in range(na)) - b if na \
                else N * Atx - b
            res = np.concatenate([
                elem, [x.sum() - 1.0],
                [active[i][1] @ lam - active[i][2] for i in range(na)]])
            if np.abs(res).max() < tol:
                break
            m = ne + 1 + na
            J = np.zeros((m, m))
            J[:ne, :ne] = N * (A.T @ (x[:, None] * A))
            J[:ne, ne] = N * Atx
            for i in range(na):
                J[:ne, ne + 1 + i] = active[i][1]
                J[ne + 1 + i, :ne] = active[i][1]
            J[ne, :ne] = Atx
            try:
                step = np.linalg.solve(J + 1e-13 * np.eye(m), -res)
            except np.linalg.LinAlgError:
                step = np.linalg.lstsq(J, -res, rcond=None)[0]
            sc = min(1.0, 3.0 / (np.abs(step).max() + 1e-30))
            lam += sc * step[:ne]
            lnN += sc * step[ne]
            if na:
                n_act += sc * step[ne + 1:]

        # deactivate phases with negative moles
        changed = False
        kept_active = []
        for i, (c, a_c, g_c, _) in enumerate(active):
            if n_act[i] <= 0:
                changed = True
            else:
                kept_active.append((c, a_c, g_c, n_act[i]))
        active = kept_active
        if changed:
            continue
        # stability test: activate the most supersaturated inactive phase
        worst = None
        for (c, a_c, g_c) in cond:
            if any(c is ac for ac, _, _, _ in active):
                continue
            phi = g_c - a_c @ lam
            if phi < -1e-9 and (worst is None or phi < worst[0]):
                worst = (phi, c, a_c, g_c)
        if worst is None:
            break
        active.append((worst[1], worst[2], worst[3], 1e-6))
    x = fractions(lam)
    n_cond = {c.name: float(n) for c, _, _, n in active}
    return x / x.sum(), n_cond, dict(zip(els_kept, lam))


def equilibrate_hp(mech: Mechanism, H_mass: float, P: float,
                   x0: np.ndarray, *, T_guess: float = 2000.0,
                   max_outer: int = 60, tol: float = 1e-8, device="cuda"):
    """Adiabatic (constant H, P) equilibrium: secant on T over
    equilibrate_tp so that the equilibrium mixture's specific enthalpy
    matches H_mass [J/kg] (ChemEquil's HP mode; gives the adiabatic
    flame temperature when H_mass is the reactants' enthalpy).
    Returns (T_eq, x_eq)."""
    W = np.asarray(mech.mol_weights)

    def h_of(T):
        x = equilibrate_tp(mech, float(T), P, x0, device=device)
        hk = _h0_RT(mech, T, device) * R_GAS * T
        Wmix = float(x @ W)
        return float(x @ hk) / Wmix, x

    T0, T1 = float(T_guess), float(T_guess) * 1.05
    h_0, _ = h_of(T0)
    h_1, x1 = h_of(T1)
    for _ in range(max_outer):
        if abs(h_1 - h_0) < 1e-300:
            break
        T2 = T1 - (h_1 - H_mass) * (T1 - T0) / (h_1 - h_0)
        T2 = float(np.clip(T2, 200.0, 6000.0))
        if abs(T2 - T1) < tol * max(abs(T1), 1.0):
            T1 = T2
            break
        T0, h_0 = T1, h_1
        T1 = T2
        h_1, x1 = h_of(T1)
    return T1, x1

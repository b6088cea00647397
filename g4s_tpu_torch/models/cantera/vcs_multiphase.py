"""Full VCS multiphase equilibrium with solution phases (counterpart of
g4s_tpu/models/cantera/vcs_multiphase.py).

Reference capability: cantera/src/equil/vcs_solve.cpp + vcs_solve_TP.cpp
(MultiPhase::equilibrate("TP","vcs")): N coexisting phases (ideal-gas
mixtures, non-ideal solutions such as the HMW Pitzer electrolyte,
stoichiometric condensed phases) with per-phase mole-fraction unknowns,
phase birth/death and element (charge included) conservation.

Equilibrium is a damped Newton on the element-potential KKT system with
activity coefficients frozen per outer sweep (successive substitution).
For every solution phase p and species k:

    mu_k/RT = q_k(x_p) + ln x_k      with q frozen per outer sweep
    x_k = exp(A_k . lam - q_k)

unknowns: element potentials lam (ne), ln N_p per solution phase, and
moles n_c per active stoichiometric phase; equations: element balance,
sum_k x_k = 1 per solution phase, a_c . lam = g_c/RT per active
stoichiometric phase.

The split is the reference's: the Newton runs on the host in numpy, and
each phase's activity closure q_of_x evaluates on `device` ("cuda"
unless the caller asks for the CPU): the gas's standard state through
thermo.h0_RT/s0_R, the HMW electrolyte's through hmw.activity_all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from g4s_tpu_torch.models.cantera import hmw
from g4s_tpu_torch.models.cantera.mech import P_REF, _yaml_load
from g4s_tpu_torch.models.cantera.thermo import as_tensors, h0_RT, s0_R

R_GAS = 8.314462618


@dataclasses.dataclass
class SolutionPhase:
    """A multi-species phase with mu_k/RT = q_k(x) + ln x_k."""

    name: str
    species_names: List[str]
    compositions: List[dict]        # per species {element: count}
    q_of_x: Callable[[np.ndarray], np.ndarray]
    x0: Optional[np.ndarray] = None     # initial composition guess


@dataclasses.dataclass
class StoichPhase:
    """Single-species condensed phase at unit activity."""

    name: str
    composition: dict
    g_RT: float                     # mu0/RT at (T, P)


def gas_solution_phase(mech, T: float, P: float, *,
                       device="cuda") -> SolutionPhase:
    """Ideal-gas SolutionPhase from a loaded Mechanism; its standard
    state is evaluated once on `device`."""
    Tt, = as_tensors(float(T), device=device)
    g = (h0_RT(mech, Tt) - s0_R(mech, Tt)).cpu().numpy()
    q = g + np.log(P / P_REF)

    def q_of_x(x):
        return q

    comps = [{e.upper(): float(v) for e, v in c.items()}
             for c in mech.compositions]
    return SolutionPhase(mech.name, list(mech.species_names), comps,
                         q_of_x)


def hmw_solution_phase(path: str, phase_name: str, T: float,
                       P: float, *, device="cuda") -> SolutionPhase:
    """HMW Pitzer electrolyte SolutionPhase (solvent slot 0: mole-
    fraction activity a_w; solutes: molality activities gamma*m). Its
    activities are evaluated on `device` at each call of q_of_x, the
    water density solved once."""
    ph = hmw.load_hmw(path, phase_name)
    mu0 = (hmw.standard_chem_potentials(ph, T, P, device=device)
           / (R_GAS * 1e3 * T)).cpu().numpy()
    rho_w = hmw._water_rho(ph, float(T), float(P), device)
    Mw = ph.Mw_solvent
    doc = _yaml_load(path)
    by_name = {}
    for sec in doc:
        if sec.startswith("species"):
            for sp in doc[sec]:
                by_name[sp["name"]] = sp
    comps = []
    for nm in ph.species_names:
        c = {e.upper(): float(v)
             for e, v in by_name[nm]["composition"].items()}
        comps.append(c)

    def q_of_x(x):
        x = np.maximum(np.asarray(x, np.float64), 1e-30)
        x = x / x.sum()
        # guard the Pitzer evaluation against transient Newton iterates
        # far outside the physical envelope (HMWSoln's own molality
        # floor/cap role): solvent fraction floored, molalities capped at
        # 80 mol/kg
        x_w = max(x[0], 1e-3)
        m = np.zeros_like(x)
        m[1:] = np.minimum(x[1:] / (x_w * Mw), 80.0)
        acMol = hmw.activity_all(ph, molalities=m, T=T, P=P,
                                 rho_water=rho_w, device=device
                                 )["acMol"].cpu().numpy()
        q = np.empty_like(x)
        # solvent: mu = mu0 + ln a_w = mu0 + ln(acMol_w) + ln x_w
        q[0] = mu0[0] + np.log(max(acMol[0], 1e-300))
        # solutes: mu = mu0 + ln(gamma m) = mu0 + ln gamma - ln(x_w Mw)
        #          + ln x_k
        q[1:] = (mu0[1:] + np.log(np.maximum(acMol[1:], 1e-300))
                 - np.log(x_w * Mw))
        return q

    x0 = np.full(ph.nspec, 1e-8)
    x0[0] = 1.0
    return SolutionPhase(phase_name, list(ph.species_names), comps, q_of_x,
                         x0=x0 / x0.sum())


def stoich_phase_from_yaml(path: str, species_name: str, T: float,
                           P: float) -> StoichPhase:
    """StoichPhase from a fixed-stoichiometry yaml (NaCl_Solid.yaml
    style, Shomate or NASA7 standard state); host numpy."""
    doc = _yaml_load(path)
    sp = None
    for sec in doc:
        if sec.startswith("species"):
            for s in doc[sec]:
                if s["name"] == species_name:
                    sp = s
    if sp is None:
        raise KeyError(species_name)
    th = sp["thermo"]
    if th["model"] == "Shomate":
        coeffs = np.asarray(th["data"], np.float64)
        tr = [float(t) for t in th["temperature-ranges"]]
        h, s = hmw._shomate_hs(coeffs, tr, T)   # J/kmol
        g = (h - T * s) / 1e3                   # J/mol
    elif th["model"] == "NASA7":
        data = th["data"]
        tr = th["temperature-ranges"]
        a = np.asarray(data[0] if len(data) == 1 or T < tr[1]
                       else data[1], np.float64)
        h_RT = (a[0] + T * (a[1] / 2 + T * (a[2] / 3 + T * (a[3] / 4
                + T * a[4] / 5))) + a[5] / T)
        s_R = (a[0] * np.log(T) + T * (a[1] + T * (a[2] / 2
               + T * (a[3] / 3 + T * a[4] / 4))) + a[6])
        g = R_GAS * T * (h_RT - s_R)
    else:
        raise NotImplementedError(th["model"])
    comp = {e.upper(): float(v) for e, v in sp["composition"].items()}
    return StoichPhase(species_name, comp, g / (R_GAS * T))


def vcs_multiphase_tp(phases: Sequence, n0: Sequence[np.ndarray],
                      T: float, P: float, *, max_outer: int = 80,
                      max_newton: int = 300, tol: float = 1e-11):
    """Equilibrate N phases at fixed (T, P).

    phases: SolutionPhase / StoichPhase objects; n0: initial species
    moles per phase (scalars for StoichPhase). Returns a dict with
    per-phase mole numbers, mole fractions, the element potentials and
    the counts of outer sweeps and inner Newton iterations."""
    sols = [(i, p) for i, p in enumerate(phases)
            if isinstance(p, SolutionPhase)]
    stoichs = [(i, p) for i, p in enumerate(phases)
               if isinstance(p, StoichPhase)]

    # global element basis (incl. charge pseudo-element E)
    els = sorted({e for _, p in sols for c in p.compositions for e in c}
                 | {e for _, p in stoichs for e in p.composition})
    ne0 = len(els)

    def amat(p: SolutionPhase):
        A = np.zeros((len(p.species_names), ne0))
        for k, c in enumerate(p.compositions):
            for e, v in c.items():
                A[k, els.index(e)] = v
        return A

    A_sol = [amat(p) for _, p in sols]
    a_st = []
    for _, p in stoichs:
        a = np.zeros(ne0)
        for e, v in p.composition.items():
            a[els.index(e)] = v
        a_st.append(a)

    b = np.zeros(ne0)
    for (i, p), A in zip(sols, A_sol):
        b += A.T @ np.asarray(n0[i], np.float64)
    for (i, p), a in zip(stoichs, a_st):
        b += a * float(np.asarray(n0[i]).sum())

    # drop elements with zero abundance UNLESS they can cancel (charge):
    # keep any element appearing with both signs (E) or positive b
    keep = np.zeros(ne0, bool)
    for j in range(ne0):
        if abs(b[j]) > 1e-300:
            keep[j] = True
        else:
            signs = set()
            for A in A_sol:
                signs |= {np.sign(v) for v in A[:, j] if v != 0}
            if 1.0 in signs and -1.0 in signs:
                keep[j] = True       # chargelike: b=0 is a constraint
    A_sol = [A[:, keep] for A in A_sol]
    a_st = [a[keep] for a in a_st]
    b = b[keep]
    ne = int(keep.sum())

    # feasibility: species containing dropped elements can't exist
    feas = []
    for (i, p), A_full in zip(sols, [amat(p) for _, p in sols]):
        feas.append(~(np.abs(A_full[:, ~keep]).sum(axis=1) > 0))

    # initial composition, q, lam, N
    xs = []
    for (i, p), A in zip(sols, A_sol):
        x = np.asarray(n0[i], np.float64)
        if x.sum() <= 0:
            x = (p.x0 if p.x0 is not None
                 else np.ones(len(p.species_names)))
        x = np.maximum(x, 1e-20)
        xs.append(x / x.sum())
    Ns = [max(float(np.asarray(n0[i]).sum()), 1e-10) for i, _ in sols]
    qs = [p.q_of_x(x) for (_, p), x in zip(sols, xs)]
    # lam init: lstsq over the dominant species of every solution phase
    rows, rhs = [], []
    for A, q, x, f in zip(A_sol, qs, xs, feas):
        mask = (x > 1e-12) & f
        rows.append(A[mask])
        rhs.append(q[mask] + np.log(x[mask]))
    lam = np.linalg.lstsq(np.vstack(rows), np.concatenate(rhs),
                          rcond=None)[0]

    active = []          # [idx into stoichs, n]
    for j, (i, p) in enumerate(stoichs):
        nn = float(np.asarray(n0[i]).sum())
        if nn > 0:
            active.append([j, nn])

    def frac(A, q, f):
        e = A @ lam - q
        e = np.where(f, np.clip(e, -400, 400), -np.inf)
        return np.exp(e)

    n_newton = 0
    for outer in range(max_outer):
        # ---- inner Newton at frozen q ----
        nsol = len(sols)
        for it in range(max_newton):
            na = len(active)
            m = ne + nsol + na
            xs_u = [frac(A, q, f) for A, q, f in zip(A_sol, qs, feas)]
            elem = -b.copy()
            for x_u, A, N in zip(xs_u, A_sol, Ns):
                elem += N * (A.T @ x_u)
            for j, nn in active:
                elem += nn * a_st[j]
            res = np.concatenate([
                elem,
                [x_u.sum() - 1.0 for x_u in xs_u],
                [a_st[j] @ lam - stoichs[j][1].g_RT for j, _ in active]])
            if np.abs(res).max() < tol:
                break
            n_newton += 1
            J = np.zeros((m, m))
            for x_u, A, N in zip(xs_u, A_sol, Ns):
                J[:ne, :ne] += N * (A.T @ (x_u[:, None] * A))
            for pI, (x_u, A, N) in enumerate(zip(xs_u, A_sol, Ns)):
                J[:ne, ne + pI] = N * (A.T @ x_u)
                J[ne + pI, :ne] = A.T @ x_u
            for aI, (j, _) in enumerate(active):
                J[:ne, ne + nsol + aI] = a_st[j]
                J[ne + nsol + aI, :ne] = a_st[j]
            try:
                step = np.linalg.solve(J + 1e-14 * np.eye(m), -res)
            except np.linalg.LinAlgError:
                step = np.linalg.lstsq(J, -res, rcond=None)[0]
            sc = min(1.0, 1.5 / (np.abs(step).max() + 1e-30))
            lam += sc * step[:ne]
            for pI in range(nsol):
                Ns[pI] *= np.exp(np.clip(sc * step[ne + pI], -2, 2))
            for aI in range(na):
                active[aI][1] += sc * step[ne + nsol + aI]

        # ---- stoich phase death / birth ----
        changed = False
        active2 = []
        for j, nn in active:
            if nn <= 0:
                changed = True
            else:
                active2.append([j, nn])
        active = active2
        if not changed:
            for j, (i, p) in enumerate(stoichs):
                if any(j == jj for jj, _ in active):
                    continue
                phi = p.g_RT - a_st[j] @ lam
                if phi < -1e-9:
                    active.append([j, 1e-8])
                    changed = True
                    break

        # ---- refresh activity offsets (damped: the undamped
        # gamma-frozen fixed point 2-cycles for concentrated
        # electrolytes, as the reference observed on its NaCl brine) ----
        drift = 0.0
        omega = 0.5
        for pI, ((i, p), A, f) in enumerate(zip(sols, A_sol, feas)):
            x_u = frac(A, qs[pI], f)
            x = np.maximum(x_u, 1e-300)
            x = x / x.sum()
            q_new = p.q_of_x(x)
            sig = np.abs(q_new - qs[pI])[x > 1e-12]
            if sig.size:
                drift = max(drift, float(np.max(sig)))
            qs[pI] = qs[pI] + omega * (q_new - qs[pI])
            xs[pI] = x
        if not changed and drift < 1e-10:
            break

    out = {"lam": dict(zip([e for e, k in zip(els, keep) if k], lam)),
           "phases": {}, "outer": outer + 1, "newton": n_newton}
    for pI, (i, p) in enumerate(sols):
        x_u = frac(A_sol[pI], qs[pI], feas[pI])
        x = np.maximum(x_u, 0.0)
        x = x / x.sum()
        out["phases"][p.name] = {
            "N": Ns[pI], "x": dict(zip(p.species_names, x))}
    for j, (i, p) in enumerate(stoichs):
        nn = next((n for jj, n in active if jj == j), 0.0)
        out["phases"][p.name] = {"N": nn, "x": {p.name: 1.0}}
    return out

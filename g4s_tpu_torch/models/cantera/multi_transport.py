"""Exact multicomponent transport: the Dixon-Lewis L-matrix solution
(counterpart of g4s_tpu/models/cantera/multi_transport.py).

Capability match for cantera/src/transport/MultiTransport.cpp (the
`transport_model="multicomponent"` tier): multicomponent thermal
conductivity, thermal diffusion (Soret) coefficients, the exact
multicomponent diffusion coefficient matrix, and species mass fluxes
driven by composition AND temperature gradients.

The method (Dixon-Lewis 1968; Kee, Coltrin & Glarborg Ch. 12) expands
the Boltzmann equation in three Sonine-polynomial moment blocks per
species — 00 (diffusion), 10 (translational heat flux), 01 (internal
heat flux) — and solves the 3K x 3K linear system

    L a = b,   b = [0, X, X_internal]

whose blocks are built from binary diffusion coefficients, the
collision-integral ratios A*, B*, C*, rotational relaxation numbers and
internal heat capacities. Block formulas follow MultiTransport.cpp
(eval_L0000 :491, eval_L0010 :513, eval_L1010 :542, eval_L1001 :576,
eval_L0101 :626, solve :114-170), vectorized over species pairs. Outputs:

    lambda = -4 sum_{10,01} b a                 (thermalConductivity :90)
    D_T,k  = (1.6/R) W_k X_k a_k                (getThermalDiffCoeffs :100)
    D_ij   = 16 T Wbar / (25 p W_j) X_i ((L00^-1)_ij - (L00^-1)_ii)
                                                (getMultiDiffCoeffs :356)

A*, B*, C* come from the Neufeld-Janzen-Aziz (1972) analytic fits of
the reduced collision integrals Omega(1,1), (1,2), (1,3), (2,2).
Everything is torch on the state's device and composes with torch.func.
The L00 inverse is `torch.linalg.inv_ex`: `inv` reads its error flag on
the host, which would wait for the device on every call; a singular
block shows as non-finite coefficients instead.
"""

from __future__ import annotations

import numpy as np
import torch

from g4s_tpu_torch.models.cantera.kinetics import _floor
from g4s_tpu_torch.models.cantera.mech import R_GAS
from g4s_tpu_torch.models.cantera.thermo import as_scalar, mech_tensor
from g4s_tpu_torch.models.cantera.transport import (_offdiag, _omega11,
                                                    binary_diffusion,
                                                    species_viscosities)


def _omega12(t_star):
    """Neufeld fit for the (1,2) reduced collision integral."""
    return (1.00220 * t_star ** -0.15530
            + 0.16105 * torch.exp(-0.72751 * t_star)
            + 0.86125 * torch.exp(-2.06848 * t_star)
            + 1.95162 * torch.exp(-4.84688 * t_star))


def _omega13(t_star):
    """Neufeld fit for the (1,3) reduced collision integral."""
    return (0.96573 * t_star ** -0.15611
            + 0.44067 * torch.exp(-0.82770 * t_star)
            + 1.25225 * torch.exp(-2.38188 * t_star))


def _omega22(t_star):
    """Neufeld fit for the (2,2) reduced collision integral."""
    return (1.16145 * t_star ** -0.14874
            + 0.52487 * torch.exp(-0.77320 * t_star)
            + 2.16178 * torch.exp(-2.43787 * t_star))


def collision_ratios(t_star):
    """A* = O22/O11, B* = (5 O12 - 4 O13)/O11, C* = O12/O11 for each
    reduced temperature (the astar/bstar/cstar tables of
    GasTransport.cpp:439-449, from independent analytic fits)."""
    o11 = _omega11(t_star)
    o12 = _omega12(t_star)
    o13 = _omega13(t_star)
    o22 = _omega22(t_star)
    return o22 / o11, (5.0 * o12 - 4.0 * o13) / o11, o12 / o11


def _frot(tr, sqtr):
    """Parker's temperature correction to the rotational collision
    number (MultiTransport.cpp:27-33)."""
    c1 = 0.5 * np.pi ** 1.5
    c2 = 0.25 * np.pi ** 2 + 2.0
    c3 = np.pi ** 1.5
    return 1.0 + c1 * sqtr + c2 * tr + c3 * sqtr * tr


_MIN_C_INTERNAL = 0.001     # MultiTransport.cpp:484


def _pair_props(mech, trd, T):
    """Per-pair reduced temperature and the A*/B*/C* ratios, plus the
    pressure-multiplied binary diffusion matrix pD (Pa m^2/s) with the
    self-diffusion diagonal from viscosity (updateThermal_T :462-464)."""
    wd = mech_tensor(trd, "well_depth", T)
    eps = torch.sqrt(wd[:, None] * wd[None, :])
    ts = T / eps
    ast, bst, cst = collision_ratios(ts)
    pD = binary_diffusion(mech, trd, T, 1.0)      # P=1 -> p*D
    mu = species_viscosities(mech, trd, T)
    W = mech_tensor(mech, "mol_weights", T)       # kg/mol
    pD_self = 1.2 * torch.diagonal(ast) * mu * R_GAS * T / W
    K = W.shape[0]
    pD = torch.where(_offdiag(K, T), pD, pD_self[None, :])
    return ast, bst, cst, pD


def _rot_relax(trd, T):
    """Temperature-corrected rotational collision numbers
    (updateThermal_T :455-459)."""
    eps = mech_tensor(trd, "well_depth", T)
    rr298 = _frot(eps / 298.0, torch.sqrt(eps / 298.0))
    rrT = _frot(eps / T, torch.sqrt(eps / T))
    return _floor(mech_tensor(trd, "rot_relax", T), 1.0) * rr298 / rrT


def _x_floor(x):
    # Tiny offset (update_C), renormalized
    xs = _floor(x, 1e-12)
    return xs / torch.sum(xs)


def _l00(T, xs, W, pD):
    """The L00,00 block (eval_L0000)."""
    pre = 16.0 * T / 25.0
    srow = (torch.sum(xs[None, :] / pD, dim=1)
            - xs / torch.diagonal(pD)) / W
    L00 = pre * xs[None, :] * (W[None, :] * srow[:, None]
                               + xs[:, None] / pD)
    return torch.where(_offdiag(W.shape[0], T), L00, 0.0)


def build_l_matrix(mech, trd, T, x, cp_R):
    """Assemble the 3K x 3K Dixon-Lewis matrix and RHS.

    cp_R: reference-state dimensionless heat capacities (NASA7 cp/R at
    T); internal capacity c_int = cp/R - 5/2 (updateThermal_T :476-479).
    Returns (L, b, has_internal mask)."""
    T = as_scalar(T, x)
    K = mech.nspec
    W = mech_tensor(mech, "mol_weights", T)
    x = _x_floor(x)
    ast, bst, cst, pD = _pair_props(mech, trd, T)
    rr = _rot_relax(trd, T)
    crot = mech_tensor(trd, "rot_dof", T)
    cint = cp_R - 2.5
    has_int = cint > _MIN_C_INTERNAL
    offK = _offdiag(K, T)
    Wi = W[:, None]
    Wj = W[None, :]
    Wsum = Wi + Wj

    # ---- L00,00 (eval_L0000) ------------------------------------------
    pre = 16.0 * T / 25.0
    L00 = _l00(T, x, W, pD)

    # ---- L00,10 (eval_L0010) and its block transpose -------------------
    # entry (i, j): -1.6 T x_i x_j W_i (1.2 C*_ji - 1) / ((W_j + W_i) pD_ji)
    M = -1.6 * T * x[:, None] * x[None, :] * Wi \
        * (1.2 * cst.T - 1.0) / (Wsum * pD.T)
    L0010 = M + torch.diag(-torch.sum(M, dim=0))

    # ---- L10,10 (eval_L1010) -------------------------------------------
    # off-diagonal entry (i, j):
    #   pre x_i x_j W_i W_j / (pD_ij (W_i+W_j)^2)
    #     * (13.75 - 3 B*_ij - 4 A*_ij G_ij),
    # G_ij = 1 + 5/(3 pi) (crot_i/rr_i + crot_j/rr_j)
    f53p = 5.0 / (3.0 * np.pi)
    crr = crot / rr
    G = 1.0 + f53p * (crr[:, None] + crr[None, :])
    denom = pD * Wsum ** 2
    L1010 = pre * x[:, None] * x[None, :] * Wi * Wj / denom \
        * (13.75 - 3.0 * bst - 4.0 * ast * G)
    # diagonal subtraction (the `sum` accumulated over i for column j):
    #   pre x_j sum_i x_i / (pD_ij (W_i+W_j)^2)
    #     * (7.5 W_j^2 + W_i^2 (6.25 - 3 B*_ij) + 4 W_i W_j A*_ij G_ij)
    ssum = torch.sum(x[:, None] / denom
                     * (7.5 * Wj ** 2 + Wi ** 2 * (6.25 - 3.0 * bst)
                        + 4.0 * Wi * Wj * ast * G), dim=0)
    L1010 = L1010 - torch.diag(pre * x * ssum)

    # ---- L10,01 (eval_L1001) and transpose ------------------------------
    cint_s = torch.where(has_int, cint, 1.0)
    constj = (32.0 * T / (5.0 * np.pi)) * Wj * x[None, :] \
        * torch.where(has_int, crot / (cint_s * rr), 0.0)[None, :]
    L1001 = constj * ast.T * x[:, None] / (Wsum * pD.T)
    L1001 = torch.where(has_int[None, :], L1001, 0.0)
    L1001 = L1001 + torch.diag(torch.sum(L1001, dim=0))

    # ---- L01,01 (eval_L0101): diagonal only ------------------------------
    c1 = 4.0 * T * x / cint_s
    c2 = 12.0 * W * crot / (5.0 * np.pi * cint_s * rr)
    mu = species_viscosities(mech, trd, T)
    inner = torch.sum(x[None, :] / pD
                      + torch.where(offK, x[None, :] * ast * c2[:, None]
                                    / (Wj * pD), 0.0), dim=1)
    diag0101 = (-8.0 / np.pi * W * x ** 2 * crot
                / (cint_s ** 2 * R_GAS * mu * rr) - c1 * inner)
    L0101 = torch.diag(torch.where(has_int, diag0101, 1.0))

    Z = torch.zeros_like(L00)
    L = torch.cat([torch.cat([L00, L0010, Z], dim=1),
                   torch.cat([L0010.T, L1010, L1001], dim=1),
                   torch.cat([Z, L1001.T, L0101], dim=1)])
    b = torch.cat([torch.zeros_like(x), x, torch.where(has_int, x, 0.0)])
    return L, b, has_int


def solve_l_matrix(mech, trd, T, x, cp_R):
    """a = L^-1 b (solveLMatrixEquation :114-170)."""
    L, b, _ = build_l_matrix(mech, trd, T, x, cp_R)
    return torch.linalg.solve(L, b), b


def multicomponent_conductivity(mech, trd, T, x, cp_R):
    """lambda [W/m/K] = -4 sum over the 10 and 01 blocks of b a
    (MultiTransport::thermalConductivity :90-98)."""
    a, b = solve_l_matrix(mech, trd, T, x, cp_R)
    K = mech.nspec
    return -4.0 * torch.sum(b[K:] * a[K:])


def thermal_diff_coeffs(mech, trd, T, x, cp_R):
    """Soret coefficients D_T,k [kg/(m s)] with sum_k D_T,k = 0
    (getThermalDiffCoeffs :100-107). Positive D_T,k drives species k
    toward cold regions via j_k -= D_T,k grad(ln T)."""
    a, _ = solve_l_matrix(mech, trd, T, x, cp_R)
    K = mech.nspec
    W = mech_tensor(mech, "mol_weights", x)
    return (1.6 / R_GAS) * W * _x_floor(x) * a[:K]


def multicomponent_diff_coeffs(mech, trd, T, P, x, cp_R=None):
    """Exact multicomponent diffusion matrix D_ij [m^2/s]
    (getMultiDiffCoeffs :356-393): invert the L00,00 block alone."""
    T = as_scalar(T, x)
    W = mech_tensor(mech, "mol_weights", T)
    xs = _x_floor(x)
    _, _, _, pD = _pair_props(mech, trd, T)
    Linv, _ = torch.linalg.inv_ex(_l00(T, xs, W, pD))
    Wbar = torch.sum(xs * W)
    prefactor = 16.0 * T * Wbar / (25.0 * P)
    return (prefactor / W[None, :]) * xs[:, None] \
        * (Linv - torch.diagonal(Linv)[:, None])


def species_mass_fluxes(mech, trd, T, P, x, grad_x, grad_T, cp_R):
    """Mass fluxes j_k [kg/m^2/s] from composition and temperature
    gradients (getSpeciesFluxes :173-255): solve the Stefan-Maxwell
    system with the sum(Y_k V_k) = 0 closure replacing the
    largest-gradient row, then add the Soret term -D_T,k grad(ln T)."""
    T = as_scalar(T, x)
    K = mech.nspec
    W = mech_tensor(mech, "mol_weights", T)
    xs = _x_floor(x)
    Wbar = torch.sum(xs * W)
    Y = xs * W / Wbar
    rho = P * Wbar / (R_GAS * T)
    D = binary_diffusion(mech, trd, T, P)
    offK = _offdiag(K, T)
    A = torch.where(offK, xs[:, None] * xs[None, :] / D, 0.0)
    A = A - torch.diag(torch.sum(A, dim=1))
    # the closure replaces the largest-gradient row (argmax's first on a
    # tie, as jnp.argmax)
    row = torch.arange(K, device=x.device) == torch.argmax(torch.abs(grad_x))
    A = torch.where(row[:, None], Y[None, :], A)
    rhs = torch.where(row, 0.0, grad_x)
    V = torch.linalg.solve(A, rhs)                # P*V/p in ref units
    flux = rho * Y * V
    dt = thermal_diff_coeffs(mech, trd, T, xs, cp_R)
    return flux - dt * grad_T / T

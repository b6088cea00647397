"""Gas thermodynamics: NASA7 ideal-gas properties + Redlich-Kwong and
Peng-Robinson real gas (counterpart of g4s_tpu/models/cantera/thermo.py).

Reference capability: cantera/src/thermo — IdealGasPhase + the NASA7
species polynomials (NasaPoly2), and RedlichKwongMFTP (cubic EoS with
quadratic mixing rules; the G4S-modified hot loop GraphProcess1/2 at
RedlichKwongMFTP.cpp:917-1034 computes a_mix = sum_ij x_i x_j sqrt(a_i a_j);
updateMixingExpressions:985).

Every function is plain torch over (T, concentrations) and composes with
torch.func (grad, jacfwd, vmap), which is what the implicit reactor
integrator needs for its Jacobians. Derivatives inside these functions
(the RK/PR departures, the cubic's Newton step) use torch.func.grad, so
they nest under an outer jacfwd; torch.autograd.grad does not.

The mechanism's numpy arrays are staged on T's device and dtype once per
Mechanism (`mech_tensor`); change a Mechanism's arrays before its first
use, not after.

Units: mol-SI (mol, m^3, J, K); R = 8.314462618.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, grad_and_value

from g4s_tpu_torch.models.cantera.mech import Mechanism, R_GAS
from g4s_tpu_torch.sparse.containers import resolve_device


def mech_tensor(mech: Mechanism, name: str, like: torch.Tensor):
    """Field `name` of `mech` as a tensor on like's device: floating arrays
    in like's dtype, bool and integer arrays as they are. Cached on the
    Mechanism per (name, device, dtype)."""
    cache = mech.__dict__.setdefault("_tensor_cache", {})
    key = (name, like.device, like.dtype)
    t = cache.get(key)
    if t is None:
        a = np.asarray(getattr(mech, name))
        dtype = like.dtype if a.dtype.kind == "f" else None
        # made outside any torch.func transform the caller is in: inside
        # one a new tensor is wrapped at that transform's level, and the
        # cached wrapper would escape into later calls, where another
        # transform takes it for one of its own (a Jacobian after a first
        # RHS call then fails, or runs other kernels)
        with torch._C._DisableFuncTorch():
            t = torch.as_tensor(a, dtype=dtype, device=like.device)
        cache[key] = t
    return t


def as_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor on like's device and dtype (tensors
    pass through)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def as_tensors(*xs, device="cuda"):
    """The arguments as tensors: tensors pass through, numbers become 0-d
    tensors on the first tensor argument's device and dtype, or f64 on
    `device` when no argument is a tensor. A number is filled on the device
    (torch.full), which makes the host wait for nothing."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if like is None:
        dev, dtype = resolve_device(device), torch.float64
    else:
        dev, dtype = like.device, like.dtype
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.full((), float(x), dtype=dtype, device=dev)
                 for x in xs)


def const_tensor(cache: dict, key, values, like: torch.Tensor):
    """`values` (numbers or a numpy array) as a tensor on like's device and
    dtype, cached in `cache` under (key, device, dtype) and made outside any
    torch.func transform (see mech_tensor)."""
    k = (key, like.device, like.dtype)
    t = cache.get(k)
    if t is None:
        with torch._C._DisableFuncTorch():
            t = torch.as_tensor(np.asarray(values, np.float64),
                                dtype=like.dtype, device=like.device)
        cache[k] = t
    return t


def graphable(*xs) -> bool:
    """Plain CUDA tensors outside any torch.func transform and autograd
    graph: a solve replayed from a CUDA graph gives them the same values,
    and no derivative is lost."""
    return (torch._C._functorch.maybe_current_level() is None
            and all(x.is_cuda and not x.requires_grad
                    and not torch._C._functorch.is_functorch_wrapped_tensor(x)
                    for x in xs))


def replay(cache: dict, key, fn, *args):
    """fn(*args) from a CUDA graph captured at the first call with `key`
    (cached in `cache`): the same kernels on the same values, launched by
    one replay instead of one by one from the host (an IAPWS density solve
    is about 24,000 small kernels). The arguments are copied into the
    graph's inputs and the result is cloned out of its pool."""
    entry = cache.get(key)
    if entry is None:
        static = tuple(a.clone() for a in args)
        dev = args[0].device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static)     # fills the constant caches before the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*static)
        entry = cache[key] = (graph, static, out)
    graph, static, out = entry
    for dst, src in zip(static, args):
        dst.copy_(src)
    graph.replay()
    return out.clone()


def _nasa_select(mech: Mechanism, T):
    """Per-species NASA7 coefficients for temperature T (piecewise Tmid)."""
    lowT = T < mech_tensor(mech, "t_mid", T)
    return torch.where(lowT[:, None], mech_tensor(mech, "nasa_low", T),
                  mech_tensor(mech, "nasa_high", T))


def _region_select(mech: Mechanism, T, bounds_name: str, coef_name: str):
    """Per-species region for temperature T (Nasa9PolyMultiTempRegion.cpp:
    pick the region whose [Tlo, Thi) brackets T; clamped at the ends)."""
    bounds = mech_tensor(mech, bounds_name, T)          # (nspec, R+1)
    coefs = mech_tensor(mech, coef_name, T)             # (nspec, R, k)
    R = coefs.shape[1]
    idx = torch.clamp(torch.sum(T >= bounds[:, 1:-1], dim=1), 0, R - 1)
    idx = idx[:, None, None].expand(-1, 1, coefs.shape[2])
    return torch.gather(coefs, 1, idx)[:, 0, :]


def _nasa9_cp(a, T):
    # cp0/R = a0 T^-2 + a1/T + a2 + a3 T + a4 T^2 + a5 T^3 + a6 T^4
    # (Nasa9Poly1.cpp:14-40)
    return (a[:, 0] / (T * T) + a[:, 1] / T + a[:, 2]
            + T * (a[:, 3] + T * (a[:, 4] + T * (a[:, 5] + T * a[:, 6]))))


def _nasa9_h(a, T):
    return (-a[:, 0] / (T * T) + a[:, 1] * torch.log(T) / T + a[:, 2]
            + T * (a[:, 3] / 2 + T * (a[:, 4] / 3
                   + T * (a[:, 5] / 4 + T * a[:, 6] / 5)))
            + a[:, 7] / T)


def _nasa9_s(a, T):
    return (-a[:, 0] / (2 * T * T) - a[:, 1] / T
            + a[:, 2] * torch.log(T)
            + T * (a[:, 3] + T * (a[:, 4] / 2
                   + T * (a[:, 5] / 3 + T * a[:, 6] / 4)))
            + a[:, 8])


def _shomate_cp(a, T):
    # NIST Shomate, t=T/1000, cp in J/mol/K (ShomatePoly2.h)
    t = T / 1000.0
    cp = (a[:, 0] + t * (a[:, 1] + t * (a[:, 2] + t * a[:, 3]))
          + a[:, 4] / (t * t))
    return cp / R_GAS


def _shomate_h(a, T):
    t = T / 1000.0
    h = (a[:, 0] * t + a[:, 1] * t * t / 2 + a[:, 2] * t ** 3 / 3
         + a[:, 3] * t ** 4 / 4 - a[:, 4] / t + a[:, 5]) * 1000.0
    return h / (R_GAS * T)


def _shomate_s(a, T):
    t = T / 1000.0
    s = (a[:, 0] * torch.log(t) + a[:, 1] * t + a[:, 2] * t * t / 2
         + a[:, 3] * t ** 3 / 3 - a[:, 4] / (2 * t * t) + a[:, 6])
    return s / R_GAS


def _blend9(mech, v7, f9, fsh, T):
    if mech.is_nasa9 is not None:
        a9 = _region_select(mech, T, "nasa9_T", "nasa9_c")
        v7 = torch.where(mech_tensor(mech, "is_nasa9", T), f9(a9, T), v7)
    if mech.is_shomate is not None:
        ash = _region_select(mech, T, "shomate_T", "shomate_c")
        v7 = torch.where(mech_tensor(mech, "is_shomate", T), fsh(ash, T), v7)
    return v7


def cp0_R(mech: Mechanism, T):
    a = _nasa_select(mech, T)
    v = a[:, 0] + T * (a[:, 1] + T * (a[:, 2] + T * (a[:, 3] + T * a[:, 4])))
    return _blend9(mech, v, _nasa9_cp, _shomate_cp, T)


def h0_RT(mech: Mechanism, T):
    a = _nasa_select(mech, T)
    v = (a[:, 0] + T * (a[:, 1] / 2 + T * (a[:, 2] / 3
         + T * (a[:, 3] / 4 + T * a[:, 4] / 5))) + a[:, 5] / T)
    return _blend9(mech, v, _nasa9_h, _shomate_h, T)


def s0_R(mech: Mechanism, T):
    a = _nasa_select(mech, T)
    v = (a[:, 0] * torch.log(T) + T * (a[:, 1] + T * (a[:, 2] / 2
         + T * (a[:, 3] / 3 + T * a[:, 4] / 4))) + a[:, 6])
    return _blend9(mech, v, _nasa9_s, _shomate_s, T)


def u0_RT(mech: Mechanism, T):
    return h0_RT(mech, T) - 1.0


# ---------------- Redlich-Kwong real gas ----------------
#
# P = R T / (v - b) - a(T) / (sqrt(T) v (v + b))
# a_mix = sum_ij x_i x_j sqrt(a_i(T) a_j(T)),  b_mix = sum_i x_i b_i
# (RedlichKwongMFTP::updateMixingExpressions; the ij double sum is the
#  engine reduction GraphProcess1 parallelizes in the reference)


def _max0(x):
    # torch.maximum splits the derivative at a tie as jnp.maximum does
    return torch.maximum(x, torch.zeros_like(x))


def rk_a_species(mech: Mechanism, T):
    a = mech_tensor(mech, "rk_a", T)
    return _max0(a[:, 0] + a[:, 1] * T)


def rk_mix(mech: Mechanism, T, x):
    """a_mix(T), b_mix for mole fractions x. The quadratic mixing rule is
    evaluated as (sum_i x_i sqrt(a_i))^2 — exactly sum_ij x_i x_j
    sqrt(a_i a_j) for the geometric-mean combining rule the reference uses,
    with O(K) work instead of the O(K^2) vertex loop."""
    sa = torch.sqrt(rk_a_species(mech, T))
    a_mix = torch.square(torch.sum(x * sa))
    b_mix = torch.sum(x * mech_tensor(mech, "rk_b", x))
    return a_mix, b_mix


def rk_pressure(mech: Mechanism, T, molar_volume, x):
    a, b = rk_mix(mech, T, x)
    v = molar_volume
    return R_GAS * T / (v - b) - a / (torch.sqrt(T) * v * (v + b))


def _derivatives(fn, T):
    """fn(T), fn'(T) and fn''(T) of a scalar function, from one nested
    torch.func.grad_and_value (the reference takes jax.grad and
    jax.grad(jax.grad) apart; the values are the same)."""
    def first(t):
        return grad_and_value(fn)(t)

    d2, (d1, value) = grad_and_value(first, has_aux=True)(T)
    return value, d1, d2


def _cubic_newton(f, v0, b, iters: int):
    """Safeguarded Newton on f from v0: `iters` steps, each keeping v > b
    (a step past b halves the distance to b instead)."""
    df = grad(f)
    v = v0
    for _ in range(iters):
        step = f(v) / df(v)
        v_new = v - step
        v = torch.where(v_new > b, v_new, 0.5 * (v + b))
    return v


def rk_molar_volume(mech: Mechanism, T, P, x, *, iters: int = 60):
    """Solve the cubic for the gas-phase molar volume (largest real root)
    by safeguarded Newton from the ideal-gas start."""
    x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    T, P = as_scalar(T, x), as_scalar(P, x)
    a, b = rk_mix(mech, T, x)

    def f(v):
        return R_GAS * T / (v - b) - a / (torch.sqrt(T) * v * (v + b)) - P

    return _cubic_newton(f, R_GAS * T / P, b, iters)


def rk_departures(mech: Mechanism, T, molar_volume, x):
    """(u - u_ig, cv - cv_ig) per mole of mixture for the RK EoS.

    With alpha(T) = a_mix(T)/sqrt(T):
      u_dep = (alpha - T alpha') / b * ln(v/(v+b)),
      cv_dep = -T alpha'' / b * ln(v/(v+b)),
    alpha' and alpha'' by torch.func.grad, as the reference takes them by
    jax.grad."""
    v = molar_volume

    def alpha(t):
        am, _ = rk_mix(mech, t, x)
        return am / torch.sqrt(t)

    b = torch.sum(x * mech_tensor(mech, "rk_b", x))
    alpha_T, dalpha, d2alpha = _derivatives(alpha, T)
    log_term = torch.log(v / (v + b)) / b
    u_dep = (alpha_T - T * dalpha) * log_term
    cv_dep = -T * d2alpha * log_term
    return u_dep, cv_dep


# ---------------- Peng-Robinson real gas ----------------
#
# P = R T / (v - b) - a alpha(T) / (v^2 + 2 b v - b^2)
# alpha_i = (1 + kappa_i (1 - sqrt(T/Tc_i)))^2
# (PengRobinson.cpp; same autodiff-departure pattern as RK above)

_SQRT2 = 1.4142135623730951


def pr_a_alpha_species(mech: Mechanism, T):
    Tr = T / mech_tensor(mech, "pr_Tc", T)
    alpha = torch.square(1.0 + mech_tensor(mech, "pr_kappa", T)
                         * (1.0 - torch.sqrt(Tr)))
    return mech_tensor(mech, "pr_a", T) * alpha


def pr_mix(mech: Mechanism, T, x):
    """Geometric-mean combining rule, O(K) form (cf. rk_mix)."""
    sa = torch.sqrt(_max0(pr_a_alpha_species(mech, T)))
    a_mix = torch.square(torch.sum(x * sa))
    b_mix = torch.sum(x * mech_tensor(mech, "pr_b", x))
    return a_mix, b_mix


def pr_pressure(mech: Mechanism, T, molar_volume, x):
    a, b = pr_mix(mech, T, x)
    v = molar_volume
    return R_GAS * T / (v - b) - a / (v * v + 2.0 * b * v - b * b)


def pr_molar_volume(mech: Mechanism, T, P, x, *, iters: int = 60):
    x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    T, P = as_scalar(T, x), as_scalar(P, x)
    a, b = pr_mix(mech, T, x)

    def f(v):
        return (R_GAS * T / (v - b)
                - a / (v * v + 2.0 * b * v - b * b) - P)

    return _cubic_newton(f, R_GAS * T / P, b, iters)


def pr_departures(mech: Mechanism, T, molar_volume, x):
    """(u_dep, cv_dep) per mole for PR:
      u_dep = (T a'(T) - a(T)) L,  cv_dep = T a''(T) L,
      L = ln((v+(1+s)b)/(v+(1-s)b)) / (2 s b),  s = sqrt(2)."""
    v = molar_volume

    def a_of_T(t):
        am, _ = pr_mix(mech, t, x)
        return am

    b = torch.sum(x * mech_tensor(mech, "pr_b", x))
    a_T, da, d2a = _derivatives(a_of_T, T)
    L = torch.log((v + (1.0 + _SQRT2) * b)
                  / (v + (1.0 - _SQRT2) * b)) / (2.0 * _SQRT2 * b)
    return (T * da - a_T) * L, T * d2a * L


class GasState:
    """Convenience wrapper: mixture properties from (T, concentrations).

    conc: (nspec,) mol/m^3. Every method composes with torch.func.
    """

    def __init__(self, mech: Mechanism, real_gas: bool = False):
        self.mech = mech
        model = getattr(mech, "eos_model", "ideal")
        if model == "peng-robinson":
            self.real_gas = real_gas and bool((mech.pr_b != 0).any())
        else:
            self.real_gas = real_gas and bool((mech.rk_b != 0).any())
        self._is_pr = self.real_gas and model == "peng-robinson"

    def _eos_pressure(self, T, v, x):
        return (pr_pressure if self._is_pr else rk_pressure)(
            self.mech, T, v, x)

    def _eos_departures(self, T, v, x):
        return (pr_departures if self._is_pr else rk_departures)(
            self.mech, T, v, x)

    def density(self, conc):
        return torch.sum(conc * mech_tensor(self.mech, "mol_weights", conc))

    def mole_fractions(self, conc):
        return conc / torch.sum(conc)

    def pressure(self, T, conc):
        T = as_scalar(T, conc)
        ctot = torch.sum(conc)
        if not self.real_gas:
            return ctot * R_GAS * T
        return self._eos_pressure(T, 1.0 / ctot, self.mole_fractions(conc))

    def cv_mole(self, T, conc):
        """Mixture molar cv (J/mol/K)."""
        T = as_scalar(T, conc)
        x = self.mole_fractions(conc)
        cv_ig = torch.sum(x * (cp0_R(self.mech, T) - 1.0)) * R_GAS
        if not self.real_gas:
            return cv_ig
        _, cv_dep = self._eos_departures(T, 1.0 / torch.sum(conc), x)
        return cv_ig + cv_dep

    def partial_molar_int_energy(self, T, conc):
        """u_k (J/mol). Real-gas: ideal per-species + mixture departure
        attributed via d(n u_dep)/dn_k at constant T, V (torch.func.grad)."""
        T = as_scalar(T, conc)
        u_ig = u0_RT(self.mech, T) * R_GAS * T
        if not self.real_gas:
            return u_ig

        def U_dep_total(c):
            ntot = torch.sum(c)
            x = c / ntot
            u_dep, _ = self._eos_departures(T, 1.0 / ntot, x)
            return ntot * u_dep   # per unit volume

        return u_ig + grad(U_dep_total)(conc)

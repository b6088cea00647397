"""Model compression: spline-tabulated embedding nets (counterpart of
g4s_tpu/models/deepmd/compress.py).

Equivalent of `dp compress` (deepmd/deepmd/entrypoints/compress.py +
deepmd/deepmd/utils/tabulate.py: each embedding net is sampled on a uniform
grid of its scalar input and fitted with 5th-order polynomials per
interval; inference then evaluates the table, the tabulate_fusion op).

The quintic coefficients come from Hermite data (value, first and second
derivative at both interval ends) from forward-mode autodiff of the exact
embedding net (torch.func.jvp; every grid point is its own row, so one
all-ones tangent gives each row's derivative). Build them in f64: in f32
the second derivatives are noisy at the 1e-3 level. Evaluation is a gather
of the interval's 6 coefficient rows + Horner over all (atom, neighbor)
pairs.

The port's artifact (save_compressed) is a pickle of numpy arrays and the
spec. load_compressed reads it and the reference's `dp compress` artifact,
whose pickle holds jax.Arrays and the reference's NamedTuples: a restricted
unpickler rebuilds each jax.Array as the numpy array it pickled (jax's
reconstructor wraps numpy's own) and each reference class as the port's,
without importing jax, and refuses every other global. The reference does
not read the port's artifact; the frozen .npz loads both ways.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec, env_mat,
                                                    normalize_env_mat)
from g4s_tpu_torch.models.deepmd.freeze import (params_from_numpy,
                                                params_to_numpy)
from g4s_tpu_torch.models.deepmd.model import (ModelSpec, _select_by_type,
                                               atomic_energy, params_to)
from g4s_tpu_torch.models.deepmd.network import embedding_net_apply


class EmbeddingTable(NamedTuple):
    coeffs: torch.Tensor    # (n_intervals, 6, M1) quintic coefficients
    lower: float
    stride: float
    n_intervals: int


def tabulate_embedding(layers, lower: float, upper: float, stride: float,
                       m1: int) -> EmbeddingTable:
    """Quintic-Hermite table of one embedding net over [lower, upper], in
    the nets' dtype and on their device."""
    w = layers[0]["w"]
    n = int(np.ceil((upper - lower) / stride)) + 1
    xs = torch.as_tensor(lower + np.arange(n + 1) * stride, dtype=w.dtype,
                         device=w.device)[:, None]
    ones = torch.ones_like(xs)

    def g_fn(u):
        return embedding_net_apply(layers, u)              # (n+1, M1)

    def g1_fn(u):
        return torch.func.jvp(g_fn, (u,), (ones,))[1]

    with torch.no_grad():
        g, g1 = torch.func.jvp(g_fn, (xs,), (ones,))
        g2 = torch.func.jvp(g1_fn, (xs,), (ones,))[1]

    h = stride
    y0, y1 = g[:-1], g[1:]
    d0, d1 = g1[:-1] * h, g1[1:] * h
    s0, s1 = g2[:-1] * h * h, g2[1:] * h * h
    # quintic Hermite basis coefficients on t in [0, 1]
    c0 = y0
    c1 = d0
    c2 = 0.5 * s0
    c3 = 10 * (y1 - y0) - 6 * d0 - 4 * d1 - 1.5 * s0 + 0.5 * s1
    c4 = -15 * (y1 - y0) + 8 * d0 + 7 * d1 + 1.5 * s0 - s1
    c5 = 6 * (y1 - y0) - 3 * (d0 + d1) - 0.5 * (s0 - s1)
    coeffs = torch.stack([c0, c1, c2, c3, c4, c5], dim=1)  # (n, 6, M1)
    return EmbeddingTable(coeffs, float(lower), float(stride), n)


def eval_table(table: EmbeddingTable, u):
    """u: (...,) -> (..., M1) via interval lookup + Horner.

    Out-of-range inputs are clamped to the table edge (constant
    extrapolation): a quintic Hermite polynomial evaluated at |t| >> 1
    diverges. Build tables with data-driven ranges (sample_inputs) to
    avoid clamping in the first place."""
    t_all = (u - table.lower) / table.stride
    t_all = torch.clamp(t_all, 0.0, table.n_intervals - 1e-6)
    idx = torch.clamp(t_all.detach().long(), 0, table.n_intervals - 1)
    t = t_all - idx
    c = table.coeffs[idx]                                  # (..., 6, M1)
    tt = t[..., None]
    return ((((c[..., 5, :] * tt + c[..., 4, :]) * tt + c[..., 3, :]) * tt
             + c[..., 2, :]) * tt + c[..., 1, :]) * tt + c[..., 0, :]


class CompressedModel(NamedTuple):
    tables: tuple        # tables[tc][tn]
    params: dict         # original params (stats + fit nets still used)
    spec: ModelSpec


def compress_model(params, spec: ModelSpec, *, stride: float = 0.01,
                   extrapolate: float = 5.0, sample_inputs=None):
    """Build tables for every (center, neighbor) embedding net.

    Input range: the normalized s(r) channel is standardized, so
    [-extrapolate, extrapolate] covers it; `sample_inputs` (normalized
    s(r) values) can set the range from data like the reference's
    check_freq sampling.
    """
    if spec.descriptor_type != "se_e2_a":
        raise NotImplementedError("compression is ported for se_e2_a only")
    lo, hi = -extrapolate, extrapolate
    if sample_inputs is not None:
        # generous margin: frames OUTSIDE the sampled set stray past the
        # sampled range, and the clamped edge would flatten their forces
        s = sample_inputs.detach().cpu().numpy() \
            if isinstance(sample_inputs, torch.Tensor) \
            else np.asarray(sample_inputs)
        span = float(s.max()) - float(s.min())
        lo = float(s.min()) - 0.25 * span - 1.0
        hi = float(s.max()) + 0.25 * span + 1.0
    nt = spec.descriptor.ntypes
    tables = tuple(tuple(
        tabulate_embedding(params["embed"][tc][tn], lo, hi, stride, spec.m1)
        for tn in range(nt)) for tc in range(nt))
    return CompressedModel(tables, params, spec)


def atomic_descriptor_compressed(cm: CompressedModel, R, types):
    """atomic_descriptor with table-evaluated embeddings."""
    spec = cm.spec
    params = cm.params
    nt = spec.descriptor.ntypes
    nnei = spec.descriptor.nnei
    Rn = normalize_env_mat(R, types, params["stats"]["davg"],
                           params["stats"]["dstd"])
    sec = np.concatenate([[0], np.cumsum(spec.descriptor.sel)])
    lead = Rn.shape[:-2]
    D_by_tc = []
    for tc in range(nt):
        T = torch.zeros(lead + (4, spec.m1), dtype=Rn.dtype, device=Rn.device)
        for tn in range(nt):
            sec_R = Rn[..., sec[tn]: sec[tn + 1], :]
            G = eval_table(cm.tables[tc][tn], sec_R[..., 0])
            T = T + torch.einsum("...sc,...sm->...cm", sec_R, G)
        T = T / nnei
        D = torch.einsum("...cm,...ck->...mk", T, T[..., : spec.axis_neuron])
        D_by_tc.append(D.reshape(lead + (-1,)))
    return _select_by_type(D_by_tc, types)


def total_energy_compressed(cm: CompressedModel, coords, box, types):
    R, _ = env_mat(coords, box, types, cm.spec.descriptor)
    D = atomic_descriptor_compressed(cm, R, types)
    return torch.sum(atomic_energy(cm.params, cm.spec, D, types), dim=-1)


def energy_force_compressed(cm: CompressedModel, coords, box, types):
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        e = total_energy_compressed(cm, x, box, types)
        g, = torch.autograd.grad(e.sum(), (x,))
    return e.detach(), -g


def compressed_to(cm: CompressedModel, *, device=None, dtype=None):
    """The compressed model with its tables and params on `device` in
    `dtype` (None keeps each as it is)."""
    tables = tuple(tuple(t._replace(coeffs=t.coeffs.to(device=device,
                                                       dtype=dtype))
                         for t in row) for row in cm.tables)
    return CompressedModel(tables, params_to(cm.params, device=device,
                                             dtype=dtype), cm.spec)


def save_compressed(cm: CompressedModel, path) -> None:
    """Write the `dp compress` artifact: a pickle of numpy arrays and the
    spec."""
    tables = tuple(tuple(t._replace(coeffs=t.coeffs.cpu().numpy())
                         for t in row) for row in cm.tables)
    with open(path, "wb") as f:
        pickle.dump({"tables": tables, "params": params_to_numpy(cm.params),
                     "spec": cm.spec}, f)


def _numpy_from_jax(fun, args, arr_state, aval_state):
    """What jax._src.array._reconstruct_array does, short of the device
    put: numpy's reconstructor and the array's state."""
    a = fun(*args)
    a.__setstate__(arr_state)
    return a


# the globals a compressed artifact may name: numpy's array machinery, jax's
# array reconstructor, and the model's NamedTuples of either package
_ALLOWED = {
    ("jax._src.array", "_reconstruct_array"): _numpy_from_jax,
    **{(f"{pkg}.models.deepmd.{mod}", cls.__name__): cls
       for pkg in ("g4s_tpu", "g4s_tpu_torch")
       for mod, cls in (("compress", EmbeddingTable), ("model", ModelSpec),
                        ("descriptor", DescriptorSpec))}}
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.multiarray", "scalar")}


class _ArtifactUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        if (module, name) in _ALLOWED:
            return _ALLOWED[module, name]
        raise pickle.UnpicklingError(
            f"compressed artifact: global {module}.{name} is not allowed")


def load_compressed(path, *, device="cuda") -> CompressedModel:
    """Load a `dp compress` artifact, the port's or the reference's, onto
    `device`. Only numpy arrays and the model's own NamedTuples are
    rebuilt; any other object in the pickle raises."""
    with open(path, "rb") as f:
        d = _ArtifactUnpickler(f).load()
    params = params_from_numpy(d["params"], device=device)
    dev = params["stats"]["davg"].device
    tables = tuple(tuple(
        t._replace(coeffs=torch.from_numpy(t.coeffs).to(dev))
        for t in row) for row in d["tables"])
    return CompressedModel(tables, params, d["spec"])

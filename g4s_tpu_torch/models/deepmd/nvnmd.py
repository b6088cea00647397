"""NVNMD: the quantized hardware-deployment pipeline (counterpart of
g4s_tpu/models/deepmd/nvnmd.py).

The reference ships NVNMD (NVNMD paper, DOI 10.1038/s41524-022-00773-z) as
a TF graph-surgery layer that retargets a trained se_a model onto a
fixed-point accelerator:

* quantization-aware training with straight-through estimators and a
  polynomial `tanh4` activation (`deepmd/nvnmd/utils/network.py:62-88`);
* ``mapt``: piecewise-polynomial mapping tables u=r^2 -> s, h and
  s -> G so inference needs only table lookups and fixed-point matmuls
  (`deepmd/nvnmd/entrypoints/mapt.py:35-152`);
* the quantized descriptor contraction with the wrapped-band D' subset
  (`deepmd/nvnmd/descriptor/se_a.py:180-336`);
* ``wrap``: packing quantized weights + tables into the device image
  (`deepmd/nvnmd/entrypoints/wrap.py`).

The pipeline's semantics are kept: two-stage CNN/QNN training,
table-driven inference, a fixed-point artifact with a bit-exact reload.
The straight-through quantizers are x + (q(x) - x).detach(), a table
lookup is a gather and a Horner cubic, and forces come from
torch.autograd through the tables (the reference builds separate `*_grad`
tables for its hand-written backward ops; differentiating the same cubic
gives the same derivative). Every product goes through
engine.matmul.dense_matmul. One frame at a time: coords (N, 3), box
(3, 3).

Hardware constraint kept from `deepmd/nvnmd/data/data.py` ("ntypex": 1):
the embedding net depends only on the *neighbor* type, so the G tables are
per neighbor type.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from g4s_tpu_torch.engine.matmul import dense_matmul
from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec,
                                                    min_image_displacements,
                                                    switch_fn)
from g4s_tpu_torch.models.deepmd.network import (init_embedding_net,
                                                 init_fitting_net)
from g4s_tpu_torch.sparse.containers import resolve_device


# ---------------------------------------------------------------------------
# Quantization primitives (utils/network.py:62-88)
# ---------------------------------------------------------------------------

def qf(x, nbit: int):
    """Floor-quantize to the 2^-nbit grid; straight-through gradient."""
    prec = 2.0 ** nbit
    y = torch.floor(x * prec) / prec
    return x + (y - x).detach()


def qr(x, nbit: int):
    """Round-quantize (half to even) to the 2^-nbit grid; straight-through
    gradient."""
    prec = 2.0 ** nbit
    y = torch.round(x * prec) / prec
    return x + (y - x).detach()


def tanh4(x):
    """Quartic tanh surrogate: sign(x)*(|x|^4/16 - |x|^3/4 + |x|), |x|<=2.

    Exactly representable in fixed point (coefficients are powers of two);
    saturates smoothly at +-1 with zero slope at |x|=2
    (utils/network.py:80-88).
    """
    c = torch.clamp(x, -2.0, 2.0)
    # odd form c^3|c|/16 - c^3/4 + c keeps grad(0) = 1 exactly
    return c ** 3 * torch.abs(c) / 16.0 - c ** 3 / 4.0 + c


# ---------------------------------------------------------------------------
# Spec + parameters
# ---------------------------------------------------------------------------

class NvnmdSpec(NamedTuple):
    """NVNMD model: se_a with ntypex=1 embedding and fixed-point budgets.

    Bit budgets follow `deepmd/nvnmd/data/data.py` jdata_config["nbit"]:
    NBIT_FIXD_FL=23 (descriptor data), NBIT_FIT_DATA_FL=23 and
    NBIT_FIT_WEIGHT=18 (fitting net).
    """
    descriptor: DescriptorSpec
    embed_neurons: Tuple[int, ...] = (8, 16, 32)
    axis_neuron: int = 4                       # M2
    fit_neurons: Tuple[int, ...] = (32, 32)
    nbit_data_fl: int = 23                     # NBIT_FIXD_FL
    nbit_fit_data_fl: int = 23                 # NBIT_FIT_DATA_FL
    nbit_fit_weight: int = 18                  # NBIT_FIT_WEIGHT
    n_u2s: int = 512                           # u->s,h table rows
    n_s2g_fine: int = 256                      # s->G fine rows
    n_s2g_coarse: int = 256                    # s->G coarse rows (16x step)

    @property
    def m1(self) -> int:
        return self.embed_neurons[-1]


def init_nvnmd_params(gen, spec: NvnmdSpec, *, bias_atom_e=None,
                      dtype=torch.float64):
    """Embedding nets per NEIGHBOR type (ntypex=1) + per-type fitting,
    drawn from the torch.Generator `gen` on its device."""
    nt = spec.descriptor.ntypes
    dev = gen.device
    if bias_atom_e is None:
        bias_atom_e = np.zeros(nt)
    embed = [init_embedding_net(gen, spec.embed_neurons, dtype=dtype)
             for _ in range(nt)]
    in_dim = spec.m1 * spec.axis_neuron
    fit = [init_fitting_net(gen, in_dim, spec.fit_neurons,
                            bias_out=float(bias_atom_e[tc]), dtype=dtype)
           for tc in range(nt)]
    # per-type SCALAR stats: the hardware contract (mapt.py run_u2s uses
    # avg[t,0], std[t,0] for s and std[t,1] for h; no per-slot
    # normalization exists on the device)
    stats = {"avg": torch.zeros((nt,), dtype=dtype, device=dev),
             "std_s": torch.ones((nt,), dtype=dtype, device=dev),
             "std_h": torch.ones((nt,), dtype=dtype, device=dev)}
    return {"embed": embed, "fit": fit, "stats": stats}


# ---------------------------------------------------------------------------
# Forward passes (CNN stage: continuous tanh4; QNN stage: quantized)
# ---------------------------------------------------------------------------

def _embed_apply(layers, x, *, quantize: bool, spec: NvnmdSpec):
    """Embedding net with tanh4; the QNN stage round-quantizes weights and
    floor-quantizes activations (utils/network.py matmul2_qq + qf)."""
    for layer in layers:
        w, b = layer["w"], layer["b"]
        if quantize:
            w = qr(w, spec.nbit_fit_weight)
            b = qr(b, spec.nbit_fit_weight)
        h = tanh4(dense_matmul(x, w) + b)
        if quantize:
            h = qf(h, spec.nbit_data_fl)
        n_in, n_out = layer["w"].shape
        if n_out == n_in:
            x = x + h
        elif n_out == 2 * n_in:
            x = torch.cat([x, x], dim=-1) + h
        else:
            x = h
    return x


def _fit_apply(params, x, *, quantize: bool, spec: NvnmdSpec):
    for layer in params["hidden"]:
        w, b = layer["w"], layer["b"]
        if quantize:
            w = qr(w, spec.nbit_fit_weight)
            b = qr(b, spec.nbit_fit_weight)
        h = tanh4(dense_matmul(x, w) + b)
        if quantize:
            h = qf(h, spec.nbit_fit_data_fl)
        n_in, n_out = layer["w"].shape
        x = x + h if n_out == n_in else h
    w, b = params["final"]["w"], params["final"]["b"]
    if quantize:
        w = qr(w, spec.nbit_fit_weight)
    out = dense_matmul(x, w) + b
    return out[..., 0]


def _band_subset_idx(m1: int, m2: int) -> np.ndarray:
    """The wrapped-band D' subset: (i, (i+j) mod M1) for j in [0, M2)
    (descriptor/se_a.py:300-306): NVNMD keeps a band of the full M1xM1
    Gram matrix instead of the leading M2 columns."""
    idx = []
    for i in range(m1):
        for j in range(i, i + m2):
            idx.append(i * m1 + (j % m1))
    return np.asarray(idx, np.int32)


def _neighbor_u(coords, box, types, dspec: DescriptorSpec):
    """Per-neighbor u = r^2, unit vectors, validity and neighbor type.

    The type-sectioned top-k layout of descriptor.env_mat, keeping r^2
    (the table input the hardware indexes on: mapt.py run_u2s samples
    u = r^2 so no sqrt is needed on the device).
    """
    n = coords.shape[0]
    disp = min_image_displacements(coords, box)
    r2 = torch.sum(disp * disp, dim=-1)
    big = 1e10
    r2 = r2 + big * torch.eye(n, dtype=r2.dtype, device=r2.device)
    types = torch.as_tensor(types, device=coords.device)
    u_secs, e_secs, v_secs = [], [], []
    for t in range(dspec.ntypes):
        k = dspec.sel[t]
        r2_t = torch.where(types[None, :] == t, r2, big)
        if r2_t.shape[1] < k:
            r2_t = F.pad(r2_t, (0, k - r2_t.shape[1]), value=big)
        d2, idx = torch.topk(r2_t, k, dim=-1, largest=False, sorted=True)
        valid = d2 < dspec.rcut ** 2
        idx_g = torch.where(valid, idx, 0)
        vec = torch.gather(disp, 1, idx_g[..., None].expand(n, k, 3))
        d = torch.sqrt(torch.where(valid, d2, 1.0))
        unit = vec / d[:, :, None]
        u_secs.append(torch.where(valid, d2, 0.0))
        e_secs.append(unit * valid[:, :, None])
        v_secs.append(valid)
    return (torch.cat(u_secs, dim=1), torch.cat(e_secs, dim=1),
            torch.cat(v_secs, dim=1))


def _s_h_of_u(u, dspec: DescriptorSpec):
    """s(u) = switch(r)/r and h(u) = s/r as functions of u = r^2."""
    r = torch.sqrt(torch.clamp(u, min=1e-30))
    s = switch_fn(r, dspec.rcut_smth, dspec.rcut) / r
    return s, s / r


def _gram_band(spec: NvnmdSpec, Rt, G, quantize: bool):
    """GR = Rt^T G / nnei, its Gram matrix and the band subset D."""
    GR = torch.einsum("nsc,nsm->ncm", Rt, G) / spec.descriptor.nnei
    if quantize:
        GR = qf(GR, spec.nbit_data_fl)
    gram = torch.einsum("ncm,ncl->nml", GR, GR)        # (N, M1, M1)
    band = torch.as_tensor(_band_subset_idx(spec.m1, spec.axis_neuron),
                           device=G.device).long()
    D = gram.reshape(gram.shape[0], -1)[:, band]
    if quantize:
        D = qf(D, spec.nbit_data_fl)
    return D


def _atomic_energy_sum(params, spec: NvnmdSpec, D, types, quantize: bool):
    types = torch.as_tensor(types, device=D.device)
    ae = _fit_apply(params["fit"][0], D, quantize=quantize, spec=spec)
    for tc in range(1, spec.descriptor.ntypes):
        ae = torch.where(types == tc,
                         _fit_apply(params["fit"][tc], D, quantize=quantize,
                                    spec=spec), ae)
    return torch.sum(ae)


def nvnmd_total_energy(params, spec: NvnmdSpec, coords, box, types, *,
                       stage: str = "cnn"):
    """Direct (net-evaluating) forward. stage='cnn' is the continuous
    tanh4 model; stage='qnn' applies the fixed-point quantizers
    (quantization-aware, straight-through gradients)."""
    quantize = stage == "qnn"
    dspec = spec.descriptor
    types = torch.as_tensor(types, device=coords.device).long()
    u, unit, valid = _neighbor_u(coords, box, types, dspec)
    s, h = _s_h_of_u(u, dspec)
    s = torch.where(valid, s, 0.0)
    h = torch.where(valid, h, 0.0)
    # per-center-type scalar normalization (the hardware contract)
    st = params["stats"]
    s_n = (s - st["avg"][types][:, None]) / st["std_s"][types][:, None]
    h_n = h / st["std_h"][types][:, None]   # pads: -avg/std_s, as the table
    if quantize:
        s_n = qf(s_n, spec.nbit_data_fl)
        h_n = qf(h_n, spec.nbit_data_fl)
    # R-tilde rows [s_n, h_n*ex, h_n*ey, h_n*ez]
    Rt = torch.cat([s_n[:, :, None], h_n[:, :, None] * unit], dim=-1)
    # G per neighbor-type section (ntypex=1: the net indexed by tn only);
    # pad slots take part, as in se_a after normalization
    sec = np.concatenate([[0], np.cumsum(dspec.sel)])
    G = torch.cat([_embed_apply(params["embed"][tn],
                                s_n[:, sec[tn]:sec[tn + 1], None],
                                quantize=quantize, spec=spec)
                   for tn in range(dspec.ntypes)], dim=1)  # (N, nnei, M1)
    D = _gram_band(spec, Rt, G, quantize)
    return _atomic_energy_sum(params, spec, D, types, quantize)


def _energy_force(energy_of, coords, create_graph: bool):
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        e = energy_of(x)
        (g,) = torch.autograd.grad(e, x, create_graph=create_graph)
    return (e if create_graph else e.detach()), -g


def nvnmd_energy_force(params, spec: NvnmdSpec, coords, box, types, *,
                       stage: str = "cnn", create_graph: bool = False):
    """(E, F = -dE/dx); create_graph=True keeps the graph of both for a
    loss on the forces (train_two_stage)."""
    return _energy_force(
        lambda x: nvnmd_total_energy(params, spec, x, box, types,
                                     stage=stage), coords, create_graph)


# ---------------------------------------------------------------------------
# Mapping tables (entrypoints/mapt.py): u -> s,h and s -> G as
# piecewise cubics; two-segment s->G grid (fine + 16x coarse).
# ---------------------------------------------------------------------------

class MapTables(NamedTuple):
    cfg_u2s: np.ndarray     # (1, 5): x0, x1, dx, row0, row1
    cfg_s2g: np.ndarray     # (2, 5)
    coef_s: torch.Tensor    # (nt, n_u2s, 4)        Hermite cubic coeffs
    coef_h: torch.Tensor    # (nt, n_u2s, 4)
    coef_g: torch.Tensor    # (nt, n_rows, 4*M1)
    s_range: Tuple[float, float]


def _hermite_coef(y0, y1, d0, d1, dx):
    """Cubic Hermite coefficients on [0, dx]: y = c0+c1 t+c2 t^2+c3 t^3,
    from endpoint values and first derivatives: the rank-4 table the
    reference assembles from (val, grad, grad_grad) triples (mapt.py
    build_map_coef)."""
    c0 = y0
    c1 = d0
    c2 = (3 * (y1 - y0) / dx - 2 * d0 - d1) / dx
    c3 = (2 * (y0 - y1) / dx + d0 + d1) / dx ** 2
    return torch.stack([c0, c1, c2, c3], dim=-1)


def build_map(params, spec: NvnmdSpec) -> MapTables:
    """Sample the trained nets onto the two mapping grids, in float64 on
    the parameters' device (the grid bounds are computed on the host)."""
    dspec = spec.descriptor
    nt = dspec.ntypes
    dev = params["stats"]["avg"].device
    f64 = torch.float64
    avg = params["stats"]["avg"].detach().cpu().numpy()        # (nt,)
    std_s = params["stats"]["std_s"].detach().cpu().numpy()
    std_h = params["stats"]["std_h"].detach().cpu().numpy()

    # --- u -> s, h on a uniform grid over [0, rcut^2] ------------------
    n_u = spec.n_u2s
    u_max = dspec.rcut ** 2
    du = u_max / n_u
    u_knots = np.arange(n_u + 1) * du
    with torch.enable_grad():
        u_j = torch.as_tensor(np.maximum(u_knots, 1e-12), dtype=f64,
                              device=dev).requires_grad_(True)
        s_val, h_val = _s_h_of_u(u_j, dspec)
        # elementwise functions: the gradient of the sum is each knot's
        s_grad = torch.autograd.grad(s_val.sum(), u_j, retain_graph=True)[0]
        h_grad = torch.autograd.grad(h_val.sum(), u_j)[0]
    s_val, h_val = s_val.detach(), h_val.detach()

    coef_s_rows, coef_h_rows = [], []
    for tc in range(nt):
        sv = (s_val - avg[tc]) / std_s[tc]
        sg = s_grad / std_s[tc]
        hv = h_val / std_h[tc]
        hg = h_grad / std_h[tc]
        # u = 0 is the "no neighbor" sentinel: pin the first knot to the
        # normalized-zero value with zero slope (mapt.py run_u2s rows 0)
        sv[0] = -avg[tc] / std_s[tc]
        sg[0] = 0.0
        hv[0] = 0.0
        hg[0] = 0.0
        coef_s_rows.append(_hermite_coef(sv[:-1], sv[1:],
                                         sg[:-1], sg[1:], du))
        coef_h_rows.append(_hermite_coef(hv[:-1], hv[1:],
                                         hg[:-1], hg[1:], du))
    cfg_u2s = np.asarray([[0.0, u_max, du, 0, n_u]])

    # --- s -> G on a two-segment grid (mapt.py cfg_s2g) ----------------
    s_host = s_val.cpu().numpy()
    s_all = np.concatenate([(s_host[1:] - avg[t]) / std_s[t]
                            for t in range(nt)] + [-avg / std_s])
    s_lo = float(s_all.min())
    s_hi = float(s_all.max())
    span = max(s_hi - s_lo, 1e-6)
    s_lo -= 0.05 * span
    s_hi += 0.05 * span
    nf, nc = spec.n_s2g_fine, spec.n_s2g_coarse
    ds = (s_hi - s_lo) / (nf + 16 * nc)
    fine = s_lo + np.arange(nf + 1) * ds
    coarse = fine[-1] + np.arange(nc + 1) * (16 * ds)
    cfg_s2g = np.asarray([[s_lo, fine[-1], ds, 0, nf],
                          [fine[-1], coarse[-1], 16 * ds, nf, nf + nc]])

    coef_g_rows = []
    for tn in range(nt):
        layers = params["embed"][tn]
        rows = []
        for knots, step in ((fine, ds), (coarse, 16 * ds)):
            kj = torch.as_tensor(knots, dtype=f64, device=dev)
            # each knot's row depends on its own input only: one forward-
            # mode pass with unit tangents gives every dG/ds
            gv, gd = torch.func.jvp(
                lambda s_: _embed_apply(layers, s_[:, None], quantize=False,
                                        spec=spec),
                (kj,), (torch.ones_like(kj),))           # (nk+1, M1) each
            rows.append(_hermite_coef(gv[:-1], gv[1:],
                                      gd[:-1], gd[1:], step))
        coef = torch.cat(rows, dim=0)                   # (nf+nc, M1, 4)
        coef_g_rows.append(coef.reshape(coef.shape[0], -1).detach())
    return MapTables(cfg_u2s=cfg_u2s, cfg_s2g=cfg_s2g,
                     coef_s=torch.stack(coef_s_rows).detach(),
                     coef_h=torch.stack(coef_h_rows).detach(),
                     coef_g=torch.stack(coef_g_rows),
                     s_range=(s_lo, s_hi))


def _map_index(x, cfg, rows: int):
    """(row, offset) of each x in a table of `rows` rows laid out by the
    segments cfg (nseg, 5) (numpy); x below or above the table clamps to
    its first or last row."""
    idx = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    dxx = torch.zeros_like(x)
    hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    cfg = np.asarray(cfg)
    for x0, x1, dx, r0, r1 in cfg:
        k = torch.floor((x - x0) / dx).long().clamp(0, int(r1 - r0) - 1)
        inseg = (x >= x0) & (x <= x1) & ~hit
        idx = torch.where(inseg, k + int(r0), idx)
        dxx = torch.where(inseg, x - x0 - k.to(x.dtype) * dx, dxx)
        hit = hit | inseg
    lo, hi = cfg[0], cfg[-1]
    below = x < lo[0]
    above = x > hi[1]
    idx = torch.where(below, 0, torch.where(above, rows - 1, idx))
    dxx = torch.where(below, 0.0, torch.where(above, float(hi[2]), dxx))
    return idx, dxx


def _horner(c, t):
    """c: (..., ncol, 4) cubic coefficients at offsets t (...)."""
    t = t[..., None]
    return c[..., 0] + t * (c[..., 1] + t * (c[..., 2] + t * c[..., 3]))


def _map_lookup(x, coef, cfg):
    """Piecewise-cubic table evaluation, differentiable in x.

    x: (...,); coef: (rows, C*4) Hermite coefficients; cfg: (nseg, 5)
    numpy. Returns (..., C)."""
    idx, dxx = _map_index(x, cfg, coef.shape[0])
    c = coef[idx].reshape(x.shape + (coef.shape[-1] // 4, 4))
    return _horner(c, dxx)


def nvnmd_map_energy(params, spec: NvnmdSpec, tables: MapTables,
                     coords, box, types):
    """Table-driven forward: the hardware-execution path. No embedding
    net evaluation: only u2s/u2h/s2g lookups, the GR contraction, the
    band subset, and the quantized fitting net."""
    dspec = spec.descriptor
    types = torch.as_tensor(types, device=coords.device).long()
    u, unit, valid = _neighbor_u(coords, box, types, dspec)
    # each atom's own type's u tables
    idx, dxx = _map_index(u, tables.cfg_u2s, tables.coef_s.shape[1])
    s_n = _horner(tables.coef_s[types[:, None], idx][..., None, :], dxx)
    h_n = _horner(tables.coef_h[types[:, None], idx][..., None, :], dxx)
    s_n = qf(s_n[..., 0], spec.nbit_data_fl)     # pads: the u=0 knot
    h_n = qf(h_n[..., 0], spec.nbit_data_fl)
    Rt = torch.cat([s_n[:, :, None], h_n[:, :, None] * unit], dim=-1)
    sec = np.concatenate([[0], np.cumsum(dspec.sel)])
    G = torch.cat([_map_lookup(s_n[:, sec[tn]:sec[tn + 1]],
                               tables.coef_g[tn], tables.cfg_s2g)
                   for tn in range(dspec.ntypes)], dim=1)
    G = qf(G, spec.nbit_data_fl)
    D = _gram_band(spec, Rt, G, True)
    return _atomic_energy_sum(params, spec, D, types, True)


def nvnmd_map_energy_force(params, spec, tables, coords, box, types):
    return _energy_force(
        lambda x: nvnmd_map_energy(params, spec, tables, x, box, types),
        coords, False)


# ---------------------------------------------------------------------------
# Wrap: fixed-point device image (entrypoints/wrap.py role)
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def wrap_model(params, spec: NvnmdSpec, tables: MapTables, path: str):
    """Save the deployment artifact, every tensor as int64 fixed point
    (the reference's .npz layout: either package reads the other's).

    Weights at 2^-NBIT_FIT_WEIGHT, tables and stats at 2^-NBIT_FIXD_FL:
    the binary the reference's wrap.py would burn into model.pb. Reload
    with `load_wrapped`; the round trip is bit-exact at the quantized
    precision, so eval(load(wrap(m))) == eval(quantized m).
    """
    pw = 2 ** spec.nbit_fit_weight
    pd = 2 ** spec.nbit_data_fl

    def fixed(x, prec):
        return np.round(_np(x) * prec).astype(np.int64)

    out = {"spec_rcut": np.float64(spec.descriptor.rcut),
           "spec_rcut_smth": np.float64(spec.descriptor.rcut_smth),
           "spec_sel": np.asarray(spec.descriptor.sel, np.int64),
           "spec_embed": np.asarray(spec.embed_neurons, np.int64),
           "spec_axis": np.int64(spec.axis_neuron),
           "spec_fit": np.asarray(spec.fit_neurons, np.int64),
           "spec_nbits": np.asarray([spec.nbit_data_fl,
                                     spec.nbit_fit_data_fl,
                                     spec.nbit_fit_weight], np.int64),
           "spec_tab": np.asarray([spec.n_u2s, spec.n_s2g_fine,
                                   spec.n_s2g_coarse], np.int64),
           "cfg_u2s": np.asarray(tables.cfg_u2s),
           "cfg_s2g": np.asarray(tables.cfg_s2g),
           "s_range": np.asarray(tables.s_range),
           "coef_s": fixed(tables.coef_s, pd),
           "coef_h": fixed(tables.coef_h, pd),
           "coef_g": fixed(tables.coef_g, pd),
           "avg": fixed(params["stats"]["avg"], pd),
           "std_s": fixed(params["stats"]["std_s"], pd),
           "std_h": fixed(params["stats"]["std_h"], pd)}
    nt = spec.descriptor.ntypes
    for tn in range(nt):
        for li, layer in enumerate(params["embed"][tn]):
            out[f"e{tn}_{li}_w"] = fixed(layer["w"], pw)
            out[f"e{tn}_{li}_b"] = fixed(layer["b"], pw)
    for tc in range(nt):
        fitp = params["fit"][tc]
        for li, layer in enumerate(fitp["hidden"]):
            out[f"f{tc}_{li}_w"] = fixed(layer["w"], pw)
            out[f"f{tc}_{li}_b"] = fixed(layer["b"], pw)
        out[f"f{tc}_final_w"] = fixed(fitp["final"]["w"], pw)
        # output bias keeps full precision (energy offset)
        out[f"f{tc}_final_b"] = _np(fitp["final"]["b"]).astype(np.float64)
    # np.savez appends ".npz" to bare string paths; a file handle writes
    # to exactly the path the caller asked for (model.nvnmd etc.)
    with open(path, "wb") as fh:
        np.savez(fh, **out)


def load_wrapped(path: str, *, device="cuda"):
    """Inverse of wrap_model: (params, spec, tables) on `device`, float64,
    with the dequantized (already on-grid) weights, so the QNN/table
    forward is bit-identical to the pre-wrap model's."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    with np.load(path) as z:
        z = dict(z)
    nbits = z["spec_nbits"]
    tabs = z["spec_tab"]
    sel = tuple(int(v) for v in z["spec_sel"])
    spec = NvnmdSpec(
        descriptor=DescriptorSpec(rcut=float(z["spec_rcut"]),
                                  rcut_smth=float(z["spec_rcut_smth"]),
                                  sel=sel, ntypes=len(sel)),
        embed_neurons=tuple(int(v) for v in z["spec_embed"]),
        axis_neuron=int(z["spec_axis"]),
        fit_neurons=tuple(int(v) for v in z["spec_fit"]),
        nbit_data_fl=int(nbits[0]), nbit_fit_data_fl=int(nbits[1]),
        nbit_fit_weight=int(nbits[2]),
        n_u2s=int(tabs[0]), n_s2g_fine=int(tabs[1]),
        n_s2g_coarse=int(tabs[2]))
    pw = 2.0 ** spec.nbit_fit_weight
    pd = 2.0 ** spec.nbit_data_fl
    nt = spec.descriptor.ntypes

    def layers(prefix):
        out, li = [], 0
        while f"{prefix}_{li}_w" in z:
            out.append({"w": t(z[f"{prefix}_{li}_w"] / pw),
                        "b": t(z[f"{prefix}_{li}_b"] / pw)})
            li += 1
        return out

    embed = [layers(f"e{tn}") for tn in range(nt)]
    fit = [{"hidden": layers(f"f{tc}"),
            "final": {"w": t(z[f"f{tc}_final_w"] / pw),
                      "b": t(z[f"f{tc}_final_b"])}}
           for tc in range(nt)]
    params = {"embed": embed, "fit": fit,
              "stats": {"avg": t(z["avg"] / pd),
                        "std_s": t(z["std_s"] / pd),
                        "std_h": t(z["std_h"] / pd)}}
    tables = MapTables(cfg_u2s=z["cfg_u2s"], cfg_s2g=z["cfg_s2g"],
                       coef_s=t(z["coef_s"] / pd),
                       coef_h=t(z["coef_h"] / pd),
                       coef_g=t(z["coef_g"] / pd),
                       s_range=tuple(float(v) for v in z["s_range"]))
    return params, spec, tables


# ---------------------------------------------------------------------------
# Two-stage training (entrypoints/train.py: CNN then QNN)
# ---------------------------------------------------------------------------

def train_two_stage(params, spec: NvnmdSpec, frames, *, lr=1e-3,
                    steps_cnn=50, steps_qnn=50, pref_e=1.0, pref_f=1.0):
    """CNN stage (continuous tanh4) then QNN stage (quantization-aware).

    frames: list of (coords, box, types, e_ref, f_ref) tensors on the
    parameters' device. SGD with momentum 0.9 over every leaf, the stats
    included, as the reference's; returns (params, losses_cnn,
    losses_qnn), the losses as host floats.
    """
    from g4s_tpu_torch.ckpt import tree_leaves, tree_unflatten

    def loss(p, stage):
        tot = 0.0
        for coords, box, types, e_ref, f_ref in frames:
            e, f = nvnmd_energy_force(p, spec, coords, box, types,
                                      stage=stage, create_graph=True)
            na = coords.shape[0]
            tot = tot + pref_e * ((e - e_ref) / na) ** 2 \
                + pref_f * torch.mean((f - f_ref) ** 2)
        return tot / len(frames)

    losses = {"cnn": [], "qnn": []}
    leaves = [x.detach() for x in tree_leaves(params)]
    vel = [torch.zeros_like(x) for x in leaves]
    for stage, steps in (("cnn", steps_cnn), ("qnn", steps_qnn)):
        for _ in range(steps):
            live = [x.requires_grad_(True) for x in leaves]
            with torch.enable_grad():
                lv = loss(tree_unflatten(params, iter(live)), stage)
                grads = torch.autograd.grad(lv, live, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, live)]
            vel = [0.9 * v - lr * g for v, g in zip(vel, grads)]
            leaves = [(x + v).detach() for x, v in zip(live, vel)]
            losses[stage].append(float(lv.detach()))
    return tree_unflatten(params, iter(leaves)), losses["cnn"], losses["qnn"]

"""DeePMD-kit's energy model in plain PyTorch: the se_e2_a (DescrptSeA)
and se_e3 (DescrptSeT) descriptors, the fitting net, E per frame, and the
forces and virial.

Written from DeePMD-kit's description (deepmd/descriptor/se_a.py,
se_t.py, fit/ener.py, source/lib/src/{env_mat,fmt_nlist,prod_force,
prod_virial}.cc):

  - neighbours of atom i: per neighbour type t the sel[t] nearest minimum
    images within rcut, sorted by distance, padded to sel[t] (fmt_nlist);
  - the env row of a neighbour at displacement d = x_j - x_i, r = |d|:
    s(r) (1, d/r), s(r) = 1/r below rcut_smth, times the quintic switch
    u^3 (-6u^2 + 15u - 10) + 1 up to rcut; padded rows are 0;
  - rows normalised per centre type, (R - davg) / dstd, padded rows too;
  - se_e2_a: T = sum over type sections of R_sec^T G_sec / nnei, G the
    embedding net [centre type][neighbour type] of the row's first column;
    D = T^T T[:, :axis_neuron], flattened row-major;
  - se_e3: for t1 <= t2, theta_jk = x_j . x_k of the normalised vector
    columns, D = sum_jk theta_jk G_{t1,t2}(theta_jk) / (sel1 sel2);
  - E_i = fit_{type i}(D_i); E = sum_i E_i.

Forces and virial come from dE/dd over the selected displacements, as
DeePMD-kit's prod_force and prod_virial assemble them: F_i gains
sum_j dE/dd_ij, F_j loses dE/dd_ij, W = -sum_ij d_ij (x) dE/dd_ij. The
program differentiates a strain instead, so the two paths to W differ.

Unlike DeePMD-kit (and the program), each atom runs its own centre type's
nets only. Boxes are orthorhombic: L holds each frame's three lengths.
The work runs in blocks of centre atoms of one type, so any size fits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

PAIR_BUDGET = 1 << 25        # candidate pairs held at once (the search)
ROW_BUDGET = 1 << 23         # embedding-net input rows held at once


class Model(NamedTuple):
    kind: str                   # "se_e2_a" or "se_e3"
    sel: Tuple[int, ...]
    rcut: float
    rcut_smth: float
    neuron: Tuple[int, ...]
    axis_neuron: int
    fit_neuron: Tuple[int, ...]

    @property
    def nnei(self) -> int:
        return sum(self.sel)

    @property
    def ntypes(self) -> int:
        return len(self.sel)

    @property
    def rows_per_center(self) -> int:
        if self.kind == "se_e3":
            return sum(a * b for i, a in enumerate(self.sel)
                       for b in self.sel[i:])
        return self.nnei


def model_from_config(cfg: dict) -> Model:
    d, fit = cfg["descriptor"], cfg["fitting_net"]
    if d["type"] not in ("se_e2_a", "se_e3"):
        raise ValueError(f"the reference has no descriptor {d['type']!r}")
    return Model(d["type"], tuple(d["sel"]), float(d["rcut"]),
                 float(d["rcut_smth"]), tuple(d["neuron"]),
                 int(d.get("axis_neuron", 0)), tuple(fit["neuron"]))


def _switch(r, rmin, rmax):
    u = (r - rmin) / (rmax - rmin)
    sw = u * u * u * (-6.0 * u * u + 15.0 * u - 10.0) + 1.0
    return torch.where(r < rmin, torch.ones_like(r),
                       torch.where(r < rmax, sw, torch.zeros_like(r)))


def _wrap(d, L):
    """Minimum image of displacements d (F, ..., 3) in boxes L (F, 3)."""
    Lb = L.reshape(L.shape[0], *([1] * (d.dim() - 2)), 3)
    return d - Lb * torch.round(d / Lb)


def neighbors(model: Model, x, L, types, centers):
    """(F, C, nnei) neighbour indices of the atoms `centers` (C,) in each
    frame (x (F, N, 3)), per type section sorted by distance, -1 where a
    slot is empty; the most atoms any centre has within rcut per type
    (more than sel[t] are cut to the nearest sel[t]); and the closest
    distance of any pair."""
    F, N, _ = x.shape
    C = centers.shape[0]
    d = _wrap(x[:, None, :, :] - x[:, centers, None, :], L)
    r2 = (d * d).sum(-1)                                   # (F, C, N)
    r2[:, torch.arange(C, device=x.device), centers] = float("inf")
    rc2 = model.rcut * model.rcut
    secs, most = [], []
    closest = float(r2.min().sqrt()) if r2.numel() else float("inf")
    for t, s in enumerate(model.sel):
        r2t = torch.where(types[None, None, :] == t, r2,
                          torch.full_like(r2, float("inf")))
        most.append(int((r2t < rc2).sum(-1).max()) if C else 0)
        srt, order = torch.sort(r2t, dim=-1, stable=True)
        srt, order = srt[..., :s], order[..., :s]
        if srt.shape[-1] < s:                              # N < sel[t]
            pad = s - srt.shape[-1]
            srt = torch.nn.functional.pad(srt, (0, pad), value=float("inf"))
            order = torch.nn.functional.pad(order, (0, pad), value=0)
        secs.append(torch.where(srt < rc2, order, torch.full_like(order, -1)))
    return torch.cat(secs, -1), most, closest


def _displacements(x, L, centers, nbr):
    """d_ij (F, C, nnei, 3) of each centre's selected neighbours (0 where
    the slot is empty) and the slot mask."""
    F = x.shape[0]
    valid = nbr >= 0
    fi = torch.arange(F, device=x.device)[:, None, None]
    xj = x[fi, nbr.clamp(min=0)]
    d = _wrap(xj - x[:, centers, None, :], L)
    return torch.where(valid[..., None], d, torch.zeros_like(d)), valid


def env_rows(model: Model, d, valid):
    """Raw env rows (..., nnei, 4) of displacements d (..., nnei, 3)."""
    r2 = (d * d).sum(-1)
    r = torch.sqrt(torch.where(valid, r2, torch.ones_like(r2)))
    s = torch.where(valid, _switch(r, model.rcut_smth, model.rcut) / r,
                    torch.zeros_like(r))
    return torch.cat([s[..., None], s[..., None] * d / r[..., None]], -1)


def _net(layers, x):
    """DeePMD-kit's embedding net: tanh layers, x + h where the width
    stays, (x, x) + h where it doubles."""
    for layer in layers:
        h = torch.tanh(x @ layer["w"] + layer["b"])
        if "idt" in layer:
            h = h * layer["idt"]
        n_in, n_out = layer["w"].shape
        if n_out == n_in:
            x = x + h
        elif n_out == 2 * n_in:
            x = torch.cat([x, x], -1) + h
        else:
            x = h
    return x


def _fit(net, D):
    x = D
    for layer in net["hidden"]:
        h = torch.tanh(x @ layer["w"] + layer["b"])
        if "idt" in layer:
            h = h * layer["idt"]
        x = x + h if layer["w"].shape[0] == layer["w"].shape[1] else h
    return (x @ net["final"]["w"] + net["final"]["b"])[..., 0]


def _descriptor(model: Model, embed, tc: int, Rn):
    """D (F, C, dim) of centres of type tc from normalised rows Rn."""
    bounds = [0]
    for s in model.sel:
        bounds.append(bounds[-1] + s)
    if model.kind == "se_e2_a":
        T = 0
        for tn in range(model.ntypes):
            Rs = Rn[..., bounds[tn]:bounds[tn + 1], :]
            G = _net(embed[tc][tn], Rs[..., :1])
            T = T + Rs.transpose(-1, -2) @ G               # (F, C, 4, m1)
        T = T / model.nnei
        D = T.transpose(-1, -2) @ T[..., :model.axis_neuron]
        return D.reshape(*D.shape[:-2], -1)
    D = 0
    for t1 in range(model.ntypes):
        x1 = Rn[..., bounds[t1]:bounds[t1 + 1], 1:]
        for t2 in range(t1, model.ntypes):
            x2 = Rn[..., bounds[t2]:bounds[t2 + 1], 1:]
            th = x1 @ x2.transpose(-1, -2)                 # (F, C, s1, s2)
            G = _net(embed[t1][t2], th[..., None])
            D = D + torch.einsum("fcjk,fcjkm->fcm", th, G) \
                / (model.sel[t1] * model.sel[t2])
    return D


def _blocks(model: Model, F: int, N: int, n_centers: int):
    rows = model.rows_per_center
    fc = max(1, min(F, ROW_BUDGET // rows, PAIR_BUDGET // N))
    cb = max(1, min(n_centers, PAIR_BUDGET // (fc * N),
                    ROW_BUDGET // (fc * rows)))
    for f0 in range(0, F, fc):
        for c0 in range(0, n_centers, cb):
            yield slice(f0, f0 + fc), slice(c0, c0 + cb)


def compute_stats(model: Model, x, L, types):
    """davg, dstd (ntypes, 4) over frames x (F, N, 3), as DeePMD-kit's
    compute_input_stats: per centre type, the mean and spread of the raw
    rows' first column and the spread of the other three over every slot,
    empty ones included; davg's last three are 0, a spread is at least
    0.01."""
    nt = model.ntypes
    sums = torch.zeros(nt, 4, dtype=torch.float64)
    with torch.no_grad():
        for tc in range(nt):
            centers = torch.nonzero(types == tc)[:, 0]
            for fs, cs in _blocks(model, x.shape[0], x.shape[1],
                                  centers.shape[0]):
                c = centers[cs]
                nbr = neighbors(model, x[fs], L[fs], types, c)[0]
                d, valid = _displacements(x[fs], L[fs], c, nbr)
                R = env_rows(model, d, valid).double()
                sums[tc] += torch.stack([
                    R[..., 0].sum(), (R[..., 0] ** 2).sum(),
                    (R[..., 1:] ** 2).sum(),
                    torch.tensor(float(R[..., 0].numel()),
                                 dtype=torch.float64,
                                 device=R.device)]).cpu()
    davg = torch.zeros(nt, 4, dtype=torch.float64)
    dstd = torch.ones(nt, 4, dtype=torch.float64)
    for t in range(nt):
        s, s2, a2, n = sums[t].tolist()
        if n == 0:
            continue
        mean = s / n
        davg[t, 0] = mean
        dstd[t, 0] = max(max(s2 / n - mean * mean, 0.0) ** 0.5, 1e-2)
        dstd[t, 1:] = max(max(a2 / (3 * n), 0.0) ** 0.5, 1e-2)
    return davg, dstd


def energy_force_virial(model: Model, nets, davg, dstd, x, L, types):
    """E (F,), forces (F, N, 3) and virial (F, 3, 3) of frames x (F, N, 3)
    in boxes L (F, 3), atom types (N,), in x's dtype and on its device.
    nets: {"embed": [[layers]], "fit": [net per type]}; davg, dstd:
    (ntypes, 4). Also returns {"most": the most neighbours any atom had
    within rcut, per type; "closest": the closest pair's distance}."""
    F, N, _ = x.shape
    E = torch.zeros(F, dtype=x.dtype, device=x.device)
    force = torch.zeros_like(x)
    W = torch.zeros(F, 3, 3, dtype=x.dtype, device=x.device)
    most, closest = [0] * model.ntypes, float("inf")
    davg = davg.to(x)
    dstd = dstd.to(x)
    for tc in range(model.ntypes):
        centers = torch.nonzero(types == tc)[:, 0]
        for fs, cs in _blocks(model, F, N, centers.shape[0]):
            c = centers[cs]
            xf, Lf = x[fs], L[fs]
            with torch.no_grad():
                nbr, m, near = neighbors(model, xf, Lf, types, c)
            most = [max(a, b) for a, b in zip(most, m)]
            closest = min(closest, near)
            d, valid = _displacements(xf, Lf, c, nbr)
            d = d.detach().requires_grad_(True)
            with torch.enable_grad():
                Rn = (env_rows(model, d, valid) - davg[tc]) / dstd[tc]
                e = _fit(nets["fit"][tc],
                         _descriptor(model, nets["embed"], tc, Rn))
                (g,) = torch.autograd.grad(e.sum(), d)
            g = torch.where(valid[..., None], g, torch.zeros_like(g))
            E[fs] += e.detach().sum(-1)
            fb = force[fs]
            fb[:, c] += g.sum(-2)
            nf = g.shape[0]
            idx = nbr.clamp(min=0).reshape(nf, -1, 1).expand(-1, -1, 3)
            fb.scatter_add_(1, idx, -g.reshape(nf, -1, 3))
            W[fs] -= torch.einsum("fcka,fckb->fab", d.detach(), g)
    return E, force, W, {"most": most, "closest": closest}

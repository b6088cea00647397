"""Electronic density-of-states fitting (counterpart of
g4s_tpu/models/deepmd/fit_dos.py; deepmd/fit/dos.py + deepmd/loss/dos.py).

A per-type MLP maps the invariant se_e2_a descriptor to `numb_dos`
channels per atom (the discretized DOS on a fixed energy grid); the frame
DOS is the atomic sum. The loss combines four lr-scheduled terms
(DOSLoss): global dos MSE, global CDF (cumsum) MSE, atomic dos MSE and
atomic CDF MSE; the CDF terms regularize the low-frequency shape.

Data layout (examples/dos/data/heat-221): set.*/{coord,box}.npy plus
atom_dos.npy (nframes, natoms*numb_dos) and dos.npy (nframes, numb_dos).
Every function takes one frame or a batch of frames sharing one types.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from g4s_tpu_torch.models.deepmd.descriptor import env_mat
from g4s_tpu_torch.models.deepmd.model import (ModelSpec, _select_by_type,
                                               atomic_descriptor)
from g4s_tpu_torch.models.deepmd.network import (fitting_net_outputs,
                                                 init_fitting_net)


def init_wide_fit(gen, spec: ModelSpec, n_out: int, *, bias=None,
                  dtype=torch.float64):
    """Per-type fitting MLPs whose final layer is (last_hidden, n_out),
    drawn from the torch.Generator gen; bias (ntypes, n_out) is each
    type's final bias (zeros when None)."""
    nets = []
    last = spec.fit_neurons[-1]
    for tc in range(spec.descriptor.ntypes):
        net = init_fitting_net(gen, spec.descriptor_dim, spec.fit_neurons,
                               resnet_dt=spec.fit_resnet_dt, dtype=dtype)
        b = torch.zeros((n_out,), dtype=dtype, device=gen.device) \
            if bias is None else torch.as_tensor(
                np.asarray(bias[tc]), dtype=dtype, device=gen.device)
        net["final"] = {
            "w": torch.randn((last, n_out), generator=gen, dtype=dtype,
                             device=gen.device) / np.sqrt(last + n_out),
            "b": b}
        nets.append(net)
    return nets


def init_dos_fit(gen, spec: ModelSpec, numb_dos: int, *, bias_dos=None,
                 dtype=torch.float64):
    """Per-type MLPs with a (last_hidden, numb_dos) final layer; bias_dos:
    (ntypes, numb_dos) output bias from data statistics
    (compute_output_stats role)."""
    return init_wide_fit(gen, spec, numb_dos, bias=bias_dos, dtype=dtype)


def per_type_outputs(nets, D, types):
    """Each atom's own type's net applied to its descriptor rows,
    (..., N, n_out)."""
    return _select_by_type([fitting_net_outputs(net, D) for net in nets],
                           types)


def atomic_dos(params, dos_nets, spec: ModelSpec, coords, box, types):
    """(..., N, numb_dos) per-atom DOS (DOSFitting.build)."""
    R, nlist = env_mat(coords, box, types, spec.descriptor)
    D = atomic_descriptor(params, spec, R, types, nlist)
    return per_type_outputs(dos_nets, D, types)


def total_dos(params, dos_nets, spec, coords, box, types):
    return torch.sum(atomic_dos(params, dos_nets, spec, coords, box, types),
                     dim=-2)


class DOSLossConfig(NamedTuple):
    """DOSLoss prefactors: each term's pref follows the lr schedule
    pref(t) = limit + (start - limit) * lr(t)/start_lr."""

    start_pref_dos: float = 1.0
    limit_pref_dos: float = 1.0
    start_pref_cdf: float = 0.0
    limit_pref_cdf: float = 0.0
    start_pref_ados: float = 0.0
    limit_pref_ados: float = 0.0
    start_pref_acdf: float = 0.0
    limit_pref_acdf: float = 0.0


def frozen_stats(params):
    """params with its normalisation stats cut from the graph (the
    reference's stop_gradient: they get zero gradient, so Adam leaves
    them where they are)."""
    return dict(params, stats={k: v.detach()
                               for k, v in params["stats"].items()})


def make_dos_loss_fn(spec: ModelSpec, loss_cfg: DOSLossConfig, lr_cfg):
    from g4s_tpu_torch.models.deepmd.train import pref

    def loss_fn(tparams, batch, types, step):
        params, nets = tparams
        ados = atomic_dos(frozen_stats(params), nets, spec, batch["coord"],
                          batch["box"], types)       # (F, N, numb_dos)
        natoms = ados.shape[1]
        lr = lr_cfg.lr_at(step)
        frac = lr / lr_cfg.start_lr
        c = loss_cfg
        loss = torch.zeros((), dtype=ados.dtype, device=ados.device)
        aux = {"lr": lr}
        if "dos" in batch:
            g = torch.sum(ados, dim=1)               # (F, numb_dos)
            d2 = torch.mean((g - batch["dos"]) ** 2)
            loss = loss + pref(c.start_pref_dos, c.limit_pref_dos, frac) \
                * d2 / natoms ** 2
            aux["rmse_dos"] = torch.sqrt(d2) / natoms
            if c.start_pref_cdf or c.limit_pref_cdf:
                c2 = torch.mean((torch.cumsum(g, dim=1)
                                 - torch.cumsum(batch["dos"], dim=1)) ** 2)
                loss = loss + pref(c.start_pref_cdf, c.limit_pref_cdf,
                                   frac) * c2 / natoms ** 2
        if "atom_dos" in batch:
            a2 = torch.mean((ados - batch["atom_dos"]) ** 2)
            loss = loss + pref(c.start_pref_ados, c.limit_pref_ados,
                               frac) * a2
            aux["rmse_ados"] = torch.sqrt(a2)
            if c.start_pref_acdf or c.limit_pref_acdf:
                ac2 = torch.mean((torch.cumsum(ados, dim=2)
                                  - torch.cumsum(batch["atom_dos"],
                                                 dim=2)) ** 2)
                loss = loss + pref(c.start_pref_acdf, c.limit_pref_acdf,
                                   frac) * ac2
        return loss, aux
    return loss_fn


def load_dos_system(path: str) -> dict:
    """Read a heat-221-style DOS system."""
    import glob
    import os
    types = np.atleast_1d(np.loadtxt(os.path.join(path, "type.raw"),
                                     dtype=np.int64))
    n = types.size
    coords, boxes, adoss, doss = [], [], [], []
    for sp in sorted(glob.glob(os.path.join(path, "set.*"))):
        c = np.load(os.path.join(sp, "coord.npy"))
        coords.append(c.reshape(c.shape[0], n, 3))
        b = np.load(os.path.join(sp, "box.npy"))
        boxes.append(b.reshape(b.shape[0], 3, 3))
        ap = os.path.join(sp, "atom_dos.npy")
        if os.path.exists(ap):
            a = np.load(ap)
            adoss.append(a.reshape(a.shape[0], n, -1))
        gp = os.path.join(sp, "dos.npy")
        if os.path.exists(gp):
            doss.append(np.load(gp))
    frames = {"coord": np.concatenate(coords),
              "box": np.concatenate(boxes)}
    if adoss:
        frames["atom_dos"] = np.concatenate(adoss)
    if doss:
        frames["dos"] = np.concatenate(doss)
    return {"frames": frames, "types": types}


def train_dos(params, dos_nets, spec: ModelSpec, frames: dict, types, *,
              numb_steps: int, loss_cfg: DOSLossConfig, lr_cfg=None,
              batch_size: int = 4, seed: int = 0, callback=None):
    """Adam training over DOS labels; returns ((params, nets), aux)."""
    from g4s_tpu_torch.models.deepmd.train import (Adam, LRConfig, batch_to,
                                                   value_and_grad)
    lr_cfg = lr_cfg or LRConfig(1e-2, 1e-4, max(numb_steps // 10, 1),
                                numb_steps)
    opt = Adam(lr_cfg.lr_at_count)
    loss_fn = make_dos_loss_fn(spec, loss_cfg, lr_cfg)
    tparams = (params, dos_nets)
    opt_state = opt.init(tparams)
    like = params["stats"]["davg"]
    types = torch.as_tensor(np.asarray(types), device=like.device)
    rng = np.random.default_rng(seed)
    nf = frames["coord"].shape[0]
    aux = {}
    for step in range(numb_steps):
        idx = rng.integers(0, nf, min(batch_size, nf))
        batch = batch_to({k: v[idx] for k, v in frames.items()}, like)
        loss, aux, grads = value_and_grad(loss_fn, tparams, batch, types,
                                          step)
        tparams, opt_state = opt.update(grads, opt_state, tparams)
        if callback and (step % 20 == 0 or step == numb_steps - 1):
            callback(step, float(loss), {k: float(v) for k, v in aux.items()})
    return tparams, {k: float(v) for k, v in aux.items()}

"""se_e2_a energy model: descriptor -> embeddings -> fitting -> E, F, virial
(counterpart of g4s_tpu/models/deepmd/model.py).

The forward graph the reference builds in TF (deepmd/deepmd/model/ener.py
+ descriptor/se_a.py DescrptSeA.build):

  R (N, nnei, 4)  normalized per center type
  per (center type tc, neighbor type tn): G = embed_{tc,tn}(s(r))
  T  = sum_sections R̃_sec^T G_sec / nnei          (se_a.py:1056-1095)
  D  = T^T T[:, :axis_neuron]  flattened           (se_a.py:1099-1105)
  E_i = fit_{tc}(D_i) + bias_{tc}
  E  = sum_i E_i;  F = -dE/dx and the virial -dE/d(strain) by
  torch.autograd, in place of the hand-written prod_force_se_a and
  prod_virial adjoints.

As in the reference, both center types' embeddings and fitting nets run
for every atom and each atom then takes its own type's result. Every
function takes one frame (coords (N, 3), box (3, 3)) or a batch of frames
(coords (B, N, 3), box (B, 3, 3)) sharing one types (N,).

Of the reference's descriptor types, se_e2_a and se_e2_r are ported; the
others (se_atten, se_t, hybrid, loc_frame, se_a_ebd, se_a_mask) raise
NotImplementedError (ROADMAP.md queue 1, item 6, "The rest of DeePMD").
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from g4s_tpu_torch.ckpt import rebuild
from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec, env_mat,
                                                    normalize_env_mat)
from g4s_tpu_torch.models.deepmd.network import (embedding_net_apply,
                                                 fitting_net_apply,
                                                 init_embedding_net,
                                                 init_fitting_net)

PORTED_DESCRIPTORS = ("se_e2_a", "se_e2_r")


class ModelSpec(NamedTuple):
    descriptor: DescriptorSpec
    embed_neurons: Tuple[int, ...]      # e.g. (25, 50, 100)
    axis_neuron: int                    # M2, e.g. 16
    fit_neurons: Tuple[int, ...]        # e.g. (240, 240, 240)
    embed_resnet_dt: bool = False
    fit_resnet_dt: bool = True
    descriptor_type: str = "se_e2_a"    # se_e2_r|se_atten|se_t|hybrid|
                                        # loc_frame|se_a_ebd|se_a_mask
    attn_layers: int = 2                # se_atten: attention layers
    attn_dim: int = 0                   # se_atten: Q/K/V width (0 -> m1)
    tebd_dim: int = 8                   # se_atten: type-embedding width
    hybrid_types: Tuple[str, ...] = ("se_e2_a", "se_e2_r")  # hybrid parts
    numb_fparam: int = 0                # frame parameters appended to the
    numb_aparam: int = 0                # fitting input (ener.py:127-158)

    @property
    def m1(self) -> int:
        return self.embed_neurons[-1]

    @property
    def descriptor_dim(self) -> int:
        if self.descriptor_type == "hybrid":
            return sum(self._replace(descriptor_type=t).descriptor_dim
                       for t in self.hybrid_types)
        if self.descriptor_type == "loc_frame":
            return 4 * self.descriptor.nnei
        if self.descriptor_type in ("se_e2_r", "se_t"):
            return self.m1
        # se_e2_a / se_atten / se_a_ebd / se_a_mask all contract to M1*M2
        return self.m1 * self.axis_neuron


def check_ported(spec: ModelSpec) -> None:
    if spec.descriptor_type not in PORTED_DESCRIPTORS:
        raise NotImplementedError(
            f"descriptor_type {spec.descriptor_type!r} is not ported to "
            f"g4s_tpu_torch yet (ROADMAP.md queue 1, item 6, 'The rest of "
            f"DeePMD'); ported: "
            f"{', '.join(PORTED_DESCRIPTORS)}")


def map_tree(fn, tree):
    """fn applied to every leaf of a tree of dicts, lists, tuples and
    NamedTuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [map_tree(fn, v) for v in tree])
    return fn(tree)


def params_to(params, *, device=None, dtype=None):
    """The parameter tree with every tensor on `device` and every floating
    tensor in `dtype` (None keeps each as it is)."""
    def move(x):
        return x.to(device=device,
                    dtype=dtype if x.is_floating_point() else None)
    return map_tree(move, params)


def init_params(gen, spec: ModelSpec, *, bias_atom_e=None,
                dtype=torch.float64):
    """Parameter tree: embed[tc][tn] nets + fit[tc] nets + stats, drawn
    from the torch.Generator `gen` on its device."""
    check_ported(spec)
    nt = spec.descriptor.ntypes
    dev = gen.device
    if bias_atom_e is None:
        bias_atom_e = np.zeros(nt)
    # nets indexed [center_type][neighbor_type]
    embed = [[init_embedding_net(gen, spec.embed_neurons,
                                 resnet_dt=spec.embed_resnet_dt, dtype=dtype)
              for _ in range(nt)] for _ in range(nt)]
    fit_in = spec.descriptor_dim + spec.numb_fparam + spec.numb_aparam
    fit = [init_fitting_net(gen, fit_in, spec.fit_neurons,
                            resnet_dt=spec.fit_resnet_dt,
                            bias_out=float(bias_atom_e[tc]), dtype=dtype)
           for tc in range(nt)]
    nnei = spec.descriptor.nnei
    stats = {"davg": torch.zeros((nt, nnei, 4), dtype=dtype, device=dev),
             "dstd": torch.ones((nt, nnei, 4), dtype=dtype, device=dev)}
    for name, n in (("fparam", spec.numb_fparam),
                    ("aparam", spec.numb_aparam)):
        if n:
            stats[f"{name}_avg"] = torch.zeros((n,), dtype=dtype, device=dev)
            stats[f"{name}_std"] = torch.ones((n,), dtype=dtype, device=dev)
    return {"embed": embed, "fit": fit, "stats": stats}


def _select_by_type(per_type, types):
    """per_type[t]: (..., N, F) for each center type t -> each atom's own
    type's row, as the reference's take_along_axis over the stacked
    results."""
    types = torch.as_tensor(types, device=per_type[0].device)
    out = per_type[0]
    for t in range(1, len(per_type)):
        out = torch.where((types == t)[:, None], per_type[t], out)
    return out


def atomic_descriptor(params, spec: ModelSpec, R, types):
    """R: (..., N, nnei, 4) raw env mat -> D: (..., N, descriptor_dim)."""
    check_ported(spec)
    Rn = normalize_env_mat(R, types, params["stats"]["davg"],
                           params["stats"]["dstd"])
    return _descriptor_plain(params["embed"], spec, Rn, types)


def _descriptor_plain(embed, spec: ModelSpec, Rn, types):
    nt = spec.descriptor.ntypes
    nnei = spec.descriptor.nnei
    sec = np.concatenate([[0], np.cumsum(spec.descriptor.sel)])
    lead = Rn.shape[:-2]                                   # (..., N)

    # per center type, accumulate T = sum over neighbor sections R̃^T G
    D_by_tc = []
    for tc in range(nt):
        if spec.descriptor_type == "se_e2_r":
            # radial-only descriptor (DescrptSeR, deepmd/descriptor/se_r.py):
            # D = mean over neighbors of the embedded s(r)
            acc = torch.zeros(lead + (spec.m1,), dtype=Rn.dtype,
                              device=Rn.device)
            for tn in range(nt):
                sec_R = Rn[..., sec[tn]: sec[tn + 1], :]
                G = embedding_net_apply(embed[tc][tn], sec_R[..., 0:1])
                acc = acc + torch.sum(G, dim=-2)
            D_by_tc.append(acc / nnei)
            continue
        T = env_embedding(embed[tc], spec, Rn)
        T2 = T[..., : spec.axis_neuron]
        D = torch.einsum("...cm,...ck->...mk", T, T2)
        D_by_tc.append(D.reshape(lead + (-1,)))
    return _select_by_type(D_by_tc, types)


def env_embedding(embed_tc, spec: ModelSpec, Rn):
    """T = sum over neighbor-type sections of R̃_sec^T G_sec / nnei,
    (..., N, 4, m1), for one center type's embedding nets embed_tc[tn]
    (se_a.py:1056-1095); its rows 1:4 are the covariant qmat of the
    tensor fits."""
    sec = np.concatenate([[0], np.cumsum(spec.descriptor.sel)])
    T = torch.zeros(Rn.shape[:-2] + (4, spec.m1), dtype=Rn.dtype,
                    device=Rn.device)
    for tn in range(spec.descriptor.ntypes):
        sec_R = Rn[..., sec[tn]: sec[tn + 1], :]           # (..., N, sel, 4)
        G = embedding_net_apply(embed_tc[tn], sec_R[..., 0:1])
        T = T + torch.einsum("...sc,...sm->...cm", sec_R, G)
    return T / spec.descriptor.nnei


def _fit_input(params, spec: ModelSpec, D, fparam, aparam):
    """Append normalized frame/atom parameters to the fitting input
    (ener.py:191-260: (p - avg)/std, fparam tiled over atoms). fparam is
    (numb_fparam,) per frame, aparam (N, numb_aparam) per frame."""
    st = params["stats"]
    if spec.numb_fparam:
        if fparam is None:
            raise ValueError("model has numb_fparam > 0: pass fparam")
        fp = torch.as_tensor(fparam, dtype=D.dtype, device=D.device)
        fp = (fp.reshape(D.shape[:-2] + (-1,)) - st["fparam_avg"]) \
            / st["fparam_std"]
        D = torch.cat([D, fp[..., None, :].expand(D.shape[:-1]
                                                  + fp.shape[-1:])], dim=-1)
    if spec.numb_aparam:
        if aparam is None:
            raise ValueError("model has numb_aparam > 0: pass aparam")
        ap = torch.as_tensor(aparam, dtype=D.dtype, device=D.device)
        ap = (ap.reshape(D.shape[:-1] + (-1,)) - st["aparam_avg"]) \
            / st["aparam_std"]
        D = torch.cat([D, ap], dim=-1)
    return D


def atomic_energy(params, spec: ModelSpec, D, types, fparam=None,
                  aparam=None):
    D = _fit_input(params, spec, D, fparam, aparam)
    e_by_tc = [fitting_net_apply(params["fit"][tc], D)[..., None]
               for tc in range(spec.descriptor.ntypes)]
    return _select_by_type(e_by_tc, types)[..., 0]


def total_energy(params, spec: ModelSpec, coords, box, types,
                 fparam=None, aparam=None):
    """E per frame: a scalar for one frame, (B,) for a batch."""
    check_ported(spec)
    R, _ = env_mat(coords, box, types, spec.descriptor)
    D = atomic_descriptor(params, spec, R, types)
    return torch.sum(atomic_energy(params, spec, D, types, fparam, aparam),
                     dim=-1)


def energy_force_virial(params, spec: ModelSpec, coords, box, types,
                        fparam=None, aparam=None, *, create_graph=False):
    """E, F = -dE/dx, virial W = -dE/de (strain derivative) of one frame,
    or of each frame of a batch (frames are independent, so one backward
    pass of the summed energy gives every frame's derivatives).

    create_graph=True is the training form (train.batched_efv): E, F and W
    keep their graph, so a loss on the forces differentiates through the
    first backward pass to the parameters. Otherwise E is detached and F
    and W carry no graph."""
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        strain = torch.zeros(coords.shape[:-2] + (3, 3), dtype=coords.dtype,
                             device=coords.device, requires_grad=True)
        eye = torch.eye(3, dtype=coords.dtype, device=coords.device)
        xs = x @ (eye + strain)
        bs = box @ (eye + strain)
        e = total_energy(params, spec, xs, bs, types, fparam=fparam,
                         aparam=aparam)
        g_x, g_s = torch.autograd.grad(e.sum(), (x, strain),
                                       create_graph=create_graph)
    return (e if create_graph else e.detach()), -g_x, -g_s

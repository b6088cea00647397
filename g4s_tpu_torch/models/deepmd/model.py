"""DeePMD energy model: descriptor -> embeddings -> fitting -> E, F,
virial (counterpart of g4s_tpu/models/deepmd/model.py).

The forward graph the reference builds in TF (deepmd/deepmd/model/ener.py
+ descriptor/se_a.py DescrptSeA.build), for se_e2_a:

  R (N, nnei, 4)  normalized per center type
  per (center type tc, neighbor type tn): G = embed_{tc,tn}(s(r))
  T  = sum_sections R̃_sec^T G_sec / nnei          (se_a.py:1056-1095)
  D  = T^T T[:, :axis_neuron]  flattened           (se_a.py:1099-1105)
  E_i = fit_{tc}(D_i) + bias_{tc}
  E  = sum_i E_i;  F = -dE/dx and the virial -dE/d(strain) by
  torch.autograd, in place of the hand-written prod_force_se_a and
  prod_virial adjoints.

The other descriptor types change D: se_e2_r (radial only), se_atten and
se_a_ebd (a type-embedded neighbor net, se_atten with attention over the
neighbors), se_t (three-body angles), hybrid (parts concatenated),
loc_frame (raw rows in a per-atom frame, no nets) and se_a_mask (se_e2_a
on a finite system with virtual atoms masked out).

As in the reference, both center types' embeddings and fitting nets run
for every atom and each atom then takes its own type's result. Every
function takes one frame (coords (N, 3), box (3, 3)) or a batch of frames
(coords (B, N, 3), box (B, 3, 3)) sharing one types (N,), and keeps
finite second derivatives (training differentiates the forces).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from g4s_tpu_torch.ckpt import rebuild
from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec, env_mat,
                                                    env_mat_nopbc,
                                                    normalize_env_mat)
from g4s_tpu_torch.models.deepmd.network import (embedding_net_apply,
                                                 fitting_net_apply,
                                                 init_embedding_net,
                                                 init_fitting_net)

PORTED_DESCRIPTORS = ("se_e2_a", "se_e2_r", "se_atten", "se_a_ebd", "se_t",
                      "hybrid", "loc_frame", "se_a_mask")


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
    """Refuse a descriptor_type that is none of the reference's (whose
    code falls through to the se_e2_a contraction for any other name), and
    a hybrid part that is itself a hybrid or a loc_frame (which works on
    the raw env mat; the reference fails on an index there)."""
    parts = tuple(spec.hybrid_types) \
        if spec.descriptor_type == "hybrid" else ()
    for t in (spec.descriptor_type,) + parts:
        if t not in PORTED_DESCRIPTORS:
            raise ValueError(f"unknown descriptor_type {t!r}; known: "
                             f"{', '.join(PORTED_DESCRIPTORS)}")
    if {"hybrid", "loc_frame"} & set(parts):
        raise ValueError(f"hybrid_types {parts}: a hybrid part cannot be a "
                         f"hybrid or a loc_frame")


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


def _init_embed(gen, spec: ModelSpec, dtype):
    """Embedding-side parameters of one descriptor type (the reference's
    _init_embed): embed[tc][tn] nets for se_e2_a, se_e2_r and se_a_mask,
    the [t1][t2] grid for se_t, {"net", "attn", "tebd"} for se_atten and
    se_a_ebd (whose attn is empty), [] for loc_frame, {"parts": [...]}
    for hybrid."""
    nt = spec.descriptor.ntypes
    dev = gen.device
    if spec.descriptor_type == "loc_frame":
        return []            # no embedding nets: raw local coordinates
    if spec.descriptor_type == "hybrid":
        return {"parts": [_init_embed(gen, spec._replace(descriptor_type=t),
                                      dtype)
                          for t in spec.hybrid_types]}
    if spec.descriptor_type in ("se_atten", "se_a_ebd"):
        # one type-mixed embedding net over [s(r), tebd_j, tebd_i]
        net = init_embedding_net(gen, spec.embed_neurons,
                                 in_dim=1 + 2 * spec.tebd_dim,
                                 resnet_dt=spec.embed_resnet_dt, dtype=dtype)
        d = spec.attn_dim or spec.m1
        n_attn = spec.attn_layers if spec.descriptor_type == "se_atten" else 0
        sc = 1.0 / np.sqrt(spec.m1)
        attn = [{k: sc * torch.randn(shape, generator=gen, dtype=dtype,
                                     device=dev)
                 for k, shape in (("wq", (spec.m1, d)), ("wk", (spec.m1, d)),
                                  ("wv", (spec.m1, d)), ("wo", (d, spec.m1)))}
                for _ in range(n_attn)]
        tebd = 0.1 * torch.randn((nt, spec.tebd_dim), generator=gen,
                                 dtype=dtype, device=dev)
        return {"net": net, "attn": attn, "tebd": tebd}
    # se_e2_a / se_e2_r / se_a_mask: nets indexed [center_type][neighbor_
    # type]; se_t: the same grid indexed [type1][type2], upper triangle used
    return [[init_embedding_net(gen, spec.embed_neurons,
                                resnet_dt=spec.embed_resnet_dt, dtype=dtype)
             for _ in range(nt)] for _ in range(nt)]


def init_params(gen, spec: ModelSpec, *, bias_atom_e=None,
                dtype=torch.float64):
    """Parameter tree: the descriptor's embedding parameters (_init_embed)
    + fit[tc] nets + stats, drawn from the torch.Generator `gen` on its
    device."""
    check_ported(spec)
    nt = spec.descriptor.ntypes
    dev = gen.device
    if bias_atom_e is None:
        bias_atom_e = np.zeros(nt)
    embed = _init_embed(gen, spec, dtype)
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


def atomic_descriptor(params, spec: ModelSpec, R, types, nlist=None):
    """R: (..., N, nnei, 4) raw env mat -> D: (..., N, descriptor_dim);
    se_atten and se_a_ebd (alone or in a hybrid) take the neighbor types
    from nlist, (..., N, nnei)."""
    check_ported(spec)
    if spec.descriptor_type == "loc_frame":
        return _descriptor_loc_frame(spec, R)
    Rn = normalize_env_mat(R, types, params["stats"]["davg"],
                           params["stats"]["dstd"])
    return _descr_dispatch(params["embed"], spec, Rn, types, nlist)


def _descr_dispatch(embed, spec: ModelSpec, Rn, types, nlist):
    if spec.descriptor_type == "hybrid":
        # DescrptHybrid (deepmd/descriptor/hybrid.py): the sub-descriptors
        # over the same neighbor environment, concatenated
        return torch.cat([
            _descr_dispatch(embed["parts"][i],
                            spec._replace(descriptor_type=t), Rn, types,
                            nlist)
            for i, t in enumerate(spec.hybrid_types)], dim=-1)
    if spec.descriptor_type in ("se_atten", "se_a_ebd"):
        return _descriptor_atten(embed, spec, Rn, types, nlist)
    if spec.descriptor_type == "se_t":
        return _descriptor_se_t(embed, spec, Rn)
    return _descriptor_plain(embed, spec, Rn, types)


def _safe_norm(x):
    """|x| over the last axis, keepdim, with finite first and second
    derivatives at x = 0 (a missing axis neighbor)."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    nz = n2 > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, n2, 1.0)), 0.0)


def _descriptor_loc_frame(spec: ModelSpec, R):
    """Local-frame descriptor (DescrptLocFrame, deepmd/descriptor/
    loc_frame.py): an orthonormal frame per atom from two axis neighbors
    (the first slot of the type-0 and type-1 sections, the axis_rule
    "closest of type" convention), every neighbor's raw (s, x, y, z)
    env-mat row expressed in that frame."""
    sec = np.concatenate([[0], np.cumsum(spec.descriptor.sel)])
    nt = spec.descriptor.ntypes
    t1, t2 = 0, min(1, nt - 1)
    a1 = R[..., sec[t1], 1:4]                      # closest of type t1
    idx2 = sec[t2] if t2 != t1 else sec[t1] + 1    # a distinct axis atom
    a2 = R[..., idx2, 1:4]
    eps = 1e-12
    e1 = a1 / (_safe_norm(a1) + eps)
    a2p = a2 - torch.sum(a2 * e1, dim=-1, keepdim=True) * e1
    e2 = a2p / (_safe_norm(a2p) + eps)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    frame = torch.stack([e1, e2, e3], dim=-2)      # (..., N, 3frame, 3glob)
    xyz_loc = torch.einsum("...fg,...kg->...kf", frame, R[..., 1:4])
    D = torch.cat([R[..., 0:1], xyz_loc], dim=-1)
    return D.reshape(R.shape[:-2] + (-1,))


def _descriptor_se_t(embed, spec: ModelSpec, Rn):
    """Three-body descriptor (DescrptSeT, deepmd/descriptor/se_t.py
    _filter): for each neighbor-type pair t1 <= t2 the angular matrix
    theta_jk = x̃_j . x̃_k is embedded by the pair's net and contracted,
    sum_jk theta_jk G_jk / (sel1 sel2)."""
    sel = spec.descriptor.sel
    sec = np.concatenate([[0], np.cumsum(sel)])
    nt = spec.descriptor.ntypes
    D = torch.zeros(Rn.shape[:-2] + (spec.m1,), dtype=Rn.dtype,
                    device=Rn.device)
    for t1 in range(nt):
        x1 = Rn[..., sec[t1]: sec[t1 + 1], 1:4]
        for t2 in range(t1, nt):
            x2 = Rn[..., sec[t2]: sec[t2 + 1], 1:4]
            theta = torch.einsum("...jm,...km->...jk", x1, x2)
            G = embedding_net_apply(embed[t1][t2], theta[..., None])
            D = D + (torch.einsum("...jk,...jkm->...m", theta, G)
                     / (sel[t1] * sel[t2]))
    return D


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


def _descriptor_atten(emb, spec: ModelSpec, Rn, types, nlist):
    """DPA-style attention descriptor (DescrptSeAtten, se_atten.py): a
    type-mixed neighbor embedding of [s(r), tebd_neighbor, tebd_center],
    refined by dot-product attention over the neighbors (logits of
    invalid keys set to -1e9, rows of invalid queries zeroed), then the
    R^T G contraction of se_e2_a. se_a_ebd has no attention layers."""
    if nlist is None:
        raise ValueError(f"{spec.descriptor_type} needs the neighbor list "
                         f"(the types of the neighbors); call it through "
                         f"total_energy")
    tebd = emb["tebd"]
    types = torch.as_tensor(types, device=Rn.device).long()
    valid = nlist >= 0
    nb_type = torch.where(valid, types[nlist.clamp(min=0)], 0)
    t_j = tebd[nb_type]                                # (..., N, nnei, d_t)
    t_i = tebd[types][:, None, :].expand(t_j.shape)
    x = torch.cat([Rn[..., 0:1], t_j, t_i], dim=-1)
    G = embedding_net_apply(emb["net"], x)             # (..., N, nnei, m1)
    d = spec.attn_dim or spec.m1
    np_dtype = np.float32 if G.dtype == torch.float32 else np.float64
    # 1/sqrt(d) rounded as the reference computes it, in G's precision
    scale = float(np_dtype(1.0) / np.sqrt(np_dtype(d)))
    for layer in emb["attn"]:
        q = G @ layer["wq"]
        k = G @ layer["wk"]
        v = G @ layer["wv"]
        logits = torch.einsum("...id,...jd->...ij", q, k) * scale
        logits = torch.where(valid[..., None, :], logits, -1e9)
        attn = torch.softmax(logits, dim=-1)
        attn = torch.where(valid[..., :, None], attn, 0.0)
        G = G + (attn @ v) @ layer["wo"]
    G = torch.where(valid[..., None], G, 0.0)
    T = torch.einsum("...sc,...sm->...cm", Rn, G) / spec.descriptor.nnei
    D = torch.einsum("...cm,...ck->...mk", T, T[..., : spec.axis_neuron])
    return D.reshape(Rn.shape[:-2] + (-1,))


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
                 fparam=None, aparam=None, *, atom_mask=None):
    """E per frame: a scalar for one frame, (B,) for a batch. se_a_mask
    treats the frame as a finite system (box unused) and drops the
    energies of atoms where atom_mask (N,) is False."""
    check_ported(spec)
    if spec.descriptor_type == "se_a_mask":
        R, nlist = env_mat_nopbc(coords, types, spec.descriptor,
                                 atom_mask=atom_mask)
    else:
        R, nlist = env_mat(coords, box, types, spec.descriptor)
    D = atomic_descriptor(params, spec, R, types, nlist)
    ae = atomic_energy(params, spec, D, types, fparam, aparam)
    if spec.descriptor_type == "se_a_mask" and atom_mask is not None:
        am = torch.as_tensor(atom_mask, device=ae.device).bool()
        ae = torch.where(am, ae, 0.0)            # virtual atoms drop out
    return torch.sum(ae, dim=-1)


def energy_force_virial(params, spec: ModelSpec, coords, box, types,
                        fparam=None, aparam=None, *, create_graph=False):
    """E, F = -dE/dx, virial W = -dE/de (strain derivative) of one frame,
    or of each frame of a batch (frames are independent, so one backward
    pass of the summed energy gives every frame's derivatives).

    create_graph=True is the training form (train.batched_efv): E, F and W
    keep their graph, so a loss on the forces differentiates through the
    first backward pass to the parameters. Otherwise E is detached and F
    and W carry no graph. It passes no atom_mask, as the reference's does:
    se_a_mask's virtual atoms are masked in total_energy only."""
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

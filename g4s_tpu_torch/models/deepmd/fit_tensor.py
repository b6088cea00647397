"""Tensor fitting: dipole and polarizability models (counterpart of
g4s_tpu/models/deepmd/fit_tensor.py).

Reference capability: deepmd/fit/dipole.py (DipoleFittingSeA) and
deepmd/fit/polar.py (PolarFittingSeA), served by DeepTensor
(source/api_cc/DeepTensor.cc). Both reuse the se_e2_a rotation matrix
qmat, the xyz rows of T = R̃^T G, so the outputs are exactly rotationally
covariant by construction:

  dipole_i = qmat_i^T o_i                (o_i: per-atom m1-vector, an MLP)
  polar_i  = qmat_i^T diag(o_i) qmat_i   (symmetric, PSD for o >= 0)

Every function takes one frame or a batch of frames sharing one types.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from g4s_tpu_torch.models.deepmd.descriptor import (env_mat, env_mat_nopbc,
                                                    normalize_env_mat)
from g4s_tpu_torch.models.deepmd.fit_dos import (frozen_stats,
                                                 init_wide_fit,
                                                 per_type_outputs)
from g4s_tpu_torch.models.deepmd.model import (ModelSpec, _select_by_type,
                                               env_embedding)


def init_tensor_fit(gen, spec: ModelSpec, *, dtype=torch.float64):
    """Per-type MLPs whose FINAL layer is (last_hidden, m1): the m1
    channel weights applied to qmat."""
    return init_wide_fit(gen, spec, spec.m1, dtype=dtype)


def _descriptor_and_qmat(params, spec: ModelSpec, coords, box, types,
                         nopbc: bool = False):
    """(D, qmat): the invariant descriptor (..., N, m1*axis) and the
    covariant xyz rows of T, (..., N, 3, m1) (se_a.py _pass_filter returns
    the same qmat)."""
    if nopbc:
        R, _ = env_mat_nopbc(coords, types, spec.descriptor)
    else:
        R, _ = env_mat(coords, box, types, spec.descriptor)
    Rn = normalize_env_mat(R, types, params["stats"]["davg"],
                           params["stats"]["dstd"])
    lead = Rn.shape[:-2]
    D_tc, Q_tc = [], []
    for tc in range(spec.descriptor.ntypes):
        T = env_embedding(params["embed"][tc], spec, Rn)
        D = torch.einsum("...cm,...ck->...mk", T, T[..., : spec.axis_neuron])
        D_tc.append(D.reshape(lead + (-1,)))
        Q_tc.append(T[..., 1:4, :].reshape(lead + (-1,)))
    Q = _select_by_type(Q_tc, types).reshape(lead + (3, spec.m1))
    return _select_by_type(D_tc, types), Q


def atomic_dipole(params, tensor_nets, spec: ModelSpec, coords, box, types,
                  nopbc: bool = False):
    """(..., N, 3) per-atom dipoles (DipoleFittingSeA.build)."""
    D, Q = _descriptor_and_qmat(params, spec, coords, box, types, nopbc)
    o = per_type_outputs(tensor_nets, D, types)           # (..., N, m1)
    return torch.einsum("...cm,...m->...c", Q, o)


def atomic_polar(params, tensor_nets, spec: ModelSpec, coords, box, types,
                 nopbc: bool = False):
    """(..., N, 3, 3) symmetric per-atom polarizability (PolarFittingSeA)."""
    D, Q = _descriptor_and_qmat(params, spec, coords, box, types, nopbc)
    o = per_type_outputs(tensor_nets, D, types)
    return torch.einsum("...cm,...m,...dm->...cd", Q, o, Q)


def total_dipole(params, tensor_nets, spec, coords, box, types):
    return torch.sum(atomic_dipole(params, tensor_nets, spec, coords, box,
                                   types), dim=-2)


def total_polar(params, tensor_nets, spec, coords, box, types):
    return torch.sum(atomic_polar(params, tensor_nets, spec, coords, box,
                                  types), dim=-3)


# ---------------------------------------------------------------------------
# Tensor-supervised training (the DPLR dipole-model training path)
# ---------------------------------------------------------------------------


class TensorLossConfig(NamedTuple):
    """deepmd/loss/tensor.py (TensorLoss) semantics: a weighted sum of an
    atomic-label term and a global-label term,

      loss = pref_atomic * mean((scale*(pred_i - label_i))^2)
           + pref * mean((scale*(sum_i pred_i - label))^2) / n_sel

    with the sums/means restricted to `sel_type` atoms (the types that
    carry the tensor, DipoleFittingSeA sel_type)."""

    pref: float = 0.0
    pref_atomic: float = 1.0
    scale: float = 1.0
    sel_type: Optional[Tuple[int, ...]] = None


def _sel_mask(types, ntypes, sel_type):
    if sel_type is None:
        return torch.ones(types.shape, dtype=torch.bool, device=types.device)
    oh = torch.zeros((ntypes,), dtype=torch.bool, device=types.device)
    oh[list(sel_type)] = True
    return oh[types.long()]


def make_tensor_loss_fn(spec: ModelSpec, loss_cfg: TensorLossConfig,
                        tensor_fn=atomic_dipole, nopbc: bool = False):
    """Loss over a batch {coord (F,N,3), box (F,...), and labels
    'atomic_label' (F,N,k) and/or 'label' (F,k)}; `tensor_fn` is
    atomic_dipole or atomic_polar (per-atom tensors, trailing dims
    flattened to k). Normalization statistics stay frozen, as the
    reference's non-trainable t_avg/t_std constants do."""

    def loss_fn(tparams, batch, types):
        params, nets = tparams
        pred = tensor_fn(frozen_stats(params), nets, spec, batch["coord"],
                         batch["box"], types, nopbc=nopbc)   # (F, N, ...)
        F, N = pred.shape[0], pred.shape[1]
        pred = pred.reshape(F, N, -1)
        mask = _sel_mask(types, spec.descriptor.ntypes, loss_cfg.sel_type)
        n_sel = max(int(mask.sum()), 1)
        loss = torch.zeros((), dtype=pred.dtype, device=pred.device)
        aux = {}
        if loss_cfg.pref_atomic > 0.0 and "atomic_label" in batch:
            lab = batch["atomic_label"].reshape(F, N, -1)
            d2 = torch.square(loss_cfg.scale * (pred - lab))
            local = torch.sum(torch.where(mask[None, :, None], d2, 0.0)) \
                / (F * n_sel * pred.shape[-1])
            loss = loss + loss_cfg.pref_atomic * local
            aux["rmse_local"] = torch.sqrt(local) / loss_cfg.scale
        if loss_cfg.pref > 0.0 and "label" in batch:
            g = torch.sum(torch.where(mask[None, :, None], pred, 0.0), dim=1)
            lab = batch["label"].reshape(F, -1)
            glob = torch.mean(torch.square(loss_cfg.scale * (g - lab)))
            loss = loss + loss_cfg.pref * glob / n_sel
            aux["rmse_global"] = torch.sqrt(glob) / loss_cfg.scale
        return loss, aux

    return loss_fn


def load_tensor_system(path: str, label: str = "dipole",
                       sel_type=None) -> dict:
    """Read a water_tensor-style npy system (examples/water_tensor/
    dipole/training_data): set.*/{coord,box}.npy plus atomic_<label>.npy
    (labels for the sel_type atoms only, in atom order) and/or
    <label>.npy (per-frame global labels); a `nopbc` marker file switches
    the descriptor to the finite-system path.

    Returns {"frames": {coord (F,N,3), box (F,3,3), atomic_label (F,N,k)
    zero-padded on non-selected atoms, label (F,k)}, "types": (N,),
    "nopbc": bool}.
    """
    import glob
    import os
    types = np.loadtxt(os.path.join(path, "type.raw"), dtype=np.int64)
    types = np.atleast_1d(types)
    n = types.size
    coords, boxes, alabels, glabels = [], [], [], []
    for sp in sorted(glob.glob(os.path.join(path, "set.*"))):
        c = np.load(os.path.join(sp, "coord.npy"))
        coords.append(c.reshape(c.shape[0], n, 3))
        b = np.load(os.path.join(sp, "box.npy"))
        boxes.append(b.reshape(b.shape[0], 3, 3))
        ap = os.path.join(sp, f"atomic_{label}.npy")
        if os.path.exists(ap):
            alabels.append(np.load(ap))
        gp = os.path.join(sp, f"{label}.npy")
        if os.path.exists(gp):
            glabels.append(np.load(gp))
    frames = {"coord": np.concatenate(coords),
              "box": np.concatenate(boxes)}
    if alabels:
        al = np.concatenate(alabels)           # (F, nsel * k)
        if sel_type is None:
            sel = np.ones(n, bool)
        else:
            sel = np.isin(types, np.asarray(sel_type))
        nsel = int(sel.sum())
        k = al.shape[1] // nsel
        full = np.zeros((al.shape[0], n, k), al.dtype)
        full[:, sel, :] = al.reshape(al.shape[0], nsel, k)
        frames["atomic_label"] = full
    if glabels:
        frames["label"] = np.concatenate(glabels)
    return {"frames": frames, "types": types,
            "nopbc": os.path.exists(os.path.join(path, "nopbc"))}


def train_tensor(params, tensor_nets, spec: ModelSpec, frames: dict, types,
                 *, numb_steps: int, loss_cfg: TensorLossConfig,
                 tensor_fn=atomic_dipole, lr_cfg=None, batch_size: int = 8,
                 seed: int = 0, callback=None, nopbc: bool = False):
    """Adam + exp-decay LR over tensor labels (DPTrainer with a
    loss/tensor.py objective, trainer.py:816 loop role). `frames` holds
    full arrays keyed like the loss batch; minibatches are drawn with a
    numpy RNG. Returns ((params, tensor_nets), last_aux)."""
    from g4s_tpu_torch.models.deepmd.train import (Adam, LRConfig, batch_to,
                                                   value_and_grad)
    lr_cfg = lr_cfg or LRConfig(1e-2, 1e-4, max(numb_steps // 10, 1),
                                numb_steps)
    opt = Adam(lr_cfg.lr_at_count)
    loss_fn = make_tensor_loss_fn(spec, loss_cfg, tensor_fn, nopbc=nopbc)
    tparams = (params, tensor_nets)
    opt_state = opt.init(tparams)
    like = params["stats"]["davg"]
    types = torch.as_tensor(np.asarray(types), device=like.device)
    rng = np.random.default_rng(seed)
    nf = frames["coord"].shape[0]
    aux = {}
    for step in range(numb_steps):
        idx = rng.integers(0, nf, min(batch_size, nf))
        batch = batch_to({k: v[idx] for k, v in frames.items()}, like)
        loss, aux, grads = value_and_grad(loss_fn, tparams, batch, types)
        tparams, opt_state = opt.update(grads, opt_state, tparams)
        if callback and (step % 100 == 0 or step == numb_steps - 1):
            callback(step, float(loss), {k: float(v) for k, v in aux.items()})
    return tparams, {k: float(v) for k, v in aux.items()}

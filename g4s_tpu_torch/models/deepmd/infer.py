"""Inference API: DeepPot + ensemble model deviation (counterpart of
g4s_tpu/models/deepmd/infer.py).

Reference surface: deepmd/deepmd/infer/deep_pot.py (DeepPot.eval, a
session wrapper over a frozen graph) and model_devi.py (force deviation
across an ensemble of models, used for active-learning error estimates).
The reference vmaps one frame's function over a batch; here the model
takes the batch axis itself, and one backward pass gives every frame's
forces and virial.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from g4s_tpu_torch.models.deepmd.freeze import load_frozen, load_frozen_meta
from g4s_tpu_torch.models.deepmd.model import energy_force_virial, params_to


class DeepPot:
    """Frozen-model evaluator (DeepPot.eval equivalent) on `device`.

    dp = DeepPot("frozen_model.npz")
    e, f, v = dp.eval(coords, box, types)      # single frame or batch

    dtype: the evaluation dtype (None keeps the frozen file's)."""

    def __init__(self, model_file, *, device="cuda", dtype=None):
        params, self.spec = load_frozen(model_file, device=device)
        self.params = params_to(params, dtype=dtype)
        self.device = self.params["stats"]["davg"].device
        self.dtype = self.params["stats"]["davg"].dtype
        self.type_map = load_frozen_meta(model_file).get("type_map") or []

    @property
    def rcut(self) -> float:
        return self.spec.descriptor.rcut

    @property
    def ntypes(self) -> int:
        return self.spec.descriptor.ntypes

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype or self.dtype,
                               device=self.device)

    def eval(self, coords, box, atom_types, fparam=None, aparam=None):
        """(e, f, v) tensors on the model's device for one frame (coords
        (N, 3)) or a batch (coords (B, N, 3), box (B, 3, 3)); models with
        numb_fparam/numb_aparam require the matching parameters, given per
        frame or once for the whole batch (DeepPot.eval fparam/aparam)."""
        coords = self._tensor(coords)
        box = self._tensor(box)
        types = self._tensor(atom_types, torch.int64)
        fp = None if fparam is None else self._tensor(fparam)
        ap = None if aparam is None else self._tensor(aparam)
        if coords.dim() == 3:
            b = coords.shape[0]
            if fp is not None and fp.dim() == 1:
                fp = fp.expand(b, -1)
            if ap is not None and ap.dim() == 2:
                ap = ap.expand(b, -1, -1)
        return energy_force_virial(self.params, self.spec, coords, box,
                                   types, fparam=fp, aparam=ap)


def calc_model_devi(models: Sequence[DeepPot], coords, box, atom_types):
    """Force deviation across an ensemble (model_devi.py semantics):
    per atom sigma_i = std over models of the force vector; returns
    (max_devi_f, min_devi_f, avg_devi_f) per frame, as numpy arrays."""
    fs = []
    for m in models:
        _, f, _ = m.eval(coords, box, atom_types)
        fs.append(f.cpu().numpy())
    F = np.stack(fs)                      # (n_models, [batch,] natoms, 3)
    if F.ndim == 3:
        F = F[:, None]
    mean = F.mean(axis=0)
    devi = np.sqrt(((F - mean) ** 2).sum(axis=-1).mean(axis=0))  # (b, natoms)
    return devi.max(axis=-1), devi.min(axis=-1), devi.mean(axis=-1)

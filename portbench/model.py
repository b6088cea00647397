"""A configuration's model on both sides: raw weights from the seed, the
program's DeepPot through `dp train`'s statistics, `dp freeze` and
`DeepPot`, and the reference's own statistics.

The weights follow DeePMD-kit's initialisation, as the program's
init_params draws them: w ~ N(0, 1) / sqrt(n_in + n_out), embedding
biases ~ N(0, 1), fitting biases ~ 0.1 N(0, 1), resnet_dt timesteps
1 + 0.001 N(0, 1), the final layer's bias 0. They are drawn on the card in
one call from a torch.Generator seeded with the run's seed, in the
configuration's precision, and laid out as the program's parameter tree
(embed[type][type] lists of layers, fit[type] {"hidden", "final"}), which
`dp freeze` writes and `DeepPot` reads back.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from portbench import frames
from portbench.reference import deepmd as ref

def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["precision"])


def _tree(cfg: dict, draw) -> dict:
    """The weight tree, each leaf draw(shape, kind), kind one of w,
    b_embed, b_fit, idt, zero, in the order they are drawn."""
    d, fit = cfg["descriptor"], cfg["fitting_net"]
    nt = len(cfg["type_map"])

    def layer(n_in, n_out, b_kind, idt):
        out = {"w": draw((n_in, n_out), "w"), "b": draw((n_out,), b_kind)}
        if idt:
            out["idt"] = draw((n_out,), "idt")
        return out

    dims = [1] + list(d["neuron"])
    embed = [[[layer(a, b, "b_embed", d.get("resnet_dt", False))
               for a, b in zip(dims, dims[1:])]
              for _ in range(nt)] for _ in range(nt)]
    m1 = d["neuron"][-1]
    dims = [m1 * d["axis_neuron"] if d["type"] == "se_e2_a" else m1] \
        + list(fit["neuron"])
    nets = [{"hidden": [layer(a, b, "b_fit",
                              fit.get("resnet_dt", True) and a == b)
                        for a, b in zip(dims, dims[1:])],
             "final": {"w": draw((dims[-1], 1), "w"),
                       "b": draw((1,), "zero")}}
            for _ in range(nt)]
    return {"embed": embed, "fit": nets}


def raw_weights(cfg: dict, seed: int, device) -> dict:
    """{"embed": [[layers]], "fit": [nets]} from the seed, on `device`."""
    sizes = []
    _tree(cfg, lambda shape, kind: sizes.append(int(np.prod(shape))))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype_of(cfg),
                       device=device)
    at = 0

    def draw(shape, kind):
        nonlocal at
        n = int(np.prod(shape))
        x = flat[at:at + n].reshape(shape)
        at += n
        if kind == "w":
            return x / np.sqrt(shape[0] + shape[1])
        if kind == "b_fit":
            return 0.1 * x
        if kind == "idt":
            return 1.0 + 0.001 * x
        if kind == "zero":
            return torch.zeros_like(x)
        return x.clone()
    return _tree(cfg, draw)


def port_spec(cfg: dict):
    """The program's ModelSpec of a configuration."""
    from g4s_tpu_torch.models.deepmd import DescriptorSpec, ModelSpec
    d, fit = cfg["descriptor"], cfg["fitting_net"]
    return ModelSpec(
        DescriptorSpec(float(d["rcut"]), float(d["rcut_smth"]),
                       tuple(d["sel"]), len(cfg["type_map"])),
        tuple(d["neuron"]), int(d.get("axis_neuron", 16)),
        tuple(fit["neuron"]), embed_resnet_dt=bool(d.get("resnet_dt", False)),
        fit_resnet_dt=bool(fit.get("resnet_dt", True)),
        descriptor_type=cfg["port"]["descriptor_type"])


def stat_frames(cfg: dict, seed: int) -> np.ndarray:
    """The frames `dp train` would take its statistics from: the
    configuration's stat_frames frames of 64 molecules."""
    return frames.water_frames(frames.rng(seed, "stats"),
                               cfg["stat_frames"], 4)


def program_pot(cfg: dict, weights: dict, stat_x: np.ndarray, device):
    """The program's DeepPot: davg/dstd from compute_stats over the stat
    frames' env matrices (as `dp train`), the tree frozen with `dp
    freeze` into a temporary directory and loaded back with DeepPot."""
    from g4s_tpu_torch.models.deepmd import DeepPot, compute_stats, freeze
    from g4s_tpu_torch.models.deepmd.descriptor import env_mat
    spec = port_spec(cfg)
    dt = dtype_of(cfg)
    nt = spec.descriptor.ntypes
    L = frames.box_length(4)
    ty = frames.types(64)
    box = torch.eye(3, dtype=dt, device=device) * L
    types = torch.as_tensor(ty, device=device)
    Rs = [env_mat(torch.as_tensor(x, dtype=dt, device=device), box, types,
                  spec.descriptor)[0] for x in stat_x]
    davg, dstd = compute_stats(Rs, [ty] * len(Rs), nt, spec.descriptor.nnei)
    params = {"embed": weights["embed"], "fit": weights["fit"],
              "stats": {"davg": torch.as_tensor(davg, dtype=dt,
                                                device=device),
                        "dstd": torch.as_tensor(dstd, dtype=dt,
                                                device=device)}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frozen_model.npz")
        freeze(params, spec, path, type_map=cfg["type_map"])
        return DeepPot(path, device=device)


class Reference:
    """The reference's side of a configuration: its model, the weights,
    and its own davg/dstd from the same stat frames, in `dtype`."""

    def __init__(self, cfg: dict, weights: dict, stat_x: np.ndarray,
                 device, dtype=None):
        self.model = ref.model_from_config(cfg)
        self.dtype = dtype or dtype_of(cfg)
        self.device = device
        self.nets = _cast(weights, self.dtype)
        x = torch.as_tensor(stat_x, dtype=self.dtype, device=device)
        L = torch.full((x.shape[0], 3), frames.box_length(4),
                       dtype=self.dtype, device=device)
        types = torch.as_tensor(frames.types(64), device=device)
        self.davg, self.dstd = ref.compute_stats(self.model, x, L, types)

    def efv(self, x, L, types):
        """E, F, W and the neighbour info of frames x (F, N, 3) in cubes
        of side L (a float)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        Lt = torch.full((x.shape[0], 3), L, dtype=self.dtype,
                        device=self.device)
        types = torch.as_tensor(types, device=self.device)
        return ref.energy_force_virial(self.model, self.nets, self.davg,
                                       self.dstd, x, Lt, types)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)

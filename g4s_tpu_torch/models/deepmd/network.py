"""Embedding / fitting MLPs as plain parameter trees (counterpart of
g4s_tpu/models/deepmd/network.py).

The reference's network builders (deepmd/deepmd/utils/network.py):
  - embedding_net: layers y = phi(x W + b) with identity-style residual
    shortcuts (+x when N2==N1, +(x,x) when N2==2*N1) and optional
    resnet_dt scaling.
  - one_layer: fitting layers with tanh + resnet_dt, final linear layer
    with energy bias.

A layer is a dict {"w", "b"[, "idt"]} of tensors. Every product goes
through the engine's dense entry (g4s_tpu_torch.engine.matmul.dense_matmul),
the G4S seam where the reference routes the same matmul through its
OptMatmul graph-engine op. The init_* functions draw from a
torch.Generator on its device; the two packages' random streams differ, so
the same weights reach both packages only by copying them
(model.params_from_numpy).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from g4s_tpu_torch.engine.matmul import dense_matmul


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def init_embedding_net(gen, sizes: Sequence[int], *, in_dim: int = 1,
                       resnet_dt: bool = False, dtype=torch.float64):
    """Params for one embedding net [in_dim] + sizes."""
    dims = [in_dim] + list(sizes)
    layers = []
    for i in range(1, len(dims)):
        w = _normal(gen, (dims[i - 1], dims[i]), dtype) \
            / np.sqrt(dims[i] + dims[i - 1])
        layer = {"w": w, "b": _normal(gen, (dims[i],), dtype)}
        if resnet_dt:
            layer["idt"] = 1.0 + 0.001 * _normal(gen, (dims[i],), dtype)
        layers.append(layer)
    return layers


def embedding_net_apply(layers, x):
    """x: (..., in_dim) -> (..., sizes[-1]) with DeePMD residual rules."""
    for layer in layers:
        h = torch.tanh(dense_matmul(x, layer["w"]) + layer["b"])
        if "idt" in layer:
            h = h * layer["idt"]
        n_in, n_out = layer["w"].shape
        if n_out == n_in:
            x = x + h
        elif n_out == 2 * n_in:
            x = torch.cat([x, x], dim=-1) + h
        else:
            x = h
    return x


def init_fitting_net(gen, in_dim: int, sizes: Sequence[int], *,
                     resnet_dt: bool = True, bias_out: float = 0.0,
                     dtype=torch.float64):
    dims = [in_dim] + list(sizes)
    layers = []
    for i in range(1, len(dims)):
        w = _normal(gen, (dims[i - 1], dims[i]), dtype) \
            / np.sqrt(dims[i] + dims[i - 1])
        layer = {"w": w, "b": _normal(gen, (dims[i],), dtype) * 0.1}
        if resnet_dt and dims[i] == dims[i - 1]:
            layer["idt"] = 1.0 + 0.001 * _normal(gen, (dims[i],), dtype)
        layers.append(layer)
    w_final = _normal(gen, (dims[-1], 1), dtype) / np.sqrt(dims[-1] + 1)
    final = {"w": w_final,
             "b": torch.tensor([bias_out], dtype=dtype, device=gen.device)}
    return {"hidden": layers, "final": final}


def fitting_net_outputs(params, x):
    """x: (..., in_dim) -> (..., n_out), every output of the final layer
    (n_out = 1 for energies; the DOS and tensor fits' final layers are
    wider)."""
    for layer in params["hidden"]:
        h = torch.tanh(dense_matmul(x, layer["w"]) + layer["b"])
        if "idt" in layer:
            h = h * layer["idt"]
        n_in, n_out = layer["w"].shape
        x = x + h if n_out == n_in else h
    return dense_matmul(x, params["final"]["w"]) + params["final"]["b"]


def fitting_net_apply(params, x):
    """x: (..., in_dim) -> (...,) atomic energies."""
    return fitting_net_outputs(params, x)[..., 0]

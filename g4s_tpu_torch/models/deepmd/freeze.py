"""Freeze: serialize a model to a single deployable artifact (counterpart
of g4s_tpu/models/deepmd/freeze.py).

Equivalent of `dp freeze -o graph.pb` (deepmd/deepmd/entrypoints/freeze.py
freeze_graph). The artifact is the reference's own .npz: `__meta__`, a
JSON string of the spec (with `type_map` and the tree's structure), and
`leaf_{i}`, the parameter leaves in JAX's tree_flatten order: dict keys
sorted (`b`, `idt`, `w`; `final` before `hidden`; `embed`, `fit`,
`stats`), lists in order (ckpt.tree_leaves). So a model frozen by either
package loads in the other. The order is rebuilt here from the spec,
without JAX.

params_from_numpy / params_to_numpy carry a parameter tree between the two
packages as numpy arrays (the JAX tree under jax.tree_util.tree_map(
np.asarray, ...)).
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from g4s_tpu_torch.ckpt import tree_leaves, tree_unflatten
from g4s_tpu_torch.models.deepmd.descriptor import DescriptorSpec
from g4s_tpu_torch.models.deepmd.model import (ModelSpec, init_params,
                                               map_tree)
from g4s_tpu_torch.sparse.containers import resolve_device


def _treedef_str(tree) -> str:
    """The string JAX prints for the tree's PyTreeDef."""
    def s(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {s(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(s(v) for v in t) \
                + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({s(tree)})"


def params_to_numpy(params):
    """The parameter tree with every tensor as a host numpy array."""
    return map_tree(lambda x: x.detach().cpu().numpy(), params)


def params_from_numpy(tree, *, device="cuda", dtype=None):
    """A parameter tree of numpy arrays (the JAX package's, or
    params_to_numpy's) as tensors on `device`, floating leaves cast to
    `dtype` when given."""
    device = resolve_device(device)

    def to_tensor(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device,
                    dtype=dtype if t.is_floating_point() else None)
    return map_tree(to_tensor, tree)


def freeze(params, spec: ModelSpec, path, *, type_map=None) -> None:
    meta = dict(
        rcut=spec.descriptor.rcut, rcut_smth=spec.descriptor.rcut_smth,
        sel=list(spec.descriptor.sel), ntypes=spec.descriptor.ntypes,
        embed_neurons=list(spec.embed_neurons), axis_neuron=spec.axis_neuron,
        fit_neurons=list(spec.fit_neurons),
        embed_resnet_dt=spec.embed_resnet_dt,
        fit_resnet_dt=spec.fit_resnet_dt,
        descriptor_type=spec.descriptor_type,
        numb_fparam=spec.numb_fparam, numb_aparam=spec.numb_aparam,
        type_map=list(type_map) if type_map else None,
        treedef=_treedef_str(params))
    arrays = {f"leaf_{i}": l for i, l in
              enumerate(tree_leaves(params_to_numpy(params)))}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_frozen(path, *, device="cuda") -> Tuple[dict, ModelSpec]:
    """(params on `device`, spec) of a frozen model from either package."""
    meta = load_frozen_meta(path)
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    spec = ModelSpec(
        DescriptorSpec(meta["rcut"], meta["rcut_smth"], tuple(meta["sel"]),
                       meta["ntypes"]),
        tuple(meta["embed_neurons"]), meta["axis_neuron"],
        tuple(meta["fit_neurons"]), meta["embed_resnet_dt"],
        meta["fit_resnet_dt"], meta.get("descriptor_type", "se_e2_a"),
        numb_fparam=meta.get("numb_fparam", 0),
        numb_aparam=meta.get("numb_aparam", 0))
    # the tree's structure from a skeleton of the same spec
    skeleton = init_params(torch.Generator().manual_seed(0), spec)
    if len(tree_leaves(skeleton)) != len(leaves):
        raise ValueError(f"{path}: {len(leaves)} leaves, but a "
                         f"{spec.descriptor_type} model of this spec has "
                         f"{len(tree_leaves(skeleton))}")
    return params_from_numpy(tree_unflatten(skeleton, iter(leaves)),
                             device=device), spec


def load_frozen_meta(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))

"""Checkpoints (counterpart of g4s_tpu/ckpt.py).

Reference capabilities: CitcomS full solver-state checkpoints, written
every checkpoint_frequency steps and restored on restart
(citcoms/lib/Checkpoints.c:53-139 output_checkpoint / :89
read_checkpoint; wired at bin/Citcom.c:140-156,247-250), and DeePMD TF
Saver checkpoints and re-init from a checkpoint
(deepmd/deepmd/train/trainer.py:1094-1123, :1326-1416).

A checkpoint is the reference's own npz file: `__header__`, a JSON string
{"sentinel": "g4s-tpu-ckpt-v1", "n_leaves", "meta"}, then `leaf_{i}`, the
tree's leaves in JAX's tree_flatten order (dicts by sorted key; lists,
tuples and NamedTuples in order). So a checkpoint written by either
package restores in the other. The file is written beside its path and
moved into place, so a reader never sees a torn checkpoint.

A DeePMD checkpoint holds {"params": ...} and, when saved with one, the
optimizer state as "opt_state", laid out as optax flattens
optax.adam(learning_rate=schedule)'s state (models/deepmd/train.py Adam).

A CitcomS checkpoint holds the State's leaves in the reference's field
order (T, Tdot, V, P, time, dt, step; step an int32 scalar) with meta
{"kind": "citcoms", "step", "time", "config": cfg.dump()}.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

SENTINEL = "g4s-tpu-ckpt-v1"


def tree_leaves(tree) -> list:
    """Leaves in JAX's tree_flatten order: dicts by sorted key, lists,
    tuples and NamedTuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def rebuild(skeleton, children):
    """A container of the skeleton's type holding `children` (a NamedTuple
    takes them as positional fields)."""
    if hasattr(skeleton, "_fields"):
        return type(skeleton)(*children)
    return type(skeleton)(children)


def tree_unflatten(skeleton, it):
    """The skeleton's tree with its leaves taken from the iterator `it` in
    tree_leaves order; each must have its skeleton leaf's shape."""
    if isinstance(skeleton, dict):
        return {k: tree_unflatten(skeleton[k], it) for k in sorted(skeleton)}
    if isinstance(skeleton, (list, tuple)):
        return rebuild(skeleton, [tree_unflatten(v, it) for v in skeleton])
    leaf = next(it)
    if tuple(leaf.shape) != tuple(skeleton.shape):
        raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where the "
                         f"template has {tuple(skeleton.shape)}")
    return leaf


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path, tree, *, meta: Optional[Dict[str, Any]] = None) -> None:
    leaves = tree_leaves(tree)
    header = {"sentinel": SENTINEL, "n_leaves": len(leaves),
              "meta": meta or {}}
    arrays = {f"leaf_{i}": _host(l) for i, l in enumerate(leaves)}
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, __header__=json.dumps(header), **arrays)
    os.replace(tmp, path)


def _header(z, path) -> Dict[str, Any]:
    header = json.loads(str(z["__header__"]))
    if header.get("sentinel") != SENTINEL:
        raise ValueError(f"{path}: bad checkpoint sentinel")
    return header


def read_meta(path) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        return _header(z, path)["meta"]


def load_pytree(path, like) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure of `like` (a template tree of tensors):
    each leaf keeps the dtype it was saved in and goes to the device of
    its template leaf."""
    with np.load(path, allow_pickle=False) as z:
        header = _header(z, path)
        leaves = [z[f"leaf_{i}"] for i in range(header["n_leaves"])]
    template = tree_leaves(like)
    if len(template) != len(leaves):
        raise ValueError(
            f"{path}: {len(leaves)} leaves, template has {len(template)}")
    tensors = [torch.from_numpy(np.array(a)).to(t.device)
               for a, t in zip(leaves, template)]
    return tree_unflatten(like, iter(tensors)), header["meta"]


# ---------------- CitcomS ----------------

def _citcoms_leaves(state) -> list:
    return [state.T, state.Tdot, state.V, state.P, state.time, state.dt,
            torch.tensor(int(state.step), dtype=torch.int32)]


def save_citcoms(path, state, cfg) -> None:
    """output_checkpoint equivalent: full momentum+energy solver state."""
    save_pytree(path, _citcoms_leaves(state), meta={
        "kind": "citcoms", "step": int(state.step),
        "time": float(state.time), "config": cfg.dump()})


def load_citcoms(path, model):
    """read_checkpoint equivalent: the State on the model's device, its
    float leaves in the model's dtype. Returns (state, meta)."""
    from g4s_tpu_torch.models.citcoms.driver import State
    leaves, meta = load_pytree(path, _citcoms_leaves(model.init_state()))
    if meta.get("kind") != "citcoms":
        raise ValueError(f"{path} is not a citcoms checkpoint")
    fields = [x.to(model.dtype) for x in leaves[:6]]
    return State(*fields, int(leaves[6])), meta


# ---------------- DeePMD ----------------

def save_deepmd(path, params, opt_state=None, *, step: int = 0) -> None:
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    save_pytree(path, tree, meta={"kind": "deepmd", "step": step,
                                  "has_opt": opt_state is not None})


def load_deepmd(path, params_template, opt_state_template=None):
    like = {"params": params_template}
    if read_meta(path).get("has_opt"):
        if opt_state_template is None:
            raise ValueError("checkpoint has optimizer state; pass a template")
        like["opt_state"] = opt_state_template
    return load_pytree(path, like)

"""Operator-level strategy dispatch (counterpart of
g4s_tpu/engine/operator.py): the engine chooses the execution form of a
linear operator, not just a sparse layout.

Workloads register an apply rule for each form they can provide, and
`build_operator` picks one from structure statistics once, on the host:
the seam the reference CitcomS exposes between its element-by-element and
preassembled nodal stiffness products, generalized.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

_APPLY_RULES: Dict[str, Callable] = {}


def register_operator_variant(name: str, apply_fn: Callable) -> None:
    """Register `apply_fn(data, u) -> v` as the executor for `name`."""
    _APPLY_RULES[name] = apply_fn


@dataclasses.dataclass(frozen=True)
class OperatorGraph:
    """A linear operator staged for the engine with a chosen form."""

    data: Any          # whatever the form's apply rule consumes
    variant: str


def build_operator(candidates: Dict[str, Any], *,
                   stats: Dict) -> OperatorGraph:
    """Pick the execution form from structure statistics.

    Preference order:
      'stencil' — regular tensor grid: shifted block multiply-adds, no
                  gather or scatter; requires stats['regular_grid'].
      'eltk'    — element-by-element gather / element matrix / scatter;
                  always available.
    Otherwise the first candidate by name, deterministically."""
    if "stencil" in candidates and stats.get("regular_grid", False):
        return OperatorGraph(candidates["stencil"], "stencil")
    if "eltk" in candidates:
        return OperatorGraph(candidates["eltk"], "eltk")
    name = sorted(candidates)[0]
    return OperatorGraph(candidates[name], name)


def apply_operator(g: OperatorGraph, u):
    """v = A u through the chosen form's registered rule."""
    try:
        rule = _APPLY_RULES[g.variant]
    except KeyError:
        raise KeyError(f"no apply rule registered for operator variant "
                       f"{g.variant!r}; call register_operator_variant")
    return rule(g.data, u)

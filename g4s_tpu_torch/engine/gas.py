"""Gather/Apply (GAS) vertex programs over the engine (counterpart of
g4s_tpu/engine/gas.py).

The user supplies `gather` (fold an edge into a vertex accumulator) and
`apply` (post-process the accumulator); the engine owns the execution
strategy, i.e. the layout build_graph chose. Callbacks are torch
expressions broadcast over the whole edge set at once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from g4s_tpu_torch.engine.dispatch import Graph, permute_in, permute_out
from g4s_tpu_torch.ops.segment import sorted_segment_sum


def gather_apply(g: Graph, x, gather: Callable,
                 apply: Optional[Callable] = None):
    """out[i] = apply(sum_k gather(w[i,k], x[neighbor_k(i)])).

    `gather(edge_weight, neighbor_state) -> contribution` is applied
    elementwise over all edges. Padded slots carry weight 0, so gather must
    map zero-weight edges to a zero contribution (true for every
    multiplicative gather).
    """
    if g.variant == "dense":
        acc = gather(g.dense, x[None, :]).sum(dim=1)
    elif g.variant == "dia":
        n = g.shape[0]
        maxoff = max((abs(o) for o in g.dia.offsets), default=0)
        xp = torch.nn.functional.pad(permute_in(g, x), (maxoff, maxoff))
        acc = torch.zeros((n,), dtype=torch.promote_types(g.dia.vals.dtype,
                                                          x.dtype),
                          device=x.device)
        for i, o in enumerate(g.dia.offsets):
            acc = acc + gather(g.dia.vals[i], xp[maxoff + o: maxoff + o + n])
        acc = permute_out(g, acc)
    elif g.variant == "ell":
        acc = gather(g.ell.vals, x[g.ell.cols.long()]).sum(dim=1)
    else:
        contrib = gather(g.csr.data, x[g.csr.indices.long()])
        acc = sorted_segment_sum(contrib, g.row_ids, g.shape[0])
    return apply(acc) if apply is not None else acc


def spmm_dense(edge_weight, vertex_states, gather: Callable,
               apply: Optional[Callable] = None):
    """The degree-regular dense engine entry (spmm_dense ABI):
    edge_weight and vertex_states are both (num_nodes, degree)."""
    acc = gather(edge_weight, vertex_states).sum(dim=1)
    return apply(acc) if apply is not None else acc

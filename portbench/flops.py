"""Floating-point operations of one E + F + W evaluation of a DeePMD
configuration: the dense products only (each layer's matmul, the
descriptor's contractions), 2 per multiply-add.

The backward pass to the coordinates and the strain takes no weight
gradients, so a layer's product costs its forward once more; a
contraction whose two operands both depend on the coordinates costs its
forward twice more.

se_e2_a (after chip_smoke.py's _deepmd_flops): per atom and centre type,
the embedding net over nnei rows, T = R^T G (nnei * 4 * m1) and
D = T^T T[:, :m2] (4 * m1 * m2), the fitting net over D. The program runs
every centre type's nets on every atom; `own_type_only` counts each
atom's own type once.

se_e3: per atom, for each neighbour-type pair t1 <= t2, sel1 * sel2 rows
of theta_jk = x_j . x_k (3 multiply-adds), the embedding net over them,
and sum_jk theta_jk G_jk (m1 per row); these the program computes once
per atom. The fitting net runs per centre type as above.
"""

from __future__ import annotations


def _net(dims) -> int:
    return 2 * sum(a * b for a, b in zip(dims, dims[1:]))


def model_flops(cfg: dict, n_atoms: int) -> dict:
    """{"forward", "total", "own_type_only"} of one evaluation of n_atoms
    atoms."""
    d, fit = cfg["descriptor"], cfg["fitting_net"]
    sel = list(d["sel"])
    nt = len(sel)
    nnei = sum(sel)
    m1 = d["neuron"][-1]
    embed_dims = [1] + list(d["neuron"])
    if d["type"] == "se_e2_a":
        m2 = d["axis_neuron"]
        embed = n_atoms * nnei * _net(embed_dims)             # per type
        contract = n_atoms * (nnei * 4 * m1 + 4 * m1 * m2) * 2
        fit_one = n_atoms * _net([m1 * m2] + list(fit["neuron"]) + [1])
        shared, per_type = 0, 2 * (embed + fit_one) + 3 * contract
        forward = nt * (embed + contract + fit_one)
    elif d["type"] == "se_e3":
        pairs = sum(a * b for i, a in enumerate(sel) for b in sel[i:])
        embed = n_atoms * pairs * _net(embed_dims)
        contract = n_atoms * pairs * (3 + m1) * 2
        fit_one = n_atoms * _net([m1] + list(fit["neuron"]) + [1])
        shared, per_type = 2 * embed + 3 * contract, 2 * fit_one
        forward = embed + contract + nt * fit_one
    else:
        raise ValueError(f"no FLOP count for {d['type']!r}")
    return {"forward": forward, "total": shared + nt * per_type,
            "own_type_only": shared + per_type}

"""The reference's cell list against its all-pairs env_mat (both from
g4s_tpu, JAX on the CPU in f64), and what the port does with the same
frames.

    JAX_PLATFORMS=cpu python tests/deepmd_celllist_duplicates.py

For each case (random atoms in a cubic box, sel 46/92, half of them of each
type): the box's cells per side, the largest |R_celllist - R_env_mat| over
all slots, the most neighbour slots in one row that repeat an atom already
in that row, whether every row holds the same neighbour set, and whether
the port's env_mat_celllist raised ValueError. With fewer than 3 cells per
side the reference's 27 neighbouring cells, taken modulo the cell count,
hold one cell two or three times; past max_per_cell it drops atoms.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from g4s_tpu.models.deepmd import descriptor as jd  # noqa: E402
from g4s_tpu_torch.models.deepmd import descriptor as pd  # noqa: E402

CASES = [  # atoms, box side (A), rcut (A), max_per_cell
    (192, 12.444661, 6.0, 64),      # the water frame's box
    (200, 14.0, 3.5, 64),
    (1536, 24.889322, 6.0, 64),     # the water frame's box doubled
    (200, 14.0, 3.5, 3),            # more atoms in a cell than its slots
]


def duplicates_per_row(nlist) -> int:
    return max(int(np.sum(np.unique(r[r >= 0], return_counts=True)[1] - 1))
               for r in np.asarray(nlist))


def main():
    for n, L, rcut, occ in CASES:
        rng = np.random.default_rng(n)
        c = rng.uniform(0, L, (n, 3))
        b = np.eye(3) * L
        ty = np.repeat([0, 1], [n // 2, n - n // 2]).astype(np.int32)
        spec = jd.DescriptorSpec(rcut, 0.5, (46, 92), 2)
        R1, nl1 = jd.env_mat(jnp.asarray(c), jnp.asarray(b),
                             jnp.asarray(ty), spec)
        R2, nl2 = jd.env_mat_celllist(jnp.asarray(c), jnp.asarray(b),
                                      jnp.asarray(ty), spec,
                                      max_per_cell=occ)
        same = bool((np.sort(np.asarray(nl1), 1)
                     == np.sort(np.asarray(nl2), 1)).all())
        try:
            pd.env_mat_celllist(torch.from_numpy(c), torch.from_numpy(b),
                                torch.from_numpy(ty),
                                pd.DescriptorSpec(*spec), max_per_cell=occ)
            port = "returned"
        except ValueError:
            port = "raised ValueError"
        print(f"atoms={n} box={L} rcut={rcut} max_per_cell={occ} "
              f"cells_per_side={int(L // rcut)} "
              f"max_abs_dR={float(np.abs(np.asarray(R1 - R2)).max()):.3g} "
              f"max_duplicates_per_row={duplicates_per_row(nl2)} "
              f"neighbour_sets_equal={same} port={port}", flush=True)


if __name__ == "__main__":
    main()

"""Per-rank output and its merge (counterpart of
g4s_tpu/models/citcoms/combine.py: the reference's visual/combine.py /
batchcombine.py post-processing).

CitcomS writes one ASCII file per MPI rank per step
(<datafile>.velo.<rank>.<step>) and ships python scripts that stitch them
into a single global field file. Here each rank of a
distributed.DistributedCitcom writes its own file, in the reference's
format byte for byte; ranks are enumerated bx-major (bx * py + by), each
owning the tensor-product node slab _block_slices gives.
"""

from __future__ import annotations

import os

import numpy as np

from g4s_tpu_torch.models.citcoms.distributed import _block_slices


def rank_node_grid(cfg, px: int, py: int, rank: int):
    """(y-slice, x-slice) of the rank's nodes in the global grid."""
    bx, by = divmod(rank, py)
    xs = _block_slices(cfg.nodex, px)
    ys = _block_slices(cfg.nodey, py)
    return ys[by], xs[bx]


def write_rank_outputs(dist, s, step: int) -> list:
    """Write this rank's velo file from its block of a distributed state
    (the per-proc file Output.c writes on each MPI rank). Returns the
    list of files written (one)."""
    cfg = dist.cfg
    os.makedirs(cfg.datadir, exist_ok=True)
    T = s["T"].detach().cpu().numpy()
    V = s["V"].detach().cpu().numpy()
    t = float(s["time"])
    p = os.path.join(cfg.datadir,
                     f"{cfg.datafile}.velo.{dist.grid.rank}.{step}")
    with open(p, "w") as f:
        f.write(f"{t:.6e} {T.shape[0]}\n")
        np.savetxt(f, np.column_stack([V, T]), fmt="%.6e")
    return [p]


def combine_velo(cfg, px: int, py: int, step: int):
    """Merge per-rank velo files -> global (nno, 4) [Vt, Vf, Vr, T]
    array in global node order (combine.py role). Shared boundary nodes
    are written consistently by every owner, so later ranks overwrite
    earlier ones harmlessly."""
    nox, noy, noz = cfg.nodex, cfg.nodey, cfg.nodez
    out = np.zeros((noy, nox, noz, 4))
    for r in range(px * py):
        p = os.path.join(cfg.datadir, f"{cfg.datafile}.velo.{r}.{step}")
        data = np.loadtxt(p, skiprows=1)
        (y0, y1), (x0, x1) = rank_node_grid(cfg, px, py, r)
        out[y0:y1, x0:x1, :] = data.reshape(y1 - y0, x1 - x0, noz, 4)
    return out.reshape(-1, 4)

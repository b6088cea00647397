"""DeePMD npy data systems (counterpart of g4s_tpu/models/deepmd/data.py,
numpy only, copied so the port imports nothing of g4s_tpu).

Loads the reference's training-data layout (deepmd/deepmd/utils/data.py +
data_system.py DeepmdDataSystem): a system directory holds `type.raw` and
`set.NNN/{coord,box,energy,force}.npy` with coord/force flattened
(nframes, natoms*3). Batches are sampled from systems with probability
proportional to their frame counts; batch_size 'auto' picks
ceil(32/natoms) frames (data_system.py auto rule).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np


class System(NamedTuple):
    path: str
    types: np.ndarray      # (natoms,)
    coord: np.ndarray      # (nframes, natoms, 3)
    box: np.ndarray        # (nframes, 3, 3)
    energy: np.ndarray     # (nframes,)
    force: np.ndarray      # (nframes, natoms, 3)
    fparam: np.ndarray = None   # (nframes, numb_fparam) when present
    aparam: np.ndarray = None   # (nframes, natoms, numb_aparam)

    @property
    def natoms(self) -> int:
        return self.types.shape[0]

    @property
    def nframes(self) -> int:
        return self.coord.shape[0]


def load_system(path) -> System:
    types = np.loadtxt(os.path.join(path, "type.raw"), dtype=np.int32,
                       ndmin=1)
    n = types.shape[0]
    coords, boxes, energies, forces = [], [], [], []
    sets = sorted(d for d in os.listdir(path) if d.startswith("set."))
    if not sets:
        raise FileNotFoundError(f"no set.* directories under {path}")
    fparams, aparams = [], []
    for s in sets:
        sp = os.path.join(path, s)
        coords.append(np.load(os.path.join(sp, "coord.npy")))
        boxes.append(np.load(os.path.join(sp, "box.npy")))
        energies.append(np.load(os.path.join(sp, "energy.npy")))
        forces.append(np.load(os.path.join(sp, "force.npy")))
        fp = os.path.join(sp, "fparam.npy")
        if os.path.exists(fp):
            fparams.append(np.load(fp))
        ap = os.path.join(sp, "aparam.npy")
        if os.path.exists(ap):
            aparams.append(np.load(ap))
    coord = np.concatenate(coords).reshape(-1, n, 3).astype(np.float64)
    box = np.concatenate(boxes).reshape(-1, 3, 3).astype(np.float64)
    energy = np.concatenate(energies).astype(np.float64)
    force = np.concatenate(forces).reshape(-1, n, 3).astype(np.float64)
    fparam = np.concatenate(fparams).reshape(len(energy), -1) \
        .astype(np.float64) if fparams else None
    aparam = np.concatenate(aparams).reshape(len(energy), n, -1) \
        .astype(np.float64) if aparams else None
    return System(str(path), types, coord, box, energy, force,
                  fparam, aparam)


class DataSystem:
    """Multi-system sampler (DeepmdDataSystem equivalent)."""

    def __init__(self, paths: Sequence[str], *, batch_size="auto", seed=10):
        self.systems = [load_system(p) for p in paths]
        # with systems of mixed sizes the first one's natoms sets the
        # 'auto' batch, as in the reference
        natoms = self.systems[0].natoms
        if batch_size == "auto":
            self.batch_size = max(1, int(np.ceil(32 / natoms)))
        else:
            self.batch_size = int(batch_size)
        nf = np.array([s.nframes for s in self.systems], dtype=np.float64)
        self.probs = nf / nf.sum()
        self.rng = np.random.default_rng(seed)

    @property
    def ntypes(self) -> int:
        return int(max(s.types.max() for s in self.systems)) + 1

    def energy_bias(self, ntypes: int) -> np.ndarray:
        """Least-squares per-type energy bias (data_stat: compute_energy_shift)."""
        rows, ys = [], []
        for s in self.systems:
            count = np.bincount(s.types, minlength=ntypes).astype(np.float64)
            for e in s.energy:
                rows.append(count)
                ys.append(e)
        A = np.stack(rows)
        bias, *_ = np.linalg.lstsq(A, np.asarray(ys), rcond=None)
        return bias

    def sample_batch(self):
        """One batch from one randomly chosen system (frames stacked)."""
        si = self.rng.choice(len(self.systems), p=self.probs)
        s = self.systems[si]
        idx = self.rng.integers(0, s.nframes, size=self.batch_size)
        out = dict(types=s.types, coord=s.coord[idx], box=s.box[idx],
                   energy=s.energy[idx], force=s.force[idx])
        # duck-typed: tests substitute minimal System-likes without the
        # optional fparam/aparam fields
        if getattr(s, "fparam", None) is not None:
            out["fparam"] = s.fparam[idx]
        if getattr(s, "aparam", None) is not None:
            out["aparam"] = s.aparam[idx]
        return out

    def fparam_stats(self):
        """(avg, std) of the frame parameters over all systems
        (ener.py compute_input_stats for fparam)."""
        allf = np.concatenate([s.fparam for s in self.systems
                               if s.fparam is not None])
        std = allf.std(axis=0)
        return allf.mean(axis=0), np.where(std > 0, std, 1.0)

    def sample_batches(self, n: int):
        return [self.sample_batch() for _ in range(n)]

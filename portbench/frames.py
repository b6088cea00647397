"""Water frames and velocities from a seed.

A frame holds n^3 rigid water molecules in a cube at the density of
DeePMD-kit's examples/water data (water.lmp: 64 H2O in a 12.444661 A
cube): O atoms on an n x n x n lattice, each jittered uniformly by up to
JITTER_A per axis; each H at O_H_A from its O with the H-O-H angle
HOH_DEG, the molecule turned by a uniform random rotation. A molecule
that comes closer than O_H_A to another (minimum image) is drawn again,
so no two atoms of different molecules are closer than the bond. Atoms
are ordered O first (molecule i's O is atom i), then the H pairs (atoms
n_mol + 2i, n_mol + 2i + 1): types 0 (O) and 1 (H).
"""

from __future__ import annotations

import numpy as np

WATER_64_L = 12.444661          # A, the cube of 64 molecules
O_H_A = 0.9572
HOH_DEG = 104.52
JITTER_A = 0.25
STREAMS = {"stats": 1, "frames": 2, "velocities": 3, "sample": 4}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named use of a run's seed."""
    return np.random.default_rng([STREAMS[stream], seed % (1 << 63)])


def box_length(n_side: int) -> float:
    return WATER_64_L * n_side / 4


def types(n_mol: int) -> np.ndarray:
    return np.concatenate([np.zeros(n_mol, np.int64),
                           np.ones(2 * n_mol, np.int64)])


def _rotations(g: np.random.Generator, n: int) -> np.ndarray:
    q = g.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def _hydrogens(g: np.random.Generator, n: int) -> np.ndarray:
    """(n, 2, 3) H offsets from their O."""
    half = np.deg2rad(HOH_DEG) / 2
    local = O_H_A * np.array([[np.sin(half), np.cos(half), 0.0],
                              [-np.sin(half), np.cos(half), 0.0]])
    return np.einsum("nij,hj->nhi", _rotations(g, n), local)


def _molecule_pairs(n_side: int) -> np.ndarray:
    """(P, 2) pairs of molecules that can come within the bond of each
    other: lattice neighbours, or all pairs where the lattice is too
    small for its neighbours to be distinct."""
    n_mol = n_side ** 3
    if n_side < 3:
        i, j = np.triu_indices(n_mol, 1)
        return np.stack([i, j], 1)
    idx = np.arange(n_mol).reshape(n_side, n_side, n_side)
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1) if (a, b, c) > (0, 0, 0)]
    pairs = [np.stack([idx.ravel(),
                       np.roll(idx, (-a, -b, -c), (0, 1, 2)).ravel()], 1)
             for a, b, c in offs]
    return np.concatenate(pairs)


def _clashes(mol: np.ndarray, pairs: np.ndarray, L: float) -> np.ndarray:
    """Molecules (the second of each pair) closer than the bond to their
    pair's first; mol (n_mol, 3, 3) holds O, H, H positions."""
    d = mol[pairs[:, 1]][:, None, :, :] - mol[pairs[:, 0]][:, :, None, :]
    d -= L * np.round(d / L)
    close = (np.sqrt((d * d).sum(-1)) < O_H_A).any(axis=(1, 2))
    return np.unique(pairs[close, 1])


def water_frame(g: np.random.Generator, n_side: int) -> np.ndarray:
    """Coordinates (3 n_side^3, 3) of one frame, in [0, L)."""
    L = box_length(n_side)
    n_mol = n_side ** 3
    a = L / n_side
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) * a + a / 2
    mol = np.empty((n_mol, 3, 3))
    todo = np.arange(n_mol)
    pairs = _molecule_pairs(n_side)
    for _ in range(1000):
        o = grid[todo] + g.uniform(-JITTER_A, JITTER_A, size=(len(todo), 3))
        mol[todo, 0] = o
        mol[todo, 1:] = o[:, None, :] + _hydrogens(g, len(todo))
        todo = _clashes(mol, pairs, L)
        if not len(todo):
            break
    else:
        raise RuntimeError("water_frame: molecules still clash")
    x = np.concatenate([mol[:, 0], mol[:, 1:].reshape(-1, 3)])
    return x - L * np.floor(x / L)


def water_frames(g: np.random.Generator, n_frames: int,
                 n_side: int) -> np.ndarray:
    return np.stack([water_frame(g, n_side) for _ in range(n_frames)])


def velocities(g: np.random.Generator, masses: np.ndarray, T0: float,
               kb: float, f_over_m: float) -> np.ndarray:
    """Maxwell-Boltzmann velocities at T0 with no net momentum, scaled to
    exactly T0 over 3N degrees of freedom (LAMMPS `velocity create`
    with the program's count of degrees of freedom)."""
    v = g.normal(size=(masses.shape[0], 3)) \
        * np.sqrt(kb * T0 * f_over_m / masses[:, None])
    v -= (masses[:, None] * v).sum(0) / masses.sum()
    T = (masses[:, None] * v * v).sum() / f_over_m / (3 * len(masses) * kb)
    return v * np.sqrt(T0 / T)

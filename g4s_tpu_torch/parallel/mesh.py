"""Rank grids over torch.distributed (counterpart of
g4s_tpu/parallel/mesh.py).

The reference's processor grid (CitcomS's nprocx*nprocy*nprocz bricks,
citcoms/lib/Regional_parallel_related.c:213; the 12-cap layout,
Full_parallel_related.c:249) is one `jax.sharding.Mesh` with named axes.
Here it is one process per rank: `init_ranks` joins the process group
(NCCL with one card per rank, or gloo on the CPU) and a `RankGrid` names
the axes, gives this rank's coordinates and holds the sub-communicators
(Regional_parallel_related.c:134-204) for every axis and axis subset.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AxisNames = Union[str, Sequence[str], None]


def device_mesh_shape(n_devices: int, n_axes: int) -> tuple:
    """Factor n_devices into a near-cubic n_axes-dim grid (largest factors
    last so the fastest-varying axis maps to adjacent devices/ICI links)."""
    shape = [1] * n_axes
    remaining = n_devices
    for i in range(n_axes - 1, -1, -1):
        # greedy: largest divisor <= remaining ** (1/(i+1))
        target = round(remaining ** (1.0 / (i + 1)))
        d = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                d = cand
                break
        shape[i] = d
        remaining //= d
    shape[-1] *= remaining  # any residue
    assert int(np.prod(shape)) == n_devices
    return tuple(shape)


def init_ranks(world: int, rank: int, *, device="cuda",
               init_method: str = "env://",
               local_rank: Optional[int] = None) -> torch.device:
    """Join the process group of `world` ranks as `rank` and return the
    rank's device.

    device="cuda" takes the NCCL backend with the rank on its own card,
    cuda:{local_rank} (local_rank defaults to rank: one host). It raises
    without a card and when more ranks are asked for than cards are
    visible: it never shares a card between ranks and never falls back to
    gloo. device="cpu" takes gloo. One all-reduce over every rank ends the
    call, so the communicator exists before any exchange between a subset
    of ranks."""
    kind = torch.device(device).type
    local = rank if local_rank is None else local_rank
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' asked for, but torch sees no CUDA card; pass "
                "device='cpu' to run the ranks on the CPU with gloo")
        cards = torch.cuda.device_count()
        if world > cards or not 0 <= local < cards:
            raise RuntimeError(
                f"{world} ranks asked for on {cards} visible CUDA cards: "
                "each rank needs a card of its own (NCCL)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world, rank=rank, device_id=dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)
    else:
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    warm = torch.ones((), device=dev)
    dist.all_reduce(warm)
    if int(warm.item()) != world:
        raise RuntimeError(f"all-reduce over {world} ranks gave {warm}")
    return dev


def init_from_env(device="cuda") -> torch.device:
    """init_ranks from the RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT environment variables (what parallel.launch sets)."""
    return init_ranks(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                      device=device,
                      local_rank=int(os.environ.get("LOCAL_RANK",
                                                    os.environ["RANK"])))


class RankGrid:
    """Named axes over the ranks of the default group (make_mesh's
    counterpart): rank r sits at np.unravel_index(r, sizes), so the last
    axis varies fastest (two axes ("bx", "by"): r = bx * py + by, as
    combine.rank_node_grid enumerates the bricks).

    The sub-communicators of every axis subset are built once, here, in
    the same order on every rank (dist.new_group must be called so)."""

    def __init__(self, axis_names: Sequence[str],
                 axis_sizes: Optional[Sequence[int]] = None):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.names = tuple(axis_names)
        if axis_sizes is None:
            axis_sizes = device_mesh_shape(self.world, len(self.names))
        self.sizes = tuple(int(s) for s in axis_sizes)
        if int(np.prod(self.sizes)) != self.world:
            raise ValueError(
                f"grid {self.sizes} needs {int(np.prod(self.sizes))} ranks, "
                f"have {self.world}")
        self._ranks = np.arange(self.world).reshape(self.sizes)
        self.coords: Dict[str, int] = dict(zip(
            self.names, (int(c) for c in np.unravel_index(self.rank,
                                                          self.sizes))))
        self._groups: Dict[Tuple[str, ...], Optional[object]] = {}
        for k in range(1, len(self.names) + 1):
            for subset in itertools.combinations(self.names, k):
                if k == len(self.names):
                    self._groups[subset] = None      # the default group
                    continue
                keep = [self.names.index(a) for a in subset]
                rest = [i for i in range(len(self.names)) if i not in keep]
                moved = np.moveaxis(self._ranks, rest, range(len(rest)))
                for members in moved.reshape(-1, int(np.prod(
                        [self.sizes[i] for i in keep]))):
                    g = dist.new_group([int(r) for r in members])
                    if self.rank in members:
                        self._groups[subset] = g

    def size(self, axes: AxisNames = None) -> int:
        return int(np.prod([self.sizes[self.names.index(a)]
                            for a in self.axes(axes)]))

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (lax.axis_index)."""
        return self.coords[axis]

    def axes(self, axes: AxisNames) -> Tuple[str, ...]:
        """Axis names in grid order: None means every axis."""
        if axes is None:
            return self.names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.names)
        if unknown:
            raise ValueError(f"no axis {sorted(unknown)} in {self.names}")
        return tuple(a for a in self.names if a in axes)

    def group(self, axes: AxisNames = None):
        """The process group of the ranks that share this rank's
        coordinates off `axes` (None: the default group)."""
        return self._groups[self.axes(axes)]

    def neighbor(self, axis: str, shift: int) -> Optional[int]:
        """Global rank `shift` steps along `axis`, or None past an end."""
        i = self.names.index(axis)
        c = [self.coords[a] for a in self.names]
        c[i] += shift
        if not 0 <= c[i] < self.sizes[i]:
            return None
        return int(self._ranks[tuple(c)])

"""Full-sphere 12-cap communication topology (a pure-Python copy of
g4s_tpu/parallel/sphere.py).

CitcomS covers the sphere with 12 caps, each an nprocx x nprocy x nprocz
processor brick; cap seams need axis-permuted exchanges because adjacent
caps' local coordinate systems differ. This module rebuilds the neighbor
tables of full_parallel_communication_routs_v
(citcoms/lib/Full_parallel_related.c:505-715) as static Python data:

  per processor (cap, lx, ly, lz):
    - up to 4 horizontal face passes (-X/+X/-Y/+Y). Interior passes target
      the adjacent brick in the same cap (plain shift); seam passes follow
      the cap%3 family rules (:536-600), some with an x/y TRANSPOSITION of
      the brick coordinates (the axis-permuted gathers of the spec);
    - 4 diagonal Z-line (edge) passes, skipped at the two polar corners of
      each family, with the opposite-cap (cap+6)%12 pairing at the poles
      (:602-666);
    - 1-2 vertical passes (lz +/- 1, :674-715).

They become a static list of (send rank -> recv rank, transpose?) pairs,
built once, as the reference builds its pass tables once at
initial_setup; the element-sharded full sphere (full_driver.
shard_full_sphere) needs none of them, since its nodal fields are
replicated and every element-to-node scatter ends in one all-reduce.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple


class Pass(NamedTuple):
    kind: str                 # 'face' | 'edge' | 'vertical'
    direction: str            # '-x' | '+x' | '-y' | '+y' | 'z-' | 'z+' | edge id
    target: Tuple[int, int, int, int]   # (cap, lx, ly, lz)
    transposed: bool          # seam exchange needs x/y index transposition


def proc_id(cap: int, lx: int, ly: int, lz: int,
            px: int, py: int, pz: int) -> int:
    return ((cap * px + lx) * py + ly) * pz + lz


def face_neighbor(cap: int, lx: int, ly: int, lz: int, direction: str,
                  px: int, py: int, pz: int) -> Optional[Pass]:
    """One horizontal face pass (Full_parallel_related.c:536-600)."""
    fam = cap % 3
    if direction == "-x":
        if lx > 0:
            return Pass("face", "-x", (cap, lx - 1, ly, lz), False)
        if fam != 0:   # plain seam shift to cap+2
            return Pass("face", "-x", ((cap + 2) % 12, px - 1, ly, lz), False)
        # family-0 seam: transposed target [ly][0]
        return Pass("face", "-x", ((cap + 3) % 12, ly, 0, lz), True)
    if direction == "+x":
        if lx < px - 1:
            return Pass("face", "+x", (cap, lx + 1, ly, lz), False)
        if fam != 2:
            return Pass("face", "+x", ((cap - 2) % 12, 0, ly, lz), False)
        return Pass("face", "+x", ((cap - 3) % 12, ly, py - 1, lz), True)
    if direction == "-y":
        if ly > 0:
            return Pass("face", "-y", (cap, lx, ly - 1, lz), False)
        if fam != 0:
            return Pass("face", "-y", ((cap - 1) % 12, lx, py - 1, lz), False)
        return Pass("face", "-y", ((cap - 3) % 12, 0, lx, lz), True)
    if direction == "+y":
        if ly < py - 1:
            return Pass("face", "+y", (cap, lx, ly + 1, lz), False)
        if fam != 2:
            return Pass("face", "+y", ((cap + 1) % 12, lx, 0, lz), False)
        return Pass("face", "+y", ((cap + 3) % 12, px - 1, lx, lz), True)
    raise ValueError(direction)


_POLAR_SKIP = {
    # (family, corner): the two polar corner cases where a Z-line pass is
    # skipped (Full_parallel_related.c:605, :623 and analogs)
    ("-x-y", 1), ("+x+y", 1),
    ("-x-y", 2), ("+x+y", 2),   # handled by opposite-cap pairing below
}


def edge_passes(cap: int, lx: int, ly: int, lz: int,
                px: int, py: int, pz: int) -> List[Pass]:
    """Diagonal Z-line passes (:602-666): combinations of two face hops.

    The four diagonals (-x,-y), (-x,+y), (+x,-y), (+x,+y). Each is the
    face-pass composition; at the two polar corners the diagonal pairs
    with the OPPOSITE cap (cap+6)%12 (:607-609, :625-627); at non-existent
    diagonals (family-dependent) the pass is skipped.
    """
    fam = cap % 3
    out: List[Pass] = []
    for dx, dy, name in [("-x", "-y", "-x-y"), ("-x", "+y", "-x+y"),
                         ("+x", "-y", "+x-y"), ("+x", "+y", "+x+y")]:
        at_x_seam = (lx == 0 and dx == "-x") or (lx == px - 1 and dx == "+x")
        at_y_seam = (ly == 0 and dy == "-y") or (ly == py - 1 and dy == "+y")
        if at_x_seam and at_y_seam:
            # cap corner: polar pairing or skip
            if fam == 1 and name == "-x-y":
                if dx == "-x" and dy == "-y":
                    out.append(Pass("edge", name,
                                    ((cap + 6) % 12, 0, 0, lz), True))
                continue
            if fam == 2 and name == "+x+y":
                out.append(Pass("edge", name,
                                ((cap + 6) % 12, px - 1, py - 1, lz), True))
                continue
            # other corner diagonals do not exist on the cubed sphere
            # (three caps meet at those corners; face passes cover them)
            continue
        # otherwise compose the two face hops
        p1 = face_neighbor(cap, lx, ly, lz, dx, px, py, pz)
        if p1 is None:
            continue
        c2, x2, y2, z2 = p1.target
        if p1.transposed:
            # after a transposed hop the y-direction maps to x
            dy2 = {"-y": "-x", "+y": "+x"}[dy]
        else:
            dy2 = dy
        p2 = face_neighbor(c2, x2, y2, z2, dy2, px, py, pz)
        if p2 is None:
            continue
        out.append(Pass("edge", name, p2.target,
                        p1.transposed ^ p2.transposed))
    return out


def vertical_passes(cap: int, lx: int, ly: int, lz: int,
                    px: int, py: int, pz: int) -> List[Pass]:
    out = []
    if lz > 0:
        out.append(Pass("vertical", "z-", (cap, lx, ly, lz - 1), False))
    if lz < pz - 1:
        out.append(Pass("vertical", "z+", (cap, lx, ly, lz + 1), False))
    return out


def build_pass_tables(px: int = 1, py: int = 1, pz: int = 1
                      ) -> Dict[Tuple[int, int, int, int], List[Pass]]:
    """All passes for every processor (full_parallel_communication_routs_v)."""
    tables = {}
    for cap in range(12):
        for lx in range(px):
            for ly in range(py):
                for lz in range(pz):
                    ps: List[Pass] = []
                    for d in ("-x", "+x", "-y", "+y"):
                        p = face_neighbor(cap, lx, ly, lz, d, px, py, pz)
                        if p is not None:
                            ps.append(p)
                    ps.extend(edge_passes(cap, lx, ly, lz, px, py, pz))
                    ps.extend(vertical_passes(cap, lx, ly, lz, px, py, pz))
                    tables[(cap, lx, ly, lz)] = ps
    return tables


def ppermute_pairs(tables, px: int, py: int, pz: int, *,
                   kind: Optional[str] = None,
                   direction: Optional[str] = None):
    """Flatten a pass table into (src, dst) rank pairs."""
    pairs = []
    for (cap, lx, ly, lz), ps in tables.items():
        src = proc_id(cap, lx, ly, lz, px, py, pz)
        for p in ps:
            if kind and p.kind != kind:
                continue
            if direction and p.direction != direction:
                continue
            pairs.append((src, proc_id(*p.target, px, py, pz)))
    return pairs


def check_reciprocity(tables, px: int, py: int, pz: int) -> bool:
    """Every pass must have a reverse pass (MPI_Sendrecv pairing)."""
    edges = set()
    for (cap, lx, ly, lz), ps in tables.items():
        src = (cap, lx, ly, lz)
        for p in ps:
            edges.add((src, p.target))
    return all((b, a) in edges for (a, b) in edges)

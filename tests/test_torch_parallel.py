"""Parity of g4s_tpu_torch.parallel and the row-sharded sparse products
(ops/dist_spmv.py, ops/dist_spgemm.py) with g4s_tpu's.

The port's side runs on 2 and 4 gloo ranks, one CPU process each, started
once per rank count by a module fixture (parallel.launch.run_ranks); the
reference's side is its shard_map over as many of the virtual CPU devices
(tests/conftest.py), at tests/test_parallel.py's shapes. Every input is
drawn from a seed with numpy, the same on both sides.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from g4s_tpu.ops import dist_spgemm as j_dspgemm
from g4s_tpu.ops import dist_spmv as j_dspmv
from g4s_tpu.parallel import collectives as j_coll
from g4s_tpu.parallel import halo as j_halo
from g4s_tpu.parallel import mesh as j_mesh
from g4s_tpu.parallel import sphere as j_sphere
from g4s_tpu.sparse.containers import CSR as JCSR
from g4s_tpu_torch.parallel import launch, mesh as p_mesh
from g4s_tpu_torch.parallel import sphere as p_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the inputs, drawn the same in this process and in every rank's (the
# worker runs this source too, without importing jax)
_INPUTS = r"""
import numpy as np
import scipy.sparse as sp


def _stencil(nx: int, seed: int):
    # a 3D 7-point stencil with random values, renumbered at random
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr()
    rng = np.random.default_rng(seed)
    a.data = rng.uniform(0.5, 1.5, a.nnz)
    pp = rng.permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def _er(n: int, deg: int, seed: int):
    r = np.random.RandomState(seed)
    return sp.coo_matrix((r.rand(n * deg), (r.randint(0, n, n * deg),
                                            r.randint(0, n, n * deg))),
                         shape=(n, n)).tocsr()


def _inputs(world: int) -> dict:
    # every case's inputs for `world` ranks
    rng = np.random.default_rng(0)
    return dict(
        halo1d=np.random.default_rng(0).normal(size=(world, 5, 3)),
        halo2d=np.random.default_rng(1).normal(size=(2, world // 2, 3, 4)),
        ghost=np.repeat(np.arange(world, dtype=np.float64)[:, None], 3, 1),
        g=np.random.default_rng(2).normal(size=world * 4 + 1),
        x=rng.permutation(world * 4).astype(np.float64),
        spmv=_stencil(5, 3), spgemm=_er(150, 4, 4),
        vec=np.random.default_rng(5).standard_normal(125))
"""
exec(_INPUTS)


_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from g4s_tpu_torch.parallel import (RankGrid, halo_copy_ghost,
                                    halo_exchange_add, init_from_env, pdot,
                                    pmax, pmin, pnorm2)
from g4s_tpu_torch.ops.dist_spmv import (all_gather_rows, dist_spmv,
                                         shard_rows_ell)
from g4s_tpu_torch.ops.dist_spgemm import (dist_spgemm, dist_spgemm_numeric,
                                           shard_spgemm_plan)
from g4s_tpu_torch.sparse import CSR
init_from_env("cpu")
line = RankGrid(("x",))
r, w = line.rank, line.world
inp = _inputs(w)
t = torch.from_numpy
out = {}
out["halo1d"] = halo_exchange_add(t(inp["halo1d"][r]), line, [("x", 0)])
sq = RankGrid(("x", "y"), (2, w // 2))
i, j = sq.index("x"), sq.index("y")
out["halo2d"] = halo_exchange_add(t(inp["halo2d"][i, j]), sq,
                                  [("x", 0), ("y", 1)])
out["ghost"] = halo_copy_ghost(t(inp["ghost"][r]), line, [("x", 0)])
blk = t(inp["g"][r * 4:r * 4 + 5])
own = torch.ones(5, dtype=torch.float64)
if r > 0:
    own[0] = 0.0
out["pdot"] = pdot(blk, blk, line, weight=own)
out["pnorm2"] = pnorm2(blk, line, "x", weight=own)
xb = t(inp["x"][r * 4:(r + 1) * 4])
out["pmax"], out["pmin"] = pmax(xb, line), pmin(xb, line)
# sub-communicators of the 2-D grid: sums along each axis
out["psum_x"] = pdot(xb, torch.ones_like(xb), sq, "x")
out["psum_y"] = pdot(xb, torch.ones_like(xb), sq, "y")
a = CSR.from_scipy(inp["spmv"])
ell, rows_per, shape = shard_rows_ell(a, w, r, pad_to=8, device="cpu")
out["spmv_block"] = dist_spmv(ell, t(inp["vec"]))
out["spmv"] = all_gather_rows(out["spmv_block"], line, n_rows=shape[0])
b = CSR.from_scipy(inp["spgemm"])
bp = shard_spgemm_plan(b, b, w, r, device="cpu")
out["spgemm_block"] = dist_spgemm_numeric(bp, b.data, b.data)
c = dist_spgemm(b, b, line, device="cpu")
out["spgemm_indptr"], out["spgemm_indices"], out["spgemm_data"] = (
    c.indptr, c.indices, c.data)
np.savez(os.path.join(sys.argv[2], f"rank{r}.npz"),
         **{k: v.numpy() for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's outputs, rank 1's, ...]} from one run of the
    worker on each world's gloo ranks."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"parallel{world}")
        launch.run_ranks(world, lambda r: [
            sys.executable, "-c", _INPUTS + _WORKER, "", str(d)], env=env,
            cwd=REPO, timeout=300)
        out[world] = [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(world)]
    return out


def _line_mesh(world):
    return j_mesh.make_mesh(("x",), (world,), devices=jax.devices()[:world])


# ------------------------------------------------------------- no ranks


@pytest.mark.parametrize("n,axes", [(8, 3), (8, 1), (6, 2), (1, 2), (4, 2),
                                    (12, 3), (7, 2), (16, 2)])
def test_device_mesh_shape_matches(n, axes):
    assert p_mesh.device_mesh_shape(n, axes) == \
        j_mesh.device_mesh_shape(n, axes)


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2), (3, 3, 1)])
def test_sphere_pass_tables_match(grid):
    """The 12-cap pass tables, their rank pairs per kind and direction,
    and reciprocity equal the reference's."""
    pt, jt = p_sphere.build_pass_tables(*grid), j_sphere.build_pass_tables(
        *grid)
    assert len(pt) == 12 * int(np.prod(grid))
    assert {k: [tuple(p) for p in v] for k, v in pt.items()} == \
        {k: [tuple(p) for p in v] for k, v in jt.items()}
    for kind, direction in ((None, None), ("face", "-x"), ("edge", None),
                            ("vertical", "z+")):
        assert p_sphere.ppermute_pairs(pt, *grid, kind=kind,
                                       direction=direction) == \
            j_sphere.ppermute_pairs(jt, *grid, kind=kind,
                                    direction=direction)
    assert p_sphere.check_reciprocity(pt, *grid)
    assert j_sphere.check_reciprocity(jt, *grid)


# ----------------------------------------------------------- halo, reductions


@pytest.mark.parametrize("world", WORLDS)
def test_halo_add_1d_matches(ranks, world):
    inp = _inputs(world)
    f = shard_map(lambda u: j_halo.halo_exchange_add(u, [("x", 0)]),
                  mesh=_line_mesh(world), in_specs=P("x"), out_specs=P("x"))
    want = np.asarray(f(jnp.asarray(inp["halo1d"].reshape(world * 5, 3))))
    got = np.stack([r["halo1d"] for r in ranks[world]])
    np.testing.assert_array_equal(got.reshape(world * 5, 3), want)


@pytest.mark.parametrize("world", WORLDS)
def test_halo_add_2d_corners_match(ranks, world):
    """Blocks of 3x4 on a 2 x world/2 grid: corners take every diagonal
    neighbour's part, as the reference's two exchanges in turn give."""
    inp = _inputs(world)
    py = world // 2
    mesh = j_mesh.make_mesh(("x", "y"), (2, py), devices=jax.devices()[:world])
    f = shard_map(lambda u: j_halo.halo_exchange_add(u, [("x", 0), ("y", 1)]),
                  mesh=mesh, in_specs=P("x", "y"), out_specs=P("x", "y"))
    parts = inp["halo2d"]
    out = np.asarray(f(jnp.asarray(parts.transpose(0, 2, 1, 3)
                                   .reshape(2 * 3, py * 4))))
    want = out.reshape(2, 3, py, 4).transpose(0, 2, 1, 3)
    got = np.stack([r["halo2d"] for r in ranks[world]]).reshape(2, py, 3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    if py > 1:       # the centre node sums all four blocks
        assert got[0, 0, -1, -1] == pytest.approx(sum(
            parts[i, j, 2 * (1 - i), 3 * (1 - j)] for i in range(2)
            for j in range(2)), rel=1e-14)


@pytest.mark.parametrize("world", WORLDS)
def test_halo_replace_matches(ranks, world):
    inp = _inputs(world)
    f = shard_map(lambda u: j_halo.halo_copy_ghost(u, [("x", 0)]),
                  mesh=_line_mesh(world), in_specs=P("x"), out_specs=P("x"))
    want = np.asarray(f(jnp.asarray(inp["ghost"].reshape(-1)))).reshape(
        world, 3)
    got = np.stack([r["ghost"] for r in ranks[world]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_weighted_reductions_match(ranks, world):
    """pdot with ownership weights and pnorm2 (each shared node once), pmax,
    pmin and the sums along each axis of a 2-D grid, on every rank, against
    the reference's psum/pmax/pmin and numpy."""
    inp = _inputs(world)
    g, x = inp["g"], inp["x"]
    blocks = np.stack([g[r * 4:r * 4 + 5] for r in range(world)])
    w = np.ones_like(blocks)
    w[1:, 0] = 0.0
    f = shard_map(lambda u, wt: jnp.full_like(u, j_coll.pdot(u, u, "x",
                                                             weight=wt)),
                  mesh=_line_mesh(world), in_specs=(P("x"), P("x")),
                  out_specs=P("x"))
    want = float(np.asarray(f(jnp.asarray(blocks.reshape(-1)),
                              jnp.asarray(w.reshape(-1))))[0])
    assert want == pytest.approx(g @ g, rel=1e-13)
    fm = shard_map(lambda u: jnp.stack([j_coll.pmax(u, "x"),
                                        j_coll.pmin(u, "x")]),
                   mesh=_line_mesh(world), in_specs=P("x"), out_specs=P())
    jmax, jmin = np.asarray(fm(jnp.asarray(x)))
    xs = x.reshape(2, world // 2, 4)
    for r, out in enumerate(ranks[world]):
        assert float(out["pdot"]) == pytest.approx(want, rel=1e-13)
        assert float(out["pnorm2"]) == pytest.approx(np.sqrt(want),
                                                     rel=1e-13)
        assert float(out["pmax"]) == jmax and float(out["pmin"]) == jmin
        i, j = divmod(r, world // 2)
        assert float(out["psum_x"]) == xs[:, j].sum()
        assert float(out["psum_y"]) == xs[i].sum()


# ------------------------------------------------------ row-sharded products


@pytest.mark.parametrize("world", WORLDS)
def test_dist_spmv_matches(ranks, world):
    """Each rank's ELL row block and y = A x gathered: the reference's
    shard_map blocks and scipy's y within 1e-14."""
    inp = _inputs(world)
    a, x = inp["spmv"], inp["vec"]
    cols, vals, rows_per, shape = j_dspmv.shard_rows_ell(
        JCSR(a.indptr, a.indices, a.data, a.shape), world)
    y = np.asarray(j_dspmv.dist_spmv(_line_mesh(world), "x", cols, vals,
                                     shape, jnp.asarray(x)))
    got_blocks = np.stack([r["spmv_block"] for r in ranks[world]])
    # XLA and torch add a row's seven products in other orders
    np.testing.assert_allclose(got_blocks.reshape(-1), y.reshape(-1),
                               rtol=1e-14, atol=1e-14)
    for out in ranks[world]:
        assert out["spmv"].shape == (a.shape[0],)
        np.testing.assert_allclose(out["spmv"], a @ x, rtol=1e-14)


@pytest.mark.parametrize("world", WORLDS)
def test_dist_spgemm_matches(ranks, world):
    """Each rank's numeric block (no communication) equals the reference's
    shard_map block, and the gathered C has scipy's structure and values
    within 1e-14, on every rank."""
    inp = _inputs(world)
    b = inp["spgemm"]
    jb = JCSR(b.indptr, b.indices, b.data, b.shape)
    stacked, meta = j_dspgemm.shard_spgemm_plan(jb, jb, world)
    blocks = np.asarray(j_dspgemm.dist_spgemm_numeric(
        _line_mesh(world), "x", stacked, meta["nnz_max"], b.data, b.data))
    jc = j_dspgemm.dist_spgemm(jb, jb, _line_mesh(world), "x")
    ref = (b @ b).tocsr()
    ref.sort_indices()
    for r, out in enumerate(ranks[world]):
        nnz = meta["blocks"][r]["nnz"]
        np.testing.assert_allclose(out["spgemm_block"], blocks[r, :nnz],
                                   rtol=1e-15, atol=0)
        np.testing.assert_array_equal(out["spgemm_indptr"], ref.indptr)
        np.testing.assert_array_equal(out["spgemm_indices"], ref.indices)
        np.testing.assert_array_equal(out["spgemm_indptr"],
                                      np.asarray(jc.indptr))
        np.testing.assert_allclose(out["spgemm_data"], ref.data, rtol=1e-14)
        np.testing.assert_allclose(out["spgemm_data"], np.asarray(jc.data),
                                   rtol=1e-15)

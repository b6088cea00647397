"""Parity of g4s_tpu_torch.sparse with g4s_tpu.sparse: the same .mtx file and
the same CSR give identical arrays in both packages (host numpy algorithms
on both sides, so every comparison is exact)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import g4s_tpu.sparse as ref
import g4s_tpu_torch.sparse as port
from g4s_tpu_torch.ops import segment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b):
    """Exact equality of values and dtype."""
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


def _same_csr(p, r):
    assert tuple(p.shape) == tuple(r.shape)
    for f in ("indptr", "indices", "data"):
        _same(getattr(p, f), getattr(r, f))


def _random(seed=0, n_rows=60, n_cols=50, density=0.08, dups=True):
    rng = np.random.default_rng(seed)
    nnz = int(n_rows * n_cols * density)
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_cols, nnz)
    if dups:
        r, c = np.r_[r, r[:5]], np.r_[c, c[:5]]
    v = rng.standard_normal(r.size)
    return r, c, v, (n_rows, n_cols)


def test_package_imports_no_jax():
    code = ("import sys, g4s_tpu_torch, g4s_tpu_torch.engine, "
            "g4s_tpu_torch.ops, g4s_tpu_torch.kernels._build, "
            "g4s_tpu_torch.models.deepmd, g4s_tpu_torch.drivers.dp, "
            "g4s_tpu_torch.ops.static_spmv, "
            "g4s_tpu_torch.drivers.static_spmv, g4s_tpu_torch.ckpt, "
            "g4s_tpu_torch.models.deepmd.train, "
            "g4s_tpu_torch.models.deepmd.fit_dos, "
            "g4s_tpu_torch.models.deepmd.fit_tensor, "
            "g4s_tpu_torch.models.deepmd.spin, "
            "g4s_tpu_torch.models.deepmd.dplr, "
            "g4s_tpu_torch.models.deepmd.calculator, "
            "g4s_tpu_torch.models.deepmd.ipi, "
            "g4s_tpu_torch.models.deepmd.nvnmd, "
            "g4s_tpu_torch.models.cantera, g4s_tpu_torch.ops.odeint, "
            "g4s_tpu_torch.drivers.shock_tube, "
            "g4s_tpu_torch.models.citcoms, "
            "g4s_tpu_torch.models.citcoms.multigrid, "
            "g4s_tpu_torch.models.citcoms.tracers, "
            "g4s_tpu_torch.models.citcoms.phase_change, "
            "g4s_tpu_torch.models.citcoms.anisotropic, "
            "g4s_tpu_torch.models.citcoms.lith_age, "
            "g4s_tpu_torch.models.citcoms.bc_files, "
            "g4s_tpu_torch.models.citcoms.sphere_harmonics, "
            "g4s_tpu_torch.models.citcoms.observables, "
            "g4s_tpu_torch.models.citcoms.output, "
            "g4s_tpu_torch.models.citcoms.vtk, "
            "g4s_tpu_torch.models.citcoms.full_mesh, "
            "g4s_tpu_torch.models.citcoms.full_driver, "
            "g4s_tpu_torch.models.citcoms.full_tracers, "
            "g4s_tpu_torch.models.citcoms.exchanger, "
            "g4s_tpu_torch.models.citcoms.netcdf3, "
            "g4s_tpu_torch.models.citcoms.ggrd, "
            "g4s_tpu_torch.models.citcoms.mineral_physics, "
            "g4s_tpu_torch.drivers.citcoms_regional, "
            "g4s_tpu_torch.parallel, g4s_tpu_torch.parallel.mesh, "
            "g4s_tpu_torch.parallel.collectives, "
            "g4s_tpu_torch.parallel.halo, g4s_tpu_torch.parallel.sphere, "
            "g4s_tpu_torch.parallel.launch, g4s_tpu_torch.ops.dist_spmv, "
            "g4s_tpu_torch.ops.dist_spgemm, "
            "g4s_tpu_torch.models.citcoms.distributed, "
            "g4s_tpu_torch.models.citcoms.combine, "
            "g4s_tpu_torch.models.cantera.shock_tube, "
            "g4s_tpu_torch.drivers.multichip, "
            "g4s_tpu_torch.models.cantera.transport, "
            "g4s_tpu_torch.models.cantera.multi_transport, "
            "g4s_tpu_torch.models.cantera.transport_models, "
            "g4s_tpu_torch.models.cantera.equilibrium, "
            "g4s_tpu_torch.models.cantera.solution_array, "
            "g4s_tpu_torch.models.cantera.surface, "
            "g4s_tpu_torch.models.cantera.flame, "
            "g4s_tpu_torch.models.cantera.water, "
            "g4s_tpu_torch.models.cantera.condensed, "
            "g4s_tpu_torch.models.cantera.electrolyte, "
            "g4s_tpu_torch.models.cantera.hkft, "
            "g4s_tpu_torch.models.cantera.hmw, "
            "g4s_tpu_torch.models.cantera.purefluid, "
            "g4s_tpu_torch.models.cantera.plasma, "
            "g4s_tpu_torch.models.cantera.vcs_multiphase, "
            "g4s_tpu_torch.ops.banded, g4s_tpu_torch.runtime.native_lib, "
            "g4s_tpu_torch.runtime.capi_impl, g4s_tpu_torch.obs.profile; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'g4s_tpu.')) or m == 'g4s_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("trail", [(), (3,), (2, 5), "layer_sums"])
def test_sorted_segment_sum_matches_jax(dtype, trail):
    """The plain version against jax.ops.segment_sum(indices_are_sorted=
    True) on sorted ids that leave segments empty (and ids past the last
    row), with trailing dims; the `order` form gathers rows first. Both sum
    each segment in index order on the CPU: f32 within 1e-6, f64 1e-14.
    "layer_sums" is the shape of CitcomS's buoyancy layer sums: 9 runs of
    1,089 rows, one column, int32 ids."""
    import jax
    import jax.numpy as jnp
    layers = trail == "layer_sums"
    trail = () if layers else trail
    rng = np.random.default_rng(7 if layers else len(trail))
    if layers:
        num = 9
        ids = np.sort(np.arange(num * 1089) % num).astype(np.int32)
    else:
        num = 40
        ids = np.sort(rng.integers(0, num + 5, 300))
        ids = ids[(ids % 7 != 3) & (ids < num)]
    data = rng.standard_normal((ids.size,) + trail).astype(dtype)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(data), jnp.asarray(ids), num_segments=num,
        indices_are_sorted=True))
    got = segment.sorted_segment_sum(torch.from_numpy(data),
                                     torch.from_numpy(ids), num)
    assert got.dtype == torch.from_numpy(data).dtype
    assert got.shape == (num,) + trail
    assert layers or not got[3].any()    # segment 3 is left empty
    tol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    perm = rng.permutation(ids.size)
    shuffled = torch.from_numpy(data[perm])
    got_o = segment.sorted_segment_sum(
        shuffled, torch.from_numpy(ids), num,
        order=torch.from_numpy(np.argsort(perm)))
    assert torch.equal(got_o, got)
    assert torch.equal(segment.segment_sum(
        torch.from_numpy(data), torch.from_numpy(ids), num,
        indices_are_sorted=True), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sorted_segment_sum_of_nothing(dtype):
    import jax
    import jax.numpy as jnp
    got = segment.sorted_segment_sum(torch.zeros((0, 3), dtype=dtype),
                                     torch.zeros(0, dtype=torch.int64), 4)
    want = jax.ops.segment_sum(jnp.zeros((0, 3)), jnp.zeros(0, jnp.int32),
                               num_segments=4, indices_are_sorted=True)
    assert got.shape == want.shape == (4, 3) and not got.any()


def test_sorted_segment_sum_index_dtype():
    """The kernel reads int32 ids and order where the ids come as int32
    and every row and segment fits below 2^31 - 1; int64 and other integer
    ids go as int64."""
    ids32 = torch.zeros(4, dtype=torch.int32)
    assert segment._index_dtype(ids32, 4, 10) == torch.int32
    assert segment._index_dtype(ids32, 2**31 - 1, 10) == torch.int64
    assert segment._index_dtype(ids32, 4, 2**31 - 1) == torch.int64
    assert segment._index_dtype(ids32.long(), 4, 10) == torch.int64
    assert segment._index_dtype(ids32.short(), 4, 10) == torch.int64


def test_sorted_segment_sum_refuses_other_devices():
    """Only a CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises, and any other device raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        segment.sorted_segment_sum(torch.zeros(4, device="meta"),
                                   torch.zeros(4, dtype=torch.int64,
                                               device="meta"), 2)


@pytest.mark.parametrize("kind", ["general", "symmetric", "skew-symmetric",
                                  "pattern"])
def test_read_mtx_parity(tmp_path, kind):
    a = sp.random(40, 40, density=0.1, random_state=2, format="coo")
    if kind == "symmetric":
        a = (a + a.T).tocoo()
    elif kind == "skew-symmetric":
        a = (a - a.T).tocoo()
    path = tmp_path / "a.mtx"
    field = "pattern" if kind == "pattern" else "real"
    scipy.io.mmwrite(str(path), a, field=field,
                     symmetry="general" if kind == "pattern" else kind)
    _same_csr(port.read_mtx_csr(path), ref.read_mtx_csr(path))
    pc, rc = port.read_mtx(path), ref.read_mtx(path)
    for f in ("row", "col", "val"):
        _same(getattr(pc, f), getattr(rc, f))
    dense = port.read_mtx_csr(path).to_scipy().toarray()
    want = scipy.io.mmread(str(path)).toarray()
    np.testing.assert_array_equal(dense, want)


def test_read_mtx_rejects_hermitian(tmp_path):
    path = tmp_path / "h.mtx"
    path.write_text("%%MatrixMarket matrix coordinate complex hermitian\n"
                    "2 2 1\n1 1 1.0 0.0\n")
    for mod in (port, ref):
        with pytest.raises(ValueError):
            mod.read_mtx(path)


def test_write_mtx_read_by_reference(tmp_path):
    r, c, v, shape = _random(3)
    path = tmp_path / "w.mtx"
    port.write_mtx(path, port.COO(torch.from_numpy(r), torch.from_numpy(c),
                                  torch.from_numpy(v), shape))
    back = ref.read_mtx_csr(path)
    _same_csr(port.read_mtx_csr(path), back)
    want = sp.coo_matrix((v, (r, c)), shape=shape).tocsr()
    np.testing.assert_array_equal(back.to_scipy().toarray(), want.toarray())


def test_read_gtgraph_parity(tmp_path):
    path = tmp_path / "g.gr"
    path.write_text("c toy\np sp 5 6\na 1 2 1.5\na 2 3 2.0\na 1 2 0.5\n"
                    "a 5 1 3.0\na 3 4 1.0\na 4 5 4.0\n")
    _same_csr(port.read_gtgraph(path), ref.read_gtgraph(path))


@pytest.mark.parametrize("conv", ["coo_to_csr", "coo_to_csr_sum",
                                  "csr_to_csc", "csc_to_csr",
                                  "merge_duplicates", "crop", "dense"])
def test_compressed_conversions(conv):
    r, c, v, shape = _random(4)
    rc = ref.COO(r.astype(np.int32), c.astype(np.int32), v, shape)
    pc = port.COO(torch.from_numpy(r.astype(np.int32)),
                  torch.from_numpy(c.astype(np.int32)), torch.from_numpy(v),
                  shape)
    if conv == "coo_to_csr":
        _same_csr(port.coo_to_csr(pc), ref.coo_to_csr(rc))
        return
    if conv == "coo_to_csr_sum":
        _same_csr(port.coo_to_csr(pc, sum_duplicates=True),
                  ref.coo_to_csr(rc, sum_duplicates=True))
        return
    p_csr, r_csr = port.coo_to_csr(pc), ref.coo_to_csr(rc)
    if conv == "csr_to_csc":
        _same_csr(port.csr_to_csc(p_csr), ref.csr_to_csc(r_csr))
    elif conv == "csc_to_csr":
        _same_csr(port.csc_to_csr(port.csr_to_csc(p_csr)),
                  ref.csc_to_csr(ref.csr_to_csc(r_csr)))
    elif conv == "merge_duplicates":
        _same_csr(port.merge_duplicates(p_csr), ref.merge_duplicates(r_csr))
        assert port.csr_allclose(p_csr, port.merge_duplicates(p_csr))
    elif conv == "crop":
        _same_csr(port.crop(p_csr, 45, 30), ref.crop(r_csr, 45, 30))
    else:
        d = port.csr_to_dense(p_csr)
        _same(d, ref.csr_to_dense(r_csr))
        _same_csr(port.dense_to_csr(d), ref.dense_to_csr(d))


@pytest.mark.parametrize("layout", ["ell", "ell_width", "sell", "sell_height",
                                    "dia"])
def test_padded_layouts(layout):
    if layout == "dia":
        m = sp.diags([np.arange(1.0, 81.0)] * 4, [0, 2, -5, 7],
                     shape=(80, 80), format="csr")
    else:
        r, c, v, shape = _random(5, 70, 70, 0.06, dups=False)
        m = sp.coo_matrix((v, (r, c)), shape=shape).tocsr()
    pa, ra = port.CSR.from_scipy(m), ref.CSR.from_scipy(m)
    if layout.startswith("ell"):
        kw = dict(width=16, pad_to=8) if layout == "ell_width" else \
            dict(pad_to=8)
        p, r = port.csr_to_ell(pa, **kw), ref.csr_to_ell(ra, **kw)
        _same(p.cols, r.cols)
        _same(p.vals, r.vals)
        assert p.shape == r.shape and p.width == r.width
    elif layout.startswith("sell"):
        kw = dict(slice_height=16) if layout == "sell_height" else {}
        p, r = port.csr_to_sell(pa, **kw), ref.csr_to_sell(ra, **kw)
        assert p.slice_rows == r.slice_rows
        _same(p.perm, r.perm)
        _same(p.iperm, r.iperm)
        for ps_, rs_ in zip(p.slices, r.slices):
            _same(ps_.cols, rs_.cols)
            _same(ps_.vals, rs_.vals)
        np.testing.assert_array_equal(p.to_scipy().toarray(), m.toarray())
    else:
        p, r = port.csr_to_dia(pa), ref.csr_to_dia(ra)
        assert p.offsets == r.offsets
        _same(p.vals, r.vals)
        np.testing.assert_array_equal(p.to_scipy().toarray(), m.toarray())
        with pytest.raises(ValueError):
            port.csr_to_dia(pa, max_diags=3)


@pytest.mark.parametrize("cls", ["COO", "CSR", "CSC", "ELL", "SELL", "DIA"])
def test_container_scipy_roundtrip_and_to(cls):
    m = sp.diags([np.arange(1.0, 31.0)] * 3, [0, 1, -4], shape=(30, 30),
                 format="csr")
    c = getattr(port, cls).from_scipy(m)
    back = c.to_scipy()
    np.testing.assert_array_equal(back.toarray(), m.toarray())
    moved = c.to("cpu")
    assert type(moved) is type(c)
    np.testing.assert_array_equal(moved.to_scipy().toarray(), m.toarray())


def test_compare_parity():
    r, c, v, shape = _random(6)
    pa = port.coo_to_csr(port.COO(r, c, v, shape))
    pb = port.coo_to_csr(port.COO(r, c, v * (1 + 1e-10), shape))
    ra = ref.coo_to_csr(ref.COO(r, c, v, shape))
    rb = ref.coo_to_csr(ref.COO(r, c, v * (1 + 1e-10), shape))
    assert port.csr_allclose(pa, pb) == ref.csr_allclose(ra, rb) is True
    pc = port.coo_to_csr(port.COO(r, c, v * 1.01, shape))
    rc = ref.coo_to_csr(ref.COO(r, c, v * 1.01, shape))
    assert port.csr_allclose(pa, pc) == ref.csr_allclose(ra, rc) is False
    x, y = np.array([1.0, 0.0, 1e-9, 5.0]), np.array([1.0, 1e-9, 0.0, 6.0])
    np.testing.assert_array_equal(port.error_tolerant_equal(x, y),
                                  ref.error_tolerant_equal(x, y))

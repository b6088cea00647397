"""The port's WSELL-K packers and SpMV (g4s_tpu_torch/ops/wsell_spmv.py)
against the reference (g4s_tpu/ops/pallas_spmv.py) on the matrices of
tests/test_ops.py.

Tolerances: packs and permutations are host numpy on both sides and must be
identical; products against the JAX kernel (interpret mode) use
rtol=atol=1e-5, since the two sum each row's f32 products in another order;
against scipy f64, atol=1e-4 as in tests/test_ops.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import g4s_tpu.ops.pallas_spmv as ref
from g4s_tpu.sparse import CSR as RCSR
from g4s_tpu_torch.ops import wsell_spmv as port
from g4s_tpu_torch.sparse import CSR as PCSR


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))


def _multi_window():
    rng = np.random.default_rng(0)
    n = 2048
    rows, cols, vals = [], [], []
    for i in range(n):
        for o in (0, 1, -1, 400, -400, 900, -900):
            j = i + o + int(rng.integers(-2, 3))
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(float(rng.normal()))
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def _two_halves():
    rng = np.random.default_rng(5)
    n = 1024
    rows, cols, vals = [], [], []
    for i in range(n):
        offs = [0, 1, -1] if i < n // 2 else [0, 1, -1, 300, -300]
        for o in offs:
            j = i + o
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(float(rng.normal()))
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def _rect():
    n_r, n_c = 500, 700
    m = sp.random(n_r, n_c, density=0.004, random_state=3, format="csr",
                  dtype=np.float32).tocoo()
    m.col[:] = np.minimum(n_c - 1, (m.row * n_c) // n_r + (m.col % 64))
    m = sp.coo_matrix((m.data, (m.row, m.col)), shape=(n_r, n_c)).tocsr()
    m.sum_duplicates()
    return m


def _scattered():
    rng = np.random.default_rng(1)
    n = 1 << 14
    nnz = n * 4
    m = sp.coo_matrix(
        (np.ones(nnz, np.float32),
         (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
        shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m


MATRICES = {"multi_window": _multi_window, "two_halves": _two_halves,
            "rect": _rect}


def _same_pack(p, r):
    for f in ("starts", "lanes", "vals"):
        a, b = getattr(p, f).numpy(), np.asarray(getattr(r, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    for f in ("width", "n_rows", "n_cols", "ppt", "k", "shape", "groups",
              "rows_per_pack", "rows_padded"):
        assert getattr(p, f) == getattr(r, f), f
    assert port._chain_pad(p) == ref._chain_pad(r)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("ppt", [2, 128])
def test_pack_parity(name, ppt):
    m = MATRICES[name]()
    p = port.pack_wsell(PCSR.from_scipy(m), device="cpu", packs_per_tile=ppt)
    r = ref.pack_wsell(RCSR.from_scipy(m), packs_per_tile=ppt)
    _same_pack(p, r)
    assert p.lanes.dtype == torch.int16


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_block_sort_perm_parity(name):
    m = MATRICES[name]()
    for w in (None, 16):
        p = port.wsell_block_sort_perm(PCSR.from_scipy(m), width=w)
        r = ref.wsell_block_sort_perm(RCSR.from_scipy(m), width=w)
        assert (p is None) == (r is None)
        if p is not None:
            np.testing.assert_array_equal(p, r)


def test_k_max_rejection_in_both():
    m = _scattered()
    with pytest.raises(ValueError):
        port.pack_wsell(PCSR.from_scipy(m), device="cpu", k_max=8)
    with pytest.raises(ValueError):
        ref.pack_wsell(RCSR.from_scipy(m), k_max=8)
    with pytest.raises(ValueError):
        port.pack_wsell(PCSR.from_scipy(m), device="cpu", k_max=256)


def test_spmv_matches_jax_kernel(interpret):
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    for m in (_multi_window(), _rect()):
        r = ref.pack_wsell(RCSR.from_scipy(m), packs_per_tile=2)
        p = port.pack_wsell(PCSR.from_scipy(m), device="cpu",
                            packs_per_tile=2)
        x = rng.standard_normal(m.shape[1]).astype(np.float32)
        want = np.asarray(ref.spmv_wsell(r, jnp.asarray(x, jnp.float32)))
        got = port.spmv_wsell(p, torch.from_numpy(x)).numpy()
        assert got.shape == (m.shape[0],) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, m.astype(np.float64) @ x, atol=1e-4)


def test_chain_matches_jax_kernel(interpret):
    """Block sort, then the padded-in/padded-out chain form: same length,
    zero tail, equal to the JAX chain."""
    import jax.numpy as jnp
    m = _two_halves()
    sigma = port.wsell_block_sort_perm(PCSR.from_scipy(m))
    if sigma is not None:
        m = m[sigma][:, sigma].tocsr()
    r = ref.pack_wsell(RCSR.from_scipy(m), packs_per_tile=2)
    p = port.pack_wsell(PCSR.from_scipy(m), device="cpu", packs_per_tile=2)
    n, n_pad = m.shape[0], port._chain_pad(p)
    x = np.zeros(n_pad, np.float32)
    x[:n] = np.random.default_rng(5).standard_normal(n)
    got = port.spmv_wsell_chain(p, torch.from_numpy(x)).numpy()
    want = np.asarray(ref.spmv_wsell_chain(r, jnp.asarray(x, jnp.float32)))
    assert got.shape == want.shape == (n_pad,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[n:], 0.0)
    np.testing.assert_allclose(got[:n], m.astype(np.float64) @ x[:n],
                               atol=1e-4)


def test_rectangular_chain_zero_extension():
    """n_cols > rows_padded: the chain output is extended with zeros to the
    padded input length, as the reference's rectangular case."""
    m = _rect()
    p = port.pack_wsell(PCSR.from_scipy(m), device="cpu", packs_per_tile=1)
    n_pad = port._chain_pad(p)
    assert n_pad > p.rows_padded
    x = np.zeros(n_pad, np.float32)
    x[: m.shape[1]] = np.random.default_rng(2).standard_normal(m.shape[1])
    before = port.LAUNCHES
    y = port.spmv_wsell_chain(p, torch.from_numpy(x)).numpy()
    assert port.LAUNCHES == before
    assert y.shape == (n_pad,)
    np.testing.assert_array_equal(y[m.shape[0]:], 0.0)
    np.testing.assert_allclose(y[: m.shape[0]],
                               m.astype(np.float64) @ x[: m.shape[1]],
                               atol=1e-4)

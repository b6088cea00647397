"""The port's streaming SpMV (g4s_tpu_torch/ops/stream_spmv.py) against the
reference schedule (g4s_tpu/ops/stream_spmv.py) on the matrices of
tests/test_stream_spmv.py.

The plans are built by the same host code, so sigmas (the reference's
recovered exactly with apply_permute_np), values, classes, slices and hubs
must be identical. Products: rtol=atol=1e-5 against the reference's f32
executors (another summation order of the hub matmuls), and the
tests/test_stream_spmv.py tolerances against scipy."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from g4s_tpu.ops import stream_spmv as ref
from g4s_tpu.ops.route import apply_permute_np
from g4s_tpu_torch.ops import stream_spmv as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_csr(rng, n_rows, n_cols, nnz):
    a = sp.coo_matrix(
        (rng.normal(size=nnz).astype(np.float32),
         (rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz))),
        shape=(n_rows, n_cols)).tocsr()
    a.sum_duplicates()
    return a


def _uniform(rng):
    return _random_csr(rng, 3000, 3000, 24000)


def _power_law(rng):
    n, nnz = 4000, 32000
    rows = np.minimum((rng.pareto(0.6, nnz) * 2).astype(np.int64), n - 1)
    cols = np.minimum((rng.pareto(0.6, nnz) * 2).astype(np.int64), n - 1)
    a = sp.coo_matrix((rng.normal(size=nnz).astype(np.float32),
                       (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def _hub_overlap(rng):
    n = 1200
    a = _random_csr(rng, n, n, 5000).tolil()
    a[:, 5] = 1.0
    a[7, :] = 2.0
    return a.tocsr()


def _rectangular(rng):
    return sp.random(1500, 6000, density=0.002, format="csr",
                     dtype=np.float32, random_state=7)


def _empty_rows_cols(rng):
    a = _random_csr(rng, 2000, 2000, 6000).tolil()
    a[0, :] = 0
    a[:, 0] = 0
    a[-1, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


MATRICES = {"uniform": _uniform, "power_law": _power_law,
            "hub_overlap": _hub_overlap, "rectangular": _rectangular,
            "empty_rows_cols": _empty_rows_cols}


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_plan(p, r):
    for f in ("col_classes", "slices", "n_rows", "n_cols", "m", "nc_pad",
              "nr_pad"):
        assert getattr(p, f) == getattr(r, f), f
    for f in ("xplan", "route2", "rowplan"):
        pp, rp = getattr(p, f), getattr(r, f)
        assert pp.m == rp.m
        np.testing.assert_array_equal(pp.sigma.numpy(),
                                      apply_permute_np(rp, np.arange(rp.m)))
    for f in ("vals_e", "hub_cols", "hub_dense_c", "hub_rows", "hub_dense_r"):
        _same(getattr(p, f), getattr(r, f))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plan_and_product_parity(rng, name):
    a = MATRICES[name](rng)
    r = ref.build_stream_plan(a)
    p = port.build_stream_plan(a, device="cpu")
    _same_plan(p, r)
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    y = port.spmv_stream(p, torch.from_numpy(x)).numpy()
    assert y.shape == (a.shape[0],) and y.dtype == np.float32
    np.testing.assert_allclose(y, ref.spmv_stream_np(r, x), rtol=1e-5,
                               atol=1e-5)
    atol = 2e-4 if name == "hub_overlap" else 1e-5
    np.testing.assert_allclose(y, a @ x, rtol=2e-5, atol=atol)
    if name == "power_law":
        assert p.hub_cols is not None
    if name == "empty_rows_cols":
        assert y[0] == 0 and y[-1] == 0


def test_without_hub_split(rng):
    a = _power_law(rng)
    r = ref.build_stream_plan(a, hub_split=False)
    p = port.build_stream_plan(a, device="cpu", hub_split=False)
    _same_plan(p, r)
    assert p.hub_cols is None and p.hub_rows is None
    x = rng.standard_normal(a.shape[1]).astype(np.float32)
    np.testing.assert_allclose(port.spmv_stream(p, torch.from_numpy(x)),
                               a @ x, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1199,), (1201,), (1200, 1)])
def test_x_of_another_shape_raises(rng, shape):
    """The gathers read x past its end as 0, so the length is checked on
    the host: a short x would otherwise be a silent wrong answer."""
    p = port.build_stream_plan(_random_csr(rng, 1000, 1200, 6000),
                               device="cpu")
    with pytest.raises(ValueError):
        port.spmv_stream(p, torch.zeros(shape))


def test_matches_jax_device_schedule(rng, monkeypatch):
    """Against the reference's device executor (Pallas permutes in
    interpret mode), with hub columns and rows present."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a_, **k: orig(*a_, interpret=True, **k))
    n = 1500
    a = _random_csr(rng, n, n, 8000).tolil()
    a[:, 3] = 1.5
    a[9, :] = -0.5
    a = a.tocsr()
    r = ref.build_stream_plan(a)
    p = port.build_stream_plan(a, device="cpu")
    assert p.hub_cols is not None and p.hub_rows is not None
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: ref.spmv_stream(r, v))(
        jnp.asarray(x, jnp.float32)))
    got = port.spmv_stream(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a @ x, rtol=2e-5, atol=2e-4)

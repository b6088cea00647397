"""The port's BWELL packer and SpMV (g4s_tpu_torch/ops/bwell_spmv.py)
against the reference (g4s_tpu/ops/pallas_spmv.py) on the matrices of
tests/test_ops.py.

Tolerances: packs are host numpy on both sides and must be identical
array for array; products against the JAX kernel (interpret mode, f32) use
rtol=atol=1e-5, since the two sum each row's f32 products in another
order; against scipy f64, atol=1e-4 as in tests/test_ops.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import g4s_tpu.ops.pallas_spmv as ref
from g4s_tpu.sparse import CSR as RCSR
from g4s_tpu.sparse.containers import COO as RCOO
from g4s_tpu.sparse.convert import coo_to_csr as ref_coo_to_csr
from g4s_tpu_torch.ops import bwell_spmv as port
from g4s_tpu_torch.sparse import CSR as PCSR

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _band(n=2048):
    """The 16-diagonal band of tests/test_ops.py:191 (W = 16, mode pack)."""
    offs = np.r_[0, np.arange(1, 8), -np.arange(1, 9)]
    return sp.diags([np.ones(n)] * len(offs), offs, shape=(n, n),
                    format="csr").astype(np.float32)


def _clustered(n=2048, W=16, seed=0):
    """Columns cluster per gather row but not per pack
    (tests/test_ops.py:410): mode pack rejects it, mode row takes it."""
    rng = np.random.default_rng(seed)
    gr = n // 8
    bases = rng.integers(0, (n - 64) // 64, size=gr) * 64
    cols = (bases[:, None, None]
            + rng.integers(0, 64, size=(gr, 8, W))).reshape(-1)
    rows = np.repeat(np.arange(n), W)
    vals = rng.standard_normal(n * W).astype(np.float32)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m.astype(np.float32)


def _narrow(n=1024, seed=1):
    """A 2-entry-per-row band (W = 2): 512-row packs."""
    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n), rng.standard_normal(n - 1)],
                    [0, 1], shape=(n, n), format="csr").astype(np.float32)


def _rect(seed=3):
    """Rectangular, with empty rows, columns local to each row."""
    n_r, n_c = 500, 700
    m = sp.random(n_r, n_c, density=0.004, random_state=seed, format="csr",
                  dtype=np.float32).tocoo()
    m.col[:] = np.minimum(n_c - 1, (m.row * n_c) // n_r + (m.col % 64))
    m = sp.coo_matrix((m.data, (m.row, m.col)), shape=(n_r, n_c)).tocsr()
    m.sum_duplicates()
    return m


CASES = {
    "band_pack": (_band, "pack", 4),
    "clustered_auto": (_clustered, "auto", 64),
    "band_row": (_band, "row", 2),
    "narrow_w2": (_narrow, "auto", 1),
    "rect_auto": (_rect, "auto", 2),
}


def _same_pack(p, r):
    for f in ("starts", "lanes", "vals"):
        a, b = getattr(p, f).numpy(), np.asarray(getattr(r, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("width", "n_rows", "n_cols", "ppt", "shape", "mode",
              "rows_per_pack"):
        assert getattr(p, f) == getattr(r, f), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_parity(name):
    make, mode, ppt = CASES[name]
    m = make()
    p = port.pack_bwell(PCSR.from_scipy(m), packs_per_tile=ppt, mode=mode,
                        device="cpu")
    r = ref.pack_bwell(RCSR.from_scipy(m), packs_per_tile=ppt, mode=mode)
    _same_pack(p, r)
    assert p.lanes.dtype == torch.int32 and p.vals.dtype == torch.float32
    if name == "clustered_auto":
        assert p.mode == "row"


@pytest.mark.parametrize("name", ["band_pack", "clustered_auto"])
def test_spmv_matches_jax_kernel(interpret, name):
    """The two shapes of tests/test_ops.py (mode pack and mode row) through
    the JAX kernel in interpret mode and the port's plain path."""
    import jax.numpy as jnp
    make, mode, ppt = CASES[name]
    m = make()
    r = ref.pack_bwell(RCSR.from_scipy(m), packs_per_tile=ppt, mode=mode)
    p = port.pack_bwell(PCSR.from_scipy(m), packs_per_tile=ppt, mode=mode,
                        device="cpu")
    x = np.random.default_rng(0).standard_normal(m.shape[1]) \
        .astype(np.float32)
    want = np.asarray(ref.spmv_bwell(r, jnp.asarray(x, jnp.float32),
                                     packs_per_batch=2))
    before = port.LAUNCHES
    got = port.spmv_bwell(p, torch.from_numpy(x),
                          packs_per_batch=2).numpy()
    assert port.LAUNCHES == before           # CPU: the plain version
    assert got.shape == (m.shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, m.astype(np.float64) @ x, atol=1e-4)


@pytest.mark.parametrize("name", ["band_row", "narrow_w2", "rect_auto"])
def test_plain_matches_scipy(name):
    """Mode row on a pack-mode matrix, W = 2 and a rectangular matrix with
    empty rows, through the reference's arrays carried across."""
    make, mode, ppt = CASES[name]
    m = make()
    r = ref.pack_bwell(RCSR.from_scipy(m), packs_per_tile=ppt, mode=mode)
    p = port.bwell_from_reference(
        {f: np.asarray(getattr(r, f)) for f in ("starts", "lanes", "vals")},
        {"width": r.width, "n_rows": r.n_rows, "n_cols": r.n_cols,
         "ppt": r.ppt, "shape": r.shape, "mode": r.mode}, device="cpu")
    x = np.random.default_rng(4).standard_normal(m.shape[1]) \
        .astype(np.float32)
    y = port.spmv_bwell(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, m.astype(np.float64) @ x, atol=1e-4)
    x_pad = torch.zeros(m.shape[1] + port.X_PAD)
    x_pad[: m.shape[1]] = torch.from_numpy(x)
    full = port._spmv_bwell_plain(p, x_pad)
    assert full.shape == (p.rows_padded,)
    np.testing.assert_array_equal(full[m.shape[0]:].numpy(), 0.0)


def test_rejects_wide_packs_in_both():
    """tests/test_ops.py:344: rows touching column 0 and column n-1 span a
    pack's window in every mode."""
    n = 512
    rows = np.arange(n, dtype=np.int32)
    row = np.r_[rows, rows]
    col = np.r_[np.zeros(n, np.int32), np.full(n, n - 1, np.int32)]
    a_r = ref_coo_to_csr(RCOO(row, col, np.ones(2 * n), (n, n)))
    a_p = PCSR.from_scipy(sp.csr_matrix((np.ones(2 * n), (row, col)),
                                        shape=(n, n)))
    with pytest.raises(ValueError):
        ref.pack_bwell(a_r)
    with pytest.raises(ValueError):
        port.pack_bwell(a_p, device="cpu")


def test_row_mode_rejection_in_both():
    """tests/test_ops.py:430: mode pack rejects the clustered matrix."""
    m = _clustered()
    with pytest.raises(ValueError):
        ref.pack_bwell(RCSR.from_scipy(m), mode="pack")
    with pytest.raises(ValueError):
        port.pack_bwell(PCSR.from_scipy(m), mode="pack", device="cpu")


def test_checks_packs_per_batch_and_lanes():
    m = _band(512)
    p = port.pack_bwell(PCSR.from_scipy(m), packs_per_tile=4, device="cpu")
    x = torch.ones(512)
    with pytest.raises(ValueError):
        port.spmv_bwell(p, x, packs_per_batch=3)
    with pytest.raises(ValueError):
        port.spmv_bwell(p, torch.ones(511))
    bad = {"starts": p.starts.numpy(), "lanes": p.lanes.numpy() + 256,
           "vals": p.vals.numpy()}
    meta = {"width": p.width, "n_rows": p.n_rows, "n_cols": p.n_cols,
            "ppt": p.ppt, "shape": p.shape, "mode": p.mode}
    with pytest.raises(ValueError):
        port.bwell_from_reference(bad, meta, device="cpu")

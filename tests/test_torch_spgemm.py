"""The port's SpGEMM path (g4s_tpu_torch/ops/{shifts,spgemm,spgemm_esc,
spgemm_block}.py and engine.mxm) against the reference (g4s_tpu) and scipy.

Tolerances: plans are host numpy on both sides (or the same device
algorithm) and must be identical value for value. The ESC numeric keeps
the reference's product order, stable sort and runsum tree, so in f64 it
is bit-identical to the reference. The other f64 products use rtol=1e-12:
scatter-add merges sum in another order than the reference's scans, and
the block engine fuses its multiply-adds. Against scipy, rtol=1e-12 in
f64."""

from importlib import import_module

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import g4s_tpu.engine.semiring as RS
import g4s_tpu.ops.shifts as rsh
import g4s_tpu_torch.engine.semiring as PS
from g4s_tpu.engine.dispatch import mxm as ref_mxm
from g4s_tpu.sparse import CSR as RCSR
from g4s_tpu_torch.engine import mxm
from g4s_tpu_torch.ops import shifts as psh
from g4s_tpu_torch.ops import spgemm as psg
from g4s_tpu_torch.ops import spgemm_block as pbk
from g4s_tpu_torch.ops import spgemm_esc as pesc
from g4s_tpu_torch.sparse import CSR as PCSR

# g4s_tpu.ops exports functions named like these modules
rsg = import_module("g4s_tpu.ops.spgemm")
resc = import_module("g4s_tpu.ops.spgemm_esc")
rbk = import_module("g4s_tpu.ops.spgemm_block")

SEMIRINGS = ["PLUS_TIMES", "MIN_PLUS", "MAX_PLUS", "MAX_TIMES", "OR_AND"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(A_s, B_s):
    return (PCSR.from_scipy(A_s), PCSR.from_scipy(B_s),
            RCSR.from_scipy(A_s), RCSR.from_scipy(B_s))


def _rand(m, n, dens, seed, dtype=np.float64):
    return sp.random(m, n, density=dens, format="csr", dtype=dtype,
                     random_state=np.random.RandomState(seed))


def _skewed(n=300, nnz=3000, seed=7):
    r = np.random.RandomState(seed)
    rows = np.minimum((n * r.power(0.25, nnz)).astype(int), n - 1)
    cols = np.minimum((n * r.power(0.25, nnz)).astype(int), n - 1)
    a = sp.coo_matrix((r.randn(nnz), (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def _large_keyspace(seed=3):
    """m * n >= 2^31 with few entries: the (major, minor) two-key sort."""
    rng = np.random.default_rng(seed)
    m, k, n, nnz = 50000, 40, 50000, 400
    A = sp.coo_matrix((rng.standard_normal(nnz),
                       (rng.integers(0, m, nnz), rng.integers(0, k, nnz))),
                      shape=(m, k)).tocsr()
    B = sp.coo_matrix((rng.standard_normal(nnz),
                       (rng.integers(0, k, nnz), rng.integers(0, n, nnz))),
                      shape=(k, n)).tocsr()
    A.sum_duplicates()
    B.sum_duplicates()
    return A, B


PAIRS = {
    "rect": lambda: (_rand(120, 60, 0.1, 8), _rand(60, 200, 0.08, 9)),
    "square": lambda: (_rand(200, 200, 0.04, 5),) * 2,
    "skewed": lambda: (_skewed(),) * 2,
}


# ---- shifts --------------------------------------------------------------

def _compaction(rng, m, n_live):
    pos = np.sort(rng.choice(m, size=n_live, replace=False))
    d = np.zeros(m, np.int32)
    d[pos] = (pos - np.arange(n_live)).astype(np.int32)
    x = np.full(m, -1.0)
    x[pos] = rng.standard_normal(n_live)
    return x, d, pos


@pytest.mark.parametrize("m,n_live", [(256, 100), (4096, 4096), (512, 1)])
def test_compact_matches_oracle(m, n_live):
    """Live slots only: dead slots hold garbage in both."""
    rng = np.random.default_rng(m + n_live)
    x, d, pos = _compaction(rng, m, n_live)
    y = rng.integers(0, 1 << 20, m).astype(np.int32)
    T = psh.stages_for(int(d.max(initial=0)))
    assert T == rsh.stages_for(int(d.max(initial=0)))
    ox, oy = psh.compact((torch.from_numpy(x), torch.from_numpy(y)),
                         torch.from_numpy(d), T)
    rx, ry = rsh.compact_np((x, y), d, T)
    np.testing.assert_array_equal(ox.numpy()[:n_live], rx[:n_live])
    np.testing.assert_array_equal(oy.numpy()[:n_live], ry[:n_live])
    np.testing.assert_array_equal(ox.numpy()[:n_live], x[pos])


@pytest.mark.parametrize("m,n_live", [(256, 100), (2048, 2048), (512, 1)])
def test_spread_matches_oracle(m, n_live):
    rng = np.random.default_rng(m * 3 + n_live)
    dest = np.sort(rng.choice(m, size=n_live, replace=False))
    d = np.full(m, -1, np.int32)
    d[:n_live] = (dest - np.arange(n_live)).astype(np.int32)
    x = np.full(m, 7.0, np.float32)
    x[:n_live] = rng.standard_normal(n_live).astype(np.float32)
    T = psh.stages_for(int(d[:n_live].max(initial=0)))
    got = psh.spread(torch.from_numpy(x), torch.from_numpy(d), T,
                     fill=0.0).numpy()
    np.testing.assert_array_equal(got, rsh.spread_np(x, d, T, fill=0.0))


def test_bitfill_and_runsum_match_oracles():
    """runsum keeps the reference's tree order: bit-exact in f64."""
    rng = np.random.default_rng(11)
    lens = rng.integers(1, 40, size=200)
    off = np.concatenate([np.arange(l) for l in lens]).astype(np.int32)
    x = rng.standard_normal(off.size)
    T = psh.stages_for(int(off.max()))
    got = psh.bitfill(torch.from_numpy(x), torch.from_numpy(off), T)
    np.testing.assert_array_equal(got.numpy(), rsh.bitfill_np(x, off, T))
    got = psh.runsum(torch.from_numpy(x), torch.from_numpy(off), T)
    np.testing.assert_array_equal(got.numpy(), rsh.runsum_np(x, off, T))


# ---- plans: the same arrays as the reference's ---------------------------

@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_plan_and_numeric(name):
    A_s, B_s = PAIRS[name]()
    a, b, ra, rb = _pair(A_s, B_s)
    p = psg.spgemm_plan(a, b, device="cpu")
    r = rsg.spgemm_plan(ra, rb, use_native=False)
    for f in ("src_a", "src_b", "slot", "c_indptr", "c_indices"):
        np.testing.assert_array_equal(_np(getattr(p, f)),
                                      _np(getattr(r, f)), err_msg=f)
        assert _np(getattr(p, f)).dtype == _np(getattr(r, f)).dtype, f
    assert (p.flops, p.nnz, p.shape) == (r.flops, r.nnz, r.shape)
    assert psg.spgemm_flops(a, b) == rsg.spgemm_flops(ra, rb)
    got = psg.spgemm(a, b, plan=p).data.numpy()
    want = np.asarray(rsg.spgemm(ra, rb).data)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def _esc_arrays(p, fields):
    return {f: _np(getattr(p, f)) for f in fields}


ESC_ARRAYS = ("a_rank", "b_rank", "d_a", "d_b", "d_pad", "keys", "off_c",
              "d_head")
ESC_STATIC = ("classes", "na", "nb_len", "m2", "flops", "nnz", "t_a",
              "t_b", "t_pad", "t_sum", "t_head", "shape", "order_by")


@pytest.mark.parametrize("order_by", ["row", "col"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_esc_plan_and_numeric(name, order_by):
    A_s, B_s = PAIRS[name]()
    a, b, ra, rb = _pair(A_s, B_s)
    p = pesc.esc_plan(a, b, order_by=order_by, device="cpu")
    r = resc.esc_plan(ra, rb, order_by=order_by)
    got, want = _esc_arrays(p, ESC_ARRAYS + ("c_indptr", "c_indices")), \
        _esc_arrays(r, ESC_ARRAYS + ("c_indptr", "c_indices"))
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ESC_STATIC:
        assert getattr(p, f) == getattr(r, f), f
    assert p.keys_minor is None and r.keys_minor is None
    c = pesc.esc_numeric(a.data, b.data, p).numpy()
    c_ref = np.asarray(resc.esc_numeric(np.asarray(ra.data),
                                        np.asarray(rb.data), r))
    np.testing.assert_array_equal(c, c_ref)
    ref = (A_s @ B_s).tocsr() if order_by == "row" else (A_s @ B_s).tocsc()
    ref.sort_indices()
    np.testing.assert_array_equal(_np(p.c_indptr), ref.indptr)
    np.testing.assert_allclose(c, ref.data, rtol=1e-12)


@pytest.mark.parametrize("order_by", ["row", "col"])
def test_esc_plan_device_matches_reference(order_by):
    A_s, B_s = PAIRS["skewed"]()
    a, b, ra, rb = _pair(A_s, B_s)
    p = pesc.esc_plan_device(a, b, order_by=order_by, device="cpu")
    r = resc.esc_plan_device(ra, rb, order_by=order_by)
    fields = ESC_ARRAYS + ("keys_sorted",)
    got, want = _esc_arrays(p, fields), _esc_arrays(r, fields)
    for f in fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ESC_STATIC:
        assert getattr(p, f) == getattr(r, f), f
    ip, ix = pesc.materialize_structure(p)
    rp, rx = resc.materialize_structure(r)
    np.testing.assert_array_equal(ip.numpy(), rp)
    np.testing.assert_array_equal(ix.numpy(), rx)
    host = pesc.esc_plan(a, b, order_by=order_by, device="cpu")
    np.testing.assert_array_equal(ip.numpy(), host.c_indptr.numpy())
    np.testing.assert_array_equal(
        pesc.esc_numeric(a.data, b.data, p).numpy(),
        pesc.esc_numeric(a.data, b.data, host).numpy())


def test_two_key_sort_large_keyspace():
    """m*n >= 2^31: the host plan, the device plan and the numeric all
    take the (major, minor) key pair; C matches the reference and scipy."""
    A_s, B_s = _large_keyspace()
    a, b, ra, rb = _pair(A_s, B_s)
    assert A_s.shape[0] * B_s.shape[1] >= 2 ** 31
    p = pesc.esc_plan(a, b, device="cpu")
    r = resc.esc_plan(ra, rb)
    assert p.keys_minor is not None and r.keys_minor is not None
    for f in ESC_ARRAYS + ("keys_minor", "c_indptr", "c_indices"):
        np.testing.assert_array_equal(_np(getattr(p, f)),
                                      _np(getattr(r, f)), err_msg=f)
    ref = (A_s @ B_s).tocsr()
    ref.sort_indices()
    c = pesc.esc_numeric(a.data, b.data, p).numpy()
    np.testing.assert_array_equal(
        c, np.asarray(resc.esc_numeric(np.asarray(ra.data),
                                       np.asarray(rb.data), r)))
    np.testing.assert_allclose(c, ref.data, rtol=1e-12)
    d = pesc.esc_plan_device(a, b, device="cpu")
    assert d.keys_sorted_minor is not None and d.nnz == ref.nnz
    ip, ix = pesc.materialize_structure(d)
    np.testing.assert_array_equal(ip.numpy(), ref.indptr)
    np.testing.assert_array_equal(ix.numpy(), ref.indices)
    np.testing.assert_allclose(pesc.esc_numeric(a.data, b.data, d).numpy(),
                               ref.data, rtol=1e-12)


def _blocky(mb, nb, bs, dens, seed, holes=0.0):
    rng = np.random.RandomState(seed)
    pat = sp.random(mb, nb, dens, random_state=rng, format="csr")
    data = np.random.default_rng(seed).normal(size=(pat.nnz, bs, bs))
    M = sp.bsr_matrix((data, pat.indices, pat.indptr),
                      shape=(mb * bs, nb * bs), blocksize=(bs, bs)).tocsr()
    if holes:
        keep = np.random.default_rng(seed + 1).random(M.nnz) > holes
        M.data[~keep] = 0.0
        M.eliminate_zeros()
    M.sort_indices()
    return M


@pytest.mark.parametrize("bs", [2, 3])
def test_block_plan_and_numeric(bs):
    A_s = _blocky(16, 12, bs, 0.2, 21, holes=0.2)
    B_s = _blocky(12, 10, bs, 0.2, 22, holes=0.2)
    a, b, ra, rb = _pair(A_s, B_s)
    p = pbk.block_plan(a, b, bs, device="cpu")
    r = rbk.block_plan(ra, rb, bs)
    for f in ("a_rank", "a_d", "b_rank", "b_d"):
        np.testing.assert_array_equal(_np(getattr(p, f)),
                                      _np(getattr(r, f)), err_msg=f)
    for f in ("d_pad", "keys", "off_c", "d_head", "c_indptr", "c_indices"):
        np.testing.assert_array_equal(_np(getattr(p.plan, f)),
                                      _np(getattr(r.plan, f)), err_msg=f)
    assert (p.t_a, p.t_b, p.nnz_blocks, p.shape) == \
        (r.t_a, r.t_b, r.nnz_blocks, r.shape)
    assert pbk.block_cover(a, bs) == rbk.block_cover(ra, bs)
    c = pbk.block_numeric(a.data, b.data, p)
    c_ref = np.asarray(rbk.block_numeric(np.asarray(ra.data),
                                         np.asarray(rb.data), r))
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-12, atol=1e-13)
    got = pbk.block_c_to_scipy(p, c).toarray()
    np.testing.assert_allclose(got, (A_s @ B_s).toarray(), rtol=1e-12,
                               atol=1e-12)


# ---- device-side structure discovery and the column engines -------------

def test_device_merge_full_and_csc():
    A_s, B_s = PAIRS["rect"]()
    a, b, ra, rb = _pair(A_s, B_s)
    ref = (A_s @ B_s).tocsr()
    ref.sort_indices()
    for port_fn, ref_fn in ((psg.spgemm_device_merge, rsg.spgemm_device_merge),
                            (psg.spgemm_device_full, rsg.spgemm_device_full)):
        keys, vals, nnz = port_fn(a, b, device="cpu")
        rk, rv, rn = ref_fn(ra, rb)
        assert int(nnz) == int(rn) == ref.nnz
        np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-12,
                                   atol=1e-13)
    c = psg.spgemm_device_csr(a, b, device="cpu")
    np.testing.assert_array_equal(c.indptr.numpy(), ref.indptr)
    np.testing.assert_array_equal(c.indices.numpy(), ref.indices)
    np.testing.assert_allclose(c.data.numpy(), ref.data, rtol=1e-12)
    c = psg.spgemm_via_csc(a, b, device="cpu")
    rc = rsg.spgemm_via_csc(ra, rb)
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      np.asarray(getattr(rc, f)))
    np.testing.assert_allclose(c.data.numpy(), np.asarray(rc.data),
                               rtol=1e-12)
    cc = pesc.spgemm_esc_col(a, b, device="cpu")
    rcc = resc.spgemm_esc_col(ra, rb)
    np.testing.assert_array_equal(cc.indptr.numpy(), np.asarray(rcc.indptr))
    np.testing.assert_array_equal(cc.data.numpy(), np.asarray(rcc.data))


def test_esc_numeric_staged_and_reuse():
    A_s = _rand(150, 150, 0.05, 11, np.float32)
    a = PCSR.from_scipy(A_s)
    plan = pesc.esc_plan(a, a, device="cpu")
    c, stages = pesc.esc_numeric_staged(a.data, a.data, plan)
    assert set(stages) == {"reorder_a", "reorder_b", "spread_a", "spread_b",
                           "expand", "compact_pads", "sort", "runsum",
                           "compact_heads"}
    np.testing.assert_array_equal(
        c.numpy(), pesc.esc_numeric(a.data, a.data, plan).numpy())
    c2 = pesc.esc_numeric(a.data * 2.5, a.data * 2.5, plan).numpy()
    np.testing.assert_allclose(c2, 6.25 * c.numpy(), rtol=1e-6)


# ---- engine.mxm ----------------------------------------------------------

def test_mxm_pinned_plans_match_reference():
    """mxm with a pinned SpGEMMPlan (take path) and a pinned ESCPlan (the
    CUDA engine, forced on CPU tensors) against g4s_tpu.engine.mxm."""
    A_s = _rand(120, 120, 0.1, 16)
    a, _, ra, _ = _pair(A_s, A_s)
    ref = (A_s @ A_s).tocsr()
    ref.sort_indices()
    for port_plan, ref_plan in (
            (psg.spgemm_plan(a, a, device="cpu"), rsg.spgemm_plan(ra, ra)),
            (pesc.esc_plan(a, a, device="cpu"), resc.esc_plan(ra, ra))):
        c = mxm(a, a, plan=port_plan)
        rc = ref_mxm(ra, ra, plan=ref_plan)
        np.testing.assert_array_equal(c.indptr.numpy(), ref.indptr)
        np.testing.assert_array_equal(c.indices.numpy(), ref.indices)
        np.testing.assert_allclose(c.data.numpy(), np.asarray(rc.data),
                                   rtol=1e-12)
        np.testing.assert_allclose(c.data.numpy(), ref.data, rtol=1e-12)
    with pytest.raises(NotImplementedError):
        mxm(a, a, plan=pesc.esc_plan(a, a, device="cpu"),
            semiring=PS.MIN_PLUS)


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_mxm_semirings_take_path(sr):
    """With no plan on the CPU, every semiring takes the gather path."""
    rng = np.random.default_rng(2)
    A_s = _rand(60, 50, 0.1, 31)
    B_s = _rand(50, 70, 0.1, 32)
    A_s.data = rng.uniform(0.5, 2.0, A_s.nnz)
    B_s.data = rng.uniform(0.5, 2.0, B_s.nnz)
    a, b, ra, rb = _pair(A_s, B_s)
    c = mxm(a, b, semiring=getattr(PS, sr), device="cpu")
    got = c.data.numpy()
    if sr == "OR_AND":
        # the reference's take path sums bools with jax's segment_sum,
        # which refuses them (ROADMAP section 3); hold the port to the
        # boolean product instead
        with pytest.raises(TypeError):
            ref_mxm(ra, rb, semiring=RS.OR_AND)
        pat = ((A_s != 0).astype(np.int64) @ (B_s != 0).astype(np.int64))
        pat = pat.tocsr()
        pat.sort_indices()
        np.testing.assert_array_equal(c.indptr.numpy(), pat.indptr)
        np.testing.assert_array_equal(c.indices.numpy(), pat.indices)
        assert got.dtype == np.bool_ and got.all()
        return
    rc = ref_mxm(ra, rb, semiring=getattr(RS, sr))
    np.testing.assert_array_equal(c.indptr.numpy(), np.asarray(rc.indptr))
    np.testing.assert_array_equal(c.indices.numpy(), np.asarray(rc.indices))
    np.testing.assert_allclose(got, np.asarray(rc.data), rtol=1e-12)
    if sr == "PLUS_TIMES":
        ref = (A_s @ B_s).tocsr()
        ref.sort_indices()
        np.testing.assert_allclose(got, ref.data, rtol=1e-12)


def test_mxm_with_no_device_needs_a_card():
    """mxm and the plan builders default to device="cuda"; with no card
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = PCSR.from_scipy(_rand(40, 40, 0.1, 41))
    for call in (lambda: mxm(a, a), lambda: pesc.esc_plan(a, a),
                 lambda: psg.spgemm_plan(a, a)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()

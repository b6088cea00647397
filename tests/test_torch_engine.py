"""The port's graph engine (g4s_tpu_torch.engine) against the reference
(g4s_tpu.engine): layout choices, every semiring on forced layouts, the
Graph carried across with graph_from_reference, and the slice as a whole —
the CUDA rules (RCM -> block sort -> WSELL-K, RCM-DIA, stream) run on CPU
tensors through the dispatcher's own build function.

Tolerances: layout choices, permutations and packs are exact; products
against JAX f32 use rtol=atol=1e-5 (another summation order); against
scipy f64, atol=1e-4 as in tests/test_ops.py."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import g4s_tpu.engine as R
import g4s_tpu.engine.semiring as RS
import g4s_tpu_torch.engine as P
import g4s_tpu_torch.engine.semiring as PS
from g4s_tpu.ops.pallas_spmv import pack_wsell as ref_pack_wsell
from g4s_tpu.ops.pallas_spmv import wsell_block_sort_perm as ref_block_sort
from g4s_tpu.ops.route import apply_permute_np
from g4s_tpu.ops.stream_spmv import build_stream_plan as ref_stream_plan
from g4s_tpu.ops.stream_spmv import spmv_stream_np
from g4s_tpu.sparse import CSR as RCSR
from g4s_tpu_torch.engine import dispatch
from g4s_tpu_torch.sparse import CSR as PCSR

TOL = dict(rtol=1e-5, atol=1e-5)
SEMIRINGS = ["PLUS_TIMES", "MIN_PLUS", "MAX_PLUS", "MAX_TIMES", "OR_AND"]


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


def _jx(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _both(out_p, out_r, **tol):
    p = out_p.numpy() if isinstance(out_p, torch.Tensor) else out_p
    r = np.asarray(out_r)
    assert p.shape == r.shape
    if r.dtype == bool:
        np.testing.assert_array_equal(p, r)
    else:
        np.testing.assert_allclose(p, r, **(tol or TOL))
    return p


# ---- matrices ---------------------------------------------------------------

def _band(n=256):
    return sp.diags([np.ones(n)] * 5, [0, 1, -1, 2, -2], shape=(n, n),
                    format="csr").astype(np.float32)


def _shuffled_band(n=4096, seed=0):
    offs = np.r_[0, np.arange(1, 8), -np.arange(1, 9)]
    band = sp.diags([np.ones(n)] * len(offs), offs, shape=(n, n),
                    format="csr").astype(np.float32)
    p = np.random.default_rng(seed).permutation(n)
    return band[p][:, p].tocsr()


def _uniform_rows(n=2000, d=8, seed=1):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (n, d))
    a = sp.csr_matrix((rng.standard_normal(n * d).astype(np.float32),
                       (np.repeat(np.arange(n), d), cols.reshape(-1))),
                      shape=(n, n))
    a.sum_duplicates()
    return a


def _skewed_rows(n=2000, seed=2):
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(0.8, n) + 1).astype(np.int64), n // 2)
    rows = np.repeat(np.arange(n), deg)
    a = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, rng.integers(0, n, rows.size))), shape=(n, n))
    a.sum_duplicates()
    return a


def _small_with_empty_rows(seed=3):
    rng = np.random.default_rng(seed)
    a = sp.random(60, 60, density=0.08, random_state=seed, format="lil",
                  dtype=np.float32)
    a[[4, 17, 33], :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    a.data = rng.standard_normal(a.nnz).astype(np.float32)
    return a


def _stencil(nx, seed=0):
    rng = np.random.default_rng(seed)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def _random_unstructured(n=8192, per_row=10, seed=1):
    rr = np.random.default_rng(seed)
    nnz = n * per_row
    return sp.coo_matrix(
        (rr.normal(size=nnz).astype(np.float32),
         (rr.integers(0, n, nnz), rr.integers(0, n, nnz))),
        shape=(n, n)).tocsr()


def _graphs(a, **kw):
    return (P.build_graph(PCSR.from_scipy(a), device="cpu", **kw),
            R.build_graph(RCSR.from_scipy(a), **kw))


def _x(n, seed=0, binary=False):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return (x > 0).astype(np.float32) if binary else x


# ---- layout choices ---------------------------------------------------------

@pytest.mark.parametrize("case,want", [
    ("band", "dia"), ("dense", "dense"), ("ell", "ell"), ("csr", "csr"),
    ("rcm_dia", "dia")])
def test_same_variant_as_reference(case, want):
    a = {"band": _band, "dense": _small_with_empty_rows,
         "ell": _uniform_rows, "csr": _skewed_rows,
         "rcm_dia": _shuffled_band}[case]()
    gp, gr = _graphs(a)
    assert gp.variant == gr.variant == want
    assert (gp.perm is None) == (gr.perm is None)
    if gp.perm is not None:
        np.testing.assert_array_equal(gp.perm.numpy(), np.asarray(gr.perm))
        np.testing.assert_array_equal(gp.iperm.numpy(), np.asarray(gr.iperm))
    x = _x(a.shape[1])
    _both(P.mxv(gp, torch.from_numpy(x)), R.mxv(gr, _jx(x)))


# ---- semirings on forced layouts ----------------------------------------------

@pytest.fixture(scope="module")
def forced():
    a = _small_with_empty_rows()
    return a, {v: _graphs(a, variant=v) for v in ("ell", "csr", "dense")}


def _cases():
    # the reference cannot sum booleans (jax.ops.segment_sum rejects bool),
    # so or_and runs only on ELL, where it reduces with jnp.any
    return [(s, v) for s in SEMIRINGS for v in ("ell", "csr", "dense")
            if s != "OR_AND" or v == "ell"]


@pytest.mark.parametrize("sr,variant", _cases())
def test_mxv_semirings(forced, sr, variant):
    a, graphs = forced
    gp, gr = graphs[variant]
    assert gp.variant == gr.variant == variant
    x = _x(a.shape[1], seed=4, binary=sr == "OR_AND")
    yp = _both(P.mxv(gp, torch.from_numpy(x), semiring=getattr(PS, sr)),
               R.mxv(gr, _jx(x), semiring=getattr(RS, sr)))
    if sr == "PLUS_TIMES":
        np.testing.assert_allclose(yp, a.astype(np.float64) @ x, atol=1e-4)


@pytest.mark.parametrize("sr,variant",
                         [c for c in _cases() if c[0] != "OR_AND"])
def test_vxm_semirings(forced, sr, variant):
    a, graphs = forced
    gp, gr = graphs[variant]
    x = _x(a.shape[0], seed=5)
    yp = _both(P.vxm(gp, torch.from_numpy(x), semiring=getattr(PS, sr)),
               R.vxm(gr, _jx(x), semiring=getattr(RS, sr)))
    if sr == "PLUS_TIMES":
        np.testing.assert_allclose(yp, a.T.astype(np.float64) @ x, atol=1e-4)


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("variant", ["ell", "csr", "dia"])
def test_reduce_vector(forced, sr, variant):
    if variant == "dia":
        gp, gr = _graphs(_band())
    else:
        gp, gr = forced[1][variant]
    _both(P.reduce_vector(gp, semiring=getattr(PS, sr)),
          R.reduce_vector(gr, semiring=getattr(RS, sr)))


def test_mask_and_dia_rules(forced):
    a, graphs = forced
    gp, gr = graphs["csr"]
    x = _x(a.shape[1], seed=6)
    mask = np.arange(a.shape[0]) % 3 != 0
    _both(P.mxv(gp, torch.from_numpy(x), semiring=P.MIN_PLUS,
                mask=torch.from_numpy(mask)),
          R.mxv(gr, _jx(x), semiring=R.MIN_PLUS, mask=_jx(mask)))
    gp, gr = _graphs(_shuffled_band(2048))
    assert gp.variant == "dia" and gp.perm is not None
    xb = _x(2048, seed=7)
    _both(P.vxm(gp, torch.from_numpy(xb)), R.vxm(gr, _jx(xb)))
    with pytest.raises(NotImplementedError):
        P.mxv(gp, torch.from_numpy(xb), semiring=P.MIN_PLUS)


@pytest.mark.parametrize("variant", ["dense", "dia", "ell", "csr"])
def test_gather_apply(forced, variant):
    if variant == "dia":
        a = _shuffled_band(2048)
        gp, gr = _graphs(a)
    else:
        a, graphs = forced
        gp, gr = graphs[variant]
    assert gp.variant == variant
    x = _x(a.shape[1], seed=8)

    def gather(w, s):
        return w * s * 0.5

    def apply(acc):
        return acc + 1.0

    yp = _both(P.gather_apply(gp, torch.from_numpy(x), gather, apply),
               R.gather_apply(gr, _jx(x), gather, apply))
    np.testing.assert_allclose(yp, 0.5 * (a.astype(np.float64) @ x) + 1.0,
                               atol=1e-4)


def test_spmm_dense_and_dense_matmul():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((10, 6)).astype(np.float32)
    s = rng.standard_normal((10, 6)).astype(np.float32)
    _both(P.spmm_dense(torch.from_numpy(w), torch.from_numpy(s),
                       gather=lambda a, b: a * b),
          R.spmm_dense(_jx(w), _jx(s), gather=lambda a, b: a * b))
    m = rng.standard_normal((6, 4)).astype(np.float32)
    _both(P.dense_matmul(torch.from_numpy(w), torch.from_numpy(m)),
          R.dense_matmul(_jx(w), _jx(m)))


@pytest.mark.parametrize("layout", ["ell", "sell", "csr", "dia", "dense",
                                    "dense_rows"])
def test_spmv_layouts(layout):
    import g4s_tpu.ops as rops
    import g4s_tpu.sparse as rsp
    import g4s_tpu_torch.ops as pops
    import g4s_tpu_torch.sparse as psp
    a = _band(300) if layout == "dia" else _skewed_rows(300)
    x = _x(a.shape[1], seed=12)
    pa, ra = PCSR.from_scipy(a), RCSR.from_scipy(a)
    if layout == "dense_rows":
        w = a.toarray()[:, :40]
        g = np.broadcast_to(x[:40], w.shape).copy()
        got = pops.spmv_dense_rows(torch.from_numpy(w), torch.from_numpy(g))
        _both(got, rops.spmv_dense_rows(_jx(w), _jx(g)))
        return
    conv = {"ell": ("csr_to_ell", {"pad_to": 8}), "sell": ("csr_to_sell", {}),
            "dia": ("csr_to_dia", {}), "csr": (None, {}),
            "dense": (None, {})}[layout]
    if layout == "dense":
        pm, rm = torch.from_numpy(a.toarray()), _jx(a.toarray())
    elif conv[0] is None:
        pm, rm = pa, ra.to_device()
    else:
        pm = getattr(psp, conv[0])(pa, **conv[1])
        rm = getattr(rsp, conv[0])(ra, **conv[1]).to_device()
    got = pops.spmv(pm, torch.from_numpy(x))
    _both(got, rops.spmv(rm, _jx(x)))
    np.testing.assert_allclose(got.numpy(), a.astype(np.float64) @ x,
                               atol=1e-4)


@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_reduce_empty_segments(op, dtype):
    import jax
    from g4s_tpu_torch.ops.segment import segment_reduce
    data = np.array([3, 1, 4, 1, 5, 9], dtype)
    ids = np.array([0, 0, 2, 2, 2, 4], np.int32)
    jfn = {"add": jax.ops.segment_sum, "max": jax.ops.segment_max,
           "min": jax.ops.segment_min, "mul": jax.ops.segment_prod}[op]
    got = segment_reduce(torch.from_numpy(data), torch.from_numpy(ids), 6,
                         op=op).numpy()
    want = np.asarray(jfn(_jx(data), _jx(ids), num_segments=6))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---- graph_from_reference -----------------------------------------------------

def _reference_parts(g):
    """(arrays, meta) of a g4s_tpu Graph, as graph_from_reference takes."""
    arrays = {"deg": np.asarray(g.deg)}
    meta = {"variant": g.variant, "shape": g.shape}
    for f in ("row_ids", "dense", "perm", "iperm"):
        if getattr(g, f) is not None:
            arrays[f] = np.asarray(getattr(g, f))
    if g.csr is not None:
        for f in ("indptr", "indices", "data"):
            arrays["csr." + f] = np.asarray(getattr(g.csr, f))
    if g.ell is not None:
        arrays["ell.cols"] = np.asarray(g.ell.cols)
        arrays["ell.vals"] = np.asarray(g.ell.vals)
    if g.dia is not None:
        arrays["dia.vals"] = np.asarray(g.dia.vals)
        meta["dia.offsets"] = g.dia.offsets
    if g.wsell is not None:
        for f in ("starts", "lanes", "vals"):
            arrays["wsell." + f] = np.asarray(getattr(g.wsell, f))
        meta["wsell"] = {f: getattr(g.wsell, f)
                         for f in ("width", "ppt", "k", "groups")}
    if g.stream is not None:
        s = g.stream
        for f in ("xplan", "route2", "rowplan"):
            plan = getattr(s, f)
            arrays["stream." + f] = apply_permute_np(plan, np.arange(plan.m))
        for f in ("vals_e", "hub_cols", "hub_dense_c", "hub_rows",
                  "hub_dense_r"):
            if getattr(s, f) is not None:
                arrays["stream." + f] = np.asarray(getattr(s, f))
        meta["stream"] = {f: getattr(s, f) for f in
                          ("col_classes", "slices", "m", "nc_pad", "nr_pad")}
    return arrays, meta


@pytest.mark.parametrize("variant", ["dia_perm", "ell", "csr", "dense",
                                     "wsell", "stream"])
def test_graph_from_reference(interpret, variant):
    if variant == "dia_perm":
        a = _shuffled_band(2048)
        gr = R.build_graph(RCSR.from_scipy(a))
    elif variant == "stream":
        import dataclasses
        a = _random_unstructured(3000, 8)
        base = R.build_graph(RCSR.from_scipy(a), variant="csr")
        gr = dataclasses.replace(base, variant="stream",
                                 stream=ref_stream_plan(a))
    elif variant == "wsell":
        # two packs per tile keep the interpret-mode kernel small
        import dataclasses
        a = _stencil(8)
        base = R.build_graph(RCSR.from_scipy(a), variant="wsell")
        gr = dataclasses.replace(base, wsell=ref_pack_wsell(
            RCSR.from_scipy(a), packs_per_tile=2))
    else:
        a = _skewed_rows(600)
        gr = R.build_graph(RCSR.from_scipy(a), variant=variant)
    arrays, meta = _reference_parts(gr)
    gp = P.graph_from_reference(arrays, meta, device="cpu")
    assert gp.variant == gr.variant and gp.shape == gr.shape
    x = _x(a.shape[1], seed=10)
    yp = P.mxv(gp, torch.from_numpy(x)).numpy()
    if variant == "stream":
        np.testing.assert_allclose(yp, spmv_stream_np(gr.stream, x), **TOL)
    else:
        _both(yp, R.mxv(gr, _jx(x)))
    np.testing.assert_allclose(yp, a.astype(np.float64) @ x, atol=1e-4)


# ---- the slice as a whole -------------------------------------------------------

def _cuda_rules_graph(a, **kw):
    """The graph build_graph(device="cuda") would build, on CPU tensors:
    the dispatcher's own build function with its kernel-layout gate set."""
    params = inspect.signature(dispatch.build_graph).parameters.items()
    args = {k: p.default for k, p in params
            if p.default is not inspect.Parameter.empty and k != "device"}
    args.update(kw)
    return dispatch._build_graph(PCSR.from_scipy(a), device=torch.device("cpu"),
                                 kernel_layouts=True, **args)


@pytest.mark.parametrize("case", ["stencil_wsell", "rcm_dia", "stream"])
def test_slice_cuda_rules_on_cpu(case):
    if case == "stencil_wsell":
        a, kw, want = _stencil(12), {}, "wsell"
    elif case == "rcm_dia":
        a, kw, want = _shuffled_band(4096), {}, "dia"
    else:
        a, kw, want = _random_unstructured(), {"reorder": False}, "stream"
    g = _cuda_rules_graph(a, **kw)
    assert g.variant == want
    if case == "stencil_wsell":
        # the reference's own steps: RCM, block sort, pack
        perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False))
        ap = a[perm][:, perm].tocsr()
        sigma = ref_block_sort(RCSR.from_scipy(ap))
        if sigma is not None:
            perm = perm[sigma]
            ap = ap[sigma][:, sigma].tocsr()
        np.testing.assert_array_equal(g.perm.numpy(), perm)
        np.testing.assert_array_equal(g.iperm.numpy()[perm],
                                      np.arange(perm.size))
        r = ref_pack_wsell(RCSR.from_scipy(ap))
        for f in ("starts", "lanes", "vals"):
            np.testing.assert_array_equal(getattr(g.wsell, f).numpy(),
                                          np.asarray(getattr(r, f)))
        assert (g.wsell.k, g.wsell.groups) == (r.k, r.groups)
    elif case == "rcm_dia":
        assert g.perm is not None
    else:
        r = ref_stream_plan(a)
        for f in ("xplan", "route2", "rowplan"):
            plan = getattr(r, f)
            np.testing.assert_array_equal(
                getattr(g.stream, f).sigma.numpy(),
                apply_permute_np(plan, np.arange(plan.m)))
    gr = R.build_graph(RCSR.from_scipy(a), **kw)
    x = _x(a.shape[1], seed=11)
    y = _both(P.mxv(g, torch.from_numpy(x)), R.mxv(gr, _jx(x)))
    np.testing.assert_allclose(y, a.astype(np.float64) @ x, atol=1e-4)


@pytest.mark.parametrize("case", ["stencil_wsell", "rcm_dia", "stream"])
def test_slice_mxv_rejects_x_of_another_length(case):
    """The fused permutes read x past its end as 0; mxv checks the length
    on the host instead."""
    a, kw = {"stencil_wsell": (_stencil(12), {}),
             "rcm_dia": (_shuffled_band(1024), {}),
             "stream": (_random_unstructured(), {"reorder": False})}[case]
    g = _cuda_rules_graph(a, **kw)
    assert g.variant == case.split("_")[-1]
    for n in (a.shape[1] - 1, a.shape[1] + 1):
        with pytest.raises(ValueError):
            P.mxv(g, torch.zeros(n))


def test_build_graph_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    with no card, build_graph(a) raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.build_graph(PCSR.from_scipy(_band()))
    assert inspect.signature(P.build_graph).parameters["device"].default \
        == "cuda"

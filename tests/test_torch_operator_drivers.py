"""The port's operator dispatch (engine/operator.py), dense BLAS2
(ops/blas2.py), Timings and the mm/ and mv/ drivers against the reference
(g4s_tpu) on tiny inputs, on the CPU.

Tolerances: BLAS2 in f64 against the reference to rtol=1e-12 (the same
products, summed by another library); reg_mm holds every strategy to its
own f64 dense oracle at 1e-10, its default."""

from importlib import import_module

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import g4s_tpu.engine.operator as rop
import g4s_tpu_torch.engine.operator as pop
from g4s_tpu.ops import blas2 as rb2
from g4s_tpu_torch.drivers import mm_bench, mv_bench, reg_mm
from g4s_tpu_torch.obs import Timings
from g4s_tpu_torch.ops import blas2 as pb2
from g4s_tpu_torch.sparse import CSR, csr_to_coo, write_mtx


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cands,stats", [
    (("stencil", "eltk"), {"regular_grid": True}),
    (("stencil", "eltk"), {}),
    (("stencil", "zeta", "alpha"), {}),
    (("zeta", "alpha"), {"regular_grid": True}),
])
def test_operator_dispatch_matches_reference(cands, stats):
    """Both packages pick the same form; the registered rule runs it."""
    for name in cands:
        pop.register_operator_variant(
            name, lambda data, u, _n=name: (_n, data * u))
    g = pop.build_operator({n: i + 1 for i, n in enumerate(cands)},
                           stats=stats)
    r = rop.build_operator({n: i + 1 for i, n in enumerate(cands)},
                           stats=stats)
    assert (g.variant, g.data) == (r.variant, r.data)
    assert pop.apply_operator(g, 10) == (g.variant, g.data * 10)


def test_operator_unknown_variant_raises():
    with pytest.raises(KeyError, match="no apply rule"):
        pop.apply_operator(pop.OperatorGraph(1, "never_registered"), 1)


@pytest.mark.parametrize("uplo", ["U", "L"])
def test_blas2_matches_reference(uplo):
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    n = 33
    a, x = rng.random((n, n)), rng.random(n)
    at, xt = torch.from_numpy(a), torch.from_numpy(x)
    aj, xj = jnp.asarray(a), jnp.asarray(x)
    ap = rb2.pack_symmetric(a, uplo=uplo)
    np.testing.assert_array_equal(pb2.pack_symmetric(a, uplo=uplo), ap)
    np.testing.assert_array_equal(
        pb2.unpack_symmetric(torch.from_numpy(ap), n, uplo=uplo).numpy(),
        np.asarray(rb2.unpack_symmetric(ap, n, uplo=uplo)))
    pairs = [
        (pb2.gemv(at, xt), rb2.gemv(aj, xj)),
        (pb2.symv(at, xt, uplo=uplo), rb2.symv(aj, xj, uplo=uplo)),
        (pb2.trmv(at, xt, uplo=uplo), rb2.trmv(aj, xj, uplo=uplo)),
        (pb2.trmv(at, xt, uplo=uplo, unit_diag=True),
         rb2.trmv(aj, xj, uplo=uplo, unit_diag=True)),
        (pb2.spmv_packed(torch.from_numpy(ap), xt, uplo=uplo),
         rb2.spmv_packed(jnp.asarray(ap), xj, uplo=uplo)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)


def test_timings_report_and_device_timer():
    t = Timings("x", device="cpu")
    with t.stage("a"):
        pass
    t.record("b", 0.5)
    rep = t.report(flops=1_000_000_000)
    assert "a" in rep and "b" in rep and "GFLOPS" in rep
    assert abs(t.as_dict()["total"] - t.total) < 1e-12
    res = mv_bench.run(64, reps=2, verbose=False, device="cpu")
    assert set(res) == {"dsymv", "dtrmv", "dspmv", "dgemv"}
    assert all(v > 0 for v in res.values())


def test_mm_driver_and_crop(tmp_path):
    """tests/test_drivers.py's crop case through the port's reader."""
    rng = np.random.RandomState(3)
    A = CSR.from_scipy(sp.random(50, 40, density=0.1, random_state=rng,
                                 format="csr"))
    B = CSR.from_scipy(sp.random(45, 30, density=0.1, random_state=rng,
                                 format="csr"))
    pa, pb = tmp_path / "a.mtx", tmp_path / "b.mtx"
    write_mtx(pa, csr_to_coo(A))
    write_mtx(pb, csr_to_coo(B))
    A2, B2 = mm_bench.load_pair(pa, pb)
    rA2, rB2 = import_module("g4s_tpu.drivers.mm_bench").load_pair(pa, pb)
    assert A2.shape == rA2.shape and B2.shape == rB2.shape
    assert A2.shape[1] == B2.shape[0] == 40
    for p, r in ((A2, rA2), (B2, rB2)):
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(r, f)))
    out = mm_bench.bench_pair(A2, B2, reps=2, verbose=False, device="cpu")
    assert out["flops"] > 0 and out["nnz_c"] > 0
    assert out["plan"]["numeric"] > 0 and "dense" in out


def test_reg_mm_all_pass(capsys):
    """Every strategy against the f64 oracle, block tier included (a
    3x3-blocked input), and the driver's exit code."""
    pat = sp.random(12, 12, 0.2, random_state=np.random.RandomState(5),
                    format="csr")
    data = np.random.default_rng(6).normal(size=(pat.nnz, 3, 3))
    K = sp.bsr_matrix((data, pat.indices, pat.indptr), shape=(36, 36),
                      blocksize=(3, 3)).tocsr()
    res = reg_mm.run(CSR.from_scipy(K), CSR.from_scipy(K), verbose=False,
                     device="cpu")
    assert set(res) == {"plan", "csc", "block3", "device", "dense"}
    assert all(ok for ok, _ in res.values()), res
    assert reg_mm.main(["--random", "80", "0.06", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 5          # 4 strategies + ALL PASS
    assert reg_mm.main(["--random", "80", "0.06", "--device", "cpu",
                        "--tol", "-1"]) == 1
    assert "FAILURES PRESENT" in capsys.readouterr().out

"""The port's runtime and observability tail against the reference on the
CPU: the native host library (g4s_tpu_torch/runtime/native_lib.py,
runtime/native/host_kernels.cc) under esc_plan, spgemm_plan and read_mtx;
obs/profile.py's roofline and obs/timings.py's ConvergenceLog; and the C
embedding API (runtime/native/capi.c, g4s.i, g4s_capi.f90, capi_impl.py).

Inputs: scipy random sparse matrices from seeded generators; a tiny frozen
WATER_SPEC model (the reference's init_params at PRNGKey(0), frozen by the
reference in f64); the small synthetic n-dodecane-shaped mechanism of
tests/test_torch_cantera.py.

Tolerances: plans and parsed matrices equal array for array (native, numpy
and the reference's); roofline's dict and ConvergenceLog's file equal; the
C program's energy within 1e-10 of the reference's DeepPot in f64; the
ignition delay through capi_impl within 1e-6 of the reference's.
"""

import dataclasses
import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import _synthetic_mechanism_yaml  # noqa: E402
from g4s_tpu.sparse.containers import CSR as JCSR  # noqa: E402
from g4s_tpu_torch.obs import profile as p_prof  # noqa: E402
from g4s_tpu_torch.obs import timings as p_tim  # noqa: E402
from g4s_tpu_torch.ops import spgemm as p_spgemm  # noqa: E402
from g4s_tpu_torch.ops import spgemm_esc as p_esc  # noqa: E402
from g4s_tpu_torch.runtime import capi_impl, native_lib  # noqa: E402
from g4s_tpu_torch.sparse import CSR  # noqa: E402
from g4s_tpu_torch.sparse import io_mtx as p_io  # noqa: E402

j_esc = importlib.import_module("g4s_tpu.ops.spgemm_esc")
j_spgemm = importlib.import_module("g4s_tpu.ops.spgemm")
j_prof = importlib.import_module("g4s_tpu.obs.profile")
j_tim = importlib.import_module("g4s_tpu.obs.timings")
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"

COORD = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0],
                  [4, 4, 4], [4.96, 4, 4], [3.76, 4.93, 4]], np.float64)
TYPES = np.array([0, 1, 1, 0, 1, 1], np.int32)
C_MAIN = r"""
#include <stdio.h>
extern int g4s_init(const char*);
extern int g4s_deeppot_load(const char*);
extern int g4s_deeppot_eval(int, int, const double*, const double*,
                            const int*, double*, double*, double*);
int main(int argc, char** argv) {
  if (g4s_init(argv[1])) return 1;
  int h = g4s_deeppot_load(argv[2]);
  if (h < 0) return 2;
  enum { N = 6 };
  double coord[N * 3] = {0,0,0, 0.96,0,0, -0.24,0.93,0,
                         4,4,4, 4.96,4,4, 3.76,4.93,4};
  double box[9] = {8,0,0, 0,8,0, 0,0,8};
  int types[N] = {0,1,1,0,1,1};
  double e, f[N * 3], v[9];
  if (g4s_deeppot_eval(h, N, coord, box, types, &e, f, v)) return 3;
  printf("CAPI_OK e=%.17g f0=%.17g\n", e, f[0]);
  return 0;
}
"""
F_MAIN = r"""
program fcapi_test
  use g4s_capi
  use iso_c_binding, only: c_int, c_double
  implicit none
  character(len=4096) :: repo, frozen
  integer(c_int) :: h, rc
  real(c_double) :: coord(18), box(9), energy, force(18), virial(9)
  integer(c_int) :: types(6)
  call get_command_argument(1, repo)
  call get_command_argument(2, frozen)
  if (g4s_init(repo) /= 0) stop 1
  h = g4s_deeppot_load(frozen)
  if (h < 0) stop 2
  coord = (/ 0.d0,0.d0,0.d0, 0.96d0,0.d0,0.d0, -0.24d0,0.93d0,0.d0, &
             4.d0,4.d0,4.d0, 4.96d0,4.d0,4.d0, 3.76d0,4.93d0,4.d0 /)
  box = (/ 8.d0,0.d0,0.d0, 0.d0,8.d0,0.d0, 0.d0,0.d0,8.d0 /)
  types = (/ 0_c_int,1_c_int,1_c_int,0_c_int,1_c_int,1_c_int /)
  rc = g4s_deeppot_eval(h, 6_c_int, coord, box, types, energy, force, &
                        virial)
  if (rc /= 0) stop 3
  write(*,'(A,ES25.17)') 'FCAPI_OK e=', energy
end program fcapi_test
"""


def _pair(A, B):
    return (CSR.from_scipy(A), CSR.from_scipy(B), JCSR.from_scipy(A),
            JCSR.from_scipy(B))


def _plan_equal(pn, pp, jp):
    for f in dataclasses.fields(pn):
        x, y, z = (getattr(pn, f.name), getattr(pp, f.name),
                   getattr(jp, f.name))
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
            assert np.array_equal(x.numpy(), np.asarray(z)), f.name
        else:
            assert x == y == z or x is y is z, (f.name, x, y, z)


@pytest.mark.parametrize("order_by", ["row", "col"])
def test_esc_plan_native_equals_numpy_and_reference(order_by):
    A = sp.random(300, 200, 0.03, random_state=1, format="csr")
    B = sp.random(200, 250, 0.04, random_state=2, format="csr")
    a, b, ja, jb = _pair(A, B)
    pn = p_esc.esc_plan(a, b, order_by=order_by, device=CPU)
    pp = p_esc.esc_plan(a, b, order_by=order_by, device=CPU,
                        use_native=False)
    _plan_equal(pn, pp, j_esc.esc_plan(ja, jb, order_by=order_by))
    # the plan computes the product
    C = p_esc.spgemm_esc(a, b, plan=pn) if order_by == "row" \
        else p_esc.spgemm_esc_col(a, b, plan=pn)
    ref = (A @ B)
    np.testing.assert_allclose(C.to_scipy().toarray(), ref.toarray(),
                               rtol=1e-12, atol=1e-14)


def test_esc_plan_native_two_keys():
    """m * n >= 2^31: the device sort runs on (major, minor) int32 pairs."""
    rng = np.random.default_rng(3)

    def rand(m, n, nnz):
        return sp.csr_matrix((rng.standard_normal(nnz),
                              (rng.integers(0, m, nnz),
                               rng.integers(0, n, nnz))), shape=(m, n))
    A, B = rand(50000, 4000, 40000), rand(4000, 50000, 40000)
    a, b, ja, jb = _pair(A, B)
    pn = p_esc.esc_plan(a, b, device=CPU)
    assert pn.keys_minor is not None
    _plan_equal(pn, p_esc.esc_plan(a, b, device=CPU, use_native=False),
                j_esc.esc_plan(ja, jb))


def test_spgemm_plan_native_equals_numpy_and_reference():
    A = sp.random(400, 300, 0.02, random_state=5, format="csr")
    B = sp.random(300, 350, 0.03, random_state=6, format="csr")
    a, b, ja, jb = _pair(A, B)
    pn = p_spgemm.spgemm_plan(a, b, device=CPU)
    pp = p_spgemm.spgemm_plan(a, b, device=CPU, use_native=False)
    jp = j_spgemm.spgemm_plan(ja, jb)
    for f in ("src_a", "src_b", "slot", "c_indptr", "c_indices"):
        x, y = getattr(pn, f), getattr(pp, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
        assert np.array_equal(x.numpy(), np.asarray(getattr(jp, f))), f
    assert (pn.flops, pn.nnz, pn.shape) == (pp.flops, pp.nnz, pp.shape) \
        == (jp.flops, jp.nnz, jp.shape)


@pytest.mark.parametrize("field,symmetry", [("real", "general"),
                                            ("pattern", "symmetric"),
                                            ("integer", "skew-symmetric")])
def test_read_mtx_native(tmp_path, field, symmetry):
    rng = np.random.default_rng(7)
    A = sp.random(60, 60, 0.1, random_state=8, format="coo")
    if symmetry != "general":
        A = sp.tril(A, -1 if symmetry == "skew-symmetric" else 0).tocoo()
        A = A - A.T if symmetry == "skew-symmetric" else A + sp.triu(A.T, 1)
    if field == "integer":
        A.data = np.round(rng.uniform(-9, 9, A.nnz))
    path = tmp_path / "a.mtx"
    scipy.io.mmwrite(str(path), sp.coo_matrix(A), field=field,
                     symmetry=symmetry)
    from g4s_tpu.sparse.io_mtx import read_mtx as j_read
    got = p_io.read_mtx(path)
    got_np = p_io.read_mtx(path, use_native=False)
    ref = j_read(path)
    for x, y, z in zip((got.row, got.col, got.val),
                       (got_np.row, got_np.col, got_np.val),
                       (ref.row, ref.col, ref.val)):
        assert torch.equal(x, y)
        assert np.array_equal(x.numpy(), np.asarray(z))
    assert got.shape == ref.shape


def test_native_loader_raises_without_gxx(tmp_path, monkeypatch):
    """No silent fallback: with g++ hidden from PATH a fresh build raises."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_lib.build(tmp_path / "build")


def test_roofline_matches_reference(monkeypatch):
    monkeypatch.setitem(j_prof.PEAKS, H100, dict(p_prof.PEAKS[H100]))
    for kw in (dict(seconds=1e-3, bytes_moved=10**9, flops=10**9),
               dict(seconds=2.5e-4, bytes_moved=0, flops=3 * 10**12,
                    dtype="bf16"),
               dict(seconds=0.02, bytes_moved=7 * 10**10, flops=0)):
        assert p_prof.roofline(platform=H100, **kw) \
            == j_prof.roofline(platform=H100, **kw)
    assert p_prof.PEAKS[H100]["hbm_gbs"] == 3350.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="platform="):
            p_prof.detect_platform()


def test_convergence_log_and_profile_trace(tmp_path):
    rows = [(1, dict(res=0.5, div=1e-3)), (2, dict(res=1.25e-7, div=3.0)),
            (3, dict(vrms=77.8519, nu=-0.0))]
    logs = (p_tim.ConvergenceLog(tmp_path / "p.log"),
            j_tim.ConvergenceLog(tmp_path / "j.log"))
    for log in logs:
        for step, m in rows:
            log.record(step, **m)
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log") \
        .read_bytes()
    assert logs[0].last() == logs[1].last() == (3, rows[2][1])
    assert logs[0].rows == logs[1].rows
    with p_tim.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    """A tiny WATER_SPEC model frozen by the reference in f64, and the
    reference DeepPot's (e, f) at the C programs' frame."""
    from g4s_tpu.models.deepmd import WATER_SPEC, init_params
    from g4s_tpu.models.deepmd.freeze import freeze
    from g4s_tpu.models.deepmd.infer import DeepPot
    path = tmp_path_factory.mktemp("capi") / "tiny_f64.npz"
    params = init_params(jax.random.PRNGKey(0), WATER_SPEC,
                         dtype=jnp.float64)
    freeze(params, WATER_SPEC, str(path))
    e, f, _ = DeepPot(str(path)).eval(COORD, np.eye(3) * 8.0, TYPES)
    return str(path), float(np.asarray(e)), np.asarray(f, np.float64)


def _embedded_env(tmp_path):
    """The embedded interpreter finds torch and numpy through this
    process's sys.path, and runs its models on the CPU."""
    return dict(os.environ, G4S_TORCH_DEVICE="cpu",
                PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
                LD_LIBRARY_PATH=str(tmp_path))


def test_c_program_evaluates_deeppot(tmp_path, frozen):
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        pytest.skip("no C compiler")
    path, e_ref, f_ref = frozen
    capi_impl.build_capi(tmp_path)
    (tmp_path / "main.c").write_text(C_MAIN)
    _, ld = capi_impl.embed_flags()
    subprocess.run([gcc, str(tmp_path / "main.c"), "-o",
                    str(tmp_path / "capi_test"), f"-L{tmp_path}",
                    "-lg4s_torch_capi"] + ld, check=True,
                   capture_output=True)
    out = subprocess.run([str(tmp_path / "capi_test"), REPO, path],
                         env=_embedded_env(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("CAPI_OK")]
    assert line, out.stdout
    e = float(line[0].split("e=")[1].split()[0])
    f0 = float(line[0].split("f0=")[1].split()[0])
    assert abs(e - e_ref) <= 1e-10 * max(abs(e_ref), 1.0)
    assert abs(f0 - f_ref[0, 0]) <= 1e-10 * max(np.abs(f_ref).max(), 1.0)


def test_capi_device_variable(monkeypatch):
    monkeypatch.setenv(capi_impl.DEVICE_ENV, "cpu")
    assert capi_impl.device() == CPU
    monkeypatch.delenv(capi_impl.DEVICE_ENV)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            capi_impl.device()


def test_capi_ignition_delay_matches(tmp_path, monkeypatch):
    """capi_impl.ignition_delay on the small mechanism's ideal-gas phase
    against the reference's capi_impl (the protocol's defaults: t_end 5 ms,
    rtol 1e-9, atol 1e-15)."""
    path = tmp_path / "small.yaml"
    _synthetic_mechanism_yaml(str(path), nspec=15, nrxn=30, n_falloff=2,
                              n_three_body=2, seed=0)
    monkeypatch.setenv(capi_impl.DEVICE_ENV, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tau = capi_impl.ignition_delay(str(path), "nDodecane_IG", 1000.0,
                                       40 * 101325.0)
    finally:
        torch.set_num_threads(n)
    j_capi = importlib.import_module("g4s_tpu.runtime.capi_impl")
    jtau = j_capi.ignition_delay(str(path), "nDodecane_IG", 1000.0,
                                 40 * 101325.0)
    assert 0.0 < tau < 0.005
    assert abs(tau - jtau) <= 1e-6 * jtau


def test_swig_binding(tmp_path, frozen, monkeypatch):
    """`swig -python` over g4s.i, compiled against capi.c and driven in
    this process (g4s_init's Py_Initialize is a no-op inside a live
    interpreter): E and F within 1e-10 of the reference's DeepPot."""
    gcc = shutil.which("gcc") or shutil.which("cc")
    swig = shutil.which("swig")
    if gcc is None or swig is None:
        pytest.skip("no swig/C toolchain")
    path, e_ref, f_ref = frozen
    native = capi_impl.NATIVE
    subprocess.run([swig, "-python", "-outdir", str(tmp_path), "-o",
                    str(tmp_path / "g4s_wrap.c"), str(native / "g4s.i")],
                   check=True, capture_output=True)
    inc, ld = capi_impl.embed_flags()
    subprocess.run([gcc, "-shared", "-fPIC", str(tmp_path / "g4s_wrap.c"),
                    str(native / "capi.c"), "-o",
                    str(tmp_path / "_g4s_torch_capi.so")] + inc + ld,
                   check=True, capture_output=True)
    monkeypatch.setenv(capi_impl.DEVICE_ENV, "cpu")
    monkeypatch.syspath_prepend(str(tmp_path))
    g = importlib.import_module("g4s_torch_capi")
    assert g.g4s_init(REPO) == 0
    h = g.g4s_deeppot_load(path)
    assert h >= 0
    ca, ba, ta = g.DoubleArray(18), g.DoubleArray(9), g.IntArray(6)
    for i, v in enumerate(COORD.reshape(-1)):
        ca[i] = float(v)
    for i, v in enumerate((np.eye(3) * 8.0).reshape(-1)):
        ba[i] = float(v)
    for i, v in enumerate(TYPES):
        ta[i] = int(v)
    fa, va = g.DoubleArray(18), g.DoubleArray(9)
    rc, e = g.g4s_deeppot_eval(h, 6, ca, ba, ta, fa, va)
    assert rc == 0
    assert abs(e - e_ref) <= 1e-10 * max(abs(e_ref), 1.0)
    f = np.array([fa[i] for i in range(18)])
    assert np.abs(f - f_ref.reshape(-1)).max() \
        <= 1e-10 * max(np.abs(f_ref).max(), 1.0)


def test_fortran_binding(tmp_path, frozen):
    """A Fortran program through the ISO_C_BINDING module g4s_capi.f90;
    skips where gfortran is absent, as the reference's test does."""
    gcc = shutil.which("gcc") or shutil.which("cc")
    gfortran = shutil.which("gfortran")
    if gcc is None or gfortran is None:
        pytest.skip("no Fortran toolchain")
    path, e_ref, _ = frozen
    capi_impl.build_capi(tmp_path)
    (tmp_path / "main.f90").write_text(F_MAIN)
    _, ld = capi_impl.embed_flags()
    subprocess.run([gfortran, str(capi_impl.NATIVE / "g4s_capi.f90"),
                    str(tmp_path / "main.f90"), "-o",
                    str(tmp_path / "fcapi_test"), f"-J{tmp_path}",
                    f"-L{tmp_path}", "-lg4s_torch_capi"] + ld, check=True,
                   capture_output=True)
    out = subprocess.run([str(tmp_path / "fcapi_test"), REPO, path],
                         env=_embedded_env(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("FCAPI_OK")]
    assert line, out.stdout
    e = float(line[0].split("e=")[1])
    assert abs(e - e_ref) <= 1e-10 * max(abs(e_ref), 1.0)

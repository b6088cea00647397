"""The port's per-matrix WSELL-K SpMV (g4s_tpu_torch/ops/static_spmv.py)
against the reference's two probes (benchmarks/static_spmv_probe.py and
static_spmv_probe2.py, run in Pallas interpret mode) on the same packs.

Packs: the 3D 7-point stencil at nx = 16, renumbered at random and then by
RCM, packed with 8 packs per tile (W = 8), and a 16-diagonal matrix with
far diagonals (W = 16, packs whose window count kc is below K).
Tolerances: f32 within 1e-5 of max|y| (the probes sum a row's products
by a one-hot matmul, the port in entry order); f64 within 1e-12."""

import importlib.util
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import g4s_tpu.ops.pallas_spmv as ref
from g4s_tpu.sparse import CSR as RCSR
from g4s_tpu_torch.drivers import static_spmv as driver
from g4s_tpu_torch.ops import static_spmv as port
from g4s_tpu_torch.ops import wsell_spmv
from g4s_tpu_torch.sparse import CSR as PCSR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE1 = _probe("static_spmv_probe")
PROBE2 = _probe("static_spmv_probe2")


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


def _stencil_rcm(nx=16):
    a = driver.stencil(nx, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False))
    return a[perm][:, perm].tocsr()


def _far_diagonals(n=2048):
    rng = np.random.default_rng(3)
    offs = list(range(-6, 7)) + [300, -300, 1000]
    return sp.diags([rng.normal(size=n - abs(o)) for o in offs], offs,
                    shape=(n, n), format="csr").astype(np.float32)


CASES = {"stencil_rcm": _stencil_rcm, "far_diagonals": _far_diagonals}


def _packs(name, dtype=np.float32):
    m = CASES[name]()
    r = ref.pack_wsell(RCSR.from_scipy(m), packs_per_tile=8, dtype=dtype)
    p = wsell_spmv.pack_wsell(PCSR.from_scipy(m), device="cpu",
                              packs_per_tile=8, dtype=torch.from_numpy(
                                  np.zeros(0, dtype)).dtype)
    return m, r, p


def _x_pad(p, dtype, seed=4):
    x = np.zeros(wsell_spmv._chain_pad(p), dtype)
    x[: p.n_cols] = np.random.default_rng(seed).standard_normal(p.n_cols)
    return x


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("name", sorted(CASES))
def test_windows_match_the_probes(name):
    _, r, p = _packs(name)
    starts_h, kc_h = port.static_windows(p)
    n_packs = r.lanes.shape[0] * r.ppt
    want = np.asarray(r.starts).reshape(n_packs, r.k)
    np.testing.assert_array_equal(starts_h, want)
    np.testing.assert_array_equal(
        kc_h, 1 + (np.diff(want, axis=1) > 0).sum(axis=1))
    if name == "stencil_rcm":
        assert (p.lanes.shape[0], p.k, p.width) == (5, 5, 8)
    else:
        assert p.width == 16 and (kc_h < p.k).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_matches_probe1(interpret, name):
    import jax.numpy as jnp
    m, r, p = _packs(name)
    starts_h, kc_h = port.static_windows(p)
    x = _x_pad(p, np.float32)
    want = np.asarray(PROBE1.build_static_chain(r, starts_h, kc_h)(
        jnp.asarray(x)))
    f = port.build_static_chain(p, starts_h, kc_h, device="cpu")
    got = f(torch.from_numpy(x)).numpy()
    assert got.shape == (wsell_spmv._chain_pad(p),) == (f.n_out,)
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got[m.shape[0]:], 0.0)
    _close(got[: m.shape[0]], m.astype(np.float64) @ x[: m.shape[1]], 1e-5)
    # the port's WSELL chain computes the same function
    _close(got, wsell_spmv.spmv_wsell_chain(p, torch.from_numpy(x)), 1e-6)


@pytest.mark.parametrize("name,n_tiles", [("stencil_rcm", None),
                                          ("stencil_rcm", 2),
                                          ("far_diagonals", None)])
def test_one_kernel_matches_probe2(interpret, name, n_tiles):
    import jax.numpy as jnp
    _, r, p = _packs(name)
    starts_h, kc_h = port.static_windows(p)
    nt = p.lanes.shape[0] if n_tiles is None else n_tiles
    x = _x_pad(p, np.float32)
    want = np.asarray(PROBE2.build_static_one_kernel(
        r, starts_h, kc_h, nt)(jnp.asarray(x)))
    f = port.build_static_one_kernel(p, starts_h, kc_h, n_tiles,
                                     device="cpu")
    got = f(torch.from_numpy(x)).numpy()
    rows = nt * p.ppt * p.rows_per_pack
    assert want.shape == (rows,)
    assert got.shape == ((wsell_spmv._chain_pad(p),) if n_tiles is None
                         else (rows,))
    _close(got[:rows], want, 1e-5)


def test_f64_matches_the_probes(interpret):
    """With f64 values and x the probes compute in f64 (the one-hot row sum
    at HIGHEST precision), and so does the plain version."""
    import jax.numpy as jnp
    _, r, p = _packs("stencil_rcm", np.float64)
    starts_h, kc_h = port.static_windows(p)
    x = _x_pad(p, np.float64)
    got = port._static_spmv_plain(p, starts_h, kc_h, torch.from_numpy(x))
    assert got.dtype == torch.float64
    want1 = np.asarray(PROBE1.build_static_chain(r, starts_h, kc_h)(
        jnp.asarray(x)))
    _close(got, want1, 1e-12)
    want2 = np.asarray(PROBE2.build_static_one_kernel(r, starts_h, kc_h, 2)(
        jnp.asarray(x)))
    _close(port._static_spmv_plain(p, starts_h, kc_h, torch.from_numpy(x),
                                   n_tiles=2), want2, 1e-12)


def test_plain_reads_window_0_past_kc():
    """An entry whose slot is kc or more reads window 0, as the probes'
    select chain does; a non-zero value there shows it."""
    _, _, p = _packs("far_diagonals")
    starts_h, kc_h = port.static_windows(p)
    q = int(np.argmin(kc_h))
    assert kc_h[q] < p.k
    lanes = p.lanes.clone()
    vals = p.vals.clone()
    t, qq = divmod(q, p.ppt)
    lanes[t, qq, 0, 0] = p.k * 128 - 128 + 5       # slot K-1 >= kc
    vals[t, qq, 0, 0] = 1.0
    p2 = wsell_spmv.WSELL(p.starts, lanes, vals, p.width, p.n_rows, p.n_cols,
                          p.ppt, p.k, p.shape, p.groups)
    x = torch.arange(wsell_spmv._chain_pad(p), dtype=torch.float64)
    y = port._static_spmv_plain(p2, starts_h, kc_h, x)
    y0 = port._static_spmv_plain(p, starts_h, kc_h, x)
    code = int(p.lanes[t, qq, 0, 0])
    old = float(p.vals[t, qq, 0, 0]) * float(
        x[int(starts_h[q, code >> 7]) * 128 + (code & 127)])
    new = float(x[int(starts_h[q, 0]) * 128 + 5])
    row = q * p.rows_per_pack
    assert float(y[row] - y0[row]) == pytest.approx(new - old)


_CASE = re.compile(r"case (\d+):((?: b\[\d+\] = \d+;)+) return (\d+);")


@pytest.mark.parametrize("one_kernel", [False, True])
def test_generated_source_is_a_pure_function_of_the_pack(one_kernel):
    _, _, p = _packs("far_diagonals")
    starts_h, kc_h = port.static_windows(p)
    src = port.generate_static_source(p, starts_h, kc_h,
                                      one_kernel=one_kernel)
    _, _, p_again = _packs("far_diagonals")
    again = port.generate_static_source(p_again, *port.static_windows(
        p_again), one_kernel=one_kernel)
    assert src == again
    # the constants, parsed back, are the pack's windows
    tiles = re.split(r"int windows_(\d+)\(", src)[1:]
    assert len(tiles) == 2 * p.lanes.shape[0]
    for t, body in zip(tiles[::2], tiles[1::2]):
        cases = _CASE.findall(body.split("\n}\n")[0])
        assert len(cases) == p.ppt
        for q, sets, kc in cases:
            pk = int(t) * p.ppt + int(q)
            offs = [int(v) for v in re.findall(r"= (\d+);", sets)]
            assert int(kc) == kc_h[pk] == len(offs)
            np.testing.assert_array_equal(np.array(offs) // 128,
                                          starts_h[pk, : kc_h[pk]])
            assert all(o % 128 == 0 for o in offs)
    assert ("static_one" in src) == one_kernel
    assert src.count("__global__") == (1 if one_kernel
                                       else p.lanes.shape[0])


_LAUNCH = re.compile(r"cfg\.gridDim = dim3\((\d+)\);\n"
                     r"  cfg\.numAttrs = (\d);\n"
                     r"  if \(cudaError_t e = cudaLaunchKernelEx\(&cfg, "
                     r"static_tile_(\d+),")


def test_chain_tiles_are_dependent_launches():
    """The chain form keeps one kernel per tile, launched in tile order
    through cudaLaunchKernelEx: the first as any launch (it waits for the
    stream's earlier work), each later one with programmatic stream
    serialization, so tiles overlap on the device. Each kernel lets the
    next tile start on entry and, after writing its rows, waits for the
    tile before it, so the op after the last tile sees all of y. Blocks of
    128 threads; the one-kernel form is left as it was."""
    _, _, p = _packs("stencil_rcm")
    starts_h, kc_h = port.static_windows(p)
    src = port.generate_static_source(p, starts_h, kc_h, one_kernel=False)
    tiles = p.lanes.shape[0]
    assert src.count("__global__") == tiles and "<<<" not in src
    assert "constexpr int THREADS = 128;" in src
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in src
    launches = _LAUNCH.findall(src)
    assert [(int(t), int(a)) for _, a, t in launches] \
        == [(t, int(t > 0)) for t in range(tiles)]
    rows = p.ppt * p.rows_per_pack
    assert all(int(b) == -(-rows // 128) for b, _, _ in launches[:-1])
    for body in src.split("__global__")[1:]:
        body = body.split("\n}\n")[0]
        assert body.index("griddepcontrol.launch_dependents") \
            < body.index("y[r] = acc;") < body.index("griddepcontrol.wait")
    one = port.generate_static_source(p, starts_h, kc_h, one_kernel=True)
    assert "griddepcontrol" not in one and "<<<" in one
    assert "constexpr int THREADS = 256;" in one


def test_capped_source_holds_only_its_tiles():
    _, _, p = _packs("stencil_rcm")
    starts_h, kc_h = port.static_windows(p)
    src = port.generate_static_source(p, starts_h, kc_h, one_kernel=True,
                                      n_tiles=2)
    assert "windows_1(" in src and "windows_2(" not in src
    with pytest.raises(ValueError):
        port.generate_static_source(p, starts_h, kc_h, one_kernel=False,
                                    n_tiles=2)


def test_driver_on_the_cpu(capsys):
    out = driver.main(["--nx", "16", "--device", "cpu", "--reps", "2"])
    text = capsys.readouterr().out
    assert out["variant"] == "wsell" and out["max_err"] <= 1e-5
    assert "compile" in text and "GB/s" in text
    out = driver.main(["--nx", "16", "--device", "cpu", "--reps", "2",
                       "--one-kernel", "--n-tiles-cap", "1"])
    assert out["n_tiles"] == 1 and out["max_err"] <= 1e-5

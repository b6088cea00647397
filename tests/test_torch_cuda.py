"""Kernel tests that need a CUDA card: each hand-written kernel against its
plain PyTorch version on the card, the wrappers' input checks, and the CUDA
dispatch rules. They skip where there is no card.

On the card, with no JAX installed, run them without the suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from g4s_tpu_torch.engine import build_graph, mxv
from g4s_tpu_torch.ops import (bwell_spmv, route, segment, static_spmv,
                               wsell_spmv)
from g4s_tpu_torch.sparse import CSR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_permute_gather_bit_exact(cuda, dtype):
    rng = np.random.default_rng(0)
    m = 100003
    z = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    sigma = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
    before = route.LAUNCHES
    got = route.permute_gather(z, sigma)
    assert route.LAUNCHES == before + 1
    assert torch.equal(got, route._apply_permute_plain(z, sigma))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rem,off_s,off_z", [(0, 0, 0), (1, 1, 1), (3, 2, 0),
                                             (5, 3, 1), (7, 1, 3)])
def test_permute_gather_fused_bit_exact(cuda, dtype, rem, off_s, off_z):
    """Lengths off a multiple of 8, sigma reaching past len(z), n_out past
    len(sigma), sigma and z as views at offsets into their allocations."""
    rng = np.random.default_rng(rem)
    m = 8 * 5000 + rem
    sigma = torch.from_numpy(rng.permutation(m + off_s).astype(np.int32)) \
        .to(cuda)[off_s:]
    z = torch.from_numpy(rng.standard_normal(m - 100 + off_z)) \
        .to(cuda, dtype)[off_z:]
    n_out = m + 11
    want = route._apply_permute_plain(z, sigma, n_out=n_out)
    assert not want[m:].any() and int((want[:m] == 0).sum()) >= 100
    before = route.LAUNCHES
    got = route.permute_gather(z, sigma, n_out=n_out)
    assert route.LAUNCHES == before + 1
    assert got.shape == (n_out,) and torch.equal(got, want)


# (m, n_z, n_out, sigma offset, z offset) in units of the kernel's tile T
# (the outputs one block writes): ragged last tiles, fewer tiles than SMs,
# nothing to gather, a long zero tail, unaligned heads
TILE_CASES = {
    "T-1": lambda t: (t - 1, t - 1, t - 1, 0, 0),
    "T": lambda t: (t, t, t, 0, 0),
    "T+1": lambda t: (t + 1, t + 1, t + 1, 0, 0),
    "3T+5": lambda t: (3 * t + 5, 3 * t + 5, 3 * t + 5, 0, 0),
    "few-tiles": lambda t: (10 * t + 3, 10 * t + 3, 10 * t + 3, 0, 0),
    "m=0": lambda t: (0, t, 2 * t + 3, 0, 0),
    "n_z=0": lambda t: (2 * t + 1, 0, 2 * t + 1, 0, 0),
    "n_out-tiles-past-m": lambda t: (t + 7, t, 6 * t + 5, 0, 0),
    "offsets-1-3": lambda t: (4 * t + 2, 4 * t + 2, 4 * t + 9, 1, 3),
    "offsets-2-1": lambda t: (4 * t + 1, 4 * t - 5, 4 * t + 1, 2, 1),
    "offsets-3-2": lambda t: (3 * t + 3, 3 * t + 3, 5 * t, 3, 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_permute_gather_tile_edges(cuda, dtype, case):
    """The kernel at its tiles' edges, bit-exact against the plain version,
    one launch per call, one block per tile."""
    shape = route.permute_launch_shape(dtype, 1 << 20, device=cuda)
    t = shape["tile"]
    m, n_z, n_out, off_s, off_z = TILE_CASES[case](t)
    rng = np.random.default_rng(m + n_out)
    # a permutation of [0, m) with some indices past n_z and one negative
    perm = rng.permutation(m + off_s).astype(np.int32)
    if m > 2:
        perm[off_s + 1] = -1
    sigma = torch.from_numpy(perm).to(cuda)[off_s:]
    z = torch.from_numpy(rng.standard_normal(n_z + off_z)).to(
        cuda, dtype)[off_z:]
    want = route._apply_permute_plain(z, sigma, n_out=n_out)
    before = route.LAUNCHES
    got = route.permute_gather(z, sigma, n_out=n_out)
    assert route.LAUNCHES == before + 1
    assert got.shape == (n_out,) and torch.equal(got, want)
    small = route.permute_launch_shape(dtype, n_out, device=cuda)
    assert small["tile"] == t and small["grid"] == -(-n_out // t)
    assert small["blocks_per_sm"] >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_permute_gather_reads_what_the_kernel_before_wrote(cuda, dtype):
    """Two gathers back to back, the second's sigma made by a kernel right
    before it and its z the first's output: each reads the finished data."""
    m = 3 * route.permute_launch_shape(dtype, 1 << 20,
                                       device=cuda)["tile"] + 17
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    sigma1 = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
    for _ in range(3):
        a = route.permute_gather(z, sigma1, n_out=m + 5)
        sigma2 = ((torch.arange(m + 5, device=cuda) * 7919) % (m + 9)).int()
        b = route.permute_gather(a, sigma2)
        want_a = route._apply_permute_plain(z, sigma1, n_out=m + 5)
        assert torch.equal(a, want_a)
        assert torch.equal(b, route._apply_permute_plain(want_a, sigma2))
        z = b[:m]


def test_permute_gather_rejects_bad_inputs(cuda):
    z = torch.zeros(10, device=cuda)
    with pytest.raises(TypeError):
        route.permute_gather(z, torch.arange(10, device=cuda))   # int64
    with pytest.raises(TypeError):
        route.permute_gather(z.int(), torch.arange(10, device=cuda).int())
    with pytest.raises(ValueError):
        route.permute_gather(torch.zeros(20, device=cuda)[::2],
                             torch.arange(10, device=cuda).int())


@pytest.mark.parametrize("offs", [[0, 1], [-1, 0, 1, 300, -300],
                                  list(range(-6, 7)) + [300, -300, 1000]])
def test_wsell_kernel_matches_plain(cuda, offs):
    rng = np.random.default_rng(1)
    n = 4096
    a = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 shape=(n, n), format="csr").astype(np.float32)
    packed = wsell_spmv.pack_wsell(CSR.from_scipy(a), device=cuda,
                                   packs_per_tile=2)
    x_pad = torch.zeros(wsell_spmv._chain_pad(packed), device=cuda)
    x_pad[:n] = torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(cuda)
    got = wsell_spmv.spmv_wsell_chain(packed, x_pad)
    want = wsell_spmv._spmv_wsell_plain(packed, x_pad)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((got[n:] == 0).all())
    with pytest.raises(TypeError):
        wsell_spmv.spmv_wsell_chain(packed, x_pad.double())


def test_stencil_dispatches_to_wsell(cuda):
    nx = 24
    rng = np.random.default_rng(0)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    a = a[pp][:, pp].tocsr()
    g = build_graph(CSR.from_scipy(a), device=cuda)
    assert g.variant == "wsell" and g.perm is not None
    x = rng.standard_normal(a.shape[0]).astype(np.float32)
    y = mxv(g, torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(y, a.astype(np.float64) @ x, atol=1e-4)


def test_stencil_mxv_runs_three_kernels(cuda):
    """mxv on a renumbered stencil: the permute kernel twice (the first
    writes the chain-padded x itself), WSELL once, and no separate zero
    fill or pad copy."""
    from g4s_tpu_torch.obs.timings import device_kernels
    nx = 24
    rng = np.random.default_rng(4)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    a = a[pp][:, pp].tocsr()
    g = build_graph(CSR.from_scipy(a), device=cuda)
    assert g.variant == "wsell" and g.perm is not None
    x = torch.from_numpy(rng.standard_normal(nx ** 3)
                         .astype(np.float32)).to(cuda)
    mxv(g, x)
    before = (route.LAUNCHES, wsell_spmv.LAUNCHES)
    names = device_kernels(lambda: mxv(g, x))
    assert (route.LAUNCHES - before[0], wsell_spmv.LAUNCHES - before[1]) \
        == (2, 1)
    assert len(names) == 3, names
    assert sum("permute_gather" in k for k in names) == 2, names


@pytest.mark.parametrize("mode,offs", [
    ("pack", list(range(-7, 9))),     # the 16-diagonal band, W = 16
    ("row", list(range(-7, 9))),
    ("row", [0, 1]),                  # W = 2: 512-row packs, mode row
])
def test_bwell_kernel_matches_plain(cuda, mode, offs):
    rng = np.random.default_rng(2)
    n = 4096
    a = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 shape=(n, n), format="csr").astype(np.float32)
    packed = bwell_spmv.pack_bwell(CSR.from_scipy(a), packs_per_tile=4,
                                   mode=mode, device=cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    before = bwell_spmv.LAUNCHES
    got = bwell_spmv.spmv_bwell(packed, x, packs_per_batch=2)
    assert bwell_spmv.LAUNCHES == before + 1
    x_pad = torch.zeros(n + bwell_spmv.X_PAD, device=cuda)
    x_pad[:n] = x
    want = bwell_spmv._spmv_bwell_plain(packed, x_pad)[:n]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(TypeError):
        bwell_spmv.spmv_bwell(packed, x.double())


def test_mxm_on_cuda_takes_esc(cuda):
    """Plus-times with >= 2^18 products on a CUDA device dispatches to ESC
    and matches scipy: structure exactly, values to 1e-5."""
    from g4s_tpu_torch.engine import dispatch
    from g4s_tpu_torch.ops import spgemm_esc
    n = 1 << 12
    rng = np.random.default_rng(3)
    nnz = n * 16
    a = sp.coo_matrix((rng.standard_normal(nnz).astype(np.float32),
                       (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
                      shape=(n, n)).tocsr()
    A = CSR.from_scipy(a)
    calls = []
    orig = spgemm_esc.esc_numeric
    spgemm_esc.esc_numeric = lambda *args: calls.append(1) or orig(*args)
    try:
        c = dispatch.mxm(A, A, device=cuda)
    finally:
        spgemm_esc.esc_numeric = orig
    assert calls == [1]
    ref = (a.astype(np.float64) @ a.astype(np.float64)).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(c.indptr.cpu().numpy(), ref.indptr)
    np.testing.assert_array_equal(c.indices.cpu().numpy(), ref.indices)
    got = c.data.cpu().numpy().astype(np.float64)
    assert np.abs(got - ref.data).max() <= 1e-5 * np.abs(ref.data).max()


def test_citcoms_step_on_cuda_matches_cpu(cuda):
    """The CitcomS model at 5x5x4 with a moving lid (the mesh of the CPU
    parity tests): the initial solve and one f64 step on the card against
    the same on the CPU, with the same Uzawa and CG counts; the state stays
    on the card. (Over two steps the second step's 20-iteration Uzawa
    solve left the two devices' V 2.7e-9 apart on an H100, the sums falling
    in other orders, so the test takes one.)"""
    from g4s_tpu_torch.models.citcoms import CitcomConfig, CitcomModel
    cfg = CitcomConfig(nodex=5, nodey=5, nodez=4, theta_min=0.7854,
                       theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                       num_mat=4, rayleigh=1e5, topvbc=1, topvbxval=100.0)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        s, hist = CitcomModel(cfg, device=dev).run(1)
        runs.append((s, [(d.uzawa_iterations, d.inner_iterations)
                         for d in hist]))
    (sg, cg), (sc, cc) = runs
    assert sg.V.is_cuda and sg.step == 1 and cg == cc
    for name in ("T", "V", "P", "dt"):
        g, c = getattr(sg, name).cpu(), getattr(sc, name)
        assert (g - c).abs().max() <= 1e-9 * c.abs().max(), name


def test_deepmd_energy_force_virial_on_cuda_matches_cpu(cuda):
    """The se_e2_a model at tests/test_deepmd.py's tiny_spec widths on a
    20-atom frame and a batch of 3 such frames: E, F and the virial in f64
    on the card against the CPU within 1e-10, relative to each one's
    largest magnitude."""
    from g4s_tpu_torch.models.deepmd import (DescriptorSpec, ModelSpec,
                                             energy_force_virial,
                                             init_params)
    from g4s_tpu_torch.models.deepmd.model import params_to
    spec = ModelSpec(DescriptorSpec(rcut=3.0, rcut_smth=0.5, sel=(6, 10),
                                    ntypes=2),
                     embed_neurons=(4, 8, 16), axis_neuron=4,
                     fit_neurons=(16, 16))
    params = init_params(torch.Generator().manual_seed(0), spec)
    rng = np.random.default_rng(1234)
    types = torch.from_numpy(np.sort(rng.integers(0, 2, 20)))
    coords = torch.from_numpy(rng.uniform(0, 7.0, (3, 20, 3)))
    box = torch.eye(3, dtype=torch.float64).expand(3, 3, 3) * 7.0
    for c, b in ((coords[0], box[0]), (coords, box)):
        want = energy_force_virial(params, spec, c, b, types)
        got = energy_force_virial(params_to(params, device=cuda), spec,
                                  c.to(cuda), b.to(cuda), types.to(cuda))
        for name, g, w in zip("EFW", got, want):
            assert g.is_cuda
            assert (g.cpu() - w).abs().max() <= 1e-10 * w.abs().max(), name


@pytest.mark.parametrize("descriptor_type", ["se_atten", "se_a_ebd",
                                             "se_t", "hybrid", "loc_frame",
                                             "se_a_mask"])
def test_deepmd_descriptors_on_cuda_match_cpu(cuda, descriptor_type):
    """Each of the other descriptors at tiny_spec widths on a batch of 3
    frames of 20 atoms: E, F and the virial in f64 on the card against the
    CPU within 1e-10, relative to each one's largest magnitude."""
    from g4s_tpu_torch.models.deepmd import (DescriptorSpec, ModelSpec,
                                             energy_force_virial,
                                             init_params)
    from g4s_tpu_torch.models.deepmd.model import params_to
    spec = ModelSpec(DescriptorSpec(rcut=3.0, rcut_smth=0.5, sel=(6, 10),
                                    ntypes=2),
                     embed_neurons=(4, 8, 16), axis_neuron=4,
                     fit_neurons=(16, 16), descriptor_type=descriptor_type)
    params = init_params(torch.Generator().manual_seed(0), spec)
    rng = np.random.default_rng(1234)
    types = torch.from_numpy(np.sort(rng.integers(0, 2, 20)))
    coords = torch.from_numpy(rng.uniform(0, 7.0, (3, 20, 3)))
    box = torch.eye(3, dtype=torch.float64).expand(3, 3, 3) * 7.0
    want = energy_force_virial(params, spec, coords, box, types)
    got = energy_force_virial(params_to(params, device=cuda), spec,
                              coords.to(cuda), box.to(cuda), types.to(cuda))
    for name, g, w in zip("EFW", got, want):
        assert g.is_cuda
        assert (g.cpu() - w).abs().max() <= 1e-10 * w.abs().max(), name


def test_env_mat_celllist_on_cuda_matches_env_mat(cuda):
    """The cell list at 4 cells per side on the card: R within 1e-12 of
    the all-pairs env_mat and the same neighbor sets."""
    from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec,
                                                        env_mat,
                                                        env_mat_celllist)
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(0, 14.0, (200, 3))).to(cuda)
    b = torch.eye(3, dtype=torch.float64, device=cuda) * 14.0
    ty = torch.from_numpy(np.sort(rng.integers(0, 2, 200))).to(cuda)
    spec = DescriptorSpec(3.5, 0.5, (12, 20), 2)
    R1, nl1 = env_mat(c, b, ty, spec)
    R2, nl2 = env_mat_celllist(c, b, ty, spec, max_per_cell=32)
    assert (R2 - R1).abs().max() <= 1e-12 * R1.abs().max()
    assert torch.equal(torch.sort(nl1, dim=1)[0], torch.sort(nl2, dim=1)[0])


def test_deepmd_train_step_on_cuda_matches_cpu(cuda):
    """One Trainer step (energy, force and virial terms; the force term's
    double backward) at tiny_spec widths on a batch of 3 frames of 20
    atoms, f64, on the card against the CPU: the loss and every parameter
    leaf within 1e-10 (the card's gather backward adds atomically, so not
    bitwise)."""
    from g4s_tpu_torch.ckpt import tree_leaves
    from g4s_tpu_torch.models.deepmd import (DescriptorSpec, ModelSpec,
                                             init_params)
    from g4s_tpu_torch.models.deepmd.model import params_to
    from g4s_tpu_torch.models.deepmd.train import (LossConfig, LRConfig,
                                                   Trainer, batch_to)
    spec = ModelSpec(DescriptorSpec(rcut=3.0, rcut_smth=0.5, sel=(6, 10),
                                    ntypes=2),
                     embed_neurons=(4, 8, 16), axis_neuron=4,
                     fit_neurons=(16, 16))
    params = init_params(torch.Generator().manual_seed(0), spec)
    rng = np.random.default_rng(5)
    raw = dict(coord=rng.uniform(0, 7.0, (3, 20, 3)),
               box=np.tile(np.eye(3) * 7.0, (3, 1, 1)),
               energy=rng.normal(size=3), force=rng.normal(size=(3, 20, 3)),
               virial=rng.normal(size=(3, 3, 3)),
               types=np.sort(rng.integers(0, 2, 20)))
    tr = Trainer(spec, LossConfig(0.5, 1.0, 100.0, 1.0, 0.1, 0.5),
                 LRConfig(1e-3, 1e-5, 2, 10))
    out = []
    for p in (params, params_to(params, device=cuda)):
        like = tree_leaves(p)[0]
        out.append(tr._update(p, tr.init(p), batch_to(raw, like), 0))
    (pc, _, lc, _), (pg, _, lg, _) = out
    assert lg.is_cuda and abs(float(lg) - float(lc)) <= 1e-10 * abs(float(lc))
    for c, g in zip(tree_leaves(pc), tree_leaves(pg)):
        assert g.is_cuda
        assert (g.cpu() - c).abs().max() <= 1e-10 * c.abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sorted_segment_sum_is_repeatable_and_in_order(cuda, dtype):
    """About 2^20 values that cancel heavily (each appears with both signs,
    magnitudes 1e-8..1e8): two kernel calls are bitwise equal, and bitwise
    equal to the host CPU's index_add_, which adds each segment in index
    order as the kernel does."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    big = rng.standard_normal(n // 2) * 10.0 ** rng.integers(-8, 9, n // 2)
    data = torch.from_numpy(np.concatenate([big, -big])[rng.permutation(n)])
    ids = torch.from_numpy(np.sort(rng.integers(0, 4096, n)))
    d, i = data.to(cuda, dtype), ids.to(cuda)
    before = segment.LAUNCHES
    a = segment.sorted_segment_sum(d, i, 5000)
    b = segment.sorted_segment_sum(d, i, 5000)
    assert segment.LAUNCHES == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), segment._sorted_segment_sum_plain(
        d.cpu(), ids, 5000))
    assert not a[4096:].any()


def test_sorted_segment_sum_order_and_trailing_dims(cuda):
    rng = np.random.default_rng(1)
    n = 30000
    data = torch.from_numpy(rng.standard_normal((n, 3, 3)))
    order = torch.from_numpy(rng.permutation(n))
    ids = torch.from_numpy(np.sort(rng.integers(0, 2000, n)))
    got = segment.sorted_segment_sum(data.to(cuda), ids.to(cuda), 2100,
                                     order=order.to(cuda))
    want = segment._sorted_segment_sum_plain(data, ids, 2100, order=order)
    assert torch.equal(got.cpu(), want)
    empty = segment.sorted_segment_sum(
        torch.zeros((0, 2), device=cuda, dtype=torch.float64),
        torch.zeros(0, dtype=torch.int64, device=cuda), 3)
    assert empty.shape == (3, 2) and not empty.any()


def test_sorted_segment_sum_dtype_routing(cuda):
    """Integer sums keep index_add_ (their order does not matter); f16 and
    bf16 raise rather than falling back."""
    ids = torch.tensor([0, 0, 2], device=cuda)
    before = segment.LAUNCHES
    got = segment.sorted_segment_sum(torch.tensor([1, 2, 3], device=cuda),
                                     ids, 3)
    assert segment.LAUNCHES == before
    assert got.tolist() == [3, 0, 3]
    for dt in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            segment.sorted_segment_sum(torch.ones(3, device=cuda, dtype=dt),
                                       ids, 3)


def _runs_case(seed: int):
    """Sorted ids whose runs are 1, 8, 1,089 and 5,000 rows long and cross
    the kernel's 32-row lookahead, its block rows and its 256- to
    2,048-row chunks (31-33, 224-225, 256-257, 1,023-1,025, 2,049 rows),
    between runs of 1-8: ids below 0 first and at or past num_segments
    last (dropped), empty segments at both ends and between runs. Returns
    (ids, S)."""
    rng = np.random.default_rng(seed)
    lengths = [1, 8, 1089, 5000, 31, 32, 33, 224, 225, 256, 257, 1023,
               1024, 1025, 2049]
    lengths += list(rng.integers(1, 9, 400))
    rng.shuffle(lengths)
    gaps = rng.integers(1, 3, len(lengths))
    ids = np.concatenate([np.full(3, -2), np.full(2, -1)]
                         + [np.full(n, s) for n, s in
                            zip(lengths, 3 + np.cumsum(gaps))])
    top = int(ids[-1]) + 1
    ids = np.concatenate([ids, np.full(4, top + 2), np.full(3, top + 9)])
    return ids, top + 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 9, 20])
def test_sorted_segment_sum_runs_and_edges(cuda, dtype, index, d):
    """Runs of 1 to 5,000 rows across the kernel's block and chunk
    boundaries, empty segments at both ends, dropped ids, with and without
    `order`, 1 to 20 columns (two column tiles at 20), int32 and int64 ids:
    two calls bitwise equal, and bitwise equal to the host CPU's in-order
    sum of the rows whose ids are kept (index_add_ refuses the others)."""
    ids_np, num = _runs_case(d)
    n = ids_np.size
    rng = np.random.default_rng(d + 1)
    data = torch.from_numpy(rng.standard_normal((n, d)) * 10.0
                            ** rng.integers(-8, 9, (n, d)))
    if d == 1:
        data = data[:, 0].contiguous()
    order = torch.from_numpy(rng.permutation(n))
    ids = torch.from_numpy(ids_np)
    keep = (ids >= 0) & (ids < num)
    for o in (None, order):
        rows = data if o is None else data[o]
        want = segment._sorted_segment_sum_plain(
            rows[keep].to(dtype), ids[keep], num)
        args = (data.to(cuda, dtype), ids.to(cuda, index), num)
        kw = {} if o is None else {"order": o.to(cuda, index)}
        before = segment.LAUNCHES
        a = segment.sorted_segment_sum(*args, **kw)
        b = segment.sorted_segment_sum(*args, **kw)
        assert segment.LAUNCHES == before + 2
        assert torch.equal(a, b) and torch.equal(a.cpu(), want)
        assert not a[:3].any() and not a[-2:].any()


def test_sorted_segment_sum_citcoms_plans(cuda):
    """The three sorted sums of the CitcomS step, through the model's own
    int32 plans at 9x9x5: the stencil build (f64 and f32 element blocks
    into nno*27 slots), an assembly scatter (ScatterPlan, 3 columns) and
    the buoyancy layer sums (runs of 81 nodes): bitwise equal to the host
    CPU's in-order sums and between two calls."""
    from g4s_tpu_torch.models.citcoms import (CitcomConfig, CitcomModel,
                                              nodal)
    cfg = CitcomConfig(nodex=9, nodey=9, nodez=5, theta_min=0.7854,
                       theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                       num_mat=4, rayleigh=1e5)
    rng = np.random.default_rng(4)
    for dtype in (torch.float64, torch.float32):
        m = CitcomModel(cfg, dtype=dtype, device=cuda)
        sp_, sc = m.stencil_plan, m.plan
        assert {sp_.order.dtype, sp_.seg_ids.dtype, sc.order.dtype,
                sc.seg_ids.dtype, m._layer_order.dtype,
                m._layer_sorted.dtype} == {torch.int32}
        nel, nno = m.mesh.nel, m.mesh.nno
        cases = [
            (torch.from_numpy(rng.standard_normal((nel * 64, 9))),
             sp_.seg_ids, sp_.order, nno * 27),
            (torch.from_numpy(rng.standard_normal((nel * 8, 3))),
             sc.seg_ids, sc.order, nno),
            (torch.from_numpy(rng.standard_normal(nno)),
             m._layer_sorted, m._layer_order, cfg.nodez)]
        for data, ids, order, num in cases:
            x = data.to(cuda, dtype)
            a = segment.sorted_segment_sum(x, ids, num, order=order)
            b = segment.sorted_segment_sum(x, ids, num, order=order)
            want = segment._sorted_segment_sum_plain(
                data.to(dtype), ids.cpu(), num, order=order.cpu())
            assert torch.equal(a, b) and torch.equal(a.cpu(), want)
        st = nodal.build_stencil(
            m._build_ops(m.init_state().T).elt_k, sp_)
        assert st.W.device.type == cuda.type
        assert bool(torch.isfinite(st.W).all())


@pytest.mark.parametrize("offs", [[-1, 0, 1, 300, -300],
                                  list(range(-6, 7)) + [300, -300, 1000]])
def test_static_kernels_match_plain_and_wsell(cuda, offs):
    """Both generated forms, and the one kernel capped at 2 tiles, against
    the plain version within a relative 1e-5 and against the wsell_spmv
    kernel on the same pack (the same products summed in the same order)."""
    rng = np.random.default_rng(2)
    n = 2048
    a = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 shape=(n, n), format="csr").astype(np.float32)
    packed = wsell_spmv.pack_wsell(CSR.from_scipy(a), device=cuda,
                                   packs_per_tile=4)
    starts_h, kc_h = static_spmv.static_windows(packed)
    x_pad = torch.zeros(wsell_spmv._chain_pad(packed), device=cuda)
    x_pad[:n] = torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(cuda)
    y_ws = wsell_spmv.spmv_wsell_chain(packed, x_pad)
    tiles = packed.lanes.shape[0]
    for f in (static_spmv.build_static_chain(packed, starts_h, kc_h),
              static_spmv.build_static_one_kernel(packed, starts_h, kc_h),
              static_spmv.build_static_one_kernel(packed, starts_h, kc_h,
                                                  2)):
        chain0, one0 = static_spmv.CHAIN_LAUNCHES, static_spmv.ONE_LAUNCHES
        got = f(x_pad)
        assert (static_spmv.CHAIN_LAUNCHES - chain0,
                static_spmv.ONE_LAUNCHES - one0) \
            == ((0, 1) if f.one_kernel else (tiles, 0))
        want = static_spmv._static_spmv_plain(packed, starts_h, kc_h, x_pad,
                                              f.n_tiles)
        assert got.shape == want.shape == (f.n_out,)
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
        assert torch.equal(got, y_ws[: f.n_out])
    with pytest.raises(TypeError):
        f(x_pad.double())


def test_cantera_rhs_and_jacobian_on_cuda_match_cpu(cuda, tmp_path):
    """The constant-volume reactor on chip_smoke.py's small synthetic
    mechanism (both phases): the Redlich-Kwong initial state within 1e-13,
    and the RHS and its jacfwd Jacobian at y0 and at a perturbed state
    within 1e-11 of their largest entry, the card against the host CPU, in
    f64."""
    from chip_smoke import _synthetic_mechanism_yaml
    from g4s_tpu_torch.models.cantera import (IdealGasConstVolumeReactor,
                                              load_mechanism, stoich_mixture)
    path = str(tmp_path / "small.yaml")
    _synthetic_mechanism_yaml(path, nspec=15, nrxn=30, n_falloff=2,
                              n_three_body=2, seed=0)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    rng = np.random.default_rng(4)
    for phase, real in (("nDodecane_RK", True), ("nDodecane_IG", False)):
        mech = load_mechanism(path, phase)
        card = IdealGasConstVolumeReactor(mech, real_gas=real, device=cuda)
        host = IdealGasConstVolumeReactor(mech, real_gas=real, device="cpu")
        X = stoich_mixture(mech)
        y0 = host.initial_state(1000.0, 40 * 101325.0, X)
        assert rel(card.initial_state(1000.0, 40 * 101325.0, X), y0) \
            <= 1e-13
        y_mid = y0 * torch.from_numpy(rng.uniform(0.5, 1.5, y0.shape[0]))
        y_mid[0] = 1650.0
        for y in (y0, y_mid):
            assert rel(card.rhs(0.0, y.to(cuda)), host.rhs(0.0, y)) <= 1e-11
            assert rel(torch.func.jacfwd(card.rhs, argnums=1)(0.0,
                                                              y.to(cuda)),
                       torch.func.jacfwd(host.rhs, argnums=1)(0.0, y)) \
                <= 1e-11


def _small_flames(tmp_path, device):
    """Port flames on chip_smoke.py's small synthetic mechanism (ideal-gas
    phase, transport blocks), on `device`, and a stoichiometric
    n-dodecane/air inlet."""
    from chip_smoke import _synthetic_mechanism_yaml
    from g4s_tpu_torch.models.cantera import load_mechanism, load_transport
    from g4s_tpu_torch.models.cantera import flame
    path = str(tmp_path / "small.yaml")
    _synthetic_mechanism_yaml(path, nspec=15, nrxn=30, n_falloff=2,
                              n_three_body=2, seed=0)
    mech = load_mechanism(path, "nDodecane_IG")
    tr = load_transport(path, mech)
    X = np.zeros(mech.nspec)
    X[mech.species_index("c12h26")] = 1.0
    X[mech.species_index("o2")] = 18.5
    X[mech.species_index("n2")] = 69.56
    Y = X * mech.mol_weights / (X * mech.mol_weights).sum()
    return mech, tr, Y, [
        flame.BurnerFlame(mech, tr, n_points=8, width=0.01, mdot=0.08,
                          T_burner=400.0, device=device),
        flame.BurnerFlame(mech, tr, n_points=8, width=0.01, mdot=0.08,
                          T_burner=400.0, transport="multi", soret=True,
                          device=device),
        flame.FreeFlame(mech, tr, n_points=8, width=0.006, T_inlet=400.0,
                        device=device),
        flame.ImpingingJet(mech, tr, n_points=8, width=0.01, T_inlet=400.0,
                           device=device)]


def test_flame_rhs_and_jacobian_on_cuda_match_cpu(cuda, tmp_path):
    """The burner flame (mixture-averaged, and multicomponent with Soret),
    the free flame and the impinging jet on the small synthetic mechanism:
    RHS and the Jacobian the march uses (coloured block tridiagonal for
    the burner, chunked columns for the others) at the initial profile,
    the card within 1e-11 of the host CPU's largest entry, f64."""
    _, _, Y, card = _small_flames(tmp_path, cuda)
    _, _, _, host = _small_flames(tmp_path, "cpu")

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    for fc, fh in zip(card, host):
        y = fh.initial_profile(Y)
        yc = fc.initial_profile(Y)
        assert torch.equal(yc.cpu(), y)
        assert rel(fc.rhs(0.0, yc), fh.rhs(0.0, y)) <= 1e-11
        assert rel(fc.jacobian(0.0, yc), fh.jacobian(0.0, y)) <= 1e-11


def test_equilibrium_on_cuda_matches_cpu(cuda, tmp_path):
    """equilibrate_tp and equilibrate_hp of the stoichiometric inlet and
    advance_coverages on chip_smoke.py's synthetic interface, the card
    within 1e-10 (coverages 1e-9) of the host CPU."""
    from chip_smoke import _synthetic_interface_yaml
    from g4s_tpu_torch.models.cantera import equilibrium, surface
    mech, _, Y, _ = _small_flames(tmp_path, "cpu")
    x0 = Y / mech.mol_weights
    for T in (1200.0, 2600.0):
        a = equilibrium.equilibrate_tp(mech, T, 101325.0, x0, device=cuda)
        b = equilibrium.equilibrate_tp(mech, T, 101325.0, x0, device="cpu")
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    Ta, xa = equilibrium.equilibrate_hp(mech, -2.5e5, 101325.0, x0,
                                        device=cuda)
    Tb, xb = equilibrium.equilibrate_hp(mech, -2.5e5, 101325.0, x0,
                                        device="cpu")
    assert abs(Ta - Tb) <= 1e-10 * Tb
    assert np.abs(xa - xb).max() <= 1e-10 * np.abs(xb).max()
    path = str(tmp_path / "surf.yaml")
    _synthetic_interface_yaml(path, seed=0)
    X = np.zeros(mech.nspec)
    X[mech.species_index("o2")] = 0.2
    X[mech.species_index("h2o")] = 0.05
    X[mech.species_index("co")] = 0.02
    X[mech.species_index("n2")] = 0.73
    conc = X * 101325.0 / (8.314462618 * 900.0)
    th0 = np.zeros(12)
    th0[0] = th0[1] = 0.5
    out = [surface.advance_coverages(
        surface.load_interface(path, mech, device=d), mech, 900.0, conc,
        th0, 1e-3)[0].cpu() for d in (cuda, "cpu")]
    assert float((out[0] - out[1]).abs().max()) <= 1e-9
    assert abs(float(out[0].sum()) - 1.0) <= 1e-12


def test_steam_table_on_cuda_matches_cpu(cuda):
    """torch.func.vmap of the IAPWS-95 density, h, s, p and alpha over a
    16 x 16 grid of liquid states (chip_smoke.py phase 19's ranges), the
    card within 1e-12 of the host CPU."""
    from chip_smoke import _steam_grid, _steam_table
    T, P = _steam_grid((16, 16))
    card = _steam_table(T.to(cuda), P.to(cuda))
    host = _steam_table(T, P)
    for k, v in host.items():
        assert (card[k].cpu() - v).abs().max() <= 1e-12 * v.abs().max(), k


def test_hmw_partial_molar_props_on_cuda_matches_cpu(cuda, tmp_path):
    """partial_molar_props and activity_all on chip_smoke.py's synthetic
    seawater (variable A_Debye, HKFT, Mu0Poly, Shomate and IAPWS standard
    states) at two states of phase 19's sweep, the card within 1e-10 of
    the host CPU."""
    from chip_smoke import _hmw_states, _synthetic_brine_yaml
    from g4s_tpu_torch.models.cantera import hmw
    path = str(tmp_path / "brine.yaml")
    _synthetic_brine_yaml(path, seed=0)
    ph = hmw.load_hmw(path, "seawater")
    for T, m in _hmw_states(ph, 2):
        for f in (lambda d: hmw.partial_molar_props(ph, T, 101325.0, m,
                                                    device=d),
                  lambda d: hmw.activity_all(ph, m, T, device=d)):
            card, host = f(cuda), f("cpu")
            for k, v in host.items():
                assert (card[k].cpu() - v).abs().max() \
                    <= 1e-10 * v.abs().max(), k


def _small_citcoms(device, **kw):
    from g4s_tpu_torch.models.citcoms import CitcomModel
    from g4s_tpu_torch.models.citcoms.config import CitcomConfig
    cfg = CitcomConfig(nodex=9, nodey=9, nodez=5, theta_min=0.7854,
                       theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                       radius_inner=0.55, radius_outer=1.0, num_mat=4,
                       rayleigh=1e5, topvbc=1, topvbxval=100.0, **kw)
    return CitcomModel(cfg, device=device)


def test_gauss_seidel_sweep_on_cuda_matches_cpu(cuda):
    """Three sweeps of the 8-color smoother, f64: the card within 1e-12 of
    the host CPU."""
    from g4s_tpu_torch.models.citcoms import nodal
    out = []
    rng = np.random.default_rng(11)
    F = rng.standard_normal((405, 3))
    u = rng.standard_normal((405, 3))
    for dev in ("cpu", cuda):
        m = _small_citcoms(dev)
        ops = m._build_ops(m.init_state().T)
        st = nodal.build_stencil(ops.elt_k, m.stencil_plan)
        D = nodal.stencil_block_dinv(st, m.vbc_mask)
        plan = nodal.GSPlan.build(m.stencil_plan)
        colors = nodal.GSColors.build(st, D, m.vbc_mask, plan)
        out.append(nodal.gauss_seidel_colored(
            colors, torch.from_numpy(F).to(dev), torch.from_numpy(u).to(dev),
            3).cpu())
    assert float((out[1] - out[0]).abs().max()) <= \
        1e-12 * float(out[0].abs().max())


def test_project_down_on_cuda_is_repeatable(cuda):
    """project_down sums through the segment-sum kernel: two card calls
    bitwise equal, and equal to the host CPU's in-order sum."""
    from g4s_tpu_torch.models.citcoms import multigrid
    m = _small_citcoms(cuda, solver_type="multigrid", levels=2)
    interp = m.mg.levels[1].interp
    r = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (405, 3))).to(cuda)
    before = segment.LAUNCHES
    a = multigrid.project_down(interp, r)
    b = multigrid.project_down(interp, r)
    assert segment.LAUNCHES == before + 2
    assert torch.equal(a, b)
    cpu = multigrid.Interp(*(x.cpu() if isinstance(x, torch.Tensor) else x
                             for x in interp))
    assert torch.equal(a.cpu(), multigrid.project_down(cpu, r.cpu()))


def test_full_sphere_step_on_cuda_matches_cpu(cuda):
    """The full sphere at 5x5x4 per cap (the CPU parity tests' mesh and
    blob): the initial solve and one f64 step on the card against the same
    on the CPU at the parity tests' fixed cap (1 Uzawa x 20 CG iterations,
    before the free-slip nullspace amplifies rounding), with equal counts,
    within 1e-10; the net-rotation removal and the step wait for the
    device only at the solver loops' counted reads."""
    import dataclasses
    import warnings
    from g4s_tpu_torch.models.citcoms import (CitcomConfig, FullSphereModel,
                                              solvers)
    cfg = CitcomConfig(nodex=5, nodey=5, nodez=4, radius_inner=0.55,
                       radius_outer=1.0, rayleigh=1e5, num_mat=1,
                       accuracy=0.0, piterations=1, vlowstep=20)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        m = FullSphereModel(cfg, device=dev)
        s = m.init_state()
        blob = np.exp(-np.sum((m._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                              axis=1) / 0.05)
        s = dataclasses.replace(s, T=torch.from_numpy(np.clip(
            s.T.cpu().numpy() + 0.3 * blob, 0, 1)).to(dev))
        s, mon = m.initial_solve(s)
        waits = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                m.remove_net_rotation(s.V)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    solvers.HOST_SYNCS = 0
                    m.step(s)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            waits = sum("synchroniz" in str(w.message) for w in caught)
            assert waits == solvers.HOST_SYNCS > 0
        s1, d = m.step(s)
        runs.append((s1, (mon.outer_iterations, mon.inner_iterations,
                          d.uzawa_iterations, d.inner_iterations)))
    (sg, cg), (sc, cc) = runs
    assert sg.V.is_cuda and cg == cc == (1, 40, 1, 40)
    for name in ("T", "V", "P", "dt"):
        g, c = getattr(sg, name).cpu(), getattr(sc, name)
        assert (g - c).abs().max() <= 1e-10 * c.abs().max(), name


def test_sorted_segment_sum_full_sphere_plans(cuda):
    """The full sphere's sorted sums through its own int32 plans at 9x9x5
    per cap: the layer sums (nno rows into nodez layers, runs of 770) and
    the assembly scatter (nel*8 rows, runs of 1-8), bitwise equal to the
    host CPU's in-order sums and between two calls."""
    from g4s_tpu_torch.models.citcoms import CitcomConfig, FullSphereModel
    cfg = CitcomConfig(nodex=9, nodey=9, nodez=5, radius_inner=0.55,
                       radius_outer=1.0, rayleigh=1e5, num_mat=1)
    rng = np.random.default_rng(13)
    for dtype in (torch.float64, torch.float32):
        m = FullSphereModel(cfg, dtype=dtype, device=cuda)
        nel, nno = m.mesh.nel, m.mesh.nno
        cases = [(torch.from_numpy(rng.standard_normal(nno)),
                  m._layer_sorted, m._layer_order, cfg.nodez),
                 (torch.from_numpy(rng.standard_normal((nel * 8, 3))),
                  m.plan.seg_ids, m.plan.order, nno)]
        for data, ids, order, num in cases:
            assert ids.dtype == order.dtype == torch.int32
            x = data.to(cuda, dtype)
            before = segment.LAUNCHES
            a = segment.sorted_segment_sum(x, ids, num, order=order)
            b = segment.sorted_segment_sum(x, ids, num, order=order)
            assert segment.LAUNCHES == before + 2
            want = segment._sorted_segment_sum_plain(
                data.to(dtype), ids.cpu(), num, order=order.cpu())
            assert torch.equal(a, b) and torch.equal(a.cpu(), want)


# ---------------------------------------------------------------------------
# torch.distributed on the card: one NCCL rank per card
# ---------------------------------------------------------------------------


def test_multichip_driver_on_the_card(cuda, tmp_path):
    """drivers/multichip.py --device cuda at the reference's tiny settings
    on every visible card (at most 4): NCCL, the four stages in order,
    OK; asking for one rank more than there are cards raises."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from chip_smoke import _synthetic_mechanism_yaml
    mech = str(tmp_path / "small.yaml")
    _synthetic_mechanism_yaml(mech, nspec=15, nrxn=30, n_falloff=2,
                              n_three_body=2, seed=0)
    world = min(torch.cuda.device_count(), 4)
    cmd = [sys.executable, "-m", "g4s_tpu_torch.drivers.multichip",
           "--world", str(world), "--device", "cuda", "--mech", mech,
           "--rk-phase", "nDodecane_RK", "--ig-phase", "nDodecane_IG",
           "--fuel", "c12h26", "--ntc-temps",
           ",".join(str(1450.0 + 25 * i) for i in range(world)),
           "--ntc-t-end", "3.2e-4"]
    env = dict(os.environ, PYTHONPATH=repo)
    p = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith(f"multichip: world={world} backend=nccl")
    assert lines[-1].startswith(f"multichip({world}):")
    assert lines[-1].endswith(" OK")
    cmd[4] = str(torch.cuda.device_count() + 1)
    q = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                       text=True, timeout=300)
    assert q.returncode != 0 and "each rank needs a card" in q.stderr


def test_distributed_citcom_on_cuda_matches_one_device(cuda):
    """One NCCL rank: DistributedCitcom's f64 step at a fixed cap on the
    card equals CitcomModel's element-by-element step on the card within
    1e-10, and two runs are bitwise equal."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = r"""
import torch
from g4s_tpu_torch.parallel import RankGrid, init_from_env
from g4s_tpu_torch.models.citcoms import CitcomConfig, CitcomModel
from g4s_tpu_torch.models.citcoms.distributed import DistributedCitcom
dev = init_from_env("cuda")
cfg = CitcomConfig(nodex=9, nodey=9, nodez=5, theta_min=0.7854,
                   theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                   radius_inner=0.55, radius_outer=1.0, rayleigh=1e5,
                   topvbc=1, topvbxval=100.0, num_mat=4, accuracy=0.0,
                   piterations=3, vlowstep=60)
d = DistributedCitcom(cfg, RankGrid(("bx", "by"), (1, 1)), device=dev)
a, da = d.step(d.init_state())
b, db = d.step(d.init_state())
assert all(torch.equal(a[k], b[k]) for k in a)
m = CitcomModel(cfg, device=dev, matvec="eltk")
s, dm = m.step(m.init_state())
for k in ("T", "Tdot", "V", "P"):
    e = float((a[k] - getattr(s, k)).abs().max()
              / getattr(s, k).abs().max())
    assert e <= 1e-10, (k, e)
assert (da.uzawa_iterations, da.inner_iterations) == (
    dm.uzawa_iterations, dm.inner_iterations)
print("ok")
"""
    from g4s_tpu_torch.parallel import launch
    env = dict(os.environ, PYTHONPATH=repo)
    launch.run_ranks(1, lambda r: [sys.executable, "-c", code], env=env,
                     cwd=repo, timeout=300)


def test_band_factor_and_solve_on_cuda_match_cpu(cuda):
    """ops/banded.py's no-pivot band LU and solve (one and three right-hand
    sides) on the card against the host CPU within 1e-10, f64."""
    from g4s_tpu_torch.ops import banded
    rng = np.random.default_rng(11)
    n, ml, mu = 200, 3, 3
    M = 4.0 * np.eye(n)
    for d in range(-ml, mu + 1):
        M += np.diag(rng.standard_normal(n - abs(d)), d)
    R = banded.dense_to_band(torch.from_numpy(M), ml, mu)
    fac_h = banded.band_factor(R, ml=ml, mu=mu)
    fac_c = banded.band_factor(R.to(cuda), ml=ml, mu=mu)
    for a, b in zip(fac_c, fac_h):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-10
    for rhs in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        b = torch.from_numpy(rhs)
        x_h = banded.band_solve(fac_h, b, ml=ml, mu=mu)
        x_c = banded.band_solve(fac_c, b.to(cuda), ml=ml, mu=mu)
        assert float((x_c.cpu() - x_h).abs().max() / x_h.abs().max()) \
            <= 1e-10


def test_dae_and_sensitivities_on_cuda_match_cpu(cuda):
    """dae_solve (Robertson, index-1) and bdf_solve_with_sensitivities
    (Robertson, rtol 1e-8) on the card against the host CPU within 1e-10,
    f64."""
    from g4s_tpu_torch.ops import odeint

    def F(t, y, yp):
        return torch.stack([yp[0] + 0.04 * y[0] - 1e4 * y[1] * y[2],
                            yp[1] - 0.04 * y[0] + 3e7 * y[1] ** 2
                            + 1e4 * y[1] * y[2], y[0] + y[1] + y[2] - 1.0])

    def f_p(p, t, y):
        return torch.stack([-p[0] * y[0] + p[2] * y[1] * y[2],
                            p[0] * y[0] - p[1] * y[1] ** 2
                            - p[2] * y[1] * y[2], p[1] * y[1] ** 2])

    y0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    p0 = torch.tensor([0.04, 3e7, 1e4], dtype=torch.float64)
    yd0 = f_p(p0, 0.0, y0)
    outs = [odeint.dae_solve(F, y0.to(d), yd0.to(d), 0.0, 100.0, rtol=1e-9,
                             atol=1e-12) for d in (cuda, "cpu")]
    assert outs[0].success
    assert float((outs[0].y.cpu() - outs[1].y).abs().max()) <= 1e-10
    sens = [odeint.bdf_solve_with_sensitivities(
        f_p, p0.to(d), y0.to(d), 0.0, 10.0, rtol=1e-8, atol=1e-12)
        for d in (cuda, "cpu")]
    for a, b in ((sens[0][0].y, sens[1][0].y), (sens[0][1], sens[1][1])):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-10


def test_batched_bdf_on_cuda_matches_cpu(cuda, tmp_path):
    """The lockstep batched BDF behind run_ntc_sweep_batched on the small
    synthetic mechanism's ideal-gas phase, three lanes to 2 ms: the card's
    states within 1e-10 of the host CPU's, f64."""
    from chip_smoke import _synthetic_mechanism_yaml
    from g4s_tpu_torch.models.cantera import (IdealGasConstVolumeReactor,
                                              load_mechanism, stoich_mixture)
    from g4s_tpu_torch.ops.odeint import _bdf_solve_batched
    path = str(tmp_path / "small.yaml")
    _synthetic_mechanism_yaml(path, nspec=15, nrxn=30, n_falloff=2,
                              n_three_body=2, seed=0)
    mech = load_mechanism(path, "nDodecane_IG")
    X = stoich_mixture(mech)
    outs = []
    for d in (cuda, "cpu"):
        r = IdealGasConstVolumeReactor(mech, device=d)
        y0 = torch.stack([r.initial_state(T, 40 * 101325.0, X)
                          for T in (1000.0, 1010.0, 1020.0)])
        outs.append(_bdf_solve_batched(r.rhs, y0, 0.0, 2e-3, rtol=1e-6,
                                       atol=1e-12))
    assert outs[0].success.all()
    assert float((outs[0].y.cpu() - outs[1].y).abs().max()
                 / outs[1].y.abs().max()) <= 1e-10

"""The rest of the port's DeePMD (g4s_tpu_torch/models/deepmd: the
se_atten, se_a_ebd, se_t, hybrid, loc_frame and se_a_mask descriptors,
env_mat_celllist, atomic_descriptor_ef, dplr, calculator, ipi and nvnmd)
against the reference (g4s_tpu/models/deepmd) on the CPU, on the same
weights: the reference's parameter trees carried into the port by
params_from_numpy.

Sizes: tests/test_deepmd.py's tiny_spec (rcut 3, sel 6/10, embedding
4-8-16, axis 4, fitting 16-16) and random frames of 20 atoms in a 7 A box;
the cell list at 200 atoms in a 14 A box (4 cells per side) and 60 atoms
in 7 A (2 per side); NVNMD at tests/test_nvnmd.py's small spec on 16 atoms
in 6 A.

Tolerances, relative to the largest magnitude of the reference's result:
f64 1e-10; the port in f32 against the reference in f64 1e-4. NVNMD's
quantized paths (QNN and the tables) within 4 quanta of 2^-23 absolute
(a floor or a round may flip at a boundary when a sum's order differs);
the mapping tables as c_k dx^k, each cubic coefficient times its row's
width to the power k (the raw c2, c3 divide one rounding of y1 - y0 by
dx^2 and dx^3)."""

import importlib
import json
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_deepmd import random_frame, tiny_spec

MODS = ("descriptor", "model", "freeze", "infer", "train", "fit_tensor",
        "dplr", "calculator", "ipi", "nvnmd")
J = {m: importlib.import_module(f"g4s_tpu.models.deepmd.{m}") for m in MODS}
P = {m: importlib.import_module(f"g4s_tpu_torch.models.deepmd.{m}")
     for m in MODS}
pckpt = importlib.import_module("g4s_tpu_torch.ckpt")

F64, F32 = torch.float64, torch.float32
TOL = 1e-10
QUANTUM = 2.0 ** -23
SIX = ("se_atten", "se_a_ebd", "se_t", "hybrid", "loc_frame", "se_a_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_spec(jspec):
    d = P["descriptor"].DescriptorSpec(*jspec.descriptor)
    return P["model"].ModelSpec(d, *jspec[1:])


def to_port(tree, dtype=F64):
    return P["freeze"].params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu", dtype=dtype)


def t(x, dtype=F64):
    x = np.asarray(x)
    return torch.from_numpy(x.copy()).to(
        dtype if x.dtype.kind == "f" else None)


def close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def within_quanta(got, want, what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    err = np.abs(got - np.asarray(want, np.float64)).max()
    assert err <= 4 * QUANTUM, f"{what}: {err:.3g} > 4 quanta"


_CACHE = {}


def cached(key, make):
    """Build each JAX function (and model) once per module."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def frame(seed=1234):
    c, b, ty = random_frame(np.random.default_rng(seed))
    return np.asarray(c), np.asarray(b), np.asarray(ty)


def jspec_of(descriptor_type, extra=False):
    js = tiny_spec()._replace(descriptor_type=descriptor_type)
    if extra:
        js = js._replace(numb_fparam=2, numb_aparam=1)
    return js


def jax_params(jspec, seed=0):
    """The reference's weights for jspec with davg/dstd (and the fparam/
    aparam stats) drawn away from 0/1."""
    def make():
        p = J["model"].init_params(jax.random.PRNGKey(seed), jspec)
        r = np.random.default_rng(5)
        for k in list(p["stats"]):
            shape = p["stats"][k].shape
            p["stats"][k] = jnp.asarray(
                r.normal(size=shape) * 0.1 if k.endswith("avg")
                else 1.0 + r.uniform(size=shape))
        return p
    return cached(("params", jspec, seed), make)


def jax_efv(jspec):
    return cached(("efv", jspec), lambda: jax.jit(
        lambda p, c, b, ty, fp, ap: J["model"].energy_force_virial(
            p, jspec, c, b, ty, fparam=fp, aparam=ap)))


def maybe(x, f):
    return None if x is None else f(x)


# ---------------------------------------------------------------------------
# the six descriptors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descriptor_type", SIX)
@pytest.mark.parametrize("extra", [False, True], ids=["plain", "fparam"])
def test_energy_force_virial_matches_reference(descriptor_type, extra):
    js = jspec_of(descriptor_type, extra)
    c, b, ty = frame()
    r = np.random.default_rng(2)
    fp = r.normal(size=2) if extra else None
    ap = r.normal(size=(20, 1)) if extra else None
    want = jax_efv(js)(jax_params(js), jnp.asarray(c), jnp.asarray(b),
                       jnp.asarray(ty), maybe(fp, jnp.asarray),
                       maybe(ap, jnp.asarray))
    for dtype, tol in ((F64, TOL), (F32, 1e-4)):
        got = P["model"].energy_force_virial(
            to_port(jax_params(js), dtype), port_spec(js), t(c, dtype),
            t(b, dtype), t(ty), fparam=maybe(fp, lambda x: t(x, dtype)),
            aparam=maybe(ap, lambda x: t(x, dtype)))
        for name, g, w in zip("EFW", got, want):
            close(g, w, tol, f"{descriptor_type} {name} {dtype}")


@pytest.mark.parametrize("descriptor_type", SIX)
def test_a_batch_matches_single_frames(descriptor_type):
    js = jspec_of(descriptor_type)
    pp, ps = to_port(jax_params(js)), port_spec(js)
    c, b, ty = frame()
    cs = c[None] + np.random.default_rng(7).normal(scale=0.05,
                                                   size=(3,) + c.shape)
    batch = P["model"].energy_force_virial(pp, ps, t(cs),
                                           t(np.stack([b] * 3)), t(ty))
    for i in range(3):
        one = P["model"].energy_force_virial(pp, ps, t(cs[i]), t(b), t(ty))
        for name, bt, s in zip("EFW", batch, one):
            close(bt[i], s.numpy(), 1e-12, f"{descriptor_type} frame {i} "
                  f"{name}")


def test_se_a_mask_drops_the_virtual_atoms():
    js = jspec_of("se_a_mask")
    c, _, ty = frame()
    mask = np.arange(20) < 16
    jp = jax_params(js)

    def jax_e(x):
        return J["model"].total_energy(jp, js, x, None, jnp.asarray(ty),
                                       atom_mask=jnp.asarray(mask))
    want_e, want_g = jax.jit(jax.value_and_grad(jax_e))(jnp.asarray(c))
    x = t(c).requires_grad_(True)
    e = P["model"].total_energy(to_port(jp), port_spec(js), x, None, t(ty),
                                atom_mask=t(mask))
    (g,) = torch.autograd.grad(e, x)
    close(e, want_e, what="E")
    close(g, want_g, what="dE/dx")
    assert float(torch.abs(g[16:]).max()) == 0.0   # virtual atoms feel none
    full = P["model"].total_energy(to_port(jp), port_spec(js), t(c), None,
                                   t(ty))
    assert abs(float(full) - float(e)) > 1e-6


@pytest.mark.parametrize("part", ["se_e3", "loc_frame", "hybrid"])
def test_hybrid_part_refused(part):
    js = jspec_of("hybrid")._replace(hybrid_types=("se_e2_a", part))
    with pytest.raises(ValueError, match=part):
        P["model"].init_params(torch.Generator().manual_seed(0),
                               port_spec(js))


# ---------------------------------------------------------------------------
# frozen files, DeepPot, the Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("descriptor_type", ["se_atten", "hybrid"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frozen_model_loads_in_the_other_package(tmp_path, writer,
                                                 descriptor_type):
    js = jspec_of(descriptor_type)
    c, b, ty = frame()
    path = tmp_path / "frozen.npz"
    jp = jax_params(js)
    if writer == "jax":
        J["freeze"].freeze(jp, js, path, type_map=["O", "H"])
        dp = P["infer"].DeepPot(path, device="cpu")
        assert dp.spec == port_spec(js)
        cs = c[None] + np.random.default_rng(3).normal(
            scale=0.05, size=(2,) + c.shape)
        batch = dp.eval(cs, np.stack([b] * 2), ty)
        for i in range(2):
            want = jax_efv(js)(jp, jnp.asarray(cs[i]), jnp.asarray(b),
                               jnp.asarray(ty), None, None)
            for name, g, w in zip("EFW", batch, want):
                close(g[i], w, what=f"batch {i} {name}")
        got = dp.eval(c, b, ty)
    else:
        P["freeze"].freeze(to_port(jp), port_spec(js), path,
                           type_map=["O", "H"])
        params, spec = J["freeze"].load_frozen(path)
        assert spec == js
        got = jax_efv(js)(params, jnp.asarray(c), jnp.asarray(b),
                          jnp.asarray(ty), None, None)
    want = jax_efv(js)(jp, jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty),
                       None, None)
    for name, g, w in zip("EFW", got, want):
        close(g, w, what=name)
    # the two packages write the same metadata
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    other = tmp_path / "other.npz"
    (J if writer == "port" else P)["freeze"].freeze(
        jp if writer == "port" else to_port(jp),
        js if writer == "port" else port_spec(js), other,
        type_map=["O", "H"])
    assert P["freeze"].load_frozen_meta(other) == meta


def test_trainer_step_se_atten_matches_reference():
    js = jspec_of("se_atten")
    loss, lr = (0.5, 1.0, 100.0, 1.0, 0.1, 0.5), (1e-3, 1e-5, 2, 10)
    jt = J["train"].Trainer(js, J["train"].LossConfig(*loss),
                            J["train"].LRConfig(*lr))
    pt = P["train"].Trainer(port_spec(js), P["train"].LossConfig(*loss),
                            P["train"].LRConfig(*lr))
    rng = np.random.default_rng(2)
    nf, na, L = 2, 20, 7.0
    b = dict(coord=rng.uniform(0, L, (nf, na, 3)),
             box=np.tile(np.eye(3) * L, (nf, 1, 1)),
             energy=rng.normal(size=nf), force=rng.normal(size=(nf, na, 3)),
             virial=rng.normal(size=(nf, 3, 3)),
             types=np.sort(rng.integers(0, 2, na)).astype(np.int32))
    jp = jax_params(js)
    jp2, _, jl, _ = jt._update(jp, jt.init(jp),
                               {k: jnp.asarray(v) for k, v in b.items()},
                               jnp.asarray(0.0))
    pp = to_port(jp)
    pp2, _, pl, _ = pt._update(pp, pt.init(pp), P["train"].batch_to(
        b, torch.zeros((), dtype=F64)), 0)
    close(pl, jl, what="loss")
    gl, wl = pckpt.tree_leaves(pp2), jax.tree_util.tree_leaves(jp2)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        close(g, w, what=f"leaf {i}")
    # attention weights and the type embedding moved
    assert not torch.equal(pp2["embed"]["tebd"], pp["embed"]["tebd"])


# ---------------------------------------------------------------------------
# the cell list, se_a_ef
# ---------------------------------------------------------------------------


def _box_frame(n, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, L, (n, 3)), np.eye(3) * L,
            np.sort(rng.integers(0, 2, n)).astype(np.int32))


def test_env_mat_celllist_matches_env_mat():
    """4 cells per side: the same R and neighbor sets as the all-pairs
    env_mat, and as the reference's cell list."""
    c, b, ty = _box_frame(200, 14.0, 0)
    jd = J["descriptor"].DescriptorSpec(3.5, 0.5, (12, 20), 2)
    pd = P["descriptor"].DescriptorSpec(*jd)
    R1, nl1 = P["descriptor"].env_mat(t(c), t(b), t(ty), pd)
    x = t(c).requires_grad_(True)
    R2, nl2 = P["descriptor"].env_mat_celllist(x, t(b), t(ty), pd,
                                               max_per_cell=32)
    close(R2, R1.numpy(), 1e-12, "R against env_mat")
    assert torch.equal(torch.sort(nl1, dim=1)[0], torch.sort(nl2, dim=1)[0])
    Rj, nlj = jax_celllist(c, b, ty, jd, 32)
    close(R2, Rj, TOL, "R against the reference's")
    np.testing.assert_array_equal(nl2.numpy(), np.asarray(nlj))
    # differentiable like env_mat
    (g,) = torch.autograd.grad(R2[..., 0].sum(), x)
    x1 = t(c).requires_grad_(True)
    (g1,) = torch.autograd.grad(P["descriptor"].env_mat(
        x1, t(b), t(ty), pd)[0][..., 0].sum(), x1)
    close(g, g1.numpy(), 1e-12, "d(sum s)/dx")


def jax_celllist(c, b, ty, jd, max_per_cell):
    """The reference's cell list, jitted with the box as a constant (its
    cell counts are read on the host)."""
    return jax.jit(lambda c_, ty_: J["descriptor"].env_mat_celllist(
        c_, b, ty_, jd, max_per_cell=max_per_cell))(jnp.asarray(c),
                                                   jnp.asarray(ty))


def _duplicates(nlist):
    """Neighbor slots that repeat an index already in their row."""
    return sum(int(np.sum(np.unique(row[row >= 0], return_counts=True)[1]
                          - 1)) for row in np.asarray(nlist))


def test_celllist_refuses_what_the_reference_gets_wrong():
    """At 2 cells per side (the water frame's box at rcut 6 is one such)
    the reference's 27 neighbor cells, taken modulo 2, hold each cell
    more than once, and its nlist repeats atoms; the port raises. Past
    max_per_cell the reference drops atoms silently; the port raises."""
    c, b, ty = _box_frame(60, 7.0, 1)
    jd = J["descriptor"].DescriptorSpec(3.0, 0.5, (12, 20), 2)
    _, nlj = jax_celllist(c, b, ty, jd, 64)
    assert _duplicates(nlj) > 0
    assert _duplicates(jax.jit(J["descriptor"].env_mat, static_argnums=3)(
        jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty), jd)[1]) == 0
    with pytest.raises(ValueError, match="fewer than 3"):
        P["descriptor"].env_mat_celllist(
            t(c), t(b), t(ty), P["descriptor"].DescriptorSpec(*jd))
    c, b, ty = _box_frame(200, 14.0, 0)
    jd = J["descriptor"].DescriptorSpec(3.5, 0.5, (12, 20), 2)
    _, nlj = jax_celllist(c, b, ty, jd, 3)
    _, nl1 = jax.jit(J["descriptor"].env_mat, static_argnums=3)(
        jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty), jd)
    assert (np.asarray(nlj) >= 0).sum() < (np.asarray(nl1) >= 0).sum()
    with pytest.raises(ValueError, match="max_per_cell=3"):
        P["descriptor"].env_mat_celllist(
            t(c), t(b), t(ty), P["descriptor"].DescriptorSpec(*jd),
            max_per_cell=3)


def test_atomic_descriptor_ef_matches_reference():
    js = tiny_spec()
    c, b, ty = frame(3)
    ef = np.random.default_rng(4).normal(size=(20, 3))
    pp, pv = jax_params(js, 0), jax_params(js, 1)
    want = jax.jit(lambda *a: J["descriptor"].atomic_descriptor_ef(
        a[0], a[1], js, *a[2:]))(pp, pv, jnp.asarray(c), jnp.asarray(b),
                                 jnp.asarray(ty), jnp.asarray(ef))
    for dtype, tol in ((F64, TOL), (F32, 1e-4)):
        got = P["descriptor"].atomic_descriptor_ef(
            to_port(pp, dtype), to_port(pv, dtype), port_spec(js),
            t(c, dtype), t(b, dtype), t(ty), t(ef, dtype))
        close(got, want, tol, f"D {dtype}")


# ---------------------------------------------------------------------------
# DPLR, the calculator, i-PI
# ---------------------------------------------------------------------------


def test_ewald_matches_reference():
    rng = np.random.default_rng(0)
    box = np.array([[7.0, 0.0, 0.0], [0.3, 6.5, 0.0], [-0.2, 0.4, 7.2]])
    coord = rng.uniform(0, 1, (6, 3)) @ box
    q = rng.normal(size=6)
    q -= q.mean()
    want = J["dplr"].ewald_recp(coord, q, box, beta=1.0, spacing=2.0)
    got = P["dplr"].ewald_recp(coord, q, box, beta=1.0, spacing=2.0,
                               device="cpu")
    for name, g, w in zip("EFW", got, want):
        assert g.dtype == F64
        close(g, w, what=name)
    np.testing.assert_array_equal(P["dplr"].ewald_kgrid(box, 2.0),
                                  J["dplr"].ewald_kgrid(box, 2.0))
    close(P["dplr"].ewald_real_and_self(coord, q, box, beta=1.0, rcut=5.0,
                                        device="cpu"),
          J["dplr"].ewald_real_and_self(coord, q, box, beta=1.0, rcut=5.0),
          what="real + self")


def test_dipole_charge_modifier_matches_reference():
    js = tiny_spec()
    c, b, ty = frame(1)
    jp = jax_params(js)
    jn = J["fit_tensor"].init_tensor_fit(jax.random.PRNGKey(1), js)
    kw = dict(model_charge_map=[-2.0, -1.0], sys_charge_map=[2.0, 1.0],
              ewald_h=2.0, ewald_beta=1.0)
    mod = J["dplr"].DipoleChargeModifier(jp, jn, js, **kw)
    kk = tuple(int(k) for k in J["dplr"].ewald_kgrid(b, kw["ewald_h"]))

    def e_of(x, eps):
        one = jnp.eye(3) + eps
        return mod._energy(x @ one, jnp.asarray(b) @ one, jnp.asarray(ty), kk)
    # the reference's eval (E and its coordinate and strain gradients),
    # jitted: eval itself reads the box on the host and cannot be traced
    e, (gx, gs) = jax.jit(jax.value_and_grad(e_of, argnums=(0, 1)))(
        jnp.asarray(c), jnp.zeros((3, 3)))
    want = (e, -gx, -gs)
    got = P["dplr"].DipoleChargeModifier(to_port(jp), to_port(jn),
                                         port_spec(js), **kw).eval(c, b, ty)
    for name, g, w in zip("EFW", got, want):
        close(g, w, what=name)
    # an f32 dipole model evaluates in f64: as its weights cast to f64
    p32, n32 = to_port(jp, F32), to_port(jn, F32)
    got32 = P["dplr"].DipoleChargeModifier(p32, n32, port_spec(js),
                                           **kw).eval(c, b, ty)
    got64 = P["dplr"].DipoleChargeModifier(
        P["model"].params_to(p32, dtype=F64),
        P["model"].params_to(n32, dtype=F64), port_spec(js),
        **kw).eval(c, b, ty)
    for g32, g64 in zip(got32, got64):
        assert g32.dtype == F64 and torch.equal(g32, g64)


@pytest.fixture(scope="module")
def frozen_atten(tmp_path_factory):
    js = jspec_of("se_atten")
    path = tmp_path_factory.mktemp("atten") / "frozen.npz"
    J["freeze"].freeze(jax_params(js), js, path, type_map=["O", "H"])
    return str(path), js


def test_calc_ase_free_and_dp(frozen_atten):
    path, js = frozen_atten
    c, b, ty = frame(5)
    symbols = ["O" if x == 0 else "H" for x in ty]
    want = J["calculator"].calc_ase_free(path, c, b, symbols, ["O", "H"])
    got = P["calculator"].calc_ase_free(path, c, b, symbols, ["O", "H"],
                                        device="cpu")
    assert set(got) == set(want) and isinstance(got["energy"], float)
    for k in want:
        close(got[k], want[k], what=k)
    try:
        import ase  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="calc_ase_free"):
            P["calculator"].DP(path, device="cpu")
    else:
        from ase import Atoms
        calc = P["calculator"].DP(path, device="cpu")
        atoms = Atoms(symbols, positions=c, cell=b, pbc=True)
        atoms.calc = calc
        close(atoms.get_potential_energy(), want["energy"], what="DP")


def _ipi_stream(c, b):
    cell = (np.asarray(b).T / P["ipi"].CVT_LEN).astype("<f8")
    return (cell.tobytes() + np.linalg.inv(cell).astype("<f8").tobytes()
            + struct.pack("<i", len(c))
            + (np.asarray(c) / P["ipi"].CVT_LEN).astype("<f8").tobytes())


def _exchange(drv, c, b):
    """STATUS, POSDATA, STATUS, GETFORCE through handle_message; the
    replies' bytes."""
    stream, pos, sent = _ipi_stream(c, b), [0], []

    def recv(n):
        pos[0] += n
        return stream[pos[0] - n: pos[0]]
    for h in (b"STATUS", b"POSDATA", b"STATUS", b"GETFORCE"):
        drv.handle_message(h.ljust(12), recv, sent.append)
    return sent


def _decode(msg):
    assert msg[:12].strip() == b"FORCEREADY"
    (e,) = struct.unpack_from("<d", msg, 12)
    (nat,) = struct.unpack_from("<i", msg, 20)
    f = np.frombuffer(msg[24: 24 + 24 * nat], "<f8").reshape(nat, 3)
    v = np.frombuffer(msg[24 + 24 * nat: 96 + 24 * nat], "<f8")
    assert msg[96 + 24 * nat:] == struct.pack("<i", 7) + b"nothing"
    return e, f, v.reshape(3, 3)


def test_ipi_exchange_matches_reference_driver(frozen_atten):
    path, js = frozen_atten
    c, b, ty = frame(6)
    c = c + 3.5                      # past the box: the driver wraps
    names = ["O" if x == 0 else "H" for x in ty]
    nmap = {"O": 0, "H": 1}
    want = _exchange(J["ipi"].IPIDriver(path, names, nmap), c, b)
    got = _exchange(P["ipi"].IPIDriver(path, names, nmap, device="cpu"),
                    c, b)
    assert [m.strip() for m in got[:2]] == [m.strip() for m in want[:2]] \
        == [b"READY", b"HAVEDATA"]
    for name, g, w in zip("EFV", _decode(got[2]), _decode(want[2])):
        close(g, w, what=name)


def test_ipi_main_over_a_unix_socket(frozen_atten, tmp_path):
    """main() with a json config against an in-process server on an
    abstract unix socket: one exchange, then EXIT."""
    path, js = frozen_atten
    c, b, ty = frame(6)
    names = ["O" if x == 0 else "H" for x in ty]
    xyz = tmp_path / "w.xyz"
    xyz.write_text(f"{len(names)}\nframe\n" + "".join(
        f"{n} {x:.6f} {y:.6f} {z:.6f}\n" for n, (x, y, z) in zip(names, c)))
    prefix = f"\0g4s_ipi_test_{os.getpid()}_"
    cfg = tmp_path / "ipi.json"
    cfg.write_text(json.dumps(dict(
        graph_file=path, coord_file=str(xyz), atom_type={"O": 0, "H": 1},
        host="w", use_unix=True, unix_prefix=prefix)))
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(prefix + "w")
    srv.listen(1)
    out = {}

    def server():
        conn, _ = srv.accept()

        def recvn(n):
            buf = b""
            while len(buf) < n:
                buf += conn.recv(n - len(buf))
            return buf
        conn.sendall(b"STATUS".ljust(12))
        out["status"] = recvn(12)
        conn.sendall(b"POSDATA".ljust(12) + _ipi_stream(c, b)
                     + b"GETFORCE".ljust(12))
        out["force"] = recvn(12 + 8 + 4 + 24 * len(c) + 72 + 4 + 7)
        conn.sendall(b"EXIT".ljust(12))
        conn.close()
    th = threading.Thread(target=server, daemon=True)
    th.start()
    P["ipi"].main([str(cfg), "--device", "cpu"])
    th.join(timeout=30)
    srv.close()
    assert not th.is_alive()
    assert out["status"].strip() == b"READY"
    e, f, v = _decode(out["force"])
    pot = P["infer"].DeepPot(path, device="cpu")
    we, wf, wv = pot.eval(P["ipi"].wrap_coords(c, b), b, ty)
    close(e, float(we) / P["ipi"].CVT_ENER, what="E")
    close(f, wf.numpy() / P["ipi"].CVT_F, what="F")
    close(v, wv.numpy().T / P["ipi"].CVT_ENER, what="V")


def test_read_xyz_names_and_wrap_coords(tmp_path):
    p = tmp_path / "w.xyz"
    p.write_text("3\nwater\nO 0 0 0\nH 1 0 0\nH 0 1 0\n")
    assert P["ipi"].read_xyz_names(str(p)) == \
        J["ipi"].read_xyz_names(str(p)) == ["O", "H", "H"]
    box = np.array([[5.0, 0, 0], [1.0, 5.0, 0], [0, 0, 6.0]])
    x = np.random.default_rng(0).uniform(-8, 12, (10, 3))
    np.testing.assert_array_equal(P["ipi"].wrap_coords(x, box),
                                  J["ipi"].wrap_coords(x, box))


# ---------------------------------------------------------------------------
# NVNMD
# ---------------------------------------------------------------------------


def nvnmd_specs():
    jd = J["descriptor"].DescriptorSpec(3.0, 0.5, (6, 10), 2)
    kw = dict(embed_neurons=(4, 8, 16), axis_neuron=4, fit_neurons=(16, 16))
    return (J["nvnmd"].NvnmdSpec(jd, **kw),
            P["nvnmd"].NvnmdSpec(P["descriptor"].DescriptorSpec(*jd), **kw))


def nvnmd_params(seed=0):
    def make():
        js, _ = nvnmd_specs()
        p = J["nvnmd"].init_nvnmd_params(jax.random.PRNGKey(seed), js)
        p["stats"] = {"avg": jnp.asarray([0.3, 0.1]),
                      "std_s": jnp.asarray([0.7, 1.2]),
                      "std_h": jnp.asarray([0.9, 1.1])}
        return p
    return cached(("nvnmd", seed), make)


def nvnmd_frame(seed=7):
    rng = np.random.default_rng(seed)
    ty = np.sort(rng.integers(0, 2, 16)).astype(np.int32)
    return rng.uniform(0, 6.0, (16, 3)), np.eye(3) * 6.0, ty


def nvnmd_tables():
    return cached("tables", lambda: J["nvnmd"].build_map(
        nvnmd_params(), nvnmd_specs()[0]))


def test_nvnmd_primitives_match_reference():
    x = np.random.default_rng(0).uniform(-3, 3, 200)
    for name, fn in (("qf", lambda m, v: m.qf(v, 8)),
                     ("qr", lambda m, v: m.qr(v, 8)),
                     ("tanh4", lambda m, v: m.tanh4(v))):
        want = fn(J["nvnmd"], jnp.asarray(x))
        xp = t(x).requires_grad_(True)
        got = fn(P["nvnmd"], xp)
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want), err_msg=name)
        (g,) = torch.autograd.grad(got.sum(), xp)
        wg = jax.grad(lambda v: jnp.sum(fn(J["nvnmd"], v)))(jnp.asarray(x))
        close(g, wg, 1e-15, f"{name}'")
    assert P["nvnmd"].qr(t(np.array([0.5 / 256, 1.5 / 256])), 8).tolist() \
        == [0.0, 2.0 / 256]                        # half to even


@pytest.mark.parametrize("stage", ["cnn", "qnn"])
def test_nvnmd_energy_force_matches_reference(stage):
    js, ps = nvnmd_specs()
    c, b, ty = nvnmd_frame()
    want = jax.jit(lambda p, *a: J["nvnmd"].nvnmd_energy_force(
        p, js, *a, stage=stage))(nvnmd_params(), jnp.asarray(c),
                                 jnp.asarray(b), jnp.asarray(ty))
    got = P["nvnmd"].nvnmd_energy_force(to_port(nvnmd_params()), ps, t(c),
                                        t(b), t(ty), stage=stage)
    for name, g, w in zip("EF", got, want):
        if stage == "cnn":
            close(g, w, what=name)
        else:
            within_quanta(g, w, name)


def _scaled(coef_g, cfg_s2g):
    """c_k dx^k of every s -> G table row."""
    cg = np.asarray(coef_g.numpy() if isinstance(coef_g, torch.Tensor)
                    else coef_g)
    nf = int(cfg_s2g[0, 4])
    dx = np.where(np.arange(cg.shape[1]) < nf, cfg_s2g[0, 2], cfg_s2g[1, 2])
    c = cg.reshape(cg.shape[:2] + (-1, 4))
    return c * dx[None, :, None, None] ** np.arange(4)


def test_nvnmd_build_map_and_map_energy_match_reference():
    js, ps = nvnmd_specs()
    jt = nvnmd_tables()
    pt = P["nvnmd"].build_map(to_port(nvnmd_params()), ps)
    np.testing.assert_array_equal(pt.cfg_u2s, jt.cfg_u2s)
    close(pt.cfg_s2g, jt.cfg_s2g, 1e-15, "cfg_s2g")
    close(pt.coef_s, jt.coef_s, what="coef_s")
    close(pt.coef_h, jt.coef_h, what="coef_h")
    close(_scaled(pt.coef_g, pt.cfg_s2g), _scaled(jt.coef_g, jt.cfg_s2g),
          what="coef_g as c_k dx^k")
    c, b, ty = nvnmd_frame()
    want = jax.jit(lambda p, *a: J["nvnmd"].nvnmd_map_energy_force(
        p, js, jt, *a))(nvnmd_params(), jnp.asarray(c), jnp.asarray(b),
                        jnp.asarray(ty))
    got = P["nvnmd"].nvnmd_map_energy_force(to_port(nvnmd_params()), ps, pt,
                                            t(c), t(b), t(ty))
    for name, g, w in zip("EF", got, want):
        within_quanta(g, w, f"map {name}")


def jax_map_energy(params, spec, tables, c, b, ty):
    """The reference's nvnmd_map_energy, jitted once for every table of the
    same layout (the coefficients traced, the segment bounds constant)."""
    fn = cached(("map_e", tables.cfg_u2s.tobytes(),
                 np.asarray(tables.cfg_s2g).tobytes()), lambda: jax.jit(
        lambda p, cs, ch, cg, *a: J["nvnmd"].nvnmd_map_energy(
            p, spec, tables._replace(coef_s=cs, coef_h=ch, coef_g=cg), *a)))
    return fn(params, tables.coef_s, tables.coef_h, tables.coef_g,
              jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nvnmd_wrapped_file_loads_in_the_other_package(tmp_path, writer):
    js, ps = nvnmd_specs()
    path = str(tmp_path / "model.nvnmd")
    jt = nvnmd_tables()
    c, b, ty = nvnmd_frame(8)
    if writer == "jax":
        J["nvnmd"].wrap_model(nvnmd_params(), js, jt, path)
        p2, s2, t2 = P["nvnmd"].load_wrapped(path, device="cpu")
        assert s2 == ps
        got = P["nvnmd"].nvnmd_map_energy(p2, s2, t2, t(c), t(b), t(ty))
        # re-wrapped, the loaded model gives the same file, bit for bit
        again = str(tmp_path / "again.nvnmd")
        P["nvnmd"].wrap_model(p2, s2, t2, again)
        with np.load(path) as z1, np.load(again) as z2:
            assert sorted(z1.files) == sorted(z2.files)
            for k in z1.files:
                np.testing.assert_array_equal(z1[k], z2[k], err_msg=k)
    else:
        P["nvnmd"].wrap_model(to_port(nvnmd_params()), ps,
                              P["nvnmd"].build_map(to_port(nvnmd_params()),
                                                   ps), path)
        got = jax_map_energy(*J["nvnmd"].load_wrapped(path), c, b, ty)
        # against the reference's own artifact of the same model
        path = str(tmp_path / "reference.nvnmd")
        J["nvnmd"].wrap_model(nvnmd_params(), js, jt, path)
    want = jax_map_energy(*J["nvnmd"].load_wrapped(path), c, b, ty)
    within_quanta(got, want, "E of the loaded model")


def test_nvnmd_train_two_stage_matches_reference():
    js, ps = nvnmd_specs()
    c, b, ty = nvnmd_frame(9)
    e, f = jax.jit(lambda p, *a: J["nvnmd"].nvnmd_energy_force(p, js, *a))(
        nvnmd_params(42), jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty))
    jp, lcj, lqj = J["nvnmd"].train_two_stage(
        nvnmd_params(), js, [(jnp.asarray(c), jnp.asarray(b),
                              jnp.asarray(ty), e, f)],
        lr=2e-4, steps_cnn=2, steps_qnn=2)
    pp, lcp, lqp = P["nvnmd"].train_two_stage(
        to_port(nvnmd_params()), ps, [(t(c), t(b), t(ty), t(e), t(f))],
        lr=2e-4, steps_cnn=2, steps_qnn=2)
    close(lcp, lcj, what="CNN losses")
    close(lqp, lqj, what="QNN losses")
    for i, (g, w) in enumerate(zip(pckpt.tree_leaves(pp),
                                   jax.tree_util.tree_leaves(jp))):
        close(g, w, 1e-8, f"leaf {i}")


def test_entry_points_default_to_cuda(frozen_atten, tmp_path):
    """Without a card the new entry points raise instead of drifting to the
    CPU; the modifier runs where its dipole model's parameters are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run on it")
    path, js = frozen_atten
    c, b, ty = frame()
    names = ["O" if x == 0 else "H" for x in ty]
    with pytest.raises(RuntimeError, match="cuda"):
        P["ipi"].IPIDriver(path, names, {"O": 0, "H": 1})
    cfg = tmp_path / "ipi.json"
    xyz = tmp_path / "w.xyz"
    xyz.write_text("1\n\nO 0 0 0\n")
    cfg.write_text(json.dumps(dict(graph_file=path, coord_file=str(xyz),
                                   atom_type={"O": 0})))
    with pytest.raises(RuntimeError, match="cuda"):
        P["ipi"].main([str(cfg)])
    with pytest.raises(RuntimeError, match="cuda"):
        P["calculator"].calc_ase_free(path, c, b, names, ["O", "H"])
    wrapped = str(tmp_path / "model.nvnmd")
    J["nvnmd"].wrap_model(nvnmd_params(), nvnmd_specs()[0], nvnmd_tables(),
                          wrapped)
    with pytest.raises(RuntimeError, match="cuda"):
        P["nvnmd"].load_wrapped(wrapped)
    for fn in (P["dplr"].ewald_recp, P["dplr"].ewald_real_and_self):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(c, np.ones(20), b)
    mod = P["dplr"].DipoleChargeModifier(
        to_port(jax_params(tiny_spec())), to_port(J["fit_tensor"]
        .init_tensor_fit(jax.random.PRNGKey(1), tiny_spec())),
        port_spec(tiny_spec()), [-2.0, -1.0], [2.0, 1.0])
    assert mod.device.type == "cpu"

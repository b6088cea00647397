"""The port's DeePMD serving path (g4s_tpu_torch/models/deepmd,
g4s_tpu_torch/drivers/dp.py) against the reference (g4s_tpu/models/deepmd)
on the CPU, on the same weights: the reference's parameter tree carried
into the port by params_from_numpy.

Sizes: tests/test_deepmd.py's tiny_spec and random frames (20 atoms), and
one test at the flagship width, __graft_entry__._water_setup()'s 192-atom
water frame and WATER_SPEC weights.

Tolerances, relative to the largest magnitude of the reference's result:
f64 1e-10 (neighbor lists equal, and NVT x and v over 10 steps 1e-9); the
port in f32 against the reference in f64 1e-4. The port's compressed
model against its exact one is held to the reference test's own
tolerances (E 1e-8 relative, F 1e-7 absolute, stride 0.005)."""

import importlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_deepmd import random_frame, tiny_spec

import __graft_entry__

J = {m: importlib.import_module(f"g4s_tpu.models.deepmd.{m}")
     for m in ("descriptor", "network", "model", "freeze", "infer", "md",
               "compress")}
P = {m: importlib.import_module(f"g4s_tpu_torch.models.deepmd.{m}")
     for m in ("descriptor", "network", "model", "freeze", "infer", "md",
               "compress", "data")}
dp_cli = importlib.import_module("g4s_tpu_torch.drivers.dp")

F64, F32 = torch.float64, torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return torch.from_numpy(x).to(dtype if x.dtype.kind == "f" else None)


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


_CACHE = {}


def cached(key, make):
    """Build each JAX function (and model) once per module."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def jax_efv(jspec):
    return cached(("efv", jspec), lambda: jax.jit(
        lambda p, c, b, ty, fp, ap: J["model"].energy_force_virial(
            p, jspec, c, b, ty, fparam=fp, aparam=ap)))


def jax_params(jspec, *, stats=True):
    """The reference's weights for jspec; stats=True draws davg/dstd (and
    the fparam/aparam stats) away from 0/1 so normalization is exercised."""
    def make():
        p = J["model"].init_params(jax.random.PRNGKey(0), jspec)
        if stats:
            r = np.random.default_rng(5)
            st = p["stats"]
            for k in list(st):
                shape = st[k].shape
                st[k] = jnp.asarray(
                    r.normal(size=shape) * 0.1 if k.endswith("avg")
                    else 1.0 + r.uniform(size=shape))
        return p
    return cached(("params", jspec, stats), make)


FRAME_KINDS = ("random", "fewer_than_sel", "skewed_cell", "one_type")


def frame(kind, seed=1234):
    rng = np.random.default_rng(seed)
    if kind == "random":
        c, b, ty = random_frame(rng)
        return np.asarray(c), np.asarray(b), np.asarray(ty)
    if kind == "fewer_than_sel":          # 5 atoms < sel (6, 10)
        ty = np.array([0, 0, 1, 1, 1], np.int32)
        return rng.uniform(0, 4.0, (5, 3)), np.eye(3) * 4.0, ty
    if kind == "skewed_cell":
        box = np.array([[7.0, 0.0, 0.0], [0.4, 7.0, 0.0], [-0.3, 0.5, 7.0]])
        ty = np.sort(rng.integers(0, 2, 20)).astype(np.int32)
        return rng.uniform(0, 1, (20, 3)) @ box, box, ty
    # every atom of type 0 and fewer than sel: the type-1 section holds
    # only tied padding, whose order must not reach R or nlist
    ty = np.zeros(8, np.int32)
    return rng.uniform(0, 5.0, (8, 3)), np.eye(3) * 5.0, ty


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_env_mat_matches_reference(kind):
    c, b, ty = frame(kind)
    dspec = tiny_spec().descriptor
    Rj, nlj = cached(("env_mat", dspec), lambda: jax.jit(
        lambda c_, b_, ty_: J["descriptor"].env_mat(c_, b_, ty_, dspec)))(
        jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty))
    Rp, nlp = P["descriptor"].env_mat(t(c), t(b), t(ty),
                                      port_spec(tiny_spec()).descriptor)
    close(Rp, Rj, 1e-10, "R")
    np.testing.assert_array_equal(nlp.numpy(), np.asarray(nlj))
    assert (nlp >= 0).any()


@pytest.mark.parametrize("resnet_dt", [False, True])
def test_embedding_net_residual_rules(resnet_dt):
    # 1 -> 4 (h), 4 -> 8 (concat(x, x) + h), 8 -> 8 (x + h), 8 -> 5 (h)
    layers = J["network"].init_embedding_net(
        jax.random.PRNGKey(3), (4, 8, 8, 5), resnet_dt=resnet_dt)
    x = np.random.default_rng(0).normal(size=(30, 1))
    want = J["network"].embedding_net_apply(layers, jnp.asarray(x))
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        got = P["network"].embedding_net_apply(to_port(layers, dtype),
                                               t(x, dtype))
        close(got, want, tol, f"embedding {dtype}")


def test_fitting_net_matches_reference():
    net = J["network"].init_fitting_net(jax.random.PRNGKey(4), 12,
                                        (16, 16, 8), bias_out=0.7)
    x = np.random.default_rng(1).normal(size=(2, 30, 12))
    want = J["network"].fitting_net_apply(net, jnp.asarray(x))
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        got = P["network"].fitting_net_apply(to_port(net, dtype),
                                             t(x, dtype))
        close(got, want, tol, f"fitting {dtype}")


def model_case(descriptor_type, extra):
    js = tiny_spec()._replace(descriptor_type=descriptor_type)
    if extra:
        js = js._replace(numb_fparam=2, numb_aparam=1)
    return js


@pytest.mark.parametrize("descriptor_type", ["se_e2_a", "se_e2_r"])
@pytest.mark.parametrize("extra", [False, True], ids=["plain", "fparam"])
def test_energy_force_virial_matches_reference(descriptor_type, extra):
    js = model_case(descriptor_type, extra)
    c, b, ty = frame("random")
    r = np.random.default_rng(2)
    fp = r.normal(size=2) if extra else None
    ap = r.normal(size=(20, 1)) if extra else None
    want = jax_efv(js)(jax_params(js), jnp.asarray(c), jnp.asarray(b),
                       jnp.asarray(ty),
                       None if fp is None else jnp.asarray(fp),
                       None if ap is None else jnp.asarray(ap))
    for dtype, tol in ((F64, 1e-10), (F32, 1e-4)):
        got = P["model"].energy_force_virial(
            to_port(jax_params(js), dtype), port_spec(js), t(c, dtype),
            t(b, dtype), t(ty), fparam=None if fp is None else t(fp, dtype),
            aparam=None if ap is None else t(ap, dtype))
        for name, g, w in zip("EFW", got, want):
            close(g, w, tol, f"{name} {dtype}")


def test_unported_descriptor_raises():
    """Every reference descriptor is ported; a name that is none of them is
    refused (the reference falls through to the se_e2_a contraction)."""
    js = tiny_spec()._replace(descriptor_type="se_e3")
    with pytest.raises(ValueError, match="se_e3"):
        P["model"].init_params(torch.Generator().manual_seed(0),
                               port_spec(js))


@pytest.mark.parametrize("descriptor_type", P["model"].PORTED_DESCRIPTORS)
def test_port_init_params_has_the_reference_tree(descriptor_type):
    js = model_case(descriptor_type, True)
    jp = jax_params(js)
    pp = P["model"].init_params(torch.Generator().manual_seed(0),
                                port_spec(js))
    jl, jdef = jax.tree_util.tree_flatten(jp)
    pl = importlib.import_module("g4s_tpu_torch.ckpt").tree_leaves(pp)
    assert P["freeze"]._treedef_str(pp) == str(jdef)
    assert [tuple(x.shape) for x in pl] == [tuple(x.shape) for x in jl]


def _water_masses(ty):
    return np.where(ty == 0, 16.0, 2.0)


def test_nvt_matches_reference():
    js = tiny_spec()
    c, b, ty = frame("random")
    masses = _water_masses(ty)
    v0 = P["md"].init_velocities(np.random.default_rng(23456789), masses,
                                 330.0)
    np.testing.assert_array_equal(
        v0, J["md"].init_velocities(np.random.default_rng(23456789), masses,
                                    330.0))
    jp, bj, tj = jax_params(js), jnp.asarray(b), jnp.asarray(ty)
    jinteg = J["md"].NVTIntegrator(
        jax.jit(lambda x: J["model"].energy_force_virial(
            jp, js, x, bj, tj)[1]), masses, b)
    jstate, jlog = jinteg.run(jnp.asarray(c), jnp.asarray(v0), 10,
                              thermo_every=5, verbose=False)
    pp, bp, tp = to_port(jp), t(b), t(ty)
    pinteg = P["md"].NVTIntegrator(
        lambda x: P["model"].energy_force_virial(pp, port_spec(js), x, bp,
                                                 tp)[1],
        masses, b, device="cpu")
    pstate, plog = pinteg.run(c, v0, 10, thermo_every=5, verbose=False)
    close(pstate.x, jstate.x, 1e-9, "x")
    close(pstate.v, jstate.v, 1e-9, "v")
    close(pstate.xi, jstate.xi, 1e-9, "xi")
    assert pstate.step == int(jstate.step) == 10
    close([T for _, T, _ in plog], [T for _, T, _ in jlog], 1e-9, "T")


def jax_compressed(stride):
    def make():
        js = tiny_spec()
        cm = J["compress"].compress_model(jax_params(js, stats=False), js,
                                          stride=stride)
        efc = jax.jit(lambda c, b, ty: J["compress"].energy_force_compressed(
            cm, c, b, ty))
        return cm, efc
    return cached(("compressed", stride), make)


def test_compress_tables_and_energy_match_reference():
    js = tiny_spec()
    c, b, ty = frame("random")
    jcm, jefc = jax_compressed(0.01)
    pcm = P["compress"].compress_model(to_port(jax_params(js, stats=False)),
                                       port_spec(js), stride=0.01)
    for tc in range(2):
        for tn in range(2):
            jt, pt = jcm.tables[tc][tn], pcm.tables[tc][tn]
            assert (pt.lower, pt.stride, pt.n_intervals) \
                == (jt.lower, jt.stride, jt.n_intervals)
            close(pt.coeffs, jt.coeffs, 1e-10, f"table {tc}{tn}")
    je, jf = jefc(jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty))
    pe, pf = P["compress"].energy_force_compressed(pcm, t(c), t(b), t(ty))
    close(pe, je, 1e-10, "compressed E")
    close(pf, jf, 1e-10, "compressed F")


def test_compressed_matches_exact_model():
    """The reference's equivalence test (tests/test_deepmd.py::TestCompress,
    the reference's source/tests/test_model_compression_se_a.py role) run on
    the port: the same frame, weights and tolerances."""
    js = tiny_spec()
    c, b, ty = frame("random")
    params, spec = to_port(jax_params(js, stats=False)), port_spec(js)
    cm = P["compress"].compress_model(params, spec, stride=0.005)
    e0, f0, _ = P["model"].energy_force_virial(params, spec, t(c), t(b),
                                               t(ty))
    e1, f1 = P["compress"].energy_force_compressed(cm, t(c), t(b), t(ty))
    assert abs(float(e1) - float(e0)) < 1e-8 * abs(float(e0))
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), atol=1e-7)


def test_compressed_artifact_round_trip(tmp_path):
    js = tiny_spec()
    c, b, ty = frame("random")
    cm = P["compress"].compress_model(to_port(jax_params(js)), port_spec(js),
                                      stride=0.01)
    path = tmp_path / "compressed.pkl"
    P["compress"].save_compressed(cm, path)
    cm2 = P["compress"].load_compressed(path, device="cpu")
    assert cm2.spec == cm.spec
    e1, f1 = P["compress"].energy_force_compressed(cm, t(c), t(b), t(ty))
    e2, f2 = P["compress"].energy_force_compressed(cm2, t(c), t(b), t(ty))
    assert torch.equal(e1, e2) and torch.equal(f1, f2)


_LOAD_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["g4s_tpu"] = None
import numpy as np
import torch
from g4s_tpu_torch.models.deepmd.compress import (energy_force_compressed,
                                                  load_compressed)
d = sys.argv[1]
cm = load_compressed(d + "/compressed.pkl", device="cpu")
fr = np.load(d + "/frame.npz")
e, f = energy_force_compressed(cm, *(torch.from_numpy(fr[k])
                                     for k in ("c", "b", "ty")))
np.savez(d + "/ef.npz", e=e.numpy(), f=f.numpy())
"""


def test_reference_compressed_artifact_loads_without_jax(tmp_path):
    """The reference's `dp compress` artifact, pickled as
    g4s_tpu/drivers/dp.py:393 writes it (jax.Arrays of f64 tables and
    params, the reference's NamedTuples), loads through the port's
    load_compressed in a process that cannot import jax, and gives the
    reference's compressed E and F within 1e-10."""
    js = tiny_spec()
    c, b, ty = frame("random")
    jcm, jefc = jax_compressed(0.01)
    assert jcm.tables[0][0].coeffs.dtype == jnp.float64
    with open(tmp_path / "compressed.pkl", "wb") as f:
        pickle.dump({"tables": jcm.tables, "params": jcm.params, "spec": js},
                    f)
    np.savez(tmp_path / "frame.npz", c=c, b=b, ty=ty)
    proc = subprocess.run([sys.executable, "-c", _LOAD_WITHOUT_JAX,
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(tmp_path / "ef.npz")
    je, jf = jefc(jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty))
    close(got["e"], je, 1e-10, "compressed E")
    close(got["f"], jf, 1e-10, "compressed F")


def test_load_compressed_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"tables": (), "params": {}, "spec": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system"):
        P["compress"].load_compressed(path, device="cpu")


def test_neighbor_stat_matches_reference():
    frames = [frame(k, seed=s) for k in ("random", "skewed_cell")
              for s in (1, 2)]
    coords = [f[0] for f in frames]
    boxes = [f[1] for f in frames]
    ty = frames[0][2]
    for rcut in (2.0, 3.0):
        want = J["descriptor"].neighbor_stat(coords[:2], boxes[:2], ty,
                                             rcut, 2)
        got = P["descriptor"].neighbor_stat(coords[:2], boxes[:2], ty,
                                            rcut, 2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _energy(pkg, params, spec, c, b, ty):
    if pkg == "jax":
        return float(jax_efv(spec)(params, jnp.asarray(c), jnp.asarray(b),
                                   jnp.asarray(ty), None, None)[0])
    return float(P["model"].total_energy(params, spec, t(c), t(b), t(ty)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frozen_model_loads_in_the_other_package(tmp_path, writer):
    js = tiny_spec()
    c, b, ty = frame("random")
    path = tmp_path / "frozen.npz"
    if writer == "jax":
        J["freeze"].freeze(jax_params(js), js, path, type_map=["O", "H"])
        params, spec = P["freeze"].load_frozen(path, device="cpu")
        assert spec == port_spec(js)
        got = _energy("port", params, spec, c, b, ty)
    else:
        P["freeze"].freeze(to_port(jax_params(js)), port_spec(js), path,
                           type_map=["O", "H"])
        params, spec = J["freeze"].load_frozen(path)
        assert spec == js
        got = _energy("jax", params, spec, c, b, ty)
    want = _energy("jax", jax_params(js), js, c, b, ty)
    assert abs(got - want) <= 1e-12 * abs(want)
    # the metadata of the two packages' files are the same
    other = tmp_path / "other.npz"
    if writer == "jax":
        P["freeze"].freeze(params, spec, other, type_map=["O", "H"])
    else:
        J["freeze"].freeze(params, spec, other, type_map=["O", "H"])
    assert P["freeze"].load_frozen_meta(path) \
        == J["freeze"].load_frozen_meta(other)


def test_load_frozen_rejects_a_mismatched_file(tmp_path):
    js = tiny_spec()
    path = tmp_path / "frozen.npz"
    J["freeze"].freeze(jax_params(js), js, path)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(str(arrays["__meta__"]))
    meta["axis_neuron"] = 3
    arrays["__meta__"] = json.dumps(meta)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="shape"):
        P["freeze"].load_frozen(path, device="cpu")


def frozen_tiny(tmp_path, seed=0, name="frozen.npz"):
    js = tiny_spec()
    p = J["model"].init_params(jax.random.PRNGKey(seed), js)
    path = tmp_path / name
    J["freeze"].freeze(p, js, path, type_map=["O", "H"])
    return path, p, js


def batch_frames(n=3):
    c, b, ty = frame("random")
    r = np.random.default_rng(7)
    cs = np.stack([c + r.normal(scale=0.05, size=c.shape) for _ in range(n)])
    return cs, np.stack([b] * n), ty


def test_deep_pot_single_and_batch(tmp_path):
    path, jp, js = frozen_tiny(tmp_path)
    cs, bs, ty = batch_frames()
    dp = P["infer"].DeepPot(path, device="cpu")
    assert (dp.rcut, dp.ntypes, dp.type_map) == (3.0, 2, ["O", "H"])
    efv = jax_efv(js)
    batch = dp.eval(cs, bs, ty)
    for i in range(len(cs)):
        want = efv(jp, jnp.asarray(cs[i]), jnp.asarray(bs[i]),
                   jnp.asarray(ty), None, None)
        single = dp.eval(cs[i], bs[i], ty)
        for name, s, bt, w in zip("EFW", single, batch, want):
            close(s, w, 1e-10, f"single {name}")
            close(bt[i], w, 1e-10, f"batch {name}")
    dp32 = P["infer"].DeepPot(path, device="cpu", dtype=F32)
    e32, f32, _ = dp32.eval(cs, bs, ty)
    assert e32.dtype == F32
    close(f32, batch[1], 1e-4, "f32 batch F")


def test_calc_model_devi(tmp_path):
    paths = [frozen_tiny(tmp_path, seed=s, name=f"m{s}.npz")[0]
             for s in (0, 1)]
    cs, bs, ty = batch_frames()
    pots = [P["infer"].DeepPot(p, device="cpu") for p in paths]
    for c, b in ((cs, bs), (cs[0], bs[0])):
        got = P["infer"].calc_model_devi(pots, c, b, ty)
        # the reference's formula over the same evaluations
        want = J["infer"].calc_model_devi(pots, c, b, ty)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12)
            assert g.shape == (cs.shape[0] if c.ndim == 3 else 1,)
    same = P["infer"].calc_model_devi(pots[:1] * 2, cs, bs, ty)
    assert all((x == 0).all() for x in same)
    assert (got[0] > 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_water_graft_frame_matches_reference(dtype):
    """The flagship: __graft_entry__'s 192-atom frame and WATER_SPEC
    weights."""
    from g4s_tpu_torch.models.deepmd import WATER_SPEC
    spec, jp, c, b, ty = cached("water", __graft_entry__._water_setup)
    assert port_spec(spec) == WATER_SPEC
    want = cached("water_efv", lambda: jax_efv(spec)(jp, c, b, ty, None,
                                                    None))
    tdt, tol = (F64, 1e-10) if dtype == "f64" else (F32, 1e-4)
    got = P["model"].energy_force_virial(to_port(jp, tdt), WATER_SPEC,
                                         t(c, tdt), t(b, tdt), t(ty))
    for name, g, w in zip("EFW", got, want):
        close(g, w, tol, f"{name} {dtype}")


def write_system(path, coords, boxes, types, energy, force):
    s = path / "set.000"
    s.mkdir(parents=True)
    np.savetxt(path / "type.raw", types, fmt="%d")
    nf = coords.shape[0]
    np.save(s / "coord.npy", coords.reshape(nf, -1))
    np.save(s / "box.npy", boxes.reshape(nf, 9))
    np.save(s / "energy.npy", energy)
    np.save(s / "force.npy", force.reshape(nf, -1))


def write_lammps(path, coords, types, L):
    lines = ["water-like test frame", "", f"{len(types)} atoms",
             "2 atom types",
             f"0.0 {L} xlo xhi", f"0.0 {L} ylo yhi", f"0.0 {L} zlo zhi", "",
             "Atoms # atomic", ""]
    lines += [f"{i + 1} {ty + 1} {x:.12f} {y:.12f} {z:.12f}"
              for i, (ty, (x, y, z)) in enumerate(zip(types, coords))]
    path.write_text("\n".join(lines) + "\n")


def test_dp_cli_on_cpu(tmp_path, capsys):
    """freeze, test, neighbor-stat, model-devi, compress and md through the
    port's CLI on the CPU, with labels from the reference's model."""
    path, jp, js = frozen_tiny(tmp_path)
    ckpt = tmp_path / "model.ckpt.npz"
    frozen = tmp_path / "cli_frozen.npz"
    path.rename(str(ckpt) + ".model.npz")
    dp_cli.main(["freeze", "-c", str(ckpt), "-o", str(frozen)])
    cs, bs, ty = batch_frames(4)
    efv = jax_efv(js)
    ef = [efv(jp, jnp.asarray(c), jnp.asarray(b), jnp.asarray(ty), None,
              None) for c, b in zip(cs, bs)]
    system = tmp_path / "sys"
    write_system(system, cs, bs, ty, np.array([float(e) for e, _, _ in ef]),
                 np.stack([np.asarray(f) for _, f, _ in ef]))
    sysd = P["data"].load_system(str(system))
    assert sysd.natoms == 20 and sysd.nframes == 4
    rmse_e, rmse_f = dp_cli.main(["test", "-m", str(frozen), "-s",
                                  str(system), "--device", "cpu"])
    assert rmse_e < 1e-12 and rmse_f < 1e-12
    max_nbor, sel = dp_cli.main(["neighbor-stat", "-s", str(system),
                                 "-r", "3.0"])
    want = J["descriptor"].neighbor_stat(list(cs), list(bs), ty, 3.0, 2)
    np.testing.assert_array_equal(max_nbor, want[0])
    devi = dp_cli.main(["model-devi", "-m", str(frozen), str(frozen), "-s",
                        str(system), "-o", str(tmp_path / "devi.out"),
                        "--device", "cpu"])
    assert devi.shape == (4, 4) and (devi[:, 1:] == 0).all()
    comp = tmp_path / "compressed.pkl"
    dp_cli.main(["compress", "-i", str(frozen), "-o", str(comp), "-s",
                 str(system), "--stride", "0.005", "--device", "cpu"])
    cm = P["compress"].load_compressed(comp, device="cpu")
    e1, f1 = P["compress"].energy_force_compressed(cm, t(cs[0]), t(bs[0]),
                                                   t(ty))
    assert abs(float(e1) - float(ef[0][0])) < 1e-8 * abs(float(ef[0][0]))
    np.testing.assert_allclose(f1.numpy(), np.asarray(ef[0][1]), atol=1e-7)
    lmp = tmp_path / "frame.lmp"
    write_lammps(lmp, cs[0], ty, 7.0)
    c_r, ty_r, box_r = J["md"].read_lammps_data(str(lmp))
    c_p, ty_p, box_p = P["md"].read_lammps_data(str(lmp))
    np.testing.assert_array_equal(c_p, c_r)
    np.testing.assert_array_equal(ty_p, ty_r)
    np.testing.assert_array_equal(box_p, box_r)
    state, log = dp_cli.main(["md", "-m", str(frozen), "--data", str(lmp),
                              "--steps", "2", "--device", "cpu"])
    assert state.step == 2 and np.isfinite(log[-1][1])
    assert "MD done: 2 steps" in capsys.readouterr().out


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run on it")
    path, jp, js = frozen_tiny(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        P["infer"].DeepPot(path)
    with pytest.raises(RuntimeError, match="cuda"):
        P["freeze"].load_frozen(path)
    with pytest.raises(RuntimeError, match="cuda"):
        P["md"].water_md(to_port(jp), port_spec(js), data_file="unused.lmp")
    with pytest.raises(RuntimeError, match="cuda"):
        dp_cli.main(["test", "-m", str(path), "-s", str(tmp_path)])

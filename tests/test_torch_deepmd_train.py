"""The port's DeePMD training path (g4s_tpu_torch/models/deepmd/{train,
fit_dos,fit_tensor,spin}.py, g4s_tpu_torch/ckpt.py, `dp train`) against
the reference (g4s_tpu/models/deepmd, g4s_tpu/ckpt.py) on the CPU, in f64
on both sides, from shared parameters (the reference's init carried into
the port by params_from_numpy) and batches drawn from seeded numpy
generators.

Sizes: tests/test_deepmd.py's tiny_spec (sel 6/10, embedding 4-8-16, axis
4, fitting 16-16), frames of 20 atoms in a 7 A box, and 4-atom frames in a
6 A box, where sel exceeds the atoms: the force loss's second derivative
then runs through env_mat's padded slots.

Tolerances, relative to the largest magnitude of the reference's result:
1e-10 for losses, aux values and every parameter and optimizer leaf after
each package's Adam steps; the data-parallel step on two gloo ranks against
one process on the whole batch 1e-12."""

import importlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_deepmd import tiny_spec

J = {m: importlib.import_module(f"g4s_tpu.models.deepmd.{m}")
     for m in ("model", "train", "descriptor", "fit_dos", "fit_tensor",
               "spin", "data", "freeze")}
P = {m: importlib.import_module(f"g4s_tpu_torch.models.deepmd.{m}")
     for m in ("model", "train", "descriptor", "fit_dos", "fit_tensor",
               "spin", "data", "freeze")}
jckpt = importlib.import_module("g4s_tpu.ckpt")
pckpt = importlib.import_module("g4s_tpu_torch.ckpt")
dp_cli = importlib.import_module("g4s_tpu_torch.drivers.dp")

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_spec(jspec):
    d = P["descriptor"].DescriptorSpec(*jspec.descriptor)
    return P["model"].ModelSpec(d, *jspec[1:])


def to_port(tree):
    return P["freeze"].params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu", dtype=F64)


def close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def close_trees(got, want, tol=TOL, what=""):
    """Every leaf, in JAX's flatten order on both sides."""
    gl = pckpt.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        close(g, w, tol, f"{what} leaf {i}")


_CACHE = {}


def cached(key, make):
    """Build each JAX function (and model) once per module."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def jax_params(jspec, seed=0):
    """The reference's weights with davg/dstd (and fparam stats) drawn away
    from 0/1, so normalization and the trained stats are exercised."""
    def make():
        p = J["model"].init_params(jax.random.PRNGKey(seed), jspec,
                                   bias_atom_e=np.array([-1.5, 0.7]))
        r = np.random.default_rng(5)
        for k in list(p["stats"]):
            shape = p["stats"][k].shape
            p["stats"][k] = jnp.asarray(
                r.normal(size=shape) * 0.1 if k.endswith("avg")
                else 1.0 + r.uniform(size=shape))
        return p
    return cached(("params", jspec, seed), make)


def energy_batch(rng, nf=3, na=20, L=7.0, *, fparam=0, virial=False):
    types = np.sort(rng.integers(0, 2, na)).astype(np.int32)
    b = dict(coord=rng.uniform(0, L, (nf, na, 3)),
             box=np.tile(np.eye(3) * L, (nf, 1, 1)),
             energy=rng.normal(size=nf), force=rng.normal(size=(nf, na, 3)),
             types=types)
    if fparam:
        b["fparam"] = rng.normal(size=(nf, fparam))
    if virial:
        b["virial"] = rng.normal(size=(nf, 3, 3))
    return b


LOSS = (0.5, 1.0, 100.0, 1.0, 0.1, 0.5)      # e, f and virial prefactors
LR = (1e-3, 1e-5, 2, 10)                     # lr decays every 2 steps


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def pbatch(b):
    return P["train"].batch_to(b, torch.zeros((), dtype=F64))


# ---------------------------------------------------------------------------
# the energy loss, Adam, the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fparam", [0, 1], ids=["plain", "fparam"])
def test_loss_fn_matches_reference(fparam):
    js = tiny_spec()._replace(numb_fparam=fparam)
    b = energy_batch(np.random.default_rng(1), fparam=fparam, virial=True)
    jl = cached(("loss", fparam), lambda: jax.jit(J["train"].make_loss_fn(
        js, J["train"].LossConfig(*LOSS), J["train"].LRConfig(*LR))))
    pl = P["train"].make_loss_fn(port_spec(js), P["train"].LossConfig(*LOSS),
                                 P["train"].LRConfig(*LR))
    for step in (0, 3):
        want, want_aux = jl(jax_params(js), jbatch(b), jnp.asarray(
            float(step)))
        got, got_aux = pl(to_port(jax_params(js)), pbatch(b), step)
        close(got, want, what=f"loss at step {step}")
        assert set(got_aux) == set(want_aux)
        for k in want_aux:
            close(got_aux[k], want_aux[k], what=f"{k} at step {step}")


def jax_trainer():
    return cached("trainer", lambda: J["train"].Trainer(
        tiny_spec(), J["train"].LossConfig(*LOSS), J["train"].LRConfig(*LR)))


def test_trainer_three_updates_match_reference():
    """Three Trainer._update steps from shared parameters: the loss per step
    and every parameter (the stats included: the reference trains them) and
    optimizer-state leaf after them within 1e-10; the state's layout is
    optax's (leaf counts and integer counts equal)."""
    jt = jax_trainer()
    pt = P["train"].Trainer(port_spec(tiny_spec()),
                            P["train"].LossConfig(*LOSS),
                            P["train"].LRConfig(*LR))
    jp, pp = jax_params(tiny_spec()), to_port(jax_params(tiny_spec()))
    js_, ps_ = jt.init(jp), pt.init(pp)
    rng = np.random.default_rng(2)
    for step in range(3):
        b = energy_batch(rng, virial=True)
        jp, js_, jl, ja = jt._update(jp, js_, jbatch(b),
                                     jnp.asarray(float(step)))
        pp, ps_, pl, pa = pt._update(pp, ps_, pbatch(b), step)
        close(pl, jl, what=f"loss at step {step}")
        for k in ("rmse_e", "rmse_f", "lr"):
            close(pa[k], ja[k], what=f"{k} at step {step}")
    close_trees(pp, jp, what="params")
    close_trees(ps_, js_, what="opt_state")
    assert int(ps_[0].count) == int(ps_[1].count) == 3
    # the stats moved, as in the reference
    davg0 = np.asarray(jax_params(tiny_spec())["stats"]["davg"])
    assert np.abs(pp["stats"]["davg"].numpy() - davg0).max() > 1e-5


def test_lr_config_matches_reference():
    """LRConfig: decay_rate and lr_at in f64; lr_at_count is the float32
    step size optax derives from the int32 count, equal to the reference's
    at the counts a short run reaches and within one float32 rounding at
    every count up to 3,000."""
    for args in (LR, (1e-3, 3.51e-8, 5000, 1000000), (5e-3, 1e-4, 7, 60)):
        jc, pc = J["train"].LRConfig(*args), P["train"].LRConfig(*args)
        assert pc.decay_rate() == jc.decay_rate()
        for s in (0, 1, 2.5, 40):
            close(pc.lr_at(s), jc.lr_at(jnp.asarray(float(s))), 1e-15)
        counts = np.arange(3000, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(jc.lr_at))(jnp.asarray(counts)))
        got = np.array([pc.lr_at_count(int(c)) for c in counts])
        ok = want > 1e-30            # XLA flushes float32 subnormals
        np.testing.assert_array_equal(got[:50], want[:50])
        assert (np.abs(got - want)[ok] <= 2.0 ** -23 * want[ok]).all()


def test_change_energy_bias_matches_reference():
    jd, pd = two_tasks()
    jp = jax_params(tiny_spec())
    jp2, jdelta = J["train"].change_energy_bias(jp, tiny_spec(), jd["a"], 2,
                                                n_frames=3)
    pp2, pdelta = P["train"].change_energy_bias(
        to_port(jp), port_spec(tiny_spec()), pd["a"], 2, n_frames=3)
    close(pdelta, jdelta)
    close_trees(pp2, jp2, what="finetuned params")


def _task_system(offset, seed):
    r = np.random.default_rng(seed)
    base = r.uniform(1.5, 4.5, (1, 4, 3))
    coord = base + 0.05 * r.normal(size=(8, 4, 3))
    return dict(types=np.array([0, 0, 1, 1], np.int32), coord=coord,
                box=np.tile(np.eye(3) * 6.0, (8, 1, 1)),
                energy=offset + 0.1 * r.normal(size=8),
                force=0.1 * r.normal(size=(8, 4, 3)))


def two_tasks():
    """{"a": data, "b": data} for each package: two tiny in-memory systems
    of 4 atoms (fewer than sel) with energy offsets far apart, sampled by
    each package's own DataSystem methods from the same seed."""
    out = []
    for pkg in (J, P):
        DS = pkg["data"].DataSystem

        class _Data:
            def __init__(self, sysd):
                self.systems = [pkg["data"].System(
                    "mem", sysd["types"], sysd["coord"], sysd["box"],
                    sysd["energy"], sysd["force"])]
                self.batch_size = 2
                self.rng = np.random.default_rng(0)
                self.probs = np.array([1.0])

            energy_bias = DS.energy_bias
            sample_batch = DS.sample_batch

        out.append({"a": _Data(_task_system(-40.0, 1)),
                    "b": _Data(_task_system(15.0, 2))})
    return out


def test_multitask_two_rounds_match_reference():
    """Two MultiTaskTrainer rounds (4 steps, tasks alternating, one Adam
    state per task over the shared parts and its head, LR at step //
    ntasks) from the reference's initial parameters."""
    jd, pd = two_tasks()
    loss = J["train"].LossConfig(1.0, 1.0, 10.0, 1.0)
    jmt = J["train"].MultiTaskTrainer(tiny_spec(), [
        {"name": "a", "data": jd["a"], "loss_cfg": loss},
        {"name": "b", "data": jd["b"]}])
    pmt = P["train"].MultiTaskTrainer(port_spec(tiny_spec()), [
        {"name": "a", "data": pd["a"],
         "loss_cfg": P["train"].LossConfig(*loss)},
        {"name": "b", "data": pd["b"]}])
    jp0 = jmt.init_params(jax.random.PRNGKey(0))
    jp, jh = jmt.train(jp0, 4, disp_freq=1)
    pp, ph = pmt.train(to_port(jp0), 4, disp_freq=1)
    close_trees(pp, jp, what="multi-task params")
    for name in ("a", "b"):
        close(ph[name], jh[name], what=f"rmse_f history {name}")


# ---------------------------------------------------------------------------
# DOS and tensor fits, env_mat_nopbc, spin
# ---------------------------------------------------------------------------


def dos_frames(rng, nf=6, na=20, L=7.0, numb_dos=5):
    return dict(coord=rng.uniform(0, L, (nf, na, 3)),
                box=np.tile(np.eye(3) * L, (nf, 1, 1)),
                atom_dos=rng.normal(size=(nf, na, numb_dos)),
                dos=rng.normal(size=(nf, numb_dos)))


def test_train_dos_matches_reference():
    """Three train_dos steps, every loss term on. The reference passes the
    step as float32 and evaluates the prefactors in float32 (through XLA's
    rewrites); the port evaluates them in the parameters' precision, so
    the prefactors here stay constant over the schedule and are float32
    numbers, where both are exact."""
    js = tiny_spec()
    rng = np.random.default_rng(3)
    types = np.sort(rng.integers(0, 2, 20)).astype(np.int32)
    frames = dos_frames(rng)
    jnets = J["fit_dos"].init_dos_fit(jax.random.PRNGKey(7), js, 5,
                                      bias_dos=rng.normal(size=(2, 5)))
    cfg = (2.0, 2.0, 0.5, 0.5, 1.0, 1.0, 0.25, 0.25)
    lr = (1e-2, 1e-4, 1, 3)
    (jp, jn), ja = J["fit_dos"].train_dos(
        jax_params(js), jnets, js, frames, jnp.asarray(types), numb_steps=3,
        loss_cfg=J["fit_dos"].DOSLossConfig(*cfg),
        lr_cfg=J["train"].LRConfig(*lr), batch_size=2, seed=4)
    (pp, pn), pa = P["fit_dos"].train_dos(
        to_port(jax_params(js)), to_port(jnets), port_spec(js), frames,
        types, numb_steps=3, loss_cfg=P["fit_dos"].DOSLossConfig(*cfg),
        lr_cfg=P["train"].LRConfig(*lr), batch_size=2, seed=4)
    close_trees((pp, pn), (jp, jn), what="dos params")
    for k in ("rmse_dos", "rmse_ados"):
        close(pa[k], ja[k], what=k)
    # frozen stats: the port's Adam left them where they were
    close(pp["stats"]["dstd"].numpy(), jax_params(js)["stats"]["dstd"], 0.0)


def tensor_frames(rng, kind, nf=6, na=20, L=7.0):
    k = 3 if kind == "dipole" else 9
    return dict(coord=rng.uniform(0, L, (nf, na, 3)),
                box=np.tile(np.eye(3) * L, (nf, 1, 1)),
                atomic_label=rng.normal(size=(nf, na, k)),
                label=rng.normal(size=(nf, k)))


@pytest.mark.parametrize("kind,nopbc", [("dipole", False), ("dipole", True),
                                        ("polar", False)])
def test_train_tensor_matches_reference(kind, nopbc):
    """Three train_tensor steps, atomic and global labels, sel_type (0,)."""
    js = tiny_spec()
    rng = np.random.default_rng(4)
    types = np.sort(rng.integers(0, 2, 20)).astype(np.int32)
    frames = tensor_frames(rng, kind)
    jnets = J["fit_tensor"].init_tensor_fit(jax.random.PRNGKey(8), js)
    lcfg = (0.5, 1.0, 2.0, (0,))
    lr = (1e-2, 1e-4, 1, 3)
    fn = "atomic_dipole" if kind == "dipole" else "atomic_polar"
    (jp, jn), ja = J["fit_tensor"].train_tensor(
        jax_params(js), jnets, js, frames, jnp.asarray(types), numb_steps=3,
        loss_cfg=J["fit_tensor"].TensorLossConfig(*lcfg),
        tensor_fn=getattr(J["fit_tensor"], fn),
        lr_cfg=J["train"].LRConfig(*lr), batch_size=2, seed=5, nopbc=nopbc)
    (pp, pn), pa = P["fit_tensor"].train_tensor(
        to_port(jax_params(js)), to_port(jnets), port_spec(js), frames,
        types, numb_steps=3,
        loss_cfg=P["fit_tensor"].TensorLossConfig(*lcfg),
        tensor_fn=getattr(P["fit_tensor"], fn),
        lr_cfg=P["train"].LRConfig(*lr), batch_size=2, seed=5, nopbc=nopbc)
    close_trees((pp, pn), (jp, jn), what=f"{kind} params")
    assert set(pa) == set(ja) == {"rmse_local", "rmse_global"}
    for k in ja:
        close(pa[k], ja[k], what=k)
    # and the trained tensors themselves, on one frame
    c, b = frames["coord"][0], frames["box"][0]
    want = getattr(J["fit_tensor"], fn)(jp, jn, js, jnp.asarray(c),
                                        jnp.asarray(b), jnp.asarray(types),
                                        nopbc=nopbc)
    got = getattr(P["fit_tensor"], fn)(pp, pn, port_spec(js),
                                       torch.from_numpy(c),
                                       torch.from_numpy(b),
                                       torch.from_numpy(types), nopbc=nopbc)
    close(got, want, what=f"{kind} after training")


@pytest.mark.parametrize("masked", [False, True])
def test_env_mat_nopbc_matches_reference(masked):
    rng = np.random.default_rng(6)
    c = rng.uniform(0, 5.0, (3, 12, 3))
    ty = np.sort(rng.integers(0, 2, 12)).astype(np.int32)
    mask = rng.uniform(size=12) > 0.3 if masked else None
    dspec = tiny_spec().descriptor
    Rp, nlp = P["descriptor"].env_mat_nopbc(
        torch.from_numpy(c), torch.from_numpy(ty),
        port_spec(tiny_spec()).descriptor,
        atom_mask=None if mask is None else torch.from_numpy(mask))
    for i in range(3):                # the port's batch, frame by frame
        Rj, nlj = J["descriptor"].env_mat_nopbc(
            jnp.asarray(c[i]), jnp.asarray(ty), dspec,
            atom_mask=None if mask is None else jnp.asarray(mask))
        close(Rp[i], Rj, what=f"R frame {i}")
        np.testing.assert_array_equal(nlp[i].numpy(), np.asarray(nlj))
    assert (nlp >= 0).any() and (nlp < 0).any()


def test_spin_augment_split_forces_match_reference():
    """expand_sel/expand_ntypes, augment and split_forces, and the chain rule
    dE/dS = f_virtual * virtual_len/spin_norm through the port's autograd."""
    js = J["model"].ModelSpec(J["descriptor"].DescriptorSpec(
        5.6, 5.4, (8, 8, 8), 3), (6, 12), 3, (16, 16))
    jss = J["spin"].SpinSpec((True, False), (0.4,), (1.2737,))
    pss = P["spin"].SpinSpec(*jss)
    assert P["spin"].expand_sel((8, 8), pss) == J["spin"].expand_sel(
        (8, 8), jss)
    assert P["spin"].expand_ntypes(2, pss) == J["spin"].expand_ntypes(2, jss)
    rng = np.random.default_rng(0)
    coord = rng.uniform(1.0, 9.0, (6, 3))
    types = np.array([0, 0, 1, 1, 1, 1], np.int32)
    svec = np.zeros((6, 3))
    svec[:2] = rng.normal(size=(2, 3))
    box = np.diag([12.0, 12.0, 12.0])
    jca, jta = J["spin"].augment(jnp.asarray(coord), jnp.asarray(svec),
                                 types, jss)
    pca, pta = P["spin"].augment(torch.from_numpy(coord), svec, types, pss)
    close(pca, jca, what="coord_aug")
    np.testing.assert_array_equal(pta.numpy(), np.asarray(jta))
    jp = J["model"].init_params(jax.random.PRNGKey(0), js)
    pspec = port_spec(js)
    pp = to_port(jp)
    f_aug = -jax.jit(jax.grad(lambda c: J["model"].total_energy(
        jp, js, c, jnp.asarray(box), jta)))(jca)
    pf = P["model"].energy_force_virial(pp, pspec, pca, torch.from_numpy(box),
                                        pta)[1]
    close(pf, f_aug, what="augmented forces")
    jr, jm = J["spin"].split_forces(f_aug, jta, jss)
    pr, pm = P["spin"].split_forces(pf, pta, pss)
    close(pr, jr, what="real forces")
    close(pm, jm, what="magnetic forces")
    s = torch.from_numpy(svec).requires_grad_(True)
    e = P["model"].total_energy(
        pp, pspec, P["spin"].augment(torch.from_numpy(coord), s, types,
                                     pss)[0], torch.from_numpy(box), pta)
    (g,) = torch.autograd.grad(e, s)
    close(-g[:2], pm, 1e-12, what="chain rule dE/dS")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("with_opt", [False, True], ids=["params", "opt"])
def test_deepmd_checkpoint_cross_loads(tmp_path, writer, with_opt):
    """save_deepmd written by one package restores in the other, with and
    without the Adam state (optax's layout: count, mu..., nu..., count)."""
    js = tiny_spec()
    jt = jax_trainer()
    jp = jax_params(js)
    js_ = jt.init(jp)
    jp, js_, _, _ = jt._update(jp, js_, jbatch(energy_batch(
        np.random.default_rng(8), virial=True)), jnp.asarray(0.0))
    pt = P["train"].Trainer(port_spec(js))
    pp, ps_ = to_port(jp), pt.init(to_port(jp))
    ps_ = pckpt.tree_unflatten(ps_, iter(
        torch.from_numpy(np.array(x)) for x in
        jax.tree_util.tree_leaves(js_)))
    path = tmp_path / "ck.npz"
    if writer == "jax":
        jckpt.save_deepmd(path, jp, js_ if with_opt else None, step=7)
        tree, meta = pckpt.load_deepmd(path, pp,
                                       pt.init(pp) if with_opt else None)
        close_trees(tree["params"], jp, 0.0, "params")
        if with_opt:
            close_trees(tree["opt_state"], js_, 0.0, "opt_state")
            assert tree["opt_state"][0].count.dtype == torch.int32
            assert int(tree["opt_state"][1].count) == 1
    else:
        pckpt.save_deepmd(path, pp, ps_ if with_opt else None, step=7)
        tree, meta = jckpt.load_deepmd(path, jp, js_ if with_opt else None)
        close_trees(pp, tree["params"], 0.0, "params")
        if with_opt:
            close_trees(ps_, tree["opt_state"], 0.0, "opt_state")
            assert jax.tree_util.tree_structure(tree["opt_state"]) == \
                jax.tree_util.tree_structure(js_)
    assert meta == {"kind": "deepmd", "step": 7, "has_opt": with_opt}
    if not with_opt:
        with pytest.raises(ValueError, match="leaves"):
            pckpt.load_pytree(path, {"params": pp, "opt_state": ps_})


# ---------------------------------------------------------------------------
# data parallelism on two gloo ranks
# ---------------------------------------------------------------------------

_DDP_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, src, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
from g4s_tpu_torch import ckpt
from g4s_tpu_torch.models.deepmd import train
with np.load(src, allow_pickle=True) as z:
    case = z["case"].item()
spec, params, batches = case["spec"], case["params"], case["batches"]
loss_cfg, lr_cfg = train.LossConfig(*case["loss"]), train.LRConfig(*case["lr"])
params = ckpt.tree_unflatten(params, iter(torch.from_numpy(a) for a in
                                          ckpt.tree_leaves(params)))
step_fn = train.make_dp_train_step(spec, loss_cfg, lr_cfg)
state = train.Adam(lr_cfg.lr_at_count).init(params)
res = []
for step, b in enumerate(batches):
    b = train.batch_to(train.shard_batch(b, rank, world),
                       torch.zeros((), dtype=torch.float64))
    params, state, loss, aux = step_fn(params, state, b, step)
    res += [loss.numpy(), aux["rmse_e"].numpy(), aux["rmse_f"].numpy()]
np.savez(out, *[x.numpy() for x in ckpt.tree_leaves(params)], *res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dp_train_step_on_two_gloo_ranks(tmp_path):
    """make_dp_train_step on 2 CPU processes (gloo), each with its half of
    a 4-frame batch, two steps: every parameter leaf, the loss and
    rmse_e/rmse_f equal to one process stepping on the whole batch within
    1e-12, and equal on both ranks."""
    spec = port_spec(tiny_spec())
    params = to_port(jax_params(tiny_spec()))
    rng = np.random.default_rng(9)
    batches = [energy_batch(rng, nf=4) for _ in range(2)]
    loss, lr = LOSS[:4], LR
    src = tmp_path / "case.npz"
    np.savez(src, case=np.array({
        "spec": spec, "params": P["model"].map_tree(
            lambda x: x.numpy(), params), "batches": batches,
        "loss": loss, "lr": lr}, dtype=object))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DDP_WORKER, str(r), "2", port, str(src),
         str(tmp_path / f"rank{r}.npz")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    tr = P["train"].Trainer(spec, P["train"].LossConfig(*loss),
                            P["train"].LRConfig(*lr))
    state = tr.init(params)
    want = []
    for step, b in enumerate(batches):
        params, state, lv, aux = tr._update(params, state, pbatch(b), step)
        want += [lv, aux["rmse_e"], aux["rmse_f"]]
    want = [x.numpy() for x in pckpt.tree_leaves(params)] + \
        [np.asarray(x) for x in want]
    ranks = []
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append([z[f"arr_{i}"] for i in range(len(z.files))])
    assert len(ranks[0]) == len(want)
    for i, w in enumerate(want):
        close(ranks[0][i], w, 1e-12, f"DDP entry {i}")
        np.testing.assert_array_equal(ranks[1][i], ranks[0][i])


# ---------------------------------------------------------------------------
# `dp train` through main()
# ---------------------------------------------------------------------------


def write_energy_system(path, rng, nf=12, na=8, fparam=False, types=None):
    s = path / "set.000"
    s.mkdir(parents=True)
    t = (np.arange(na) % 2).astype(np.int32) if types is None else types
    np.savetxt(path / "type.raw", t, fmt="%d")
    coord = rng.uniform(1.0, 9.0, (nf, na * 3))
    energy = coord.reshape(nf, -1, 3)[:, :, 0].sum(1) * 0.01 - 3.0
    force = np.zeros((nf, na * 3))
    force[:, 0::3] = -0.01
    if fparam:
        fp = rng.uniform(-1, 1, (nf, 1))
        energy = energy + 0.5 * fp[:, 0]
        np.save(s / "fparam.npy", fp)
    np.save(s / "coord.npy", coord)
    np.save(s / "box.npy", np.tile(np.eye(3).ravel() * 10, (nf, 1)))
    np.save(s / "energy.npy", energy)
    np.save(s / "force.npy", force)


def write_input(path, fitting, systems, *, steps=8, extra=None):
    jd = {"model": {"type_map": ["O", "H"],
                    "descriptor": {"rcut": 6.0, "rcut_smth": 0.5,
                                   "sel": [8, 12], "neuron": [6, 12],
                                   "axis_neuron": 3},
                    "fitting_net": dict({"neuron": [16, 16]}, **fitting)},
          "learning_rate": {"start_lr": 5e-3, "stop_lr": 1e-4,
                            "decay_steps": 20},
          "loss": {"start_pref_e": 1, "limit_pref_e": 1,
                   "start_pref_f": 1, "limit_pref_f": 1},
          "training": {"numb_steps": steps, "disp_freq": 2,
                       "training_data": {"systems": systems,
                                         "batch_size": 4}}}
    for k, v in (extra or {}).items():
        jd["model"][k] = v
    path.write_text(json.dumps(jd))
    return str(path)


def test_dp_train_energy_cli(tmp_path, monkeypatch):
    """`dp train` on a synthetic fparam system through main() on the CPU:
    lcurve and checkpoints written, `dp freeze` serves the trained
    parameters exactly, then --restart, --init-model and --finetune each
    train on from the result, and the reference restores the checkpoint."""
    monkeypatch.chdir(tmp_path)
    write_energy_system(tmp_path / "sys", np.random.default_rng(0),
                        fparam=True)
    inp = write_input(tmp_path / "input.json", {"numb_fparam": 1}, ["sys"])
    ck = str(tmp_path / "ck.npz")
    out = dp_cli.main(["train", inp, "--checkpoint", ck, "--device", "cpu",
                       "--dtype", "f64"])
    lines = (tmp_path / "lcurve.out").read_text().splitlines()
    assert lines[0].startswith("# step") and len(lines) == 1 + 5
    assert [int(x.split()[0]) for x in lines[1:]] == [0, 2, 4, 6, 7]
    frozen = str(tmp_path / "frozen.npz")
    dp_cli.main(["freeze", "-c", ck, "-o", frozen])
    from g4s_tpu_torch.models.deepmd.infer import DeepPot
    sysd = P["data"].load_system(str(tmp_path / "sys"))
    pot = DeepPot(frozen, device="cpu")
    e_pot = pot.eval(sysd.coord[0], sysd.box[0], sysd.types,
                     fparam=sysd.fparam[0])[0]
    e_tr = P["model"].energy_force_virial(
        out["params"], out["spec"], torch.from_numpy(sysd.coord[0]),
        torch.from_numpy(sysd.box[0]), torch.from_numpy(sysd.types),
        fparam=torch.from_numpy(sysd.fparam[0]))[0]
    close(e_pot, e_tr, 1e-12, "frozen against trained")
    # the reference restores the port's checkpoint
    jspec = J["freeze"].load_frozen(frozen)[1]
    jtmpl = J["model"].init_params(jax.random.PRNGKey(0), jspec)
    tree, meta = jckpt.load_deepmd(ck, jtmpl)
    close_trees(out["params"], tree["params"], 0.0, "reference restore")
    assert meta["step"] == 8 and not meta["has_opt"]
    for flag, src in (("--restart", ck), ("--init-model", frozen),
                      ("--finetune", frozen)):
        ck2 = str(tmp_path / f"ck{flag}.npz")
        out2 = dp_cli.main(["train", inp, flag, src, "--steps", "3",
                            "--checkpoint", ck2, "--device", "cpu",
                            "--dtype", "f64"])
        assert os.path.exists(ck2) and os.path.exists(ck2 + ".model.npz")
        # the run starts from the trained parameters: its first lcurve line
        # is the trained model's fit, below a fresh model's; its LR starts
        # afresh and decays towards the input file's numb_steps, not
        # --steps: steps 0 and 2 at the first run's rates
        rows = [r.split() for r in
                (tmp_path / "lcurve.out").read_text().splitlines()[1:]]
        assert float(rows[0][2]) < float(lines[1].split()[2]), flag
        assert [(r[0], r[3]) for r in rows] == \
            [tuple(lines[i].split()[j] for j in (0, 3)) for i in (1, 2)]
        leaves = pckpt.tree_leaves(out2["params"])
        assert all(torch.isfinite(x).all() for x in leaves)


def test_dp_train_spin_cli(tmp_path, monkeypatch):
    """The spin branch: sel and ntypes expanded by the virtual type, the
    system's type.raw holding it (as the reference's spin example does)."""
    monkeypatch.chdir(tmp_path)
    write_energy_system(tmp_path / "sys", np.random.default_rng(1), na=6,
                        types=np.array([0, 0, 1, 1, 2, 2], np.int32))
    inp = write_input(tmp_path / "input.json", {}, ["sys"], steps=3, extra={
        "spin": {"use_spin": [True, False], "virtual_len": [0.4],
                 "spin_norm": [1.2737]}})
    out = dp_cli.main(["train", inp, "--checkpoint", str(tmp_path / "c.npz"),
                       "--device", "cpu"])
    assert out["spec"].descriptor.sel == (8, 12, 8)
    assert out["spec"].descriptor.ntypes == 3
    assert out["params"]["stats"]["davg"].dtype == torch.float32


def write_dos_system(path, rng, nf=8, na=8, numb_dos=4):
    s = path / "set.000"
    s.mkdir(parents=True)
    np.savetxt(path / "type.raw", (np.arange(na) % 2).astype(np.int32),
               fmt="%d")
    coord = rng.uniform(1.0, 9.0, (nf, na * 3))
    ados = np.abs(rng.normal(size=(nf, na, numb_dos)))
    np.save(s / "coord.npy", coord)
    np.save(s / "box.npy", np.tile(np.eye(3).ravel() * 10, (nf, 1)))
    np.save(s / "atom_dos.npy", ados.reshape(nf, -1))
    np.save(s / "dos.npy", ados.sum(1))


def write_dipole_system(path, rng, *, atomic, nf=8, na=8):
    s = path / "set.000"
    s.mkdir(parents=True)
    types = (np.arange(na) % 2).astype(np.int32)
    np.savetxt(path / "type.raw", types, fmt="%d")
    coord = rng.uniform(1.0, 6.0, (nf, na, 3))
    np.save(s / "coord.npy", coord.reshape(nf, -1))
    np.save(s / "box.npy", np.tile(np.eye(3).ravel() * 10, (nf, 1)))
    # a learnable label: each O atom's dipole points to its H neighbour
    d = 0.2 * (coord[:, 1::2] - coord[:, 0::2])
    if atomic:
        np.save(s / "atomic_dipole.npy", d.reshape(nf, -1))
    else:
        np.save(s / "dipole.npy", d.sum(1))
    (path / "nopbc").write_text("")


@pytest.mark.parametrize("kind", ["dos", "dipole"])
def test_dp_train_dos_and_dipole_cli(tmp_path, monkeypatch, kind):
    """The DOS and dipole branches of `dp train` through main(): the dipole
    input mixes an atomic-label and a global-label nopbc system, as the
    reference's water_tensor example does; the checkpoint restores in the
    reference."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    if kind == "dos":
        write_dos_system(tmp_path / "sys", rng)
        fitting, systems = {"type": "dos", "numb_dos": 4}, ["sys"]
    else:
        write_dipole_system(tmp_path / "a", rng, atomic=True)
        write_dipole_system(tmp_path / "g", rng, atomic=False)
        fitting, systems = {"type": "dipole", "sel_type": [0]}, ["a", "g"]
    inp = write_input(tmp_path / "input.json", fitting, systems, steps=6)
    ck = str(tmp_path / "t.npz")
    out = dp_cli.main(["train", inp, "--checkpoint", ck, "--device", "cpu",
                       "--dtype", "f64"])
    assert all(np.isfinite(v) for v in out["final_aux"].values())
    if kind == "dipole":
        assert len(out["loss_curves"]) == 2
    meta = pckpt.read_meta(ck)
    assert meta == {"kind": f"deepmd_{kind}", "step": 6}
    with np.load(ck) as z:
        n = json.loads(str(z["__header__"]))["n_leaves"]
        assert n == len(z.files) - 1


def test_dp_train_defaults_to_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run on it")
    monkeypatch.chdir(tmp_path)
    write_energy_system(tmp_path / "sys", np.random.default_rng(0))
    inp = write_input(tmp_path / "input.json", {}, ["sys"])
    with pytest.raises(RuntimeError, match="cuda"):
        dp_cli.main(["train", inp])
    assert not (tmp_path / "model.ckpt.npz").exists()

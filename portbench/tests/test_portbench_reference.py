"""The plain reference against the program, on the CPU, at 8-32 atoms:
E, F and the virial of both descriptors, davg/dstd, and an NVT step.
(These tests import both; the reference itself imports nothing of the
program.)"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# the CPU's LAPACK can hang with more than one thread (the repo's tests
# keep one)
torch.set_num_threads(1)

from portbench import frames, model  # noqa: E402
from portbench.reference import nvt  # noqa: E402

CPU = torch.device("cpu")
CONFIGS = ["water_se_e2_a", "water_se_e3"]
TOL = 1e-12


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def _setup(name, seed):
    cfg = dict(_cfg(name), stat_frames=2)
    w = model.raw_weights(cfg, seed, CPU)
    sx = model.stat_frames(cfg, seed)
    return cfg, w, sx, model.program_pot(cfg, w, sx, CPU), \
        model.Reference(cfg, w, sx, CPU)


def _rel(a, b):
    return float((torch.as_tensor(a) - b).abs().max() / b.abs().max())


def test_weight_tree_is_the_programs():
    from g4s_tpu_torch.ckpt import tree_leaves
    from g4s_tpu_torch.models.deepmd import init_params
    for name in CONFIGS:
        cfg = _cfg(name)
        ours = model.raw_weights(cfg, 5, CPU)
        skel = init_params(torch.Generator().manual_seed(0),
                           model.port_spec(cfg))
        del skel["stats"]
        assert [tuple(x.shape) for x in tree_leaves(ours)] \
            == [tuple(x.shape) for x in tree_leaves(skel)]


def test_weights_repeat_per_seed():
    cfg = _cfg("water_se_e3")
    a, b = (model.raw_weights(cfg, 2**31 + 3, CPU) for _ in range(2))
    assert torch.equal(a["fit"][1]["final"]["w"], b["fit"][1]["final"]["w"])


@pytest.mark.parametrize("name", CONFIGS)
def test_stats_match_the_programs(name):
    _, _, _, pot, ref = _setup(name, 21)
    st = pot.params["stats"]
    assert torch.allclose(st["davg"][:, 0], ref.davg, rtol=1e-13, atol=0)
    assert torch.allclose(st["dstd"][:, 0], ref.dstd, rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n_side", [2, 3])
def test_efv_matches_the_program(name, n_side):
    _, _, _, pot, ref = _setup(name, 2**31 + 17)
    x = frames.water_frames(frames.rng(4, "frames"), 2, n_side)
    L = frames.box_length(n_side)
    ty = frames.types(n_side ** 3)
    e, f, w = pot.eval(x, np.tile(np.eye(3) * L, (2, 1, 1)), ty)
    E, F, W, info = ref.efv(x, L, ty)
    assert _rel(e, E) < TOL and _rel(f, F) < TOL and _rel(w, W) < TOL
    assert all(m <= s for m, s in zip(info["most"], ref.model.sel))
    assert info["closest"] >= frames.O_H_A - 1e-12


def test_reference_detects_a_moved_atom():
    _, _, _, pot, ref = _setup("water_se_e2_a", 8)
    x = frames.water_frames(frames.rng(4, "frames"), 1, 2)
    L = frames.box_length(2)
    ty = frames.types(8)
    e, f, _ = pot.eval(x, np.eye(3)[None] * L, ty)
    x[0, 3, 0] += 1e-6
    E, F, _, _ = ref.efv(x, L, ty)
    assert _rel(f, F) > 1e-8


def test_nvt_step_matches_the_program():
    from g4s_tpu_torch.models.deepmd.md import NVTIntegrator
    from g4s_tpu_torch.models.deepmd.model import energy_force_virial
    _, _, _, pot, ref = _setup("water_se_e2_a", 99)
    n_side = 2
    L = frames.box_length(n_side)
    ty = frames.types(n_side ** 3)
    m = np.where(ty == 0, 16.0, 2.0)
    x0 = frames.water_frame(frames.rng(1, "frames"), n_side)
    v0 = frames.velocities(frames.rng(1, "velocities"), m, 330.0,
                           nvt.KB_EV, nvt.F_OVER_M)
    box = torch.eye(3, dtype=torch.float64) * L
    types = torch.as_tensor(ty)

    def force(x):
        return energy_force_virial(pot.params, pot.spec, x, box, types)[1]
    integ = NVTIntegrator(force, m, np.eye(3) * L, device="cpu")
    s, f = integ.initial_state(x0, v0)
    p = nvt.Thermostat(330.0, 0.5, 0.0005, torch.as_tensor(m),
                       torch.full((3,), L, dtype=torch.float64))

    def rforce(x):
        return ref.efv(x[None], L, ty)[1][0]
    x, v, xi, g = s.x, s.v, s.xi, f
    for _ in range(4):
        s, f = integ.step(s, f)
        x, v, xi, g = nvt.step(p, rforce, x, v, xi, g)
    assert float((s.x - x).abs().max()) < 1e-12
    assert _rel(s.v, v) < TOL and _rel(f, g) < TOL
    assert float((s.xi - xi).abs().max()) < 1e-14
    assert ((s.x >= 0) & (s.x < L)).all()
    assert abs(float(nvt.temperature(p.masses, v))
               - float(integ.temperature(s.v))) < 1e-9

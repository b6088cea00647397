"""Parity of distributed CitcomS, the element-sharded full sphere, the
coupled step with a sharded coarse solve and the rank-striped NTC sweep
with g4s_tpu's one-device results; and the multichip driver end to end.

The port's side runs on gloo ranks, one CPU process each, started once
per rank count by a module fixture (parallel.launch.run_ranks): 2x2 and
2x1 brick grids for DistributedCitcom, 4 and 2 ranks for the full sphere,
2 ranks for the sweep. The reference's side runs in this process in f64.
Solver loops run at fixed caps (accuracy 0): the reference's own runs to
tolerance move by more than these tolerances under a rounding change
(ROADMAP.md section 3).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from g4s_tpu.models import cantera as J
from g4s_tpu.models.citcoms import CitcomConfig as JCfg
from g4s_tpu.models.citcoms import CitcomModel as JModel
from g4s_tpu.models.citcoms import combine as j_combine
from g4s_tpu.models.citcoms import exchanger as jex
from g4s_tpu.models.citcoms import full_driver as jfd
from g4s_tpu_torch.models.citcoms import CitcomConfig, FullSphereModel
from g4s_tpu_torch.models.citcoms import combine as p_combine
from g4s_tpu_torch.models.citcoms.full_driver import shard_full_step
from g4s_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from chip_smoke import _synthetic_mechanism_yaml  # noqa: E402

# the configurations, shared with the rank processes (the worker runs
# this source too, without importing jax)
_CASES = r"""
# the dry run's regional size on a 2x2 grid (__graft_entry__.py:167-172)
# and tests/test_citcoms.py:249-252's, each at a fixed cap
REGIONAL = {
    "dry": dict(nodex=5, nodey=5, nodez=4, theta_min=0.7854,
                theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                radius_inner=0.55, radius_outer=1.0, rayleigh=1e4, topvbc=1,
                topvbxval=10.0, num_mat=4, accuracy=0.0, piterations=3,
                vlowstep=20),
    "c9": dict(nodex=9, nodey=9, nodez=5, theta_min=0.7854,
               theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
               radius_inner=0.55, radius_outer=1.0, rayleigh=1e5, topvbc=1,
               topvbxval=100.0, num_mat=4, accuracy=0.0, piterations=3,
               vlowstep=60)}
# the full sphere at 5x5x4 per cap (tests/test_citcoms.py:700-702) at
# 1 Uzawa x 20 CG, and the regional box the coupled step nests in it
FULL = dict(nodex=5, nodey=5, nodez=4, radius_inner=0.55, radius_outer=1.0,
            rayleigh=1e4, num_mat=1, accuracy=0.0, piterations=1,
            vlowstep=20)
REGION = dict(nodex=5, nodey=5, nodez=4, theta_min=0.7854, theta_max=1.5708,
              fi_min=0.0, fi_max=0.7854, radius_inner=0.55, radius_outer=1.0,
              num_mat=4, rayleigh=1e4, accuracy=0.0, piterations=1,
              vlowstep=20)
# the Cantera tests' small synthetic mechanism at their tolerances, around
# their 1000 K, where each OH peak is sharp and lies inside t_end (past
# about 1400 K the peak flattens and the recorded maximum moves by up to
# 2 % between the packages); 3 cases on 2 ranks (rank 0 takes two)
MECH = {"nspec": 15, "nrxn": 30, "n_falloff": 2, "n_three_body": 2,
        "seed": 0}
NTC_T = [1000.0, 1020.0, 1010.0]
NTC_KW = dict(P0=40 * 101325.0, t_end=4.6e-3, rtol=1e-8, atol=1e-14)
"""
exec(_CASES)
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def j_state(s) -> dict:
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and one-device results."""
    d = tmp_path_factory.mktemp("ref")
    out = {"dir": d}
    jm = jfd.FullSphereModel(JCfg(**FULL))
    T0 = np.asarray(jm.init_state().T)
    blob = np.exp(-np.sum((jm._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                          axis=1) / 0.05)
    js0 = dataclasses.replace(jm.init_state(),
                              T=jnp.asarray(np.clip(T0 + 0.3 * blob, 0, 1)))
    out["full0"] = js0
    out["stokes"] = jm.stokes(js0.T, js0.V, js0.P)
    out["solved"], _ = jm.initial_solve(js0)
    out["step"] = jm.step(out["solved"])
    jf = JModel(JCfg(**REGION))
    run = jex.CoupledRun(jm, jf, two_way=True)
    out["fine0"] = jf.init_state()
    out["coupled"] = run.step(js0, out["fine0"])
    out["exchange"] = run._exchange(js0.T, out["stokes"][0])
    out["regional"] = {}
    for k, kw in REGIONAL.items():
        m = JModel(JCfg(**kw))
        out["regional"][k] = m.step(m.init_state())
    mech = str(d / "small.yaml")
    _synthetic_mechanism_yaml(mech, **MECH)
    out["mech"] = mech
    kw = dict(NTC_KW)
    P0 = kw.pop("P0")
    out["ntc"] = J.ShockTubeBenchmark(mech).run_ntc_sweep(NTC_T, P0, **kw)
    np.savez(d / "case.npz", case=np.array({
        "full0": j_state(js0), "solved": j_state(out["solved"]),
        "fine0": j_state(out["fine0"]), "mech": mech}, dtype=object))
    return out


_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from g4s_tpu_torch.parallel import RankGrid, init_from_env
from g4s_tpu_torch.models.citcoms import (CitcomConfig, CitcomModel,
                                          CoupledRun, FullSphereModel,
                                          state_from_numpy)
from g4s_tpu_torch.models.citcoms.combine import (combine_velo,
                                                  write_rank_outputs)
from g4s_tpu_torch.models.citcoms.distributed import DistributedCitcom
from g4s_tpu_torch.models.citcoms.full_driver import (shard_full_sphere,
                                                      shard_full_step)
from g4s_tpu_torch.models.cantera.shock_tube import ShockTubeBenchmark
import torch.distributed as dist
ref_dir, out_dir = sys.argv[1], sys.argv[2]
init_from_env("cpu")
with np.load(os.path.join(ref_dir, "case.npz"), allow_pickle=True) as z:
    case = z["case"].item()
rank, world = dist.get_rank(), dist.get_world_size()
res = {}
n = lambda x: x.detach().numpy()
grid = RankGrid(("bx", "by"), (2, world // 2))
for name, kw in REGIONAL.items():
    cfg = CitcomConfig(**kw, datadir=os.path.join(out_dir, "velo"))
    d = DistributedCitcom(cfg, grid, device="cpu")
    s, diag = d.step(d.init_state())
    g = d.gather(s)
    for k, v in g.items():
        res[f"{name}/{k}"] = n(v)
    res[f"{name}/dt"] = n(diag.dt)
    res[f"{name}/counts"] = np.array([diag.uzawa_iterations,
                                      diag.inner_iterations])
    if name == "c9":
        write_rank_outputs(d, s, 1)
        dist.barrier()
        res["c9/merged"] = combine_velo(cfg, 2, world // 2, 1)
egrid = RankGrid(("e",))
fm = FullSphereModel(CitcomConfig(**FULL), device="cpu")
s0 = state_from_numpy(fm, case["full0"])
stokes = shard_full_sphere(fm, egrid)
V, P, mon = stokes(s0.T, s0.V, s0.P)
res["stokes/V"], res["stokes/P"] = n(V), n(P)
res["stokes/counts"] = np.array([mon.outer_iterations, mon.inner_iterations])
s1, d1 = shard_full_step(fm, egrid)(state_from_numpy(fm, case["solved"]))
for k in ("T", "Tdot", "V", "P", "dt", "time"):
    res[f"step/{k}"] = n(getattr(s1, k))
res["step/counts"] = np.array([d1.uzawa_iterations, d1.inner_iterations])
fine = CitcomModel(CitcomConfig(**REGION), device="cpu")
run = CoupledRun(fm, fine, two_way=True, device="cpu", coarse_stokes=stokes)
res["exchange/T"], res["exchange/V"] = map(n, run.exchange(s0.T, V))
sc, sf, (dc, df) = run.step(s0, state_from_numpy(fine, case["fine0"]))
for k in ("T", "V", "P"):
    res[f"coupled/coarse_{k}"] = n(getattr(sc, k))
    res[f"coupled/fine_{k}"] = n(getattr(sf, k))
if world == 2:
    kw = dict(NTC_KW)
    P0 = kw.pop("P0")
    stb = ShockTubeBenchmark(case["mech"], device="cpu")
    sw = stb.run_ntc_sweep_sharded(None, NTC_T, P0, **kw)
    res["ntc/tau_RG"], res["ntc/tau_IG"] = (np.array(sw["tau_RG"]),
                                            np.array(sw["tau_IG"]))
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
"""


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """{world: [rank 0's outputs, ...], "velo<world>": rank files' dir}."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {}
    for world in (4, 2):
        d = tmp_path_factory.mktemp(f"dist{world}")
        launch.run_ranks(world, lambda r: [
            sys.executable, "-c", _CASES + _WORKER, str(ref["dir"]),
            str(d)], env=env, cwd=REPO, timeout=600)
        out[world] = [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(world)]
        out[f"velo{world}"] = d / "velo"
    return out


# ------------------------------------------------------- regional CitcomS


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("name", list(REGIONAL))
def test_distributed_step_matches_one_device(ref, ranks, world, name):
    """DistributedCitcom's step on a 2 x world/2 brick grid, gathered from
    the blocks: dt within 1e-12, T, Tdot, V and P within 1e-10 of the
    reference's one-device CitcomModel.step, with equal Uzawa/CG counts,
    on every rank."""
    js, jd = ref["regional"][name]
    for out in ranks[world]:
        assert abs(float(out[f"{name}/dt"]) - float(jd.dt)) <= 1e-12
        for k in ("T", "Tdot", "V", "P"):
            assert rel(out[f"{name}/{k}"], getattr(js, k)) <= TOL, k
        assert tuple(out[f"{name}/counts"]) == (int(jd.uzawa_iterations),
                                                int(jd.inner_iterations))


@pytest.mark.parametrize("world", [4, 2])
def test_rank_files_combine_like_the_reference(ref, ranks, world):
    """The rank files (<datafile>.velo.<rank>.1), merged by the reference's
    combine_velo, give the port's merged field exactly, and it is the
    one-device T and V to the files' 7 digits."""
    cfg_kw = dict(REGIONAL["c9"], datadir=str(ranks[f"velo{world}"]))
    jcfg, pcfg = JCfg(**cfg_kw), CitcomConfig(**cfg_kw)
    py = world // 2
    files = sorted(os.listdir(ranks[f"velo{world}"]))
    assert files == sorted(f"{pcfg.datafile}.velo.{r}.1"
                           for r in range(world))
    merged = j_combine.combine_velo(jcfg, 2, py, 1)
    np.testing.assert_array_equal(p_combine.combine_velo(pcfg, 2, py, 1),
                                  merged)
    np.testing.assert_array_equal(ranks[world][0]["c9/merged"], merged)
    for r in range(world):
        assert p_combine.rank_node_grid(pcfg, 2, py, r) == \
            j_combine.rank_node_grid(jcfg, 2, py, r)
    js, _ = ref["regional"]["c9"]
    np.testing.assert_allclose(merged[:, 3], np.asarray(js.T), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(merged[:, :3], np.asarray(js.V), rtol=0,
                               atol=1e-6 * float(np.abs(js.V).max()))


def test_rank_file_bytes_match_the_references_writer(ranks, tmp_path):
    """Each rank's file is byte for byte what the reference's
    write_rank_outputs writes for that block's data."""
    d = ranks["velo4"]
    for r in range(4):
        p, = d.glob(f"*.velo.{r}.1")
        head = p.read_text().splitlines()[0]
        data = np.loadtxt(p, skiprows=1)
        t = float(head.split()[0])

        class _Dist:       # the reference's writer reads cfg and blocks
            cfg = JCfg(**dict(REGIONAL["c9"], datadir=str(tmp_path)))

        written = j_combine.write_rank_outputs(_Dist, {
            "T": data[None, :, 3], "V": data[None, :, :3],
            "time": np.float64(t)}, 1)
        assert p.read_bytes() == open(written[0], "rb").read()


# ---------------------------------------------------------- full sphere


@pytest.mark.parametrize("world", [4, 2])
def test_shard_full_sphere_matches(ref, ranks, world):
    """The element-sharded Stokes solve at 1 Uzawa x 20 CG: V within 1e-12
    and P within 1e-9 of the reference's FullSphereModel.stokes
    (tests/test_citcoms.py:718-720), equal counts, on every rank."""
    V1, P1, m1 = ref["stokes"]
    for out in ranks[world]:
        assert rel(out["stokes/V"], V1) < 1e-12
        assert float(np.abs(out["stokes/P"] - np.asarray(P1)).max()) < \
            1e-9 * max(1.0, float(np.abs(np.asarray(P1)).max()))
        assert tuple(out["stokes/counts"]) == (int(m1.outer_iterations),
                                               int(m1.inner_iterations))


@pytest.mark.parametrize("world", [4, 2])
def test_shard_full_step_matches(ref, ranks, world):
    """shard_full_step from the reference's initial solve: dt equal, T, V,
    P within 1e-10 of the reference's one-device step (T exactly as
    tests/test_citcoms.py:1031-1034 holds it, V within 1e-12)."""
    js1, jd = ref["step"]
    for out in ranks[world]:
        assert float(out["step/dt"]) == float(jd.dt)
        assert rel(out["step/T"], js1.T) <= 1e-14
        assert rel(out["step/V"], js1.V) < 1e-12
        for k in ("Tdot", "P", "time"):
            assert rel(out[f"step/{k}"], getattr(js1, k)) <= TOL, k
        assert tuple(out["step/counts"]) == (int(jd.uzawa_iterations),
                                             int(jd.inner_iterations))


def test_shard_full_step_refuses_a_world_that_does_not_divide_nel():
    class Five:
        def size(self, axis):
            return 5

    fm = FullSphereModel(CitcomConfig(**FULL), device="cpu")
    assert fm.mesh.nel % 5
    with pytest.raises(ValueError, match="not divisible"):
        shard_full_step(fm, Five())


@pytest.mark.parametrize("world", [4, 2])
def test_coupled_step_with_sharded_coarse_solve(ref, ranks, world):
    """CoupledRun with the coarse model's sharded solve: the sharded coarse
    V and the fine BCs it gives, against the reference's unsharded ones at
    tests/test_citcoms.py:1797-1808's tolerances and within 1e-10; then
    one coupled step against the reference's coupled step within 1e-10."""
    V0 = np.asarray(ref["stokes"][0])
    tbc0, vbc0 = map(np.asarray, ref["exchange"])
    jsc, jsf, _ = ref["coupled"]
    vmax = float(np.abs(V0).max())
    for out in ranks[world]:
        np.testing.assert_allclose(out["stokes/V"], V0, rtol=0,
                                   atol=2e-3 * vmax)
        np.testing.assert_allclose(out["exchange/T"], tbc0, atol=1e-9)
        np.testing.assert_allclose(out["exchange/V"], vbc0,
                                   atol=2e-3 * vmax)
        assert rel(out["exchange/T"], tbc0) <= TOL
        assert rel(out["exchange/V"], vbc0) <= TOL
        for k in ("T", "V", "P"):
            assert rel(out[f"coupled/coarse_{k}"], getattr(jsc, k)) <= TOL
            assert rel(out[f"coupled/fine_{k}"], getattr(jsf, k)) <= TOL


# ------------------------------------------------------------- NTC sweep


@pytest.mark.parametrize("phase", ["RG", "IG"])
def test_ntc_sweep_sharded_matches(ref, ranks, phase):
    """run_ntc_sweep_sharded on 2 ranks (rank 0 takes cases 0 and 2,
    rank 1 case 1): every tau within 1e-6 of the reference's sequential
    run_ntc_sweep, equal on both ranks."""
    want = np.asarray(ref["ntc"][f"tau_{phase}"])
    assert (want > 0).all() and (want < NTC_KW["t_end"]).all()
    for out in ranks[2]:
        got = out[f"ntc/tau_{phase}"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ranks[2][0][f"ntc/tau_{phase}"],
                                  ranks[2][1][f"ntc/tau_{phase}"])


# -------------------------------------------------------------- driver


def test_multichip_driver_on_two_gloo_ranks(ref):
    """`python -m g4s_tpu_torch.drivers.multichip --world 2 --device cpu`:
    the four stages' progress lines in order and a last line with the
    reference's fields ending in OK; --device cuda without a card fails."""
    cmd = [sys.executable, "-m", "g4s_tpu_torch.drivers.multichip",
           "--world", "2", "--device", "cpu", "--mech", ref["mech"],
           "--rk-phase", "nDodecane_RK", "--ig-phase", "nDodecane_IG",
           "--fuel", "c12h26", "--ntc-temps", "1450,1500",
           "--ntc-t-end", "3.2e-4"]
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith("multichip: world=2 backend=gloo")
    done = [ln for ln in lines if ln.startswith("multichip stage")]
    assert [ln.split()[2] for ln in done] == ["1/4", "2/4", "3/4", "4/4"]
    last = lines[-1]
    assert last.startswith("multichip(2): dp_loss=") and last.endswith(" OK")
    for key in ("citcoms_vrms=", "fullsphere_inner=", "ntc_tau0="):
        assert key in last
    if not torch.cuda.is_available():
        q = subprocess.run(cmd[:6] + ["cuda"] + cmd[7:], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert q.returncode != 0 and "no CUDA card" in q.stderr

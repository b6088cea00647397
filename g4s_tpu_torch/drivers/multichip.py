"""The multi-rank dry run (counterpart of __graft_entry__.dryrun_multichip).

Usage:
  python -m g4s_tpu_torch.drivers.multichip --world N --device {cuda,cpu}
      --mech PATH [--full-width] [--check] [--json-out FILE]
      [--rk-phase P --ig-phase P --fuel S] [--ntc-temps T1,T2,...]
      [--ntc-t-end S]

It starts N rank processes (torch.distributed: NCCL with one card per rank
on --device cuda, gloo on --device cpu) and runs four sharded programs in
the reference's order, each followed by its progress line:

  1/4 dp-train: one data-parallel DeePMD training step, one frame per
      rank, parameters replicated, gradients all-reduced;
  2/4 citcoms-regional: one distributed regional CitcomS step
      (DistributedCitcom on a px x py brick grid: halo exchanges and
      ownership-weighted all-reduces);
  3/4 full-sphere: the element-sharded full-sphere Stokes solve
      (shard_full_sphere);
  4/4 ntc-sweep: the NTC sweep striped over the ranks
      (run_ntc_sweep_sharded).

The last line carries the reference's fields (dp_loss, citcoms_vrms,
fullsphere_inner, ntc_tau0) and ends in OK. Without --full-width the
stages run the reference's tiny settings (__graft_entry__.py:123-219: a
12-atom model, 2px+1 x 2py+1 x 4 nodes, 5x5x4 per cap, one temperature
per rank from 1500 K at 5 atm to 2e-5 s on the mechanism's "ohmech"
phase with fuel "h2", as the reference's h2o2.yaml has them); with
--full-width the widths the repo runs on one card: WATER_SPEC with one
192-atom frame per rank, Cookbook2 (33x33x9), 12 caps of 17x17x9 and the
dodecane-size mechanism's phases "nDodecane_RK"/"nDodecane_IG" with two
temperatures per rank at 40 atm. The mechanism file is required (the
reference reads a file outside the repository).

--check (run by chip_smoke.py's phase 17) also holds each stage to its
one-process counterpart in rank 0's process (or in each rank's own for
the sweep), times the f32 steps beside the one-device ones, runs the
coupled CitcomS step with the sharded coarse solve and the row-sharded
SpMV and SpGEMM; --json-out writes rank 0's results. Any failing rank
fails the whole run (the reference's stage-skipping wall budget is not
kept: a stage either runs or the run fails).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ("1/4 dp-train", "2/4 citcoms-regional", "3/4 full-sphere",
          "4/4 ntc-sweep")
# --check tolerances: f64 against the one-process counterpart on the same
# device (fixed solver caps), the sweep's taus against the rank's own
# ignition_delay; the sparse products as chip_smoke.py's phases 3 and 7
F64_TOL = 1e-10
NTC_TOL = 1e-10
SPARSE_TOL = 1e-5
FIXED = dict(accuracy=0.0, piterations=3, vlowstep=60)
FULL_FIXED = dict(accuracy=0.0, piterations=1, vlowstep=20)
F32_STEPS = 5
FULL_F32_STEPS = 2


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mech", required=True,
                    help="mechanism YAML for the NTC stage")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--json-out", default=None,
                    help="write rank 0's results as JSON to this file")
    ap.add_argument("--rk-phase", default=None)
    ap.add_argument("--ig-phase", default=None)
    ap.add_argument("--fuel", default=None)
    ap.add_argument("--ntc-temps", default=None,
                    help="comma-separated temperatures (K)")
    ap.add_argument("--ntc-t-end", type=float, default=None)
    ap.add_argument("--as-rank", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


class _Run:
    """What every stage shares: the rank's device, its grid of all ranks,
    the options, the clock and rank 0's results."""

    def __init__(self, args, dev, mods):
        import torch.distributed as dist
        self.args, self.dev, self.mods = args, dev, mods
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.t0 = time.monotonic()
        self.out = {"world": self.world,
                    "backend": dist.get_backend(), "stages": {}}
        self.lap = time.monotonic()

    def say(self, line: str):
        if self.rank == 0:
            print(line, flush=True)

    def progress(self, stage: str, detail: str):
        now = time.monotonic()
        self.out["stages"][stage] = {"seconds": round(now - self.lap, 3)}
        self.lap = now
        self.say(f"multichip stage {stage} done "
                 f"[{now - self.t0:.1f}s] {detail}")

    def all_true(self, flag: bool) -> bool:
        """flag on every rank (an all-reduced decision)."""
        import torch
        import torch.distributed as dist
        x = torch.tensor(0.0 if flag else 1.0, device=self.dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x) == 0.0

    def all_max(self, v: float) -> float:
        import torch
        import torch.distributed as dist
        x = torch.tensor(float(v), dtype=torch.float64, device=self.dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x)

    @contextlib.contextmanager
    def uncounted(self):
        """Kernel launches inside are not the main path's: the launch
        counts are put back as they were."""
        saved = {k: m.LAUNCHES for k, m in self.mods.items()}
        try:
            yield
        finally:
            for k, m in self.mods.items():
                m.LAUNCHES = saved[k]

    def sync(self):
        if self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize()

    def barrier(self):
        import torch.distributed as dist
        self.sync()
        dist.barrier()


def _rel(a, b) -> float:
    """Largest |a - b| over b's largest magnitude (the difference itself
    where b is 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if not b.numel():
        return 0.0
    d, scale = float((a - b).abs().max()), float(b.abs().max())
    return d / scale if scale else d


def _need(run: _Run, ok: bool, what: str):
    """Fail every rank when `ok` is false on any of them."""
    if not run.all_true(ok):
        raise AssertionError(f"multichip check failed: {what}")


def _timed(wait, step, s, n: int):
    """n steps after wait() (a barrier of the ranks taking part, or a
    device synchronization): wall s/step, inner CG and host syncs per
    step, and the last state."""
    from g4s_tpu_torch.models.citcoms import solvers
    wait()
    solvers.HOST_SYNCS = 0
    inner = 0
    t0 = time.perf_counter()
    for _ in range(n):
        s, d = step(s)
        inner += d.inner_iterations
    wait()
    return s, {"s_per_step": (time.perf_counter() - t0) / n,
               "inner_cg_per_step": inner / n,
               "host_syncs_per_step": solvers.HOST_SYNCS / n}


def _profile(run: _Run, fn, wall_s: float) -> dict:
    """Device kernels, busy ms and idle share of one fn() on the card, and
    the NCCL kernels among them (one process only: the profiler retakes a
    profile that lost activities, which would call fn again on one rank)."""
    if run.dev.type != "cuda" or run.world != 1:
        return {"profiled": False}
    from g4s_tpu_torch.obs import timings
    acts = timings.device_activities(fn)
    busy = sum(us for _, us in acts) / 1e3
    return {"profiled": True, "profile_tries": timings.PROFILE_TRIES,
            "device_kernels": len(acts),
            "busy_ms": busy, "idle_share": max(0.0, 1 - busy / 1e3 / wall_s),
            "nccl_kernels": sum("nccl" in n.lower() for n, _ in acts),
            "segment_sums": sum("sorted_segment_sum" in n for n, _ in acts)}


# ---------------------------------------------------------------------------
# 1/4: the data-parallel DeePMD step
# ---------------------------------------------------------------------------


def _dp_case(run: _Run, dtype):
    """(spec, params, whole-batch raw frames, LR config) of the stage."""
    import torch
    from g4s_tpu_torch.models.deepmd import WATER_SPEC, init_params
    from g4s_tpu_torch.models.deepmd.descriptor import DescriptorSpec
    from g4s_tpu_torch.models.deepmd.model import ModelSpec
    from g4s_tpu_torch.models.deepmd.train import LRConfig
    nf = run.world
    rng = np.random.default_rng(0)
    if run.args.full_width:
        spec, n, L = WATER_SPEC, 192, 12.444661
        types = np.r_[np.zeros(64, np.int64), np.ones(128, np.int64)]
        coord0 = rng.uniform(0, L, size=(n, 3))
        coord = coord0[None] + np.concatenate([np.zeros((1, n, 3)),
                                               np.random.default_rng(3).normal(
                                                   scale=0.05,
                                                   size=(nf - 1, n, 3))])
        gen = torch.Generator().manual_seed(1)
    else:
        spec = ModelSpec(DescriptorSpec(rcut=3.0, rcut_smth=0.5, sel=(4, 8),
                                        ntypes=2),
                         embed_neurons=(4, 8), axis_neuron=2,
                         fit_neurons=(8, 8))
        n, L = 12, 6.0
        types = np.r_[np.zeros(4, np.int64), np.ones(8, np.int64)]
        coord = rng.uniform(0, L, (nf, n, 3))
        gen = torch.Generator().manual_seed(0)
    raw = dict(coord=coord, box=np.tile(np.eye(3) * L, (nf, 1, 1)),
               energy=rng.normal(size=(nf,)),
               force=rng.normal(size=(nf, n, 3)), types=types)
    params = init_params(gen, spec, dtype=dtype)
    return spec, params, raw, LRConfig(numb_steps=100, decay_steps=10)


def _dp_step(run: _Run, dtype):
    """One DP step on this rank's frame: (params, loss, step seconds)."""
    from g4s_tpu_torch.ckpt import tree_leaves
    from g4s_tpu_torch.models.deepmd.model import params_to
    from g4s_tpu_torch.models.deepmd.train import (Adam, LossConfig,
                                                   batch_to,
                                                   make_dp_train_step,
                                                   shard_batch)
    spec, params, raw, lr = _dp_case(run, dtype)
    params = params_to(params, device=run.dev, dtype=dtype)
    step_fn = make_dp_train_step(spec, LossConfig(), lr)
    state = Adam(lr.lr_at_count).init(params)
    batch = batch_to(shard_batch(raw, run.rank, run.world),
                     tree_leaves(params)[0])
    run.barrier()
    t0 = time.perf_counter()
    params, state, loss, _ = step_fn(params, state, batch, 0)
    run.sync()
    return params, loss, time.perf_counter() - t0


def stage_dp(run: _Run):
    import torch
    # the reference's f32 step; taken twice, the second timed warm
    _, loss, cold = _dp_step(run, torch.float32)
    _, loss, secs = _dp_step(run, torch.float32)
    run.out["dp"] = {"loss": float(loss), "f32_step_s": secs,
                     "f32_first_step_s": cold}
    if run.args.check:
        from g4s_tpu_torch.ckpt import tree_leaves
        from g4s_tpu_torch.models.deepmd.model import params_to
        from g4s_tpu_torch.models.deepmd.train import (LossConfig, Trainer,
                                                       batch_to)
        with run.uncounted():
            p64, loss64, s64 = _dp_step(run, torch.float64)
        err = 0.0
        if run.rank == 0:
            spec, p0, raw, lr = _dp_case(run, torch.float64)
            p0 = params_to(p0, device=run.dev)
            tr = Trainer(spec, LossConfig(), lr)
            with run.uncounted():
                want, _, lw, _ = tr._update(
                    p0, tr.init(p0), batch_to(raw, tree_leaves(p0)[0]), 0)
            err = max([_rel(a, b) for a, b in zip(tree_leaves(p64),
                                                   tree_leaves(want))]
                      + [abs(float(loss64) - float(lw)) / abs(float(lw))])
        err = run.all_max(err)
        _need(run, err <= F64_TOL, f"DP step f64 against one process: {err}")
        run.out["dp"].update(f64_leaf_rel_err=err, tol=F64_TOL,
                             f64_step_s=s64)
    run.progress(STAGES[0], f"loss={float(loss):.6f}")
    return float(loss)


# ---------------------------------------------------------------------------
# 2/4: distributed regional CitcomS
# ---------------------------------------------------------------------------


def _regional_cfg(run: _Run):
    from g4s_tpu_torch.models.citcoms import CitcomConfig, load_config
    from g4s_tpu_torch.parallel.mesh import device_mesh_shape
    if run.args.full_width:
        cfg = load_config(os.path.join(ROOT, "g4s_tpu_torch", "models",
                                       "citcoms", "cookbook2.cfg"))
        return cfg, device_mesh_shape(run.world, 2)
    px = 2 if run.world % 2 == 0 else run.world
    py = run.world // px
    cfg = CitcomConfig(nodex=2 * px + 1, nodey=2 * py + 1, nodez=4,
                       theta_min=0.7854, theta_max=1.5708, fi_min=0.0,
                       fi_max=0.7854, radius_inner=0.55, radius_outer=1.0,
                       rayleigh=1e4, topvbc=1, topvbxval=10.0, num_mat=4,
                       piterations=3, vlowstep=20)
    return cfg, (px, py)


def stage_regional(run: _Run):
    import torch
    from g4s_tpu_torch.models.citcoms.distributed import DistributedCitcom
    from g4s_tpu_torch.parallel.mesh import RankGrid
    cfg, (px, py) = _regional_cfg(run)
    grid = RankGrid(("bx", "by"), (px, py))
    dist32 = DistributedCitcom(cfg, grid, dtype=torch.float32,
                               device=run.dev)
    s, diag = dist32.step(dist32.init_state())
    run.sync()
    vrms = float(diag.v_norm)
    out = run.out["regional"] = {
        "nodes": f"{cfg.nodex}x{cfg.nodey}x{cfg.nodez}", "px": px, "py": py,
        "vrms": vrms, "uzawa_cg": f"{diag.uzawa_iterations}/"
                                  f"{diag.inner_iterations}"}
    if run.args.check:
        with run.uncounted():
            _check_regional(run, cfg, grid, dist32, s, out)
    run.progress(STAGES[1], f"vrms={vrms:.4f}")
    return vrms


def _check_regional(run, cfg, grid, dist32, s, out):
    """f64 at a fixed cap from the one-device model's initial solve (as
    chip_smoke.py's phase 9 holds its fixed-count step: from a state at
    rest an initial solve multiplies a rounding difference, such as the
    weighted dots' other order of addition, about 2.7-fold per CG
    iteration), then the f32 step timings."""
    import torch
    from g4s_tpu_torch.models.citcoms import CitcomModel
    from g4s_tpu_torch.models.citcoms.distributed import DistributedCitcom
    fixed = dataclasses.replace(cfg, **FIXED)
    m = CitcomModel(fixed, dtype=torch.float64, device=run.dev,
                    matvec="eltk")
    s0, _ = _with_params(m, cfg).initial_solve(m.init_state())
    d64 = DistributedCitcom(fixed, grid, dtype=torch.float64, device=run.dev)
    b0 = d64.block_state(s0.T.cpu(), s0.Tdot.cpu(), s0.V.cpu(), s0.P.cpu(),
                         s0.time.cpu())
    a, da = d64.step(b0)
    b, db = d64.step(b0)
    same = all(torch.equal(a[k], b[k]) for k in a) and (
        da.inner_iterations == db.inner_iterations)
    _need(run, same, "distributed regional f64: two runs differ")
    ga = d64.gather(a)
    err, counts = {}, True
    if run.rank == 0:
        s1, d1 = m.step(s0)
        err = {k: _rel(ga[k], getattr(s1, k)) for k in ("T", "Tdot", "V",
                                                        "P")}
        err["dt"] = abs(float(da.dt) - float(d1.dt)) / float(d1.dt)
        counts = ((da.uzawa_iterations, da.inner_iterations)
                  == (d1.uzawa_iterations, d1.inner_iterations))
    del m
    worst = run.all_max(max(err.values(), default=0.0))
    _need(run, worst <= F64_TOL and counts,
          f"distributed regional f64 against CitcomModel eltk: {err}, "
          f"equal counts {counts}")
    out.update(f64_uzawa_cg=f"{da.uzawa_iterations}/{da.inner_iterations}",
               f64_rel_err_vs_one_device=err, tol=F64_TOL, bitwise_runs=True)
    del d64, a, b, ga

    # f32 to tolerance: a warm-up step, then F32_STEPS timed
    s, t = _timed(run.barrier, dist32.step, s, F32_STEPS)
    t.update(_profile(run, lambda: dist32.step(s), t["s_per_step"]))
    out["f32_distributed"] = t
    if run.rank == 0:
        m = CitcomModel(cfg, dtype=torch.float32, device=run.dev,
                        matvec="eltk")
        sm, _ = m.step(m.init_state())
        sm, tm = _timed(run.sync, m.step, sm, F32_STEPS)
        tm.update(_profile(run, lambda: m.step(sm), tm["s_per_step"]))
        out["f32_one_device_eltk"] = tm
        del m
    run.barrier()


def _with_params(model, cfg):
    """The model on the same mesh with cfg's solver settings."""
    import copy
    from g4s_tpu_torch.models.citcoms import solvers
    m = copy.copy(model)
    m.cfg = cfg
    m.uzawa_params = solvers.UzawaParams(
        cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
        cfg.vlowstep, cfg.check_pressure_convergence)
    return m


# ---------------------------------------------------------------------------
# 3/4: the element-sharded full sphere
# ---------------------------------------------------------------------------


def _full_cfg(run: _Run):
    from g4s_tpu_torch.models.citcoms import CitcomConfig
    if run.args.full_width:
        return CitcomConfig(nodex=17, nodey=17, nodez=9, radius_inner=0.55,
                            radius_outer=1.0, rayleigh=1e5, num_mat=1)
    return CitcomConfig(nodex=5, nodey=5, nodez=4, radius_inner=0.55,
                        radius_outer=1.0, rayleigh=1e4, num_mat=1,
                        piterations=2, vlowstep=15)


def _blob_state(model):
    """tests/test_citcoms.py's blob on the conductive profile."""
    import torch
    s = model.init_state()
    blob = np.exp(-np.sum((model._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                          axis=1) / 0.05)
    T = np.clip(s.T.cpu().double().numpy() + 0.3 * blob, 0, 1)
    return dataclasses.replace(s, T=torch.as_tensor(
        T, dtype=model.dtype, device=model.device))


def stage_full(run: _Run):
    import torch
    from g4s_tpu_torch.models.citcoms import FullSphereModel
    from g4s_tpu_torch.models.citcoms.full_driver import shard_full_sphere
    from g4s_tpu_torch.parallel.mesh import RankGrid
    cfg = _full_cfg(run)
    grid = RankGrid(("e",), (run.world,))
    model = FullSphereModel(cfg, dtype=torch.float32, device=run.dev)
    s = model.init_state()
    V, P, mon = shard_full_sphere(model, grid)(s.T, s.V, s.P)
    run.sync()
    inner = int(mon.inner_iterations)
    out = run.out["full"] = {
        "nodes_per_cap": f"{cfg.nodex}x{cfg.nodey}x{cfg.nodez}",
        "nel": model.mesh.nel, "inner": inner}
    _need(run, bool(torch.isfinite(V).all()), "sharded full sphere: V")
    if run.args.check:
        with run.uncounted():
            _check_full(run, cfg, grid, model, out)
    run.progress(STAGES[2], f"inner={inner}")
    return inner


def _check_full(run, cfg, grid, m32, out):
    import torch
    from g4s_tpu_torch.models.citcoms import (CitcomModel, CoupledRun,
                                              FullSphereModel, load_config)
    from g4s_tpu_torch.models.citcoms.full_driver import (shard_full_sphere,
                                                          shard_full_step)
    fixed = dataclasses.replace(cfg, **FULL_FIXED)
    g64 = FullSphereModel(fixed, dtype=torch.float64, device=run.dev)
    s = _blob_state(g64)
    stokes = shard_full_sphere(g64, grid)
    Va, Pa, ma = stokes(s.T, s.V, s.P)
    Vb, Pb, mb = stokes(s.T, s.V, s.P)
    _need(run, torch.equal(Va, Vb) and torch.equal(Pa, Pb),
          "sharded full-sphere Stokes f64: two runs differ")
    V0, P0, m0 = g64.stokes(s.T, s.V, s.P)
    err = {"V": _rel(Va, V0), "P": _rel(Pa, P0)}
    worst = run.all_max(max(err.values()))
    _need(run, worst <= F64_TOL and ma.inner_iterations == m0.inner_iterations,
          f"sharded full-sphere Stokes f64 against FullSphereModel: {err}")
    out.update(f64_uzawa_cg=f"{ma.outer_iterations}/{ma.inner_iterations}",
               f64_rel_err_vs_one_device=err, tol=F64_TOL, bitwise_runs=True)

    # the coupled step with the sharded coarse solve (the fine Cookbook2
    # model whole on every rank), at the fixed cap: the fine BCs from the
    # sharded coarse solution against the unsharded one's
    if run.args.full_width:
        fine_cfg = load_config(os.path.join(
            ROOT, "g4s_tpu_torch", "models", "citcoms", "cookbook2.cfg"))
    else:
        from g4s_tpu_torch.models.citcoms import CitcomConfig
        fine_cfg = CitcomConfig(nodex=5, nodey=5, nodez=4, theta_min=0.7854,
                                theta_max=1.5708, fi_min=0.0, fi_max=0.7854,
                                radius_inner=0.55, radius_outer=1.0,
                                rayleigh=1e4, num_mat=4)
    fine = CitcomModel(dataclasses.replace(fine_cfg, **FIXED),
                       dtype=torch.float64, device=run.dev)
    cr = CoupledRun(g64, fine, two_way=True, device=run.dev,
                    coarse_stokes=stokes)
    t_sh, v_sh = cr.exchange(s.T, Va)
    t_0, v_0 = cr.exchange(s.T, V0)
    cerr = {"tbc": _rel(t_sh, t_0), "vbc": _rel(v_sh, v_0)}
    sc, sf, (dc, df) = cr.step(s, fine.init_state())
    fin = bool(torch.isfinite(sf.T).all() and torch.isfinite(sc.V).all())
    worst = run.all_max(max(cerr.values()))
    _need(run, worst <= F64_TOL and fin,
          f"coupled step, sharded coarse solve: BCs {cerr}, finite {fin}")
    out["coupled"] = {"bc_rel_err_vs_unsharded": cerr, "tol": F64_TOL,
                      "coarse_uzawa_cg": f"{dc.uzawa_iterations}/"
                                         f"{dc.inner_iterations}",
                      "fine_uzawa_cg": f"{df.uzawa_iterations}/"
                                       f"{df.inner_iterations}"}
    del g64, fine, cr, stokes

    # f32 shard_full_step beside FullSphereModel.step, from the initial
    # solve of the blob state
    s32, _ = m32.initial_solve(_blob_state(m32))
    step = shard_full_step(m32, grid)
    s1, _ = step(s32)
    _, t = _timed(run.barrier, step, s1, FULL_F32_STEPS)
    t.update(_profile(run, lambda: step(s1), t["s_per_step"]))
    out["f32_sharded_step"] = t
    if run.rank == 0:
        s2, _ = m32.step(s32)
        _, tm = _timed(run.sync, m32.step, s2, FULL_F32_STEPS)
        tm.update(_profile(run, lambda: m32.step(s2), tm["s_per_step"]))
        out["f32_one_device_step"] = tm
    run.barrier()


# ---------------------------------------------------------------------------
# 4/4: the rank-striped NTC sweep
# ---------------------------------------------------------------------------


def _ntc_settings(run: _Run) -> dict:
    a = run.args
    if a.full_width:
        # two cases per rank between 1500 and 1450 K, whose OH peaks
        # (7.8 and 12.7 us on the dodecane-size synthetic mechanism) lie
        # inside t_end; a case takes 300-800 BDF steps at any rtol from
        # 1e-3 to 1e-6, the fewest seconds near rtol 1e-4, and about 430
        # for each phase at these temperatures (1350 K takes more), half
        # of them past the peak
        temps = list(np.linspace(1500.0, 1450.0, 2 * run.world))
        kw = dict(P0=40 * 101325.0, t_end=5e-5, rtol=1e-4, atol=1e-10,
                  record_size=5000)
        phases = ("nDodecane_RK", "nDodecane_IG", "c12h26")
    else:
        temps = [1500.0 - 50.0 * i for i in range(run.world)]
        kw = dict(P0=5 * 101325.0, t_end=2e-5, rtol=1e-6, atol=1e-12,
                  record_size=200)
        phases = ("ohmech", "ohmech", "h2")
    if a.ntc_temps:
        temps = [float(t) for t in a.ntc_temps.split(",")]
    if a.ntc_t_end:
        kw["t_end"] = a.ntc_t_end
    rk, ig, fuel = (a.rk_phase or phases[0], a.ig_phase or phases[1],
                    a.fuel or phases[2])
    return dict(temps=temps, kw=kw, rk=rk, ig=ig, fuel=fuel)


def stage_ntc(run: _Run):
    from g4s_tpu_torch.models.cantera.shock_tube import (ShockTubeBenchmark,
                                                         ignition_delay,
                                                         stoich_mixture)
    st = _ntc_settings(run)
    stb = ShockTubeBenchmark(run.args.mech, rk_phase=st["rk"],
                             ig_phase=st["ig"], fuel=st["fuel"],
                             device=run.dev)
    kw = st["kw"]
    t0 = time.perf_counter()
    sweep = stb.run_ntc_sweep_sharded(None, st["temps"], kw["P0"],
                                      t_end=kw["t_end"], rtol=kw["rtol"],
                                      atol=kw["atol"],
                                      record_size=kw["record_size"])
    sweep_s = time.perf_counter() - t0
    tau0 = sweep["tau_RG"][0]
    if not tau0 > 0.0:
        raise AssertionError(
            f"NTC stage returned tau0={tau0!r}: the OH peak was never "
            "resolved")
    out = run.out["ntc"] = {"T": sweep["T"], "tau_RG": sweep["tau_RG"],
                            "tau_IG": sweep["tau_IG"], "sweep_s": sweep_s,
                            "cases_per_rank": -(-len(st["temps"])
                                                // run.world),
                            "t_end": kw["t_end"], "rtol": kw["rtol"]}
    if run.args.check:
        err = 0.0
        with run.uncounted():
            for i in range(run.rank, len(st["temps"]), run.world):
                for name, r, mech in (("tau_RG", stb.r_rk, stb.mech_rk),
                                      ("tau_IG", stb.r_ig, stb.mech_ig)):
                    tau, _ = ignition_delay(
                        r, st["temps"][i], kw["P0"],
                        stoich_mixture(mech, st["fuel"]), t_end=kw["t_end"],
                        rtol=kw["rtol"], atol=kw["atol"],
                        record_size=kw["record_size"])
                    err = max(err, abs(sweep[name][i] - tau) / abs(tau))
        err = run.all_max(err)
        _need(run, err <= NTC_TOL,
              f"NTC sweep against ignition_delay in the rank: {err}")
        out.update(tau_rel_err_vs_rank_rerun=err, tol=NTC_TOL)
    run.progress(STAGES[3], f"tau0={tau0:.3e}")
    return tau0


# ---------------------------------------------------------------------------
# --check: the row-sharded SpMV and SpGEMM
# ---------------------------------------------------------------------------


def _erdos_renyi(n: int, avg_deg: int, seed: int):
    """n x n with n * avg_deg uniform COO pairs (duplicates summed), f32
    values in [0, 1) (chip_smoke.py's ER family)."""
    import scipy.sparse as sp
    r = np.random.RandomState(seed)
    nnz = n * avg_deg
    return sp.coo_matrix(
        (r.rand(nnz).astype(np.float32),
         (r.randint(0, n, nnz), r.randint(0, n, nnz))),
        shape=(n, n)).tocsr()


def check_sparse(run: _Run):
    import torch
    from g4s_tpu_torch.drivers.static_spmv import stencil
    from g4s_tpu_torch.engine import build_graph, mxm, mxv
    from g4s_tpu_torch.ops.dist_spgemm import dist_spgemm
    from g4s_tpu_torch.ops.dist_spmv import (all_gather_rows, dist_spmv,
                                             shard_rows_ell)
    from g4s_tpu_torch.parallel.mesh import RankGrid
    from g4s_tpu_torch.sparse import CSR
    t0 = time.perf_counter()
    grid = RankGrid(("r",), (run.world,))
    nx, n_er = (101, 1 << 15) if run.args.full_width else (8, 1 << 10)
    a = stencil(nx, 0)
    x_np = np.random.default_rng(1).standard_normal(a.shape[1]).astype(
        np.float32)
    x = torch.from_numpy(x_np).to(run.dev)
    block, rows_per, shape = shard_rows_ell(CSR.from_scipy(a), run.world,
                                            run.rank, device=run.dev)
    y = all_gather_rows(dist_spmv(block, x), grid, n_rows=shape[0])
    want = a.astype(np.float64) @ x_np.astype(np.float64)
    err_scipy = float(np.abs(y.cpu().double().numpy() - want).max()
                      / np.abs(want).max())
    err_mxv = 0.0
    if run.rank == 0:
        g = build_graph(CSR.from_scipy(a), device=run.dev)
        err_mxv = _rel(y, mxv(g, x))
        del g
    worst = run.all_max(max(err_scipy, err_mxv))
    _need(run, worst <= SPARSE_TOL,
          f"dist_spmv: against scipy {err_scipy}, against mxv {err_mxv}")
    out = run.out["sparse"] = {
        "spmv_n": int(shape[0]), "spmv_rows_per_rank": rows_per,
        "spmv_rel_err_vs_scipy_f64": err_scipy,
        "spmv_rel_err_vs_mxv": err_mxv, "tol": SPARSE_TOL}
    del block, x, y

    b = _erdos_renyi(n_er, 16, 0)
    c = dist_spgemm(CSR.from_scipy(b), CSR.from_scipy(b), grid,
                    device=run.dev)
    ref = (b.astype(np.float64) @ b.astype(np.float64)).tocsr()
    ref.sort_indices()
    vals_err = float(np.abs(c.data.cpu().double().numpy() - ref.data).max()
                     / np.abs(ref.data).max())
    same = (np.array_equal(c.indptr.cpu().numpy(), ref.indptr)
            and np.array_equal(c.indices.cpu().numpy(), ref.indices))
    if run.rank == 0:
        cm = mxm(CSR.from_scipy(b), CSR.from_scipy(b), device=run.dev)
        same = same and (torch.equal(cm.indptr.cpu().long(),
                                     c.indptr.cpu().long())
                         and torch.equal(cm.indices.cpu().long(),
                                         c.indices.cpu().long()))
    worst = run.all_max(vals_err)
    _need(run, same and worst <= SPARSE_TOL,
          f"dist_spgemm: structure equal {same}, values {vals_err}")
    out.update(spgemm_n=n_er, spgemm_nnz=int(ref.nnz),
               spgemm_structure_equals_mxm_and_scipy=True,
               spgemm_rel_err_vs_scipy_f64=vals_err,
               seconds=time.perf_counter() - t0)
    run.say(f"multichip check dist-sparse done "
            f"[{time.monotonic() - run.t0:.1f}s] "
            f"spmv_n={shape[0]} spgemm_nnz={ref.nnz}")


# ---------------------------------------------------------------------------


def _rank_main(args) -> int:
    import torch
    from g4s_tpu_torch.ops import bwell_spmv, route, segment, wsell_spmv
    from g4s_tpu_torch.parallel.mesh import init_from_env
    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = init_from_env(args.device)
    mods = {"sorted_segment_sum": segment, "permute_gather": route,
            "wsell_spmv": wsell_spmv, "bwell_spmv": bwell_spmv}
    run = _Run(args, dev, mods)
    run.say(f"multichip: world={run.world} "
            f"backend={run.out['backend']} device={dev} "
            f"full_width={args.full_width} check={args.check}")
    for mod in mods.values():
        mod.LAUNCHES = 0
    stages = (("dp_loss", stage_dp, "{:.6f}"),
              ("citcoms_vrms", stage_regional, "{:.4f}"),
              ("fullsphere_inner", stage_full, "{}"),
              ("ntc_tau0", stage_ntc, "{:.3e}"))
    fields = [f"{name}={fmt.format(fn(run))}" for name, fn, fmt in stages]
    run.sync()
    run.out["launches"] = {k: m.LAUNCHES for k, m in mods.items()}
    if args.check:
        with run.uncounted():
            check_sparse(run)
    run.out["seconds"] = time.monotonic() - run.t0
    if run.rank == 0 and args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(run.out, f, default=float)
    run.say(f"multichip({run.world}): {' '.join(fields)} OK")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if args.as_rank:
        return _rank_main(args)
    if args.world < 1:
        raise SystemExit("--world must be at least 1")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' asked for, but torch sees no CUDA card; pass "
                "--device cpu to run the ranks on the CPU with gloo")
        if args.world > torch.cuda.device_count():
            raise RuntimeError(
                f"--world {args.world} on {torch.cuda.device_count()} "
                "visible CUDA cards: each rank needs a card of its own")
    from g4s_tpu_torch.parallel.launch import RankFailure, run_ranks
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    rest = list(sys.argv[1:] if argv is None else argv)
    try:
        run_ranks(args.world, lambda r: [
            sys.executable, "-m", "g4s_tpu_torch.drivers.multichip",
            *rest, "--as-rank"], env=env)
    except RankFailure as e:
        print(f"multichip: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the port's graph-engine paths once on one CUDA card.

Run from the root of a checkout: `python3 chip_smoke.py`. It

  0. requires a CUDA card and prints torch, CUDA and nvcc versions and the
     card's name and power limit;
  1. builds the hand-written kernels from g4s_tpu_torch/csrc/ (one nvcc
     per source, all started together);
  2. holds each kernel against its plain PyTorch version on the card:
     permute_gather bit-exact (m = 2^20, f32 and f64, and its fused
     cases: lengths 2^20 + 0..7, sigma reaching past len(z), n_out >
     len(sigma), sigma and z as offset views), the segment sum on 2^20
     heavily cancelling values in f64 and f32 (two calls bitwise equal and
     equal to the host CPU's in-order sum), wsell_spmv
     within a relative 1e-5 on the multi-window, rectangular, W=2 and W=16
     packs;
  3. drives the SpMV main path, build_graph + mxv, on the randomly
     renumbered 3D 7-point stencil at nx = 101 (n = 1,030,301): it must
     dispatch to "wsell" with an RCM permutation, launch both kernels, run
     three device kernels per mxv (two permutes and WSELL, counted by
     torch.profiler), and match scipy in f64 to a relative 1e-5 (f32 sums
     of 7 terms in another order); both kernels are compared and timed at
     the shapes this path gives them, beside their plain versions and the
     library call (cuSPARSE CSR SpMV, z[sigma]), and mxv's host wall time
     per call is timed beside it;
  4. the shuffled 16-diagonal band at n = 2^20 -> "dia" with a permutation;
  5. a uniform random 2^17 x 8-per-row matrix -> "stream", 3 permutes;
     at each of the six permutations of phases 3-5 (stencil perm and
     iperm, the band's perm, the stream's xplan, route2 and rowplan) the
     permute kernel is held bit-exact against its plain version in f32 and
     f64 and timed warm and with L2 flushed (a 128 MiB fill before each
     call), beside its bound, z[sigma] warm and cold, itself over the
     identity sigma (what the random sector reads cost), and two library
     passes over the same lengths that read and write only whole lines: a
     copy of n_out elements and an add that moves the bound's bytes;
  6. the BWELL path, spmv_bwell: the bwell_spmv kernel against its plain
     version on four small packs (modes pack and row, W = 16 and 2), then at
     n = 2^20 on the unshuffled band of phase 4 (mode pack, W = 16) and on
     a clustered matrix that mode pack rejects (mode row), each against
     scipy f64 to a relative 1e-5, timed beside its plain version and
     cuSPARSE;
  7. the SpGEMM path, mxm, at bench.py's sizes (Erdos-Renyi n = 2^15 and
     2^17 of average degree 16, the RMAT-like 2^15 x 2^19): it must take
     the ESC engine, give C's indptr/indices equal to scipy's and values
     within a relative 1e-5 of scipy f64; its host plan runs in the
     native plan core (g4s_tpu_torch/runtime/native/host_kernels.cc,
     built by g++ at the phase's start: build seconds printed) and is
     timed again in numpy (use_native=False), the two plans array for
     array equal, beside esc_plan_device; plan and numeric times beside
     the wall time of torch.sparse.mm (cuSPARSE SpGEMM, which waits on the
     device itself; a yardstick only); the same for the corpus's
     real-structure member, the CitcomS Cookbook2 velocity stiffness K
     (29,403 rows, assembled by the port's model in f32), whose K x also
     runs through build_graph + mxv against scipy f64 beside cuSPARSE's
     SpMV; then reg_mm on two small pairs, every strategy PASS;
  8. the mv suite: the four dense BLAS2 products at dim 4096;
  9. CitcomS regional Cookbook2 (g4s_tpu_torch/models/citcoms/
     cookbook2.cfg, 33x33x9 nodes, 8192 elements): in f64 the initial
     Stokes solve and 10 steps, each step's vrms, nu_top, nu_bot, dt and
     T_mean within a relative 5e-5 of
     benchmarks/cookbook2_blessed_f64.json (how far rounding alone moves
     that trajectory; whether it stayed within 1e-6 is printed), its
     Uzawa/CG counts printed, run twice: every sum on the card has a fixed
     order (the segment-sum kernel), so the two runs' diagnostics and
     counts must be bitwise equal at every step, as must two f32 runs
     below; then one f64 step from the card's state
     after its initial solve with every solver loop run to a fixed cap,
     on the card against the host CPU, within 1e-10; in f32 the initial
     solve, one warm-up step and 5 timed steps, vrms, nu_top and dt within
     1e-4 of the blessed values, with wall s/step, inner CG, host syncs,
     device kernels and device-busy ms (torch.profiler) per step, and the
     segment-sum kernel's launches and share of that busy time; the
     stencil matvec's device time beside its bound and the
     element-by-element form's, the two forms within 1e-5 (f32) and 1e-12
     (f64) of each other, and the segment-sum kernel at every shape the
     step gives it, in f64 and f32 through the model's int32 plans (the
     stencil build, an assembly scatter, the buoyancy layer sums): each
     bitwise repeatable and equal to the host CPU's in-order sum, timed
     beside its bytes bound, its plain version and one index_add_. Of the
     hand kernels only the segment sum lies on this path (the SpMV
     kernels' launch counts are printed, 0).
 10. DeePMD se_e2_a water at the flagship width (WATER_SPEC: rcut 6,
     sel 46/92, embedding 25-50-100, axis 16, fitting 240-240-240;
     __graft_entry__.py's 192-atom frame, random weights from a seeded CPU
     generator): in f64, E/F/W on the card against the host CPU within
     1e-10, DeepPot through a frozen file and a batch of 8 frames against
     8 single calls likewise, 20 NVT steps (velocities at 330 K from seed
     23456789) within 1e-9 on x and v, and the compressed model (f64
     tables at stride 0.005 over this frame's normalised s(r)) within
     1e-10 on E and F, its error against the exact model printed; in f32,
     device ms, host wall ms, device kernels, device-busy ms and idle
     share per single-frame eval, per forward pass alone (E, no grad), per
     8-frame batch, per compressed eval and per DeepPot.eval from host
     arrays, MD ms/step over 100 steps, and the eval's dense FLOPs and
     their bound at the f32 rate. No Pallas kernel lies on this path in
     the reference, so no hand kernel does here (launch counts printed,
     0).
 11. the per-matrix WSELL-K kernels (the reference's two probes,
     benchmarks/static_spmv_probe*.py) on phase 3's stencil pack: the
     chain form (one kernel per tile) and the one-kernel form, each
     generated for this pack and built by nvcc (started in the background
     right after phase 3, beside phases 4-10; wall time printed), against
     its plain version and scipy f64 within a relative 1e-5 and against the
     wsell_spmv kernel (max abs error printed), timed warm and cold beside
     WSELL's bound, the plain version and cuSPARSE's CSR SpMV; for the
     chain, whose tiles are programmatic dependent launches, how far its
     63 tile kernels overlap in torch.profiler's trace (the sum of their
     durations over the span from the first start to the last end).
 12. DeePMD training at the flagship width (WATER_SPEC; phase 10's frame
     and 31 perturbed copies, labels from a teacher model with other
     random weights): three f64 Trainer steps (the water example's loss
     and LR; forces through a double backward; optax's Adam by hand), the
     loss per step and every parameter leaf on the card within 1e-10 of
     the host CPU; f32 ms/step, device kernels, device-busy ms and idle
     share per step at 1 frame and 8, beside the dense FLOPs and their
     bound; then `dp train` through main() for 100 steps on the frames
     written as a system (lcurve written, last rmse_f below the first),
     `--restart` from its checkpoint for 5 steps, `dp freeze` and DeepPot
     on the card within 1e-5 of the trained parameters' f32 energy. No
     hand kernel lies on this path (launch counts printed, 0).
 13. Cantera's NonIdealShockTube at the n-dodecane mechanism's size: a
     synthetic mechanism with its counts (100 species, 553 reactions, 15
     falloff, 19 three-body; _synthetic_mechanism_yaml, seed
     CANTERA_SEED), since nDodecane_Reitz.yaml is not in the repository,
     through ShockTubeBenchmark.run_single at 1000 K and 40 atm, rtol
     1e-8, atol 1e-14, as the CLI runs it: per phase (Redlich-Kwong and
     ideal gas) tau, BDF steps, RHS and Jacobian evaluations, wall s, host
     reads, device kernels, busy ms and idle share per step; ms and
     kernels per RHS, jacfwd Jacobian and LU factor + solve at n = 101;
     in f64 the RHS and Jacobian at y0 and tau/2 and the RK initial state
     on the card against the host CPU, and the host CPU's run_single of
     the same case, run in a process of its own beside the card's runs
     (tau within 1e-4); the card's run must hold each element and U, rise by
     500 K and give RK and IG apart; the RK advance to tau/2 run a
     second time on the card, right after the first: the state within
     1e-10, and whether the two runs are equal bit for bit, printed (past
     ignition the step count is set by rounding: a 1e-15 change of T0
     moves the reference's own count at 45 species from 1,400 to 1,725
     steps, tests/cantera_step_spread.py; and the card's runs part by a
     bit in a step size after some earlier host work in the process,
     ROADMAP.md section 3). No Pallas kernel lies on this path
     in the reference (its stoichiometric products are dense XLA dots,
     its LU is XLA's), so no hand kernel does here (launch counts
     printed, 0).
 14. the rest of regional CitcomS at Cookbook2's 33x33x9 nodes: in f64,
     Solver=multigrid (levels 3: 33x33x9, 17x17x5, 9x9x3; 8-color
     Gauss-Seidel smoothing) through its initial solve and 1 step, on the
     card against the host CPU within 1e-10 with equal Uzawa and V-cycle
     counts and two card runs bitwise equal, its initial vrms within 1e-3
     of phase 9's CG; in f32 3 timed steps after a warm-up, s/step,
     V-cycles, host syncs, device kernels, busy ms and idle share per step
     beside phase 9's CG numbers; the thermochemical step (10 tracers per
     element, 81,920, seed 0, buoyancy ratio 1): 3 f64 steps on the card
     against the host CPU, positions within 1e-10 and element compositions
     equal, then f32 ms/step; one f64 step each of phase changes, TALA
     with latent heat, anisotropic viscosity, lith_age from an age file
     and velocity + temperature bc files (written by the script), with
     every solver loop at a fixed cap, on the card against the host CPU
     within 1e-10, as phase 9's fixed-count step; the CLI on the card
     (storage_spacing 2, checkpoint_frequency 2, 4 steps in a temporary
     datadir: its files listed), `--restart` from the step-2 checkpoint
     reaching step 4 bitwise, and SIGTERM to a running CLI writing a
     checkpoint at the step it stops. After the phase's launches are
     read, the segment-sum kernel at the shapes the phase gives it that
     phase 9 does not (multigrid's restriction at both levels, the
     tracers' element-to-node map; f64 and f32), held and timed as in
     phase 9. The phase's launches are a kernels-line entry of their own,
     timed at the finest restriction in f64.
 15. the CitcomS full sphere (FullSphereModel, 12 caps of 17x17x9 nodes:
     24,576 elements, 27,666 nodes; Ra 1e5, radius_inner 0.55, free slip,
     a temperature blob): in f64 the initial solve and a step at a fixed
     cap of 1 Uzawa x 20 CG, on the card against the host CPU within
     1e-10 with equal counts, two card runs bitwise equal, the step's V
     free of net rotation and no host wait in the step but the counted
     solver reads; a step at 3 x 60 against the host CPU beside what a
     1e-15 change of T moves the CPU's own; in f32 the initial solve to
     tolerance, a warm-up and 5 timed steps (s/step, inner CG, host
     syncs, device kernels, busy ms, idle share); the thermochemical step
     (10 tracers per element, 245,760, seed 0): f64 card against host
     CPU (positions within 1e-13, compositions and the nodal C equal,
     fields 1e-10), then 2 timed f32 steps; the coupled Exchanger step
     with Cookbook2 inside the sphere, one-way and two-way, f64 card
     against host CPU within 1e-10, the fine boundary T equal to the
     coarse interpolation, one f32 two-way step timed; the segment-sum
     kernel at the full sphere's assembly scatter and layer sums, f64 and
     f32, held and timed as in phase 9, its launches an entry of their
     own.
 16. the rest of DeePMD on phase 10's frame, random weights from seeded
     CPU generators: se_atten, se_a_ebd, hybrid, loc_frame and se_a_mask
     at WATER_SPEC's widths and se_t at DeePMD-kit's examples/water/se_e3
     widths (rcut 5.8, sel 40/80, embedding 2-4-8), each in f64 on the
     card against the host CPU within 1e-10 (E/F/W, DeepPot through a
     frozen file, a batch of 8 against 8 single calls; se_a_mask also as
     a finite cluster with its last 16 atoms virtual), then its f32 eval
     timed as phase 10's; one f64 Trainer step of se_atten, card against
     host CPU within 1e-10 on the loss and every leaf, and its f32 step
     timed; env_mat_celllist against env_mat at the frame tiled 2x2x2
     (1,536 atoms: R within 1e-12, neighbor sets equal, and against the
     host CPU), refusing the 192-atom box (2 cells per side), and both
     timed in f32 with their peak memory at 4x4x4 (12,288 atoms);
     atomic_descriptor_ef within 1e-10; DPLR (examples/water/dplr's
     charges -8/0 on the centroids, 6/1 on the atoms, ewald_h 1.0,
     beta 0.4: a 14^3 grid) within 1e-10, ewald_recp against a host loop
     over the k vectors; 10 i-PI exchanges with an in-process server over
     a socket pair and ipi.main() over an abstract unix socket, decoded
     against DeepPot.eval within 1e-10; calc_ase_free likewise; NVNMD at
     its default widths (rcut 6, sel 46/92): CNN E/F within 1e-10, QNN
     and mapped E/F within 4 quanta (how many outputs differ printed),
     build_map's tables within 1e-10, wrap_model -> load_wrapped bitwise,
     and train_two_stage's 3 + 3 losses within 1e-8. No Pallas kernel
     lies on this path in the reference, so no hand kernel does here
     (launch counts printed, 0).
 17. the multi-rank dry run, g4s_tpu_torch/drivers/multichip.py
     --full-width --check, as a process group of its own on min(cards,
     4) ranks with NCCL, one card each, started with phase 13 and running
     beside it (both host-bound; the script waits for it before phase 14,
     and prints its lines then) (world 1 on a one-card machine: the halo
     exchanges then have no neighbour and every all-reduce spans one
     rank; the CPU tests hold the multi-rank exchanges): the DeePMD
     data-parallel step (WATER_SPEC, one 192-atom frame per rank; f64
     leaves within 1e-10 of one process's Trainer step on the card, f32
     timed), the distributed regional step (Cookbook2 on a px x py brick
     grid; f64 at 3 Uzawa x 60 CG from the one-device initial solve
     within 1e-10 of CitcomModel's element-by-element step with equal
     counts, two runs bitwise equal; f32 s/step, inner CG, host syncs,
     kernels, busy ms, idle share and NCCL kernels beside the one-device
     element-by-element step's), the element-sharded full sphere (12
     caps of 17x17x9; f64 Stokes at 1 x 20 within 1e-10 of
     FullSphereModel.stokes, two runs bitwise equal; the coupled step
     with the sharded coarse solve, its fine BCs within 1e-10 of the
     unsharded ones; f32 shard_full_step timed beside
     FullSphereModel.step), the NTC sweep striped over the ranks (the
     dodecane-size synthetic mechanism, two temperatures per rank, each
     tau within 1e-10 of ignition_delay rerun in the rank's process),
     dist_spmv on phase 3's stencil within 1e-5 of scipy f64 and of mxv,
     and dist_spgemm on ER 2^15 with mxm's and scipy's structure and
     values within 1e-5; any failing rank fails the phase. Its
     segment-sum launches (the four stages only) are an entry of their
     own, timed after phase 16 at the distributed regional step's block
     scatter.
 18. Cantera's 1-D flames, equilibrium, transport, surface kinetics and
     SolutionArray at phase 13's mechanism (the synthetic 100-species
     n-dodecane one, now with transport blocks; its ideal-gas phase),
     f64, started right after phase 13 in the main process while phase
     17's multi-rank run goes on; the host CPU's side of each check runs in
     spawned one-thread processes beside the card's work: (1) transport
     at full width on the burner's initial profile (mixture-averaged,
     L-matrix conductivity, thermal and multicomponent diffusion;
     Stefan-Maxwell on a seeded state with every species present, as
     absent species make its system singular), the high-pressure model
     (Redlich-Kwong phase) and DustyGas, within FLAME_TOL of the host
     CPU; (2) equilibrate_hp of the stoichiometric 400 K inlet (elements
     kept within FLAME_EQ_TOL, T and x within FLAME_EQ_TOL of the host
     CPU's), equilibrium_temperature_uv of phase 13's final ideal-gas
     state beside its T, SolutionArray over the marched flame's points
     against the host CPU's; (3) BurnerFlame at FLAME_BURNER, "mix",
     marched by solve(**FLAME_MARCH) (the reference test's H2 flame
     settings, its march time cut; see FLAME_MARCH): RHS and the
     coloured Jacobian at the initial profile and the marched state
     within FLAME_TOL of the host CPU's, the downstream
     T at most the equilibrate_hp T + FLAME_T_MARGIN, the residual
     reduction beside the reference test's 0.05, steps, n_fev, n_jev, s
     per step, kernels, busy ms and idle share per step of a profiled
     window, peak memory, the Jacobian's ms, and two card runs of the
     first FLAME_REPEAT_STEPS steps bitwise equal; (4) the free flame's
     eigenvalue, solve_flame_speed on FreeFlame(FLAME_FREE_POINTS) with
     the reference test's iters 3 and FLAME_FREE_MARCH (mdot, Su,
     position error), then damped_newton on anchored_residual for
     FLAME_NEWTON_ITERS iterations with its host solve's share of the
     time; (5) the "multi" + Soret burner, the counterflow flame and the
     impinging jet: RHS and Jacobian within FLAME_TOL of the host CPU's;
     (6) a seeded synthetic Pt interface (_synthetic_interface_yaml, the
     size of ptcombust.yaml) on the gas: advance_coverages within
     FLAME_COVERAGE_TOL of the host CPU's, coverages summing to 1 within
     1e-12. No Pallas kernel lies on this path in the reference, so no
     hand kernel does here (launch counts printed, 0).
 19. Cantera's phase models, f64, right after phase 18 while phase 17's
     multi-rank run goes on; the host CPU's side of every block runs in
     spawned one-thread processes started first (the steam table in
     PHASE19_STEAM_CHUNKS pieces, started with phase 13, when the host
     has cores to spare), and each block is held to it within
     PHASE19_TOL: (1) IAPWS-95: p(500 K, 838.025 kg/m^3) = 10.0003858 MPa,
     rho(298.15 K, 1 atm) = 997.0476 kg/m^3, PDSS_Water's mu0(423.15 K) =
     -317.175792 kJ/gmol and alpha < 0 at 276.15 K < alpha at 300 K on the
     card, then the steam table, torch.func.vmap of density (60 Newton
     steps), h, s, p and alpha over PHASE19_STEAM = 256 x 256 liquid
     states (T 275-550 K, P 10-100 MPa): ms per call and per state beside
     the f64 bound of its element operations (counted by a dispatch mode
     on one state); (2) HMW at the width of the Harvie-Moller-Weare
     seawater model (_synthetic_brine_yaml: 11 solutes and water, seeded
     Pitzer parameters, E-theta, psi, variable A_Debye; IAPWS, HKFT,
     Mu0Poly and Shomate standard states): activity_all and
     partial_molar_props at PHASE19_HMW_STATES seeded (T, molality)
     states; (3) the five Debye-Huckel forms on a six-species NaCl phase
     at the reference tests' two molality sets; (4) one phase of each
     condensed family (_phase_models_yaml): props, density and chemical
     potentials; (5) N2 and CO2: anchoring offsets, the saturation state
     (the equal-Gibbs residual within PHASE19_SAT_TOL), a liquid, a gas
     and a two-phase state; (6) an oxygen-plasma-shaped phase with
     isotropic distributions of shape factor 1 and 2 and a discretized
     one on 1,000 levels: Te, the species thermo with the electron at Te,
     the two-temperature rate; (7) VCS on the reference's NaCl_equil
     layout (the brine's NaCl phase, an N2/O2/H2O gas, NaCl(S); 2 mol
     H2O(L), 4 mol N2, 5 mol NaCl(S) at 298.15 K and 1 atm): phase moles
     and mole fractions, the outer-sweep count equal to the host CPU's,
     the elements within PHASE19_ELEMENT_TOL. Each block prints the wall
     ms of one call of its main function and that call's device kernels,
     busy ms and idle share. No Pallas kernel lies on this path in the
     reference, so no hand kernel does here (launch counts printed, 0).
 20. the integrator tail, f64: (1) ShockTubeBenchmark.run_ntc_sweep_batched
     (one lockstep batched BDF per phase, every case a lane) at phase 13's
     mechanism, pressure and tolerances over NTC_BATCH_TEMPS, t_end cut to
     NTC_BATCH_T_END (just past the latest lane's OH peak), run in a
     spawned process of its own from the start of phase 13 beside phases
     13, 18 and 19: each lane's tau within NTC_BATCH_TOL of its in-turn
     ignition_delay (1000 K: phase 13's run on the card; the other lanes:
     the host CPU, in spawned one-thread processes beside phases 14-16),
     with the batch's wall s, lockstep iterations and host reads, a
     window's kernels, busy ms, wall and idle share per iteration, an
     in-turn window's ms per step in the same process and the estimate of
     the in-turn over the batched wall they give, beside phase 13's
     in-turn walls and phase 17's sweep; (2)
     bdf_solve(bandwidth=(3, 3)) on tests/test_banded.py's Brusselator at
     BRUSS_POINTS points (n = 4,000) to BRUSS_T_END, the card against the
     host CPU within PHASE20_TOL and against the dense path on the card
     within BRUSS_DENSE_TOL, s per step, the device activities (the
     profiler's count), busy ms and wall ms of a band factor and a band
     solve, the dense LU's ms; (3) dae_solve and
     bdf_solve_with_sensitivities on Robertson, the card against the host
     CPU within PHASE20_TOL; (4) a C program built with gcc against
     g4s_tpu_torch/runtime/native/capi.c evaluates phase 10's water model,
     frozen in f64, at its 192-atom frame on the card (G4S_TORCH_DEVICE),
     E and F within PHASE20_TOL of DeepPot.eval. No Pallas kernel lies on
     this path in the reference (its banded, BDF, DAE and sensitivity
     code is jnp and lax), so no hand kernel does here.
Device times are medians per call between back-to-back calls queued
behind a device sleep (g4s_tpu_torch.obs.timings.device_ms); "cold" times
flush L2 before each call, outside its event pair. Each phase
prints one line; any failure raises. The line before the last is the
card's name and power limit, the one before it a JSON object describing
each kernel; the last is the result line. Fails (exit code 1, no result
line) without CUDA or outside the repo.

`python3 chip_smoke.py --batch-overlap` runs only _batch_overlap: phase
13's RK steps alone and beside phase 20's batch, on one host.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import multiprocessing
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

REL_TOL = 1e-5
# the card's published device-memory rate and float32/float64 rates outside
# the tensor cores, set by main() from g4s_tpu_torch.obs.profile.PEAKS
HBM_BYTES_PER_S = F32_OPS_PER_S = F64_OPS_PER_S = None
# Cookbook2 against the blessed f64 trajectory, which the reference computed
# in f64 on the CPU. Rounding alone moves that trajectory: the initial
# solve's inner CG amplifies a difference of one rounding about 2.6-fold per
# iteration, and where a later step's Uzawa test then falls the other way,
# vrms moves by about 2e-5. The reference itself, started from a temperature
# changed by 1e-15, leaves the file by more than 1e-6 in 2 of 10 runs and by
# up to 1.9e-5 (tests/citcoms_rounding_spread.py). So the f64 run is held to
# COOKBOOK2_F64_TOL, prints whether it stayed within 1e-6, and f64
# arithmetic on the card is checked apart from the file: one step with every
# solver loop run to a fixed cap, on the card against the host CPU from one
# state, within COOKBOOK2_FIXED_TOL (a 1e-15 change of the state moves that
# step by about 1e-13, f32 arithmetic by about 6e-6).
COOKBOOK2_F64_TOL = 5e-5
COOKBOOK2_F64_GOAL = 1e-6
COOKBOOK2_F32_TOL = 1e-4
COOKBOOK2_FIXED_TOL = 1e-10
# tiles of the stencil pack that phase 11's one-kernel form covers (None:
# all of them)
STATIC_ONE_TILES = None
# DeePMD water (phase 10): f64 E/F/W, compressed E/F and the frozen and
# batched DeepPot paths, card against host CPU, relative to each one's
# largest magnitude; 20 NVT steps compound the force differences, so x and
# v are held a decade looser; f32 on the card against f64 (the CPU parity
# tests hold f32 to 1e-4 of the reference's f64 likewise)
DEEPMD_F64_TOL = 1e-10
DEEPMD_MD_TOL = 1e-9
DEEPMD_F32_TOL = 1e-4
# DeePMD training (phase 12): three f64 Trainer steps, the card against the
# host CPU, the loss per step and every parameter leaf relative to its
# largest magnitude; the frozen model of a `dp train` run against the
# trainer's final parameters, f32 energy
DEEPMD_TRAIN_F64_TOL = 1e-10
DEEPMD_FREEZE_F32_TOL = 1e-5
# Cantera NonIdealShockTube (phase 13): a synthetic mechanism with
# n-dodecane's counts (tests/test_cantera.py:39-45) drawn from
# CANTERA_SEED; f64 on the card against the host CPU: RHS and Jacobian
# relative to each one's largest entry, the Redlich-Kwong initial state,
# the CPU run's ignition delay; the reference's invariants of a
# constant-UV ignition (tests/test_cantera.py:164-186): elements, U, a
# temperature rise. The host CPU runs the CLI's case to the protocol's
# 5 ms in a process of its own beside the card's runs, and the phase waits
# at most CANTERA_HOST_TIMEOUT s for it; the state at tau/2 is integrated
# at CANTERA_HALF_RTOL (it only places the comparisons and the profiled
# window of CANTERA_WINDOW steps).
CANTERA_SEED = 0
CANTERA_COUNTS = {"nspec": 100, "nrxn": 553, "n_falloff": 15,
                  "n_three_body": 19}
CANTERA_F64_TOL = 1e-11
CANTERA_Y0_TOL = 1e-13
CANTERA_TAU_TOL = 1e-4
CANTERA_ELEMENT_TOL = 1e-8
CANTERA_U_TOL = 1e-6
CANTERA_T_RISE = 500.0
CANTERA_HOST_TIMEOUT = 600
CANTERA_HALF_RTOL = 1e-6
CANTERA_WINDOW = 40
# the RK advance to tau/2 run a second time on the card: the state
# relative to the first run's (rounding from another history of the
# process moved the full run's tau by up to 4.5e-12 on an H100; the
# multichip driver's NTC check reruns whole cases, phase 17)
CANTERA_REPEAT_TOL = 1e-10
# Cantera's 1-D flames (phase 18) at phase 13's mechanism: the burner
# flame and its march (the reference test's H2 settings, a prevaporized
# 400 K stoichiometric n-dodecane/air inlet), the free flame's points,
# width and march times, the points of the flames checked without a march
# (the multicomponent Jacobian's host side grows with them: 3 (K+1)
# tangents per point), the Newton iterations and the profiled window; f64
# card against host CPU relative to each output's largest entry. The
# march times are cut from the reference test's (burner 0.02 s, free
# flame 4 ms and 8 ms) to fit the phase's 110 s: at 100 species the BDF
# steps through the initial ramp's ignition at 1e-9 to 1e-8 s, 0.088 s of
# wall each on an H100 (2,500 steps reached 1.97e-5 s of the burner's
# march in 218.7 s), so neither flame reaches its steady state here
FLAME_BURNER = dict(n_points=32, width=0.01, mdot=0.08, T_burner=400.0)
FLAME_MARCH = dict(t_end=1e-6, rtol=1e-5, atol=1e-8)
FLAME_FREE_POINTS = 24
FLAME_FREE_WIDTH = 0.006
FLAME_FREE_MARCH = dict(t_ignite=1e-8, t_inner=2e-8)
FLAME_MULTI_POINTS = 4
FLAME_CHECK_POINTS = 8
FLAME_NEWTON_ITERS = 3
FLAME_WINDOW = 10
FLAME_REPEAT_STEPS = 50
FLAME_TOL = 1e-11
FLAME_EQ_TOL = 1e-10
FLAME_COVERAGE_TOL = 1e-9
FLAME_T_MARGIN = 5.0
FLAME_HOST_TIMEOUT = 600
# Cantera's phase models (phase 19), f64, card against the host CPU
# relative to each value's largest magnitude: the IAPWS-95 steam table
# (PHASE19_STEAM T x P liquid states, T 275-550 K, P 10-100 MPa: rho, h
# and s at 1e-12, PHASE19_STEAM_TIGHT; p and alpha at 1e-11, since in the
# cold liquid p = rho R T (1 + delta phir_d) keeps about 5 % of its terms
# and alpha's dp/dT cancels by the density maximum, so an ulp of the
# card's or the CPU's exp and pow moves them by about 1e-12), closed
# forms (Debye-Huckel, condensed families, plasma) at 1e-12, Newton-based
# values (HMW, pure fluids, and the water block's release values and
# alpha at 276.15 K, where alpha crosses zero by the density maximum and
# its dp/dT cancels) at 1e-10, VCS phase moles and mole fractions
# at 1e-9; the HMW seawater sweep's (T, molality scale) states; the pure
# fluids' equal-Gibbs residual at saturation; VCS element conservation
# (its phases are reported after the last damped activity refresh, which
# moves q by up to half its 1e-10 stopping drift)
PHASE19_SEED = 19
PHASE19_STEAM = (256, 256)
PHASE19_STEAM_CHUNKS = 4
PHASE19_HMW_STATES = 16
PHASE19_TOL = {"steam": 1e-11, "water": 1e-10, "dh": 1e-12,
               "condensed": 1e-12, "plasma": 1e-12, "hmw": 1e-10,
               "purefluid": 1e-10, "vcs": 1e-9}
PHASE19_STEAM_TIGHT = {"rho": 1e-12, "h": 1e-12, "s": 1e-12}
PHASE19_SAT_TOL = 1e-8
PHASE19_ELEMENT_TOL = 1e-10
PHASE19_HOST_TIMEOUT = 600
# the rest of regional CitcomS (phase 14): multigrid, the thermochemical
# step and one step of each other branch, f64 on the card against the host
# CPU relative to each field's largest magnitude; multigrid's initial vrms
# against CG's (tests/test_citcoms.py:386-400 holds the two solvers' V to
# 1e-3); tracers per element of the thermochemical run (81,920 tracers)
CITCOMS_TAIL_TOL = 1e-10
CITCOMS_MG_VRMS_TOL = 1e-3
# multigrid's f64 steps after the initial solve (card twice, host CPU once)
# and its timed f32 steps (cut from 2 and 5 to keep the whole script in its
# time beside phase 17)
CITCOMS_MG_F64_STEPS = 1
CITCOMS_MG_F32_STEPS = 3
CITCOMS_TRACERS_PER_ELEMENT = 10
# the CitcomS full sphere (phase 15): nodes per cap (nodex = nodey, nodez);
# Ra 1e5, radius_inner 0.55, free slip, tests/test_citcoms.py's blob. Free
# slip leaves the rigid rotations in the Stokes nullspace and the Uzawa/CG
# iterates then amplify rounding (at 5x5x4 a 1e-15 change of T moves the
# port's V by 1.2e-14 at 1 Uzawa x 20 CG, 5.7e-7 at 1 x 40, 6.1e-9 at
# 3 x 60: tests/citcoms_full_rounding_spread.py), so f64 on the card is held
# to the host CPU within CITCOMS_FULL_TOL at CITCOMS_FULL_FIXED, and at
# CITCOMS_FULL_SPREAD_CAP within CITCOMS_FULL_SPREAD_FACTOR times what a
# 1e-15 change of T moves the host CPU's own step
CITCOMS_FULL_NODES = (17, 9)
CITCOMS_FULL_TOL = 1e-10
CITCOMS_FULL_POS_TOL = 1e-13
CITCOMS_FULL_FIXED = dict(accuracy=0.0, piterations=1, vlowstep=20)
CITCOMS_FULL_SPREAD_CAP = dict(accuracy=0.0, piterations=3, vlowstep=60)
CITCOMS_FULL_SPREAD_FACTOR = 100.0
CITCOMS_FULL_F32_STEPS = 5
CITCOMS_FULL_TRACER_STEPS = 2
# the rest of DeePMD (phase 16): the water frame (atoms, box side), the cell
# list's tilings of it (checked, timed), i-PI exchanges timed, NVNMD's
# CNN + QNN training steps
DEEPMD_TAIL_FRAME = (192, 12.444661)
DEEPMD_TAIL_TILES = (2, 4)
DEEPMD_TAIL_IPI_EXCHANGES = 10
DEEPMD_TAIL_NVNMD_STEPS = 3
# the multi-rank dry run (phase 17): at most this many ranks, one card
# each, and the multichip driver's time limit
MULTICHIP_MAX_WORLD = 4
MULTICHIP_TIMEOUT = 900


def _say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def _host_us(fn, reps: int = 100) -> float:
    """Host wall time per call of back-to-back fn() calls, synchronized at
    the end: what a caller waits when the host enqueues slower than the
    device runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _wall_ms(fn, reps: int = 5) -> float:
    """Host wall time per call, each call synchronized: for a library call
    that waits on the device itself (cuSPARSE SpGEMM sizes its output on
    the host), so its calls cannot be queued behind a device sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _bound(nbytes: float, ops: float):
    """(least ms, what bounds it): each input byte read once and each
    output byte written once at the published memory rate, against the
    operations at the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def _rel_err(y, ref) -> float:
    import numpy as np
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    if not np.isfinite(y).all():
        raise AssertionError("non-finite output")
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _kernel_names(names) -> str:
    """Device activity names, shortened and counted, as compact JSON."""
    short = []
    for name in names:
        name = name.replace("(anonymous namespace)::", "")
        hit = re.match(r"(?:void\s+)?([\w:]+)", name)
        short.append((hit.group(1) if hit else name).split("::")[-1])
    return json.dumps(collections.Counter(short)).replace(" ", "")


def _csr_tensor(a, dev):
    """A scipy CSR matrix as a torch sparse CSR tensor on `dev`, for the
    library-call yardsticks (cuSPARSE)."""
    import numpy as np
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data), size=a.shape).to(dev)


def _wsell_cases():
    """The four pack shapes the WSELL kernel is compared on: the
    multi-window and rectangular/empty-row matrices of tests/test_ops.py,
    and packs with W = 2 and W = 16."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    n = 2048
    rows, cols, vals = [], [], []
    for i in range(n):
        for o in (0, 1, -1, 400, -400, 900, -900):
            j = i + o + int(rng.integers(-2, 3))
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(float(rng.normal()))
    multi = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    multi.sum_duplicates()
    yield "multi_window", multi.astype(np.float32)

    n_r, n_c = 500, 700
    m = sp.random(n_r, n_c, density=0.004, random_state=3, format="csr",
                  dtype=np.float32).tocoo()
    m.col[:] = np.minimum(n_c - 1, (m.row * n_c) // n_r + (m.col % 64))
    rect = sp.coo_matrix((m.data, (m.row, m.col)), shape=(n_r, n_c)).tocsr()
    rect.sum_duplicates()
    yield "rect_empty_rows", rect

    n = 4096
    w2 = sp.diags([rng.normal(size=n), rng.normal(size=n - 1)], [0, 1],
                  shape=(n, n), format="csr").astype(np.float32)
    yield "w2", w2

    offs = list(range(-6, 7)) + [300, -300, 1000]
    w16 = sp.diags([rng.normal(size=n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr").astype(np.float32)
    yield "w16", w16


def _band(n: int):
    """The 16-diagonal band of tests/test_ops.py and bench.py (ones)."""
    import numpy as np
    import scipy.sparse as sp
    offs = np.r_[0, np.arange(1, 8), -np.arange(1, 9)]
    return sp.diags([np.ones(n)] * len(offs), offs, shape=(n, n),
                    format="csr").astype(np.float32)


def _clustered(n: int, seed: int, W: int = 16):
    """Columns cluster per 8-row gather row but not per 64-row pack
    (tests/test_ops.py:410): BWELL mode pack rejects it, mode row takes
    it."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    gr = n // 8
    bases = rng.integers(0, (n - 64) // 64, size=gr) * 64
    cols = (bases[:, None, None]
            + rng.integers(0, 64, size=(gr, 8, W))).reshape(-1)
    rows = np.repeat(np.arange(n), W)
    vals = rng.standard_normal(n * W).astype(np.float32)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m


def _bwell_cases():
    """(name, matrix, mode, packs per tile) of the small BWELL packs: the
    band and the clustered matrix of tests/test_ops.py, W = 2, and W = 16
    in mode row."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(5)
    n = 4096
    yield "band_pack", _band(2048), "pack", 4
    yield "clustered_row", _clustered(2048, seed=0), "auto", 64
    w2 = sp.diags([rng.normal(size=n), rng.normal(size=n - 1)], [0, 1],
                  shape=(n, n), format="csr").astype(np.float32)
    yield "w2_auto", w2, "auto", 2      # 512-row packs: mode row
    offs = list(range(-7, 9))
    w16 = sp.diags([rng.normal(size=n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr").astype(np.float32)
    yield "w16_row", w16, "row", 2


def _stencil(nx: int, seed: int):
    """bench.py's headline matrix: a 3D 7-point stencil, renumbered by a
    random permutation drawn from `seed`."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    t_ = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    e_ = sp.eye(nx)
    a = (sp.kron(sp.kron(e_, e_), t_) + sp.kron(sp.kron(e_, t_), e_)
         + sp.kron(t_, sp.kron(e_, e_))).tocsr().astype(np.float32)
    pp = rng.permutation(nx ** 3)
    return a[pp][:, pp].tocsr()


def _rmat_like(n: int, nnz: int, seed: int = 7, cap: int = 256):
    """bench.py's power-law square matrix: Zipf row and column degrees
    capped at `cap` (configuration model)."""
    import numpy as np
    import scipy.sparse as sp
    r = np.random.RandomState(seed)
    deg = np.minimum(r.zipf(1.6, size=n), cap).astype(np.int64)
    deg = deg[r.permutation(n)]
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)[:nnz]
    deg2 = np.minimum(r.zipf(1.6, size=n), cap).astype(np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64),
                     deg2[r.permutation(n)])[:nnz]
    r.shuffle(cols)
    m = min(rows.size, cols.size)
    a = sp.coo_matrix((r.randn(m).astype(np.float32),
                       (rows[:m], cols[:m])), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


_SYN_CORE = [
    # name, composition, Hf298 kJ/mol, S298 J/mol/K, cp(300 K)/R,
    # cp(high T)/R
    ("c12h26", {"C": 12, "H": 26}, -290.9, 622.5, 28.0, 58.0),
    ("o2", {"O": 2}, 0.0, 205.15, 3.53, 4.6),
    ("n2", {"N": 2}, 0.0, 191.6, 3.50, 4.4),
    ("oh", {"O": 1, "H": 1}, 37.3, 183.7, 3.58, 4.5),
    ("h2o", {"H": 2, "O": 1}, -241.8, 188.8, 4.04, 6.8),
    ("ho2", {"H": 1, "O": 2}, 12.0, 229.0, 4.20, 7.0),
    ("h2o2", {"H": 2, "O": 2}, -136.1, 232.9, 5.15, 9.0),
    ("h", {"H": 1}, 218.0, 114.7, 2.5, 2.5),
    ("co", {"C": 1, "O": 1}, -110.5, 197.7, 3.50, 4.5),
    ("co2", {"C": 1, "O": 2}, -393.5, 213.8, 4.47, 7.4),
    ("c12h25-1", {"C": 12, "H": 25}, -92.9, 640.5, 27.5, 57.0),
    ("c2h4", {"C": 2, "H": 4}, 52.4, 219.3, 5.2, 17.0),
    ("ch2o", {"C": 1, "H": 2, "O": 1}, -108.6, 218.8, 4.26, 10.5),
    ("hco", {"H": 1, "C": 1, "O": 1}, 43.5, 224.6, 4.15, 7.0),
    ("c12h25-2", {"C": 12, "H": 25}, -98.9, 643.0, 27.5, 57.0),
    ("o", {"O": 1}, 249.2, 161.1, 2.63, 2.55),
    ("h2", {"H": 2}, 0.0, 130.7, 3.47, 4.6),
    ("ch3", {"C": 1, "H": 3}, 146.0, 194.2, 4.65, 10.5),
    ("ch4", {"C": 1, "H": 4}, -74.6, 186.3, 4.30, 13.0),
    ("c2h5", {"C": 2, "H": 5}, 119.0, 247.0, 6.2, 20.0),
    ("c2h6", {"C": 2, "H": 6}, -84.0, 229.2, 6.3, 22.0),
    ("ar", {"Ar": 1}, 0.0, 154.8, 2.5, 2.5),
    ("ch3o", {"C": 1, "H": 3, "O": 1}, 21.0, 229.0, 4.9, 13.0),
    ("c2h3", {"C": 2, "H": 3}, 299.0, 233.0, 5.1, 14.0),
    ("ch3o2", {"C": 1, "H": 3, "O": 2}, 12.0, 270.0, 6.4, 16.0),
    ("ch3o2h", {"C": 1, "H": 4, "O": 2}, -132.0, 285.0, 7.9, 19.0),
    ("c2h5o2", {"C": 2, "H": 5, "O": 2}, -27.0, 315.0, 9.0, 25.0),
    ("ch3cho", {"C": 2, "H": 4, "O": 1}, -166.2, 263.8, 6.6, 20.0),
]
# critical constants (K, bar) of the species that have published ones; n-
# dodecane's set its Redlich-Kwong a and b
_SYN_CRIT = {"c12h26": (658.0, 18.2), "o2": (154.6, 50.4),
             "n2": (126.2, 33.9), "h2o": (647.1, 220.6),
             "co2": (304.1, 73.8), "co": (132.9, 35.0), "h2": (33.2, 13.0),
             "ar": (150.7, 48.6), "ch4": (190.6, 46.0),
             "c2h4": (282.3, 50.4), "c2h6": (305.3, 48.7)}


def _synthetic_mechanism_yaml(path, *, nspec: int, nrxn: int,
                              n_falloff: int, n_three_body: int,
                              seed: int) -> dict:
    """Write a Cantera-format YAML mechanism with n-dodecane's shape and
    return its counts: the phases nDodecane_RK (Redlich-Kwong) and
    nDodecane_IG (ideal gas) over the same `nspec` species and `nrxn`
    reactions, `n_falloff` of them falloff (with Troe) and `n_three_body`
    three-body (with efficiencies), so that ShockTubeBenchmark(path) runs
    with its default phase names. It stands in for nDodecane_Reitz.yaml
    (100 species, 553 reactions, 15 falloff, 19 three-body), which is not
    in the repository.

    The species are the H2/O2/CO/C1-C2 core (published formation
    enthalpies and entropies at 298 K, so heat release is real), the
    dodecyl isomers, and for n = 12..3 the alkane, alkyl, alkene, RO2,
    QOOH, O2QOOH and ketohydroperoxide of the n-alkane oxidation scheme
    (group-additivity estimates); the first `nspec` of that list are kept.
    The reactions are the H2/O2/CO core with published rates, then the
    fuel's and each family's abstractions, beta-scissions, O2 additions
    and low-temperature chain, every one balanced in every element by
    construction, with Arrhenius A, b and Ea drawn from `seed` inside the
    ranges published mechanisms give each reaction class; the first
    `nrxn` whose species are all kept, up to the quota of each type, are
    written. NASA7 polynomials are fitted to a smooth cp/R rising from its
    300 K value to its high-temperature value, the two ranges meeting at
    1000 K in value and slope; cp/R stays in [2.5, 60] over 300-3500 K.
    Redlich-Kwong a and b come from critical constants by the RK relations
    (a = 0.42748 R^2 Tc^2.5 / Pc, b = 0.08664 R Tc / Pc): published ones
    where the table has them (n-dodecane: Tc 658 K, Pc 18.2 bar), else Tc
    and Pc drawn from `seed` in a range that grows with the heavy atoms.
    Each species' `transport:` block takes its Lennard-Jones well depth
    and diameter from the same Tc and Pc (Bird-Stewart-Lightfoot) and its
    geometry from its atom count; it draws nothing from `seed`, so every
    field a mechanism loader reads is as without it."""
    import numpy as np

    R = 8.314462618
    rng = np.random.default_rng(seed)

    # ---- species: composition, Hf, S, cp(300)/R, cp(high)/R ----
    catalog = [tuple(s) for s in _SYN_CORE]

    def formula(c, h, o):
        out = {"C": c, "H": h}
        if o:
            out["O"] = o
        return out

    def cp_guess(comp):
        atoms = sum(comp.values())
        return (min(45.0, 2.5 + 0.7 * (atoms - 1)),
                min(58.0, 3.0 + 1.5 * (atoms - 1)))

    def add(name, comp, hf, s):
        catalog.append((name, comp, hf, s) + cp_guess(comp))

    def alk_h(n):
        return -84.4 - 20.6 * (n - 2), 229.2 + 39.0 * (n - 2)

    def rad(n):
        return "c12h25-1" if n == 12 else f"c{n}h{2 * n + 1}"

    for n in range(12, 2, -1):
        h_alk, s_alk = alk_h(n)
        if n == 12:
            for j in range(3, 7):
                add(f"c12h25-{j}", formula(12, 25, 0),
                    h_alk + 198.0 + rng.uniform(-4, 4),
                    s_alk + 18.0 + rng.uniform(-3, 3))
        else:
            add(f"c{n}h{2 * n + 2}", formula(n, 2 * n + 2, 0), h_alk, s_alk)
            add(rad(n), formula(n, 2 * n + 1, 0), h_alk + 198.0,
                s_alk + 18.0)
        h_r, s_r = h_alk + 198.0, s_alk + 18.0
        add(f"c{n}h{2 * n}", formula(n, 2 * n, 0), h_alk + 126.0,
            s_alk - 3.0)
        add(f"c{n}h{2 * n + 1}o2", formula(n, 2 * n + 1, 2), h_r - 150.0,
            s_r + 65.0)
        add(f"c{n}ooh", formula(n, 2 * n + 1, 2), h_r - 90.0, s_r + 75.0)
        add(f"c{n}o2ooh", formula(n, 2 * n + 1, 4), h_r - 240.0,
            s_r + 135.0)
        add(f"c{n}ket", formula(n, 2 * n, 3), h_r - 377.3, s_r + 81.0)
    if not 1 <= nspec <= len(catalog):
        raise ValueError(f"nspec must be in 1..{len(catalog)}")
    names = [c[0] for c in catalog[:nspec]]
    have = set(names)
    for need in ("c12h26", "o2", "n2", "oh"):
        if need not in have:
            raise ValueError(f"nspec={nspec} leaves out {need}")

    # ---- NASA7: constrained fits of cp/R, h and s set at 298.15 K ----
    t_lo, t_mid, t_hi, t_ref = 200.0, 1000.0, 3500.0, 298.15
    grid_lo = np.linspace(t_lo, t_mid, 60)
    grid_hi = np.linspace(t_mid, t_hi, 120)

    def vander(T):
        u = np.asarray(T) / 1000.0
        return np.stack([u ** k for k in range(5)], axis=-1)

    def dvander(T):
        u = np.asarray(T) / 1000.0
        return np.stack([k * u ** (k - 1) if k else 0 * u
                         for k in range(5)], axis=-1) / 1000.0

    scale = 1000.0 ** np.arange(5)

    def nasa7(hf, s, cp0, cpi):
        if cp0 == cpi:
            c = np.array([cp0, 0, 0, 0, 0.0])
            low, high = c, c
        else:
            def target(T):
                return cpi - (cpi - cp0) * np.exp(-(T - 300.0) / 700.0)
            b_lo = np.linalg.lstsq(vander(grid_lo), target(grid_lo),
                                   rcond=None)[0]
            # high range: least squares under value and slope continuity
            A = vander(grid_hi)
            C = np.stack([vander(t_mid), dvander(t_mid)])
            d = C @ b_lo
            kkt = np.block([[A.T @ A, C.T], [C, np.zeros((2, 2))]])
            rhs = np.concatenate([A.T @ target(grid_hi), d])
            b_hi = np.linalg.solve(kkt, rhs)[:5]
            low, high = b_lo / scale, b_hi / scale

        def h_poly(a, T):       # H/R without a5
            return T * (a[0] + T * (a[1] / 2 + T * (a[2] / 3 + T * (
                a[3] / 4 + T * a[4] / 5))))

        def s_poly(a, T):       # S/R without a6
            return (a[0] * np.log(T) + T * (a[1] + T * (a[2] / 2 + T * (
                a[3] / 3 + T * a[4] / 4))))
        a5l = hf * 1000.0 / R - h_poly(low, t_ref)
        a6l = s / R - s_poly(low, t_ref)
        a5h = h_poly(low, t_mid) + a5l - h_poly(high, t_mid)
        a6h = s_poly(low, t_mid) + a6l - s_poly(high, t_mid)
        return ([*low, a5l, a6l], [*high, a5h, a6h])

    lines = ["description: >-",
             f"  Synthetic n-dodecane-shaped mechanism (seed {seed}):",
             f"  {nspec} species, see chip_smoke._synthetic_mechanism_yaml.",
             "units: {length: cm, quantity: mol, "
             "activation-energy: cal/mol}",
             "phases:"]
    sp_list = ", ".join(names)
    for phase, thermo in (("nDodecane_RK", "Redlich-Kwong"),
                          ("nDodecane_IG", "ideal-gas")):
        lines += [f"- name: {phase}", f"  thermo: {thermo}",
                  "  elements: [O, H, C, N, Ar]",
                  f"  species: [{sp_list}]", "  kinetics: gas",
                  "  state: {T: 300.0, P: 1 atm}"]
    # critical constants for the whole catalog, so that a smaller instance
    # is a part of a larger one drawn from the same seed
    crit = {}
    for name, comp, *_ in catalog:
        heavy = sum(v for k, v in comp.items() if k != "H")
        drawn = (min(rng.uniform(150.0, 350.0) + 35.0 * heavy, 800.0),
                 rng.uniform(15.0, 60.0))
        crit[name] = _SYN_CRIT.get(name, drawn)
    lines.append("species:")
    for name, comp, hf, s, cp0, cpi in catalog[:nspec]:
        low, high = nasa7(hf, s, cp0, cpi)
        tc, pc = crit[name][0], crit[name][1] * 1e5
        a_rk = 0.42748 * R * R * tc ** 2.5 / pc * 1e12
        b_rk = 0.08664 * R * tc / pc * 1e6
        fmt = ", ".join
        lines += [f"- name: {name}",
                  "  composition: {" + fmt(f"{k}: {v}" for k, v in
                                           comp.items()) + "}",
                  "  thermo:", "    model: NASA7",
                  f"    temperature-ranges: [{t_lo}, {t_mid}, {t_hi}]",
                  "    data:",
                  "    - [" + fmt(f"{v:.12e}" for v in low) + "]",
                  "    - [" + fmt(f"{v:.12e}" for v in high) + "]",
                  "  equation-of-state:",
                  f"    model: Redlich-Kwong",
                  f"    a: {a_rk:.10e}", f"    b: {b_rk:.10e}"]
        # Lennard-Jones parameters from the same critical constants by
        # the Bird-Stewart-Lightfoot correlations (eps/k = 0.77 Tc,
        # sigma = 2.44 (Tc/Pc)^(1/3) A with Pc in atm); dipole,
        # polarizability and rotational relaxation at load_transport's
        # defaults (0, 0, 1)
        atoms = sum(comp.values())
        geometry = ("atom" if atoms == 1 else "linear" if atoms == 2
                    else "nonlinear")
        sigma = 2.44 * (tc / (pc / 101325.0)) ** (1.0 / 3.0)
        lines += ["  transport:", f"    model: gas",
                  f"    geometry: {geometry}",
                  f"    well-depth: {0.77 * tc:.10e}",
                  f"    diameter: {sigma:.10e}"]

    # ---- reactions ----
    effs_all = {"h2": 2.5, "h2o": 12.0, "co": 1.9, "co2": 3.8, "ar": 0.7,
                "ch4": 2.0, "c2h6": 3.0}

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    cands = []    # (equation, kind, dict of rate fields)

    def el(eq, A, b, Ea):
        cands.append((eq, "elementary", {"A": A, "b": b, "Ea": Ea}))

    def tb(eq, A, b, Ea):
        cands.append((eq, "three-body", {"A": A, "b": b, "Ea": Ea}))

    def fo(eq, hi, lo, troe):
        cands.append((eq, "falloff", {"hi": hi, "lo": lo, "troe": troe}))

    # the H2/O2/CO/C1-C2 core (rates as in published H2/O2, CO and C1-C2
    # mechanisms)
    fo("h + o2 (+M) <=> ho2 (+M)", (1.475e12, 0.6, 0.0),
       (6.366e20, -1.72, 524.8), (0.8, 1e-30, 1e30, 0.0))
    fo("h2o2 (+M) <=> oh + oh (+M)", (2.951e14, 0.0, 48430.0),
       (1.202e17, 0.0, 45500.0), (0.5, 1e-30, 1e30, 0.0))
    tb("h + oh + M <=> h2o + M", 3.8e22, -2.0, 0.0)
    tb("hco + M <=> h + co + M", 4.75e11, 0.66, 14870.0)
    el("c12h26 + o2 <=> c12h25-1 + ho2", 4.0e13, 0.0, 49500.0)
    el("c12h26 + oh <=> c12h25-1 + h2o", 2.0e6, 2.0, -600.0)
    el("c12h26 + ho2 <=> c12h25-1 + h2o2", 1.5e4, 2.6, 14500.0)
    el("c12h25-1 => 6 c2h4 + h", 2.0e12, 0.0, 30000.0)
    el("ho2 + ho2 <=> h2o2 + o2", 4.2e14, 0.0, 11982.0)
    el("ho2 + oh <=> h2o + o2", 2.89e13, 0.0, -497.0)
    el("ho2 + h <=> oh + oh", 7.079e13, 0.0, 295.0)
    el("h2o2 + h <=> h2o + oh", 2.41e13, 0.0, 3970.0)
    el("h2o2 + oh <=> ho2 + h2o", 1.0e12, 0.0, 0.0)
    el("co + oh <=> co2 + h", 2.229e5, 1.89, -1158.7)
    el("co + ho2 <=> co2 + oh", 3.01e13, 0.0, 23000.0)
    el("c2h4 + o2 => ch2o + ch2o", 2.0e13, 0.0, 38000.0)
    el("ch2o + oh <=> hco + h2o", 3.43e9, 1.18, -447.0)
    el("ch2o + ho2 <=> hco + h2o2", 3.0e12, 0.0, 13000.0)
    el("ch2o + o2 <=> hco + ho2", 1.0e14, 0.0, 40000.0)
    el("hco + o2 <=> co + ho2", 7.58e12, 0.0, 410.0)
    el("hco + oh <=> co + h2o", 3.02e13, 0.0, 0.0)
    el("hco + ho2 => co2 + h + oh", 3.0e13, 0.0, 0.0)
    el("hco + hco => ch2o + co", 3.0e13, 0.0, 0.0)
    el("c12h26 + o2 <=> c12h25-2 + ho2", 4.0e13, 0.0, 48000.0)
    el("c12h26 + oh <=> c12h25-2 + h2o", 3.0e6, 2.0, -800.0)
    el("c12h26 + ho2 <=> c12h25-2 + h2o2", 2.0e4, 2.6, 14000.0)
    el("c12h25-2 => 6 c2h4 + h", 2.0e12, 0.0, 30500.0)
    el("c12h25-1 <=> c12h25-2", 3.0e11, 0.0, 22000.0)
    tb("ch2o + M <=> hco + h + M", 3.3e16, 0.0, 81000.0)
    el("h + o2 <=> o + oh", 3.547e15, -0.406, 16599.0)
    el("o + h2 <=> h + oh", 5.08e4, 2.67, 6290.0)
    el("h2 + oh <=> h2o + h", 2.16e8, 1.51, 3430.0)
    el("o + h2o <=> oh + oh", 2.97e6, 2.02, 13400.0)
    tb("h2 + M <=> h + h + M", 4.577e19, -1.4, 104380.0)
    tb("o + o + M <=> o2 + M", 6.165e15, -0.5, 0.0)
    tb("o + h + M <=> oh + M", 4.714e18, -1.0, 0.0)
    fo("co + o (+M) <=> co2 (+M)", (1.8e10, 0.0, 2384.0),
       (1.55e24, -2.79, 4191.0), (0.5, 1e-30, 1e30, 0.0))
    el("ho2 + h <=> h2 + o2", 1.66e13, 0.0, 823.0)
    el("ho2 + o <=> o2 + oh", 3.25e13, 0.0, 0.0)
    el("h2o2 + h <=> ho2 + h2", 4.82e13, 0.0, 7950.0)
    el("h2o2 + o <=> oh + ho2", 9.55e6, 2.0, 3970.0)
    el("co + o2 <=> co2 + o", 2.53e12, 0.0, 47700.0)
    el("hco + h <=> co + h2", 7.23e13, 0.0, 0.0)
    el("hco + o <=> co + oh", 3.02e13, 0.0, 0.0)
    el("ch2o + h <=> hco + h2", 9.33e8, 1.5, 2976.0)
    el("ch2o + o <=> hco + oh", 4.16e11, 0.57, 2762.0)
    el("c12h26 + h <=> c12h25-1 + h2", 1.3e6, 2.4, 4470.0)
    el("c12h26 + o <=> c12h25-1 + oh", 1.0e6, 2.5, 2200.0)
    fo("ch3 + h (+M) <=> ch4 (+M)", (1.27e16, -0.63, 383.0),
       (2.477e33, -4.76, 2440.0), (0.783, 74.0, 2941.0, 6964.0))
    el("ch3 + o <=> ch2o + h", 8.43e13, 0.0, 0.0)
    el("ch3 + o2 <=> ch2o + oh", 3.6e10, 0.0, 8940.0)
    el("ch3 + ho2 <=> ch4 + o2", 1.0e12, 0.0, 0.0)
    el("ch4 + h <=> ch3 + h2", 6.6e8, 1.62, 10840.0)
    el("ch4 + oh <=> ch3 + h2o", 1.0e8, 1.6, 3120.0)
    el("ch4 + o <=> ch3 + oh", 1.02e9, 1.5, 8600.0)
    el("ch4 + ho2 <=> ch3 + h2o2", 3.42e11, 0.0, 19290.0)
    el("ch2o + ch3 <=> hco + ch4", 3.636e-6, 5.42, 998.0)
    fo("c2h4 + h (+M) <=> c2h5 (+M)", (5.4e11, 0.454, 1820.0),
       (6.0e41, -7.62, 6970.0), (0.9753, 210.0, 984.0, 4374.0))
    el("c2h4 + oh => ch2o + ch3", 2.0e12, 0.0, 960.0)
    el("c2h4 + o => ch3 + hco", 1.25e7, 1.83, 220.0)
    el("c2h5 + o2 <=> c2h4 + ho2", 8.4e11, 0.0, 3875.0)
    fo("ch3 + ch3 (+M) <=> c2h6 (+M)", (2.12e16, -0.97, 620.0),
       (1.77e50, -9.67, 6220.0), (0.5325, 151.0, 1038.0, 4970.0))
    el("c2h6 + oh <=> c2h5 + h2o", 3.54e6, 2.12, 870.0)
    el("c2h6 + h <=> c2h5 + h2", 1.15e8, 1.9, 7530.0)
    el("c2h6 + o <=> c2h5 + oh", 8.98e7, 1.92, 5690.0)
    el("c2h6 + ho2 <=> c2h5 + h2o2", 1.32e13, 0.0, 20470.0)
    el("c2h6 + ch3 <=> c2h5 + ch4", 6.14e6, 1.74, 10450.0)
    el("ch3 + ch3 <=> c2h5 + h", 6.84e12, 0.1, 10600.0)
    el("ch3 + ho2 <=> ch3o + oh", 1.34e13, 0.0, 0.0)
    fo("ch3o (+M) <=> ch2o + h (+M)", (6.8e13, 0.0, 26170.0),
       (1.867e25, -3.0, 24307.0), (0.9, 2500.0, 1300.0, 1e30))
    el("ch3o + o2 <=> ch2o + ho2", 4.28e-13, 7.6, -3530.0)
    fo("hco + h (+M) <=> ch2o (+M)", (1.09e12, 0.48, -260.0),
       (2.47e24, -2.57, 425.0), (0.7824, 271.0, 2755.0, 6570.0))
    el("c2h4 + oh <=> c2h3 + h2o", 3.6e6, 2.0, 2500.0)
    el("c2h4 + h <=> c2h3 + h2", 1.325e6, 2.53, 12240.0)
    el("c2h3 + o2 => ch2o + hco", 4.58e16, -1.39, 1015.0)
    el("ch3 + o2 <=> ch3o2", 1.0e12, 0.0, 0.0)
    el("ch3o2 + ho2 => ch3o2h + o2", 2.47e11, 0.0, -1570.0)
    el("ch3o2h => ch3o + oh", 6.31e14, 0.0, 42300.0)
    el("ch3o2 + ch3 => ch3o + ch3o", 5.08e12, 0.0, -1411.0)
    el("c2h5 + o2 <=> c2h5o2", 1.0e12, 0.0, 0.0)
    el("c2h5o2 => c2h4 + ho2", 5.0e11, 0.0, 28000.0)
    el("ch3cho + oh => ch3 + co + h2o", 3.37e12, 0.0, -619.0)
    el("ch3cho + h => ch3 + co + h2", 4.1e9, 1.16, 2400.0)
    el("ch3cho + ho2 => ch3 + co + h2o2", 3.0e12, 0.0, 12000.0)

    # H abstraction from an alkane by each radical, with its class's A, b
    # and Ea ranges
    abstractors = [("oh", "h2o", (5.5, 6.5), 2.0, (-800.0, 800.0)),
                   ("h", "h2", (5.5, 6.5), 2.4, (2500.0, 4500.0)),
                   ("o", "oh", (5.0, 6.0), 2.5, (1500.0, 3000.0)),
                   ("ho2", "h2o2", (3.5, 4.5), 2.6, (13500.0, 16500.0)),
                   ("ch3", "ch4", (0.0, 1.0), 3.5, (6000.0, 12000.0)),
                   ("o2", "ho2", (13.0, 13.7), 0.0, (47500.0, 50500.0)),
                   ("ch3o2", "ch3o2h", (12.0, 12.7), 0.0,
                    (17000.0, 20000.0)),
                   ("c2h3", "c2h4", (11.5, 12.3), 0.0, (16000.0, 18500.0)),
                   ("c2h5", "c2h6", (10.5, 11.5), 0.0, (12500.0, 14500.0)),
                   ("hco", "ch2o", (6.5, 7.5), 1.9, (16000.0, 18000.0))]

    def abstraction(alkane, radical, which=slice(None)):
        for x, xh, la, b, ea in abstractors[which]:
            el(f"{alkane} + {x} <=> {radical} + {xh}", 10 ** u(*la), b,
               u(*ea))

    def alkyl(n, j=1):
        return f"c12h25-{j}" if n == 12 else rad(n)

    # the fuel: abstraction to each dodecyl isomer, its scissions and O2
    # chemistry
    for j in range(1, 7):
        abstraction("c12h26", f"c12h25-{j}", slice(0, 6))
    for j in range(1, 7):
        r = f"c12h25-{j}"
        m = j + 1                       # alkene size of this isomer's
        el(f"{r} <=> c{m}h{2 * m} + {rad(12 - m)}", 10 ** u(12.8, 13.5),
           0.0, u(28000.0, 30500.0))
        el(f"{r} => 6 c2h4 + h", 10 ** u(12.0, 12.5), 0.0,
           u(29000.0, 31000.0))
        el(f"{r} + o2 <=> c12h24 + ho2", 10 ** u(10.5, 11.5), 0.0,
           u(2000.0, 5000.0))
        el(f"{r} + o2 <=> c12h25o2", 10 ** u(12.0, 12.7), 0.0, 0.0)
        if j > 1:
            el(f"c12h25-1 <=> {r}", 10 ** u(11.0, 12.0), 0.0,
               u(20000.0, 25000.0))
            el(f"{r} <=> c2h4 + c10h21", 10 ** u(12.8, 13.5), 0.0,
               u(28000.0, 30500.0))
    for k in range(1, 7):
        tb(f"c12h26 + M <=> {alkyl(k) if k > 2 else ('ch3', 'c2h5')[k - 1]}"
           f" + {alkyl(12 - k)} + M", 10 ** u(19.5, 20.5), 0.0,
           u(80000.0, 84000.0))

    # each carbon number's families, the fuel's first, then n = 11..3
    def small_rad(n):
        return {1: "ch3", 2: "c2h5"}.get(n, rad(n))

    def small_alkene(n):
        return "c2h4" if n == 2 else f"c{n}h{2 * n}"

    for n in range(12, 2, -1):
        r, alkene = alkyl(n), f"c{n}h{2 * n}"
        ro2, qooh = f"c{n}h{2 * n + 1}o2", f"c{n}ooh"
        o2qooh, ket = f"c{n}o2ooh", f"c{n}ket"
        el(f"{ro2} <=> {qooh}", 10 ** u(10.5, 11.5), 0.0,
           u(21000.0, 25000.0))
        el(f"{qooh} + o2 <=> {o2qooh}", 10 ** u(11.0, 11.8), 0.0, 0.0)
        el(f"{o2qooh} => {ket} + oh", 10 ** u(10.5, 11.5), 0.0,
           u(17000.0, 21000.0))
        el(f"{ket} => oh + ch2o + co + {small_rad(n - 2)}",
           10 ** u(15.5, 16.2), 0.0, u(39000.0, 42000.0))
        el(f"{qooh} <=> {alkene} + ho2", 10 ** u(12.5, 13.5), 0.0,
           u(24000.0, 27000.0))
        el(f"{qooh} => oh + ch2o + {small_alkene(n - 1)}",
           10 ** u(12.5, 13.3), 0.0, u(20000.0, 23000.0))
        el(f"{ro2} + ho2 => {ket} + h2o", 10 ** u(11.0, 11.5), 0.0,
           u(-1500.0, -1000.0))
        el(f"{alkene} + oh => ch2o + {small_rad(n - 1)}", 10 ** u(12.3, 13.0),
           0.0, u(-1000.0, 0.0))
        el(f"{alkene} + o => hco + {small_rad(n - 1)}", 10 ** u(12.5, 13.2),
           0.0, u(500.0, 1500.0))
        el(f"{alkene} + oh => ch3cho + {small_rad(n - 2)}",
           10 ** u(11.5, 12.3), 0.0, u(-500.0, 500.0))
        el(f"{alkene} + ho2 => ch2o + oh + {small_alkene(n - 1)}",
           10 ** u(11.0, 12.0), 0.0, u(13000.0, 15000.0))
        if n >= 4:
            el(f"{alkene} + h <=> c2h4 + {small_rad(n - 2)}",
               10 ** u(12.5, 13.3), 0.0, u(2000.0, 3500.0))
        el(f"{r} + ho2 => ch2o + oh + {small_rad(n - 1)}",
           10 ** u(12.5, 13.3), 0.0, 0.0)
        el(f"{r} + o => ch2o + {small_rad(n - 1)}", 10 ** u(13.0, 13.7),
           0.0, 0.0)
        el(f"{r} + o2 => ch2o + oh + {small_alkene(n - 1)}",
           10 ** u(11.0, 12.0), 0.0, u(7000.0, 10000.0))
        el(f"{ro2} => {alkene} + ho2", 10 ** u(11.5, 12.5), 0.0,
           u(28000.0, 31000.0))
        el(f"{ro2} + h => oh + ch2o + {small_rad(n - 1)}",
           10 ** u(13.0, 13.7), 0.0, 0.0)
        el(f"{r} + oh => ch2o + h + {small_rad(n - 1)}",
           10 ** u(13.0, 13.5), 0.0, 0.0)
        el(f"{r} + ch3o2 => ch3o + ch2o + {small_rad(n - 1)}",
           10 ** u(12.5, 13.0), 0.0, u(-1500.0, -1000.0))
        if n >= 4:
            el(f"{alkene} + o2 => ch2o + ch2o + {small_alkene(n - 2)}",
               10 ** u(12.5, 13.3), 0.0, u(36000.0, 40000.0))
        if n == 12:
            for j in range(1, 7):
                abstraction("c12h26", f"c12h25-{j}", slice(6, None))
            continue
        alkane = f"c{n}h{2 * n + 2}"
        abstraction(alkane, r)
        tb(f"{alkane} + M <=> ch3 + {small_rad(n - 1)} + M",
           10 ** u(19.5, 20.5), 0.0, u(80000.0, 84000.0))
        fo(f"{alkene} + h (+M) <=> {r} (+M)",
           (10 ** u(12.9, 13.3), 0.0, u(2500.0, 3500.0)),
           (10 ** u(38.5, 39.0), -6.66, u(6500.0, 7500.0)),
           (1.0, 1000.0, 1310.0, 48097.0))
        el(f"{r} <=> c2h4 + {small_rad(n - 2)}", 10 ** u(12.8, 13.5), 0.0,
           u(28000.0, 30500.0))
        for k in range(3, n):
            el(f"{r} <=> c{k}h{2 * k} + {small_rad(n - k)}",
               10 ** u(12.8, 13.5), 0.0, u(28000.0, 30500.0))
        el(f"{r} + o2 <=> {alkene} + ho2", 10 ** u(10.5, 11.5), 0.0,
           u(2000.0, 5000.0))
        el(f"{r} + o2 <=> {ro2}", 10 ** u(12.0, 12.7), 0.0, 0.0)
        el(f"{alkene} + ch3 => {small_rad(n + 1) if n < 11 else alkyl(12)}",
           10 ** u(11.0, 11.7), 0.0, u(7000.0, 8500.0))
        el(f"{r} + h <=> {alkane}", 10 ** u(13.5, 14.2), 0.0, 0.0)

    def species_of(eq):
        out = set()
        for side in eq.replace("(+M)", "").split("=>" if "<=>" not in eq
                                                 else "<=>"):
            for term in side.split(" + "):
                term = term.strip()
                if term and term != "M":
                    out.add(term.split()[-1])
        return out

    quota = {"falloff": n_falloff, "three-body": n_three_body,
             "elementary": nrxn - n_falloff - n_three_body}
    if quota["elementary"] < 0:
        raise ValueError("more falloff and three-body reactions than nrxn")
    chosen, seen = [], set()
    for eq, kind, rate in cands:
        if quota[kind] == 0 or not species_of(eq) <= have or eq in seen:
            continue
        quota[kind] -= 1
        seen.add(eq)
        chosen.append((eq, kind, rate))
    if any(quota.values()):
        raise ValueError(f"not enough reactions among {nspec} species: "
                         f"{quota} short")

    def arr(A, b, Ea):
        return f"{{A: {A:.6e}, b: {b}, Ea: {Ea:.3f}}}"

    lines.append("reactions:")
    for eq, kind, rate in chosen:
        lines.append(f"- equation: {eq}")
        if kind == "elementary":
            lines.append(f"  rate-constant: {arr(**rate)}")
            continue
        effs = {k: v for k, v in effs_all.items() if k in have}
        if kind == "three-body":
            lines += ["  type: three-body",
                      f"  rate-constant: {arr(**rate)}"]
        else:
            a, t3, t1, t2 = rate["troe"]
            lines += ["  type: falloff",
                      f"  low-P-rate-constant: {arr(*rate['lo'])}",
                      f"  high-P-rate-constant: {arr(*rate['hi'])}",
                      f"  Troe: {{A: {a}, T3: {t3}, T1: {t1}"
                      + (f", T2: {t2}}}" if t2 else "}")]
        lines.append("  efficiencies: {" + ", ".join(
            f"{k}: {v}" for k, v in effs.items()) + "}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"nspec": nspec, "nrxn": len(chosen),
            "n_falloff": n_falloff, "n_three_body": n_three_body,
            "candidates": len(cands)}


# the synthetic interface (phase 18): surface species as name, composition,
# Hf298 kJ/mol, S298 J/mol/K (Pt(111) adsorbate values of the size
# published Pt mechanisms give)
_SYN_SURF = [
    ("pt(s)", {"Pt": 1}, 0.0, 0.0),
    ("h(s)", {"H": 1, "Pt": 1}, -32.0, 40.0),
    ("o(s)", {"O": 1, "Pt": 1}, -220.0, 35.0),
    ("oh(s)", {"O": 1, "H": 1, "Pt": 1}, -190.0, 60.0),
    ("h2o(s)", {"H": 2, "O": 1, "Pt": 1}, -290.0, 80.0),
    ("co(s)", {"C": 1, "O": 1, "Pt": 1}, -250.0, 60.0),
    ("co2(s)", {"C": 1, "O": 2, "Pt": 1}, -400.0, 90.0),
    ("c(s)", {"C": 1, "Pt": 1}, 50.0, 10.0),
    ("hco(s)", {"H": 1, "C": 1, "O": 1, "Pt": 1}, -170.0, 70.0),
    ("ch2o(s)", {"C": 1, "H": 2, "O": 1, "Pt": 1}, -160.0, 85.0),
    ("ho2(s)", {"H": 1, "O": 2, "Pt": 1}, -95.0, 75.0),
    ("o2(s)", {"O": 2, "Pt": 1}, -60.0, 70.0),
]


def _synthetic_interface_yaml(path, *, seed: int) -> dict:
    """Write a Cantera-format ideal-surface phase on Pt over the gas
    species of _synthetic_mechanism_yaml (h, o2, oh, h2o, ho2, co, co2,
    hco and ch2o, all in its 15-species and its 100-species instance) and
    return its counts. It has the size of Cantera's ptcombust.yaml (12
    surface species, 24 reactions; that file is not in the repository):
    sticking adsorptions, desorptions with coverage-dependent activation
    energies, one adsorption with a coverage exponent m, and surface
    reactions, each balanced in every element and in sites. Thermo: NASA7
    with a constant cp/R of 1.0-3.0 and h, s at 298.15 K from _SYN_SURF;
    Arrhenius A, b and Ea drawn from `seed` inside the ranges published Pt
    mechanisms give each class; site density 2.7063e-9 mol/cm^2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    R = 8.314462618
    names = [s[0] for s in _SYN_SURF]

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    lines = ["description: >-",
             f"  Synthetic Pt interface (seed {seed}), see",
             "  chip_smoke._synthetic_interface_yaml.",
             "units: {length: cm, quantity: mol, "
             "activation-energy: kJ/mol}",
             "phases:",
             "- name: pt_surf", "  thermo: ideal-surface",
             "  elements: [Pt, H, O, C]",
             f"  species: [{', '.join(names)}]",
             "  kinetics: surface", "  site-density: 2.7063e-09",
             "species:"]
    for name, comp, hf, s in _SYN_SURF:
        cp = round(u(1.0, 3.0), 6)
        a5 = hf * 1000.0 / R - cp * 298.15
        a6 = s / R - cp * np.log(298.15)
        row = "[" + ", ".join(f"{v:.12e}" for v in
                              (cp, 0.0, 0.0, 0.0, 0.0, a5, a6)) + "]"
        lines += [f"- name: {name}",
                  "  composition: {" + ", ".join(
                      f"{k}: {v}" for k, v in comp.items()) + "}",
                  "  sites: 1", "  thermo:", "    model: NASA7",
                  "    temperature-ranges: [300.0, 1000.0, 3000.0]",
                  "    data:", f"    - {row}", f"    - {row}"]
    lines.append("reactions:")

    def stick(eq, gamma, extra=()):
        lines.extend([f"- equation: {eq}",
                      f"  sticking-coefficient: {{A: {gamma:.6e}, b: 0.0, "
                      f"Ea: 0.0}}", *extra])

    def arr(eq, A, b, Ea, extra=()):
        lines.extend([f"- equation: {eq}",
                      f"  rate-constant: {{A: {A:.6e}, b: {b:.4f}, "
                      f"Ea: {Ea:.4f}}}", *extra])

    def cov(sp, E, m=0.0):
        return ["  coverage-dependencies:",
                f"    {sp}: {{a: 0.0, m: {m}, E: {E:.4f}}}"]

    # adsorption (sticking coefficients)
    stick("h + pt(s) => h(s)", u(0.5, 1.0), cov("pt(s)", 0.0, -1.0))
    stick("o2 + 2 pt(s) => 2 o(s)", u(0.02, 0.08))
    stick("oh + pt(s) => oh(s)", u(0.5, 1.0))
    stick("h2o + pt(s) => h2o(s)", u(0.5, 0.9))
    stick("co + pt(s) => co(s)", u(0.5, 0.9))
    stick("co2 + pt(s) => co2(s)", u(0.005, 0.02))
    stick("ch2o + pt(s) => ch2o(s)", u(0.1, 0.5))
    stick("ho2 + pt(s) => ho2(s)", u(0.1, 0.5))
    # desorption (first order in the adsorbate, 1/s)
    arr("2 o(s) => o2 + 2 pt(s)", 10 ** u(20.5, 21.5), 0.0, u(200.0, 225.0),
        cov("o(s)", u(-70.0, -50.0)))
    arr("h2o(s) => h2o + pt(s)", 10 ** u(12.5, 13.5), 0.0, u(38.0, 42.0))
    arr("oh(s) => oh + pt(s)", 10 ** u(12.5, 13.5), 0.0, u(190.0, 200.0))
    arr("co(s) => co + pt(s)", 10 ** u(12.5, 13.5), 0.0, u(120.0, 130.0),
        cov("co(s)", u(-40.0, -25.0)))
    arr("co2(s) => co2 + pt(s)", 10 ** u(12.5, 13.5), 0.0, u(18.0, 22.0))
    arr("h(s) => h + pt(s)", 10 ** u(12.5, 13.5), 0.0, u(240.0, 260.0),
        cov("h(s)", u(-8.0, -4.0)))
    # surface reactions (cm^2/mol/s)
    arr("h(s) + o(s) <=> oh(s) + pt(s)", 10 ** u(21.0, 22.0), 0.0,
        u(10.0, 14.0))
    arr("h(s) + oh(s) <=> h2o(s) + pt(s)", 10 ** u(21.0, 22.0), 0.0,
        u(15.0, 19.0))
    arr("oh(s) + oh(s) <=> h2o(s) + o(s)", 10 ** u(21.0, 22.0), 0.0,
        u(46.0, 50.0))
    arr("co(s) + o(s) => co2(s) + pt(s)", 10 ** u(21.0, 22.0), 0.0,
        u(100.0, 110.0), cov("co(s)", u(-36.0, -30.0)))
    arr("c(s) + o(s) => co(s) + pt(s)", 10 ** u(21.0, 22.0), 0.0,
        u(60.0, 64.0))
    arr("co(s) + pt(s) => c(s) + o(s)", 10 ** u(17.5, 18.5), 0.0,
        u(180.0, 190.0))
    arr("ch2o(s) + pt(s) => hco(s) + h(s)", 10 ** u(20.5, 21.5), 0.0,
        u(20.0, 30.0))
    arr("hco(s) + pt(s) => co(s) + h(s)", 10 ** u(20.5, 21.5), 0.0,
        u(0.0, 10.0))
    arr("ho2(s) + pt(s) => o(s) + oh(s)", 10 ** u(20.5, 21.5), 0.0,
        u(10.0, 20.0))
    arr("o2(s) + pt(s) <=> o(s) + o(s)", 10 ** u(20.5, 21.5), 0.0,
        u(20.0, 30.0))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"species": len(names),
            "reactions": sum(l.startswith("- equation") for l in lines)}


def _yaml_flow(v) -> str:
    """v as one line of flow-style YAML that PyYAML reads back exactly:
    strings quoted, floats with a point and a signed exponent."""
    import json
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_yaml_flow(k)}: {_yaml_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_flow(x) for x in v) + "]"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return f"{v:.16e}"
    return json.dumps(str(v))


def _write_yaml(path, doc: dict) -> None:
    """Write a Cantera-format document: top-level keys in block style,
    one flow-style line per list entry."""
    lines = []
    for key, val in doc.items():
        if isinstance(val, list):
            lines.append(f"{key}:")
            lines += [f"- {_yaml_flow(x)}" for x in val]
        else:
            lines.append(f"{key}: {_yaml_flow(val)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# the seawater system of Harvie, Moller and Weare (1984): solutes as name,
# composition, standard state. HKFT constants are of the size SUPCRT92
# lists (g0, h0 cal/gmol; s0 cal/gmol/K; a1..a4, c1, c2, omega in its
# cal units); piecewise-Gibbs ions carry h0 kJ/mol and mu0 kJ/mol at
# 298.15 K on Cantera's absolute-entropy scale; CO2(aq) is Shomate
_BRINE_HKFT = {
    "Na+": ({"Na": 1, "E": -1}, -62591.0, -57433.0, 13.96,
            (0.1839, -228.5, 3.256, -27260.0), (18.18, -29810.0), 33060.0),
    "K+": ({"K": 1, "E": -1}, -67510.0, -60270.0, 24.15,
           (0.3559, -147.99, 5.435, -27120.0), (7.40, -17910.0), 19270.0),
    "Cl-": ({"Cl": 1, "E": 1}, -31379.0, -39933.0, 13.56,
            (0.4032, 480.1, 5.563, -28470.0), (-4.40, -57140.0), 145600.0),
    "Ca+2": ({"Ca": 1, "E": -2}, -132120.0, -129800.0, -13.5,
             (-0.01947, -725.2, 5.2966, -24792.0), (9.0, -25220.0),
             123660.0),
    "Mg+2": ({"Mg": 1, "E": -2}, -108505.0, -111367.0, -33.0,
             (-0.08217, -859.9, 8.39, -23900.0), (20.8, -58920.0),
             153720.0),
}
_BRINE_POLY = {
    "H+": ({"H": 1, "E": -1}, 0.0, 0.0, 0.0),
    "OH-": ({"O": 1, "H": 1, "E": 1}, -230.015, -226.76, -148.0),
    "SO4-2": ({"S": 1, "O": 4, "E": 2}, -909.34, -915.4, -293.0),
    "HCO3-": ({"H": 1, "C": 1, "O": 3, "E": 1}, -691.99, -719.2, -35.0),
    "CO3-2": ({"C": 1, "O": 3, "E": 2}, -677.14, -660.3, -290.0),
}
_BRINE_CO2AQ = ({"C": 1, "O": 2},
                [24.99735, 55.18696, -33.69137, 7.948387, -0.136638,
                 -423.9075, 132.0431])
_BRINE_NACL_S = [50.72389, 6.672267, -2.517167, 10.15934, -0.200675,
                 -427.2115, 130.3973]
_BRINE_STATE = {"Na+": 0.486, "K+": 0.0106, "Mg+2": 0.0547,
                "Ca+2": 0.0107, "Cl-": 0.566, "SO4-2": 0.0293,
                "HCO3-": 0.0018, "CO3-2": 0.0003, "CO2(aq)": 1e-5,
                "H+": 1e-8, "OH-": 1e-6}
BRINE_NACL_SPECIES = ["H2O(L)", "Na+", "Cl-", "H+", "OH-"]


def _synthetic_brine_yaml(path, *, seed: int) -> dict:
    """Write an HMW-electrolyte file at the width of the Harvie-Moller-
    Weare (1984) seawater model, Na-K-H-Ca-Mg-Cl-SO4-OH-HCO3-CO3-CO2-H2O
    (11 solutes and water), and return its counts. Its published Pitzer
    tables are not in the repository, so the interaction parameters come
    from `seed`, inside the ranges such tables hold: beta0, beta1, beta2
    and Cphi on every cation-anion pair in the complex-1 temperature model
    (the 2-2 pairs with alpha1 1.4, the rest 2.0; alpha2 12), theta on
    every like-sign pair (unequal charges among them, so E-theta acts),
    psi on every like-sign pair with each ion of the other sign, and
    A_Debye variable. Na-Cl keeps Pitzer's 25 C beta0 0.0765, beta1
    0.2664 and Cphi 0.00127, so that the NaCl brine saturates near its
    real 6 mol/kg. Standard states: IAPWS-95 water, HKFT for Na+, K+,
    Cl-, Ca+2 and Mg+2, piecewise-Gibbs (Mu0Poly) for H+, OH-, SO4-2,
    HCO3- and CO3-2, Shomate for CO2(aq). Phases: "seawater" (all 12
    species) and "NaCl-brine" (BRINE_NACL_SPECIES, the interactions among
    them); a fixed-stoichiometry "NaCl(S)" (halite, NIST Shomate)."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    R = 8314.46261815324

    def u(lo, hi):
        return float(rng.uniform(lo, hi))

    species = [{"name": "H2O(L)", "composition": {"H": 2, "O": 1},
                "thermo": {"model": "liquid-water-IAPWS95"},
                "equation-of-state": {"model": "liquid-water-IAPWS95"}}]
    for i, (name, (comp, g0, h0, s0, a, c, om)) in enumerate(
            _BRINE_HKFT.items()):
        # alternate bare cal numbers and strings with units
        unit = (lambda x, s: x) if i % 2 else (lambda x, s: f"{x} {s}")
        species.append({"name": name, "composition": comp,
                        "equation-of-state": {
                            "model": "HKFT", "g0": unit(g0, "cal/gmol"),
                            "h0": unit(h0, "cal/gmol"),
                            "s0": unit(s0, "cal/gmol/K"),
                            "a": [unit(a[0], "cal/gmol/bar"),
                                  unit(a[1], "cal/gmol"),
                                  unit(a[2], "cal*K/gmol/bar"),
                                  unit(a[3], "cal*K/gmol")],
                            "c": [unit(c[0], "cal/gmol/K"),
                                  unit(c[1], "cal*K/gmol")],
                            "omega": unit(om, "cal/gmol")}})
    knots = (273.15, 298.15, 323.15, 373.15, 423.15, 473.15)
    for i, (name, (comp, h0, mu298, cp)) in enumerate(_BRINE_POLY.items()):
        # mu0(T) of a constant cp through (298.15 K, mu298), on the knots
        s = (h0 - mu298) * 1e6 / 298.15
        mu = [(h0 * 1e6 + cp * 1e3 * (T - 298.15) - T * (
            s + cp * 1e3 * np.log(T / 298.15))) for T in knots]
        dimless = i % 2 == 0
        data = {T: (m / (R * T) if dimless else m) for T, m in
                zip(knots, mu)}
        species.append({"name": name, "composition": comp,
                        "thermo": {"model": "piecewise-Gibbs",
                                   "h0": f"{h0} kJ/mol",
                                   "dimensionless": dimless, "data": data},
                        "equation-of-state": {
                            "model": "constant-volume",
                            "molar-volume": u(0.005, 0.03)}})
    species.append({"name": "CO2(aq)", "composition": _BRINE_CO2AQ[0],
                    "thermo": {"model": "Shomate",
                               "temperature-ranges": [273.15, 1200.0],
                               "data": [_BRINE_CO2AQ[1]]},
                    "equation-of-state": {"model": "constant-volume",
                                          "molar-volume": 0.0325}})
    names = [s["name"] for s in species]
    z = {s["name"]: -s["composition"].get("E", 0) for s in species}
    cations = [n for n in names if z[n] > 0]
    anions = [n for n in names if z[n] < 0]

    def coeff5(base, scale):
        return [base, u(-1, 1) * 1e-3 * scale, u(-1, 1) * 1e-6 * scale,
                u(-1, 1) * 10.0 * scale, u(-1, 1) * 1e-2 * scale]

    inter = []
    for c_, a_ in itertools.product(cations, anions):
        two_two = abs(z[c_] * z[a_]) == 4
        if (c_, a_) == ("Na+", "Cl-"):
            b0, b1, cphi = 0.0765, 0.2664, 0.00127
        else:
            b0, b1, cphi = u(-0.1, 0.4), u(0.0, 3.5 if two_two else 1.5), \
                u(-0.05, 0.05)
        inter.append({"species": [c_, a_],
                      "beta0": coeff5(b0, 1.0), "beta1": coeff5(b1, 1.0),
                      "beta2": coeff5(u(-60.0, -1.0) if two_two
                                      else u(-1.0, 0.0), 1.0),
                      "Cphi": coeff5(cphi, 0.1),
                      "alpha1": 1.4 if two_two else 2.0, "alpha2": 12.0})
    for group, other in ((cations, anions), (anions, cations)):
        for p, q in itertools.combinations(group, 2):
            inter.append({"species": [p, q],
                          "theta": coeff5(u(-0.1, 0.1), 0.1)})
            for o in other:
                inter.append({"species": [p, q, o],
                              "psi": u(-0.02, 0.02)})
    nacl = [it for it in inter
            if set(it["species"]) <= set(BRINE_NACL_SPECIES)]
    phases = [{"name": "seawater", "thermo": "HMW-electrolyte",
               "elements": ["O", "H", "C", "S", "Cl", "Na", "K", "Mg",
                            "Ca", "E"],
               "species": [{"species-brine": names}],
               "state": {"T": 298.15, "P": 101325.0,
                         "molalities": _BRINE_STATE},
               "activity-data": {"temperature-model": "complex",
                                 "A_Debye": "variable",
                                 "interactions": inter}},
              {"name": "NaCl-brine", "thermo": "HMW-electrolyte",
               "elements": ["O", "H", "Cl", "Na", "E"],
               "species": [{"species-brine": BRINE_NACL_SPECIES}],
               "state": {"T": 298.15, "P": 101325.0,
                         "molalities": {"Na+": 6.0, "Cl-": 6.0,
                                        "H+": 1e-7, "OH-": 1e-7}},
               "activity-data": {"temperature-model": "complex",
                                 "A_Debye": "variable",
                                 "interactions": nacl}},
              {"name": "NaCl(S)", "thermo": "fixed-stoichiometry",
               "species": [{"species-solid": ["NaCl(S)"]}]}]
    solid = [{"name": "NaCl(S)", "composition": {"Na": 1, "Cl": 1},
              "thermo": {"model": "Shomate",
                         "temperature-ranges": [250.0, 1075.0],
                         "data": [_BRINE_NACL_S]},
              "equation-of-state": {"model": "constant-volume",
                                    "density": "2.165 g/cm^3"}}]
    _write_yaml(path, {"description": f"Synthetic HMW seawater (seed "
                                      f"{seed}), see chip_smoke."
                                      f"_synthetic_brine_yaml.",
                       "phases": phases, "species-brine": species,
                       "species-solid": solid})
    return {"species": len(names), "solutes": len(names) - 1,
            "interactions": len(inter), "nacl_interactions": len(nacl)}


# NASA7 rows (GRI-Mech 3.0 for N2, O2, H2O and O; Cantera's
# oxygen-plasma electron; O2+ and O- as O2 and O with their heats of
# formation) and temperature ranges
_NASA_N2 = ([300.0, 1000.0, 5000.0],
            [[3.298677, 1.4082404e-3, -3.963222e-6, 5.641515e-9,
              -2.444854e-12, -1020.8999, 3.950372],
             [2.92664, 1.4879768e-3, -5.68476e-7, 1.0097038e-10,
              -6.753351e-15, -922.7977, 5.980528]])
_NASA_O2 = ([200.0, 1000.0, 3500.0],
            [[3.78245636, -2.99673416e-3, 9.84730201e-6, -9.68129509e-9,
              3.24372837e-12, -1063.94356, 3.65767573],
             [3.28253784, 1.48308754e-3, -7.57966669e-7, 2.09470555e-10,
              -2.16717794e-14, -1088.45772, 5.45323129]])
_NASA_H2O = ([200.0, 1000.0, 3500.0],
             [[4.19864056, -2.0364341e-3, 6.52040211e-6, -5.48797062e-9,
               1.77197817e-12, -30293.7267, -0.849032208],
              [3.03399249, 2.17691804e-3, -1.64072518e-7, -9.7041987e-11,
               1.68200992e-14, -30004.2971, 4.9667701]])
_NASA_O = ([200.0, 1000.0, 3500.0],
           [[3.1682671, -3.27931884e-3, 6.64306396e-6, -6.12806624e-9,
             2.11265971e-12, 29122.2592, 2.05193346],
            [2.56942078, -8.59741137e-5, 4.19484589e-8, -1.00177799e-11,
             1.22833691e-15, 29217.5791, 4.78433864]])
_NASA_E = ([200.0, 1000.0, 6000.0],
           [[2.5, 0.0, 0.0, 0.0, 0.0, -745.375, -11.72]] * 2)


def _shifted(nasa, da5):
    tr, rows = nasa
    return tr, [r[:5] + [r[5] + da5, r[6]] for r in rows]


def _nasa(tr_rows) -> dict:
    tr, rows = tr_rows
    return {"model": "NASA7", "temperature-ranges": tr, "data": rows}


PLASMA_LEVELS = 1000
PLASMA_PHASES = {"plasma-maxwell": 1.0, "plasma-druyvesteyn": 2.0,
                 "plasma-discretized": None}
DH_PHASES = ("dh-dilute", "dh-bdot-ak", "dh-bdot-a", "dh-beta",
             "dh-pitzer")
CONDENSED_PHASES = ("ideal-solid", "lattice", "margules", "redlich-kister",
                    "tabulated", "maskell", "compound-lattice",
                    "ions-from-neutral", "ideal-molal", "electron-cloud",
                    "stoich-sub")


def _phase_models_yaml(path) -> dict:
    """Write the phase-model inputs that have no data file in the
    repository, in one Cantera-format file, and return its phase names:
    the five Debye-Huckel forms on a six-species NaCl phase (H2O(L), Na+,
    Cl-, H+, OH-, NaCl(aq); DH_PHASES), one phase of each condensed family
    (CONDENSED_PHASES: ideal-solid, lattice, Margules, Redlich-Kister,
    tabulated binary, Maskell, compound lattice over a lattice and a
    stoichiometric sublattice, ions from a neutral Margules melt, ideal
    molal, electron cloud), an oxygen-plasma-shaped phase (e, O2, O2+, O,
    O-) with isotropic distributions of shape factor 1 and 2 and a
    discretized one, each on PLASMA_LEVELS energy levels
    (PLASMA_PHASES), and the ideal gas "air-water" (N2, O2, H2O; GRI-Mech
    3.0 thermo). Parameters are of the sizes Cantera's own test inputs
    use (test/data/thermo-models.yaml and debye-huckel-all.yaml, which are
    not in the repository)."""
    import numpy as np

    def cc(T0, h0, s0, cp0):
        return {"model": "constant-cp", "T0": T0, "h0": h0, "s0": s0,
                "cp0": cp0}

    dh_species = [
        {"name": "H2O(L)", "composition": {"H": 2, "O": 1},
         "thermo": cc(298.15, "-241.826 kJ/mol", "188.835 J/mol/K",
                      "75.3 J/mol/K")},
        {"name": "Na+", "composition": {"Na": 1, "E": -1},
         "Debye-Huckel": {"ionic-radius": "4.0 angstrom"}},
        {"name": "Cl-", "composition": {"Cl": 1, "E": 1},
         "Debye-Huckel": {"ionic-radius": "3.0 angstrom"}},
        {"name": "H+", "composition": {"H": 1, "E": -1},
         "Debye-Huckel": {"ionic-radius": "9.0 angstrom"}},
        {"name": "OH-", "composition": {"O": 1, "H": 1, "E": 1},
         "Debye-Huckel": {"ionic-radius": "3.5 angstrom"}},
        {"name": "NaCl(aq)", "composition": {"Na": 1, "Cl": 1},
         "Debye-Huckel": {"weak-acid-charge": -1.0,
                          "electrolyte-species-type":
                              "weak-acid-associated"}}]
    betas = [{"species": ["Na+", "Cl-"], "beta": 0.0410},
             {"species": ["H+", "Cl-"], "beta": 0.0},
             {"species": ["Na+", "OH-"], "beta": 0.06}]
    common = {"A_Debye": 1.172576, "B_Debye": 3.2864e9,
              "default-ionic-radius": "3.042843 angstrom"}
    dh_data = {
        "dh-dilute": {"model": "dilute-limit", **common},
        "dh-bdot-ak": {"model": "B-dot-with-variable-a", "B-dot": 0.0410,
                       "max-ionic-strength": 30.0,
                       "use-Helgeson-fixed-form": True, **common},
        "dh-bdot-a": {"model": "B-dot-with-common-a", "B-dot": 0.0410,
                      **common},
        "dh-beta": {"model": "beta_ij", "beta": betas, **common},
        "dh-pitzer": {"model": "Pitzer-with-beta_ij", "beta": betas,
                      **common}}
    phases = [{"name": n, "thermo": "Debye-Huckel",
               "species": [{"dh-species": "all"}],
               "activity-data": dh_data[n]} for n in DH_PHASES]

    vol = {"model": "constant-volume"}
    cond = [
        {"name": "A(s)", "composition": {"Li": 1},
         "thermo": {"model": "NASA7",
                    "temperature-ranges": [200.0, 600.0, 1500.0],
                    "data": [[2.8, 2.0e-3, -1.0e-6, 2.0e-10, 0.0, -900.0,
                              -12.0],
                             [3.1, 1.0e-3, -3.0e-7, 4.0e-11, 0.0, -980.0,
                              -13.5]]},
         "equation-of-state": {**vol, "molar-volume": "13.0 cm^3/gmol"}},
        {"name": "B(s)", "composition": {"Fe": 1},
         "thermo": cc(298.15, "-20.0 kJ/mol", "30.0 J/mol/K",
                      "25.0 J/mol/K"),
         "equation-of-state": {"model": "density-temperature-polynomial",
                               "units": {"mass": "g", "length": "cm"},
                               "data": [7.9, -2.0e-4, 1.0e-8, 0.0]}},
        {"name": "C(s)", "composition": {"Li": 1, "Fe": 1},
         "thermo": {"model": "Shomate",
                    "temperature-ranges": [250.0, 700.0, 1500.0],
                    "data": [[45.0, 10.0, -3.0, 1.0, -0.3, -120.0, 90.0],
                             [50.0, 5.0, -1.0, 0.2, -0.8, -122.0, 95.0]]},
         "equation-of-state": {**vol, "molar-density": "0.07 mol/cm^3"}},
        {"name": "L1(s)", "composition": {"Li": 1},
         "thermo": cc(298.15, "-5.0 kJ/mol", "20.0 J/mol/K",
                      "22.0 J/mol/K")},
        {"name": "L2(s)", "composition": {"Li": 1, "H": 1},
         "thermo": cc(298.15, "-90.0 kJ/mol", "25.0 J/mol/K",
                      "30.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "11.0 cm^3/gmol"}},
        {"name": "S1(s)", "composition": {"Fe": 1, "O": 1},
         "thermo": cc(298.15, "-272.0 kJ/mol", "60.75 J/mol/K",
                      "49.9 J/mol/K"),
         "equation-of-state": {**vol, "density": "5.7 g/cm^3"}},
        {"name": "KCl(L)", "composition": {"K": 1, "Cl": 1},
         "thermo": cc(298.15, "-421.81 kJ/mol", "86.52 J/mol/K",
                      "73.6 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "37.57 cm^3/gmol"}},
        {"name": "LiCl(L)", "composition": {"Li": 1, "Cl": 1},
         "thermo": cc(298.15, "-391.0 kJ/mol", "74.2 J/mol/K",
                      "62.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "20.34 cm^3/gmol"}},
        {"name": "LiC6", "composition": {"Li": 1, "C": 6},
         "thermo": cc(298.15, "-11.65 kJ/mol", "0.0 J/mol/K",
                      "0.0 J/mol/K"),
         "equation-of-state": {**vol, "density": "2.2 g/cm^3"}},
        {"name": "V6", "composition": {"C": 6},
         "thermo": cc(298.15, "0.0 kJ/mol", "0.0 J/mol/K", "0.0 J/mol/K"),
         "equation-of-state": {**vol, "density": "2.26 g/cm^3"}},
        {"name": "H(s)", "composition": {"H": 1},
         "thermo": cc(298.15, "0.0 J/mol", "0.0 J/mol/K", "0.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "0.005 m^3/kmol"}},
        {"name": "He(s)", "composition": {"He": 1},
         "thermo": cc(298.15, "1000.0 J/mol", "2.0 J/mol/K",
                      "0.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "0.01 m^3/kmol"}},
        {"name": "H2O(l)", "composition": {"H": 2, "O": 1},
         "thermo": cc(298.15, "-285.83 kJ/mol", "69.95 J/mol/K",
                      "75.33 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "0.018068 m^3/kmol"}},
        {"name": "CH4(aq)", "composition": {"C": 1, "H": 4},
         "thermo": cc(298.15, "-89.04 kJ/mol", "83.7 J/mol/K",
                      "277.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "0.0371 m^3/kmol"}},
        {"name": "H2S(aq)", "composition": {"H": 2, "S": 1},
         "thermo": cc(298.15, "-39.75 kJ/mol", "121.0 J/mol/K",
                      "180.0 J/mol/K"),
         "equation-of-state": {**vol, "molar-volume": "0.0349 m^3/kmol"}},
        {"name": "electron", "composition": {"E": 1},
         "thermo": cc(298.15, 0.0, 0.0, 0.0)}]
    ions = [{"name": "Li+", "composition": {"Li": 1, "E": -1}},
            {"name": "K+", "composition": {"K": 1, "E": -1}},
            {"name": "Cl-", "composition": {"Cl": 1, "E": 1}}]
    xs = np.linspace(0.0, 1.0, 11)
    phases += [
        {"name": "ideal-solid", "thermo": "ideal-condensed",
         "species": [{"condensed-species": ["A(s)", "B(s)", "C(s)"]}],
         "standard-concentration-basis": "unity"},
        {"name": "lattice", "thermo": "lattice",
         "species": [{"condensed-species": ["L1(s)", "L2(s)"]}],
         "site-density": "0.073 mol/cm^3"},
        {"name": "stoich-sub", "thermo": "fixed-stoichiometry",
         "species": [{"condensed-species": ["S1(s)"]}]},
        {"name": "margules", "thermo": "Margules",
         "species": [{"condensed-species": ["KCl(L)", "LiCl(L)"]}],
         "units": {"energy": "J", "quantity": "mol"},
         "interactions": [{"species": ["KCl(L)", "LiCl(L)"],
                           "excess-enthalpy": [-17570.0, -377.0],
                           "excess-entropy": [-7.627, "4.958 J/mol/K"]}]},
        {"name": "redlich-kister", "thermo": "Redlich-Kister",
         "species": [{"condensed-species": ["LiC6", "V6"]}],
         "units": {"energy": "J", "quantity": "mol"},
         "interactions": [{"species": ["LiC6", "V6"],
                           "excess-enthalpy": [-3268.6, 3955.4, -4573.0,
                                               6147.7, "-3339.2 J/mol"],
                           "excess-entropy": [0.0, 1.5]}]},
        {"name": "tabulated", "thermo": "binary-solution-tabulated",
         "species": [{"condensed-species": ["LiC6", "V6"]}],
         "tabulated-species": "LiC6",
         "units": {"energy": "J", "quantity": "mol"},
         "tabulated-thermo": {
             "mole-fractions": xs.tolist(),
             "enthalpy": (-1.2e4 * xs + 3.0e3 * np.sin(3.0 * xs)).tolist(),
             "entropy": (4.0 * np.cos(2.0 * xs)).tolist()}},
        {"name": "maskell", "thermo": "Maskell-solid-solution",
         "species": [{"condensed-species": ["H(s)", "He(s)"]}],
         "excess-enthalpy": "5.0 J/mol", "product-species": "H(s)"},
        {"name": "compound-lattice", "thermo": "compound-lattice",
         "composition": {"lattice": 1.0, "stoich-sub": 2.0}},
        {"name": "ions-from-neutral",
         "thermo": "ions-from-neutral-molecule",
         "neutral-phase": "margules",
         "species": [{"ion-species": ["Li+", "K+", "Cl-"]}]},
        {"name": "ideal-molal", "thermo": "ideal-molal-solution",
         "species": [{"condensed-species": ["H2O(l)", "CH4(aq)",
                                            "H2S(aq)"]}]},
        {"name": "electron-cloud", "thermo": "electron-cloud",
         "density": "9.0 g/cm^3",
         "species": [{"condensed-species": ["electron"]}]}]

    plasma = [
        {"name": "e", "composition": {"E": 1}, "thermo": _nasa(_NASA_E)},
        {"name": "O2", "composition": {"O": 2}, "thermo": _nasa(_NASA_O2)},
        {"name": "O2+", "composition": {"O": 2, "E": -1},
         "thermo": _nasa(_shifted(_NASA_O2, 140114.0))},
        {"name": "O", "composition": {"O": 1}, "thermo": _nasa(_NASA_O)},
        {"name": "O-", "composition": {"O": 1, "E": 1},
         "thermo": _nasa(_shifted(_NASA_O, -17750.0))}]
    levels = np.linspace(0.0, 20.0, PLASMA_LEVELS)
    for name, x in PLASMA_PHASES.items():
        if x is None:
            eedf = {"type": "discretized",
                    "energy-levels": levels.tolist(),
                    "distribution": (np.exp(-levels / 1.5)
                                     * (1.0 + 0.1 * np.sin(levels))
                                     ).tolist(),
                    "normalize": True}
        else:
            eedf = {"type": "isotropic", "shape-factor": x,
                    "mean-electron-energy": f"{1.5 * x} eV",
                    "energy-levels": levels.tolist()}
        phases.append({"name": name, "thermo": "plasma",
                       "elements": ["O", "E"],
                       "species": [{"plasma-species": "all"}],
                       "kinetics": "gas",
                       "electron-energy-distribution": eedf})
    gas = [{"name": "N2", "composition": {"N": 2}, "thermo": _nasa(_NASA_N2)},
           {"name": "O2", "composition": {"O": 2}, "thermo": _nasa(_NASA_O2)},
           {"name": "H2O", "composition": {"H": 2, "O": 1},
            "thermo": _nasa(_NASA_H2O)}]
    phases.append({"name": "air-water", "thermo": "ideal-gas",
                   "elements": ["O", "H", "N"],
                   "species": [{"gas-species": "all"}],
                   "state": {"T": 298.15, "P": 101325.0}})
    _write_yaml(path, {"description": "Phase-model inputs, see "
                                      "chip_smoke._phase_models_yaml.",
                       "phases": phases, "dh-species": dh_species,
                       "condensed-species": cond, "ion-species": ions,
                       "plasma-species": plasma, "gas-species": gas})
    return {"dh": DH_PHASES, "condensed": CONDENSED_PHASES,
            "plasma": tuple(PLASMA_PHASES), "gas": "air-water"}


def _erdos_renyi(n: int, avg_deg: int, seed: int):
    """Uniform random n x n with n * avg_deg entries drawn as COO pairs
    (duplicates summed), f32 values in [0, 1)."""
    import numpy as np
    import scipy.sparse as sp
    r = np.random.RandomState(seed)
    nnz = n * avg_deg
    return sp.coo_matrix(
        (r.rand(nnz).astype(np.float32),
         (r.randint(0, n, nnz), r.randint(0, n, nnz))),
        shape=(n, n)).tocsr()


def _fem_stiffness(model):
    """The assembled CitcomS velocity stiffness K of `model` at its initial
    temperature, f32 CSR (bench.py's `_fem_stiffness_matrix`, the mm
    corpus's real-structure member): 3 dofs per node, the 24x24 element
    blocks scattered through the incidence."""
    import numpy as np
    import scipy.sparse as sp
    elt_k = model._build_ops(model.init_state().T).elt_k.cpu().numpy()
    ien = model.mesh.ien.astype(np.int64)
    dofs = (ien[:, :, None] * 3 + np.arange(3)).reshape(-1, 24)
    rows = np.repeat(dofs, 24, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, 24)).reshape(-1)
    n3 = model.mesh.nno * 3
    k = sp.coo_matrix((elt_k.reshape(-1), (rows, cols)),
                      shape=(n3, n3)).tocsr()
    k.sum_duplicates()
    k.eliminate_zeros()
    return k.astype(np.float32)


def _cookbook2(model, steps: int, blessed: dict, keys, tol: float,
               after: int = 0):
    """`steps` timed steps of `model` after its initial solve and `after`
    untimed steps; returns the state after the initial solve, the last
    state, per-step diagnostics and the largest relative error of each of
    `keys` against the blessed f64 trajectory over every step taken, which
    must stay within `tol`, and `trace`: each step's vrms, nu_top, nu_bot,
    dt, T_mean and Uzawa/CG counts, as exact values, for the determinism
    check. Observables are read after the timed loop."""
    import torch
    from g4s_tpu_torch.models.citcoms import solvers
    from g4s_tpu_torch.models.citcoms.observables import (rms_velocity,
                                                          surface_heat_flux)
    s0, _ = model.initial_solve(model.init_state())
    s, kept = s0, []
    for _ in range(after):
        s, d = model.step(s)
        kept.append((s, d))
    torch.cuda.synchronize()
    solvers.HOST_SYNCS = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        s, d = model.step(s)
        kept.append((s, d))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    syncs = solvers.HOST_SYNCS / steps
    err = {k: 0.0 for k in keys}
    counts, per_step, trace = [], [], []
    for i, (s_i, d_i) in enumerate(kept):
        got = {"vrms": rms_velocity(model, s_i.V),
               "nu_top": surface_heat_flux(model, s_i.T, top=True)[1],
               "nu_bot": surface_heat_flux(model, s_i.T, top=False)[1],
               "dt": d_i.dt, "T_mean": s_i.T.mean()}
        e_i = {k: abs(float(got[k]) - blessed[k][i]) / abs(blessed[k][i])
               for k in keys}
        err = {k: max(err[k], e_i[k]) for k in keys}
        per_step.append(f"{max(e_i.values()):.2g}")
        counts.append(f"{d_i.uzawa_iterations}/{d_i.inner_iterations}")
        trace.append(tuple(float(v) for v in got.values())
                     + (d_i.uzawa_iterations, d_i.inner_iterations))
    _check(all(v <= tol for v in err.values()),
           f"Cookbook2 {model.dtype} against the blessed trajectory: {err} "
           f"(Uzawa/CG per step {counts})")
    timed = [d for _, d in kept[after:]]
    return {"s0": s0, "s": s, "wall_s": wall, "host_syncs": syncs, "err": err,
            "counts": counts, "per_step_err": per_step, "trace": trace,
            "inner": sum(d.inner_iterations for d in timed) / steps}


def _deepmd_flops(spec, n_atoms: int) -> dict:
    """Floating-point operations of one E+F+W eval of the se_e2_a model as
    the port computes it: the dense products only (the embedding and
    fitting layers' matmuls and the two descriptor contractions, 2 per
    multiply-add), for every center type on every atom as the reference
    does. The backward pass to the coordinates and the strain needs no
    weight gradients: a layer's product costs its forward's once more,
    the contractions (both operands depend on the coordinates) twice."""
    nt, nnei = spec.descriptor.ntypes, spec.descriptor.nnei
    m1, m2 = spec.m1, spec.axis_neuron
    dims = [1] + list(spec.embed_neurons)
    embed = nt * n_atoms * nnei * 2 * sum(a * b for a, b in
                                          zip(dims, dims[1:]))
    contract = nt * n_atoms * (nnei * 4 * m1 + 4 * m1 * m2) * 2
    dims = [spec.descriptor_dim] + list(spec.fit_neurons) + [1]
    fit = nt * n_atoms * 2 * sum(a * b for a, b in zip(dims, dims[1:]))
    total = 2 * (embed + fit) + 3 * contract
    return {"forward": embed + contract + fit, "total": total,
            # each atom's own center type only: what the reference's
            # compute-both-then-select pattern spends twice
            "own_type_only": total // nt}


def _deepmd_water(dev) -> None:
    """Phase 10: the DeePMD se_e2_a serving path at the flagship water width
    (WATER_SPEC; __graft_entry__.py's 192-atom frame: 64 O, 128 H, box
    12.444661 A, coordinates from default_rng(0); weights from a seeded
    CPU torch.Generator moved to the card). f64 checks, card against host
    CPU, each within its tolerance relative to the largest magnitude; then
    f32 timings."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.models.deepmd import (WATER_SPEC, DeepPot,
                                             energy_force_virial, freeze,
                                             init_params, total_energy)
    from g4s_tpu_torch.models.deepmd.compress import (
        compress_model, compressed_to, energy_force_compressed)
    from g4s_tpu_torch.models.deepmd.descriptor import (env_mat,
                                                        normalize_env_mat)
    from g4s_tpu_torch.models.deepmd.md import NVTIntegrator, init_velocities
    from g4s_tpu_torch.models.deepmd.model import map_tree, params_to
    from g4s_tpu_torch.obs.timings import device_activities, device_ms
    from g4s_tpu_torch.ops import bwell_spmv, route, wsell_spmv

    cpu = torch.device("cpu")
    spec = WATER_SPEC
    rng = np.random.default_rng(0)
    n = 192
    types_np = np.concatenate([np.zeros(64, np.int64), np.ones(128, np.int64)])
    L = 12.444661
    coord_np = rng.uniform(0, L, size=(n, 3))
    box_np = np.eye(3) * L
    params = init_params(torch.Generator().manual_seed(1), spec)
    launch_mods = (route, wsell_spmv, bwell_spmv)
    for mod in launch_mods:
        mod.LAUNCHES = 0

    def on(device, dtype=torch.float64):
        return (params_to(params, device=device, dtype=dtype),
                torch.as_tensor(coord_np, dtype=dtype, device=device),
                torch.as_tensor(box_np, dtype=dtype, device=device),
                torch.as_tensor(types_np, device=device))

    def rel(got, want) -> float:
        return _rel_err(got.detach().cpu().double(),
                        want.detach().cpu().double())

    # ---- f64: the card against the host CPU ----
    pg, cg, bg, tg = on(dev)
    ph, ch, bh, th = on(cpu)
    t0 = time.perf_counter()
    want = energy_force_virial(ph, spec, ch, bh, th)
    host_s = time.perf_counter() - t0
    got = energy_force_virial(pg, spec, cg, bg, tg)
    efv_err = {k: rel(g, w) for k, g, w in zip("EFW", got, want)}
    _check(all(v <= DEEPMD_F64_TOL for v in efv_err.values()),
           f"DeePMD E/F/W f64, card against host CPU: {efv_err}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frozen_model.npz")
        freeze(params, spec, path, type_map=["O", "H"])
        pot = DeepPot(path, device=dev)
        pot32 = DeepPot(path, device=dev, dtype=torch.float32)
    frozen = pot.eval(coord_np, box_np, types_np)
    frozen_err = {k: rel(g, w) for k, g, w in zip("EFW", frozen, got)}
    _check(all(v <= DEEPMD_F64_TOL for v in frozen_err.values()),
           f"DeepPot through a frozen file against energy_force_virial: "
           f"{frozen_err}")
    nb = 8
    cb_np = coord_np[None] + np.random.default_rng(1).normal(
        scale=0.05, size=(nb, n, 3))
    bb_np = np.repeat(box_np[None], nb, axis=0)
    batch = pot.eval(cb_np, bb_np, types_np)
    batch_err = 0.0
    for i in range(nb):
        one = pot.eval(cb_np[i], box_np, types_np)
        batch_err = max([batch_err] + [rel(b[i], o) for b, o in
                                       zip(batch, one)])
    _check(batch_err <= DEEPMD_F64_TOL,
           f"DeepPot batch of {nb} against {nb} single calls: {batch_err}")
    _say("10-deepmd-f64", atoms=n, spec="WATER_SPEC",
         e=f"{float(got[0]):.10g}",
         rel_err_card_vs_host=json.dumps(
             {k: f"{v:.3g}" for k, v in efv_err.items()}).replace(" ", ""),
         frozen_deeppot_rel_err=f"{max(frozen_err.values()):.3g}",
         batch8_vs_single_rel_err=f"{batch_err:.3g}", tol=DEEPMD_F64_TOL,
         host_cpu_eval_s=f"{host_s:.3f}")

    # ---- 20 NVT steps, f64, the card against the host CPU ----
    masses = np.where(types_np == 0, 16.0, 2.0)
    v0 = init_velocities(np.random.default_rng(23456789), masses, 330.0)
    finals = []
    for p_, b_, t_, device in ((pg, bg, tg, dev), (ph, bh, th, cpu)):
        integ = NVTIntegrator(
            lambda x, p_=p_, b_=b_, t_=t_: energy_force_virial(
                p_, spec, x, b_, t_)[1], masses, box_np, device=device)
        state, _ = integ.run(coord_np, v0, 20, verbose=False)
        finals.append(state)
    md_err = {k: rel(getattr(finals[0], k), getattr(finals[1], k))
              for k in ("x", "v")}
    _check(all(v <= DEEPMD_MD_TOL for v in md_err.values()),
           f"20 NVT steps f64, card against host CPU: {md_err}")
    _say("10-deepmd-nvt-f64", steps=20, dt_ps=0.0005, T0=330.0,
         rel_err_card_vs_host=json.dumps(
             {k: f"{v:.3g}" for k, v in md_err.items()}).replace(" ", ""),
         tol=DEEPMD_MD_TOL,
         final_T=f"{float(integ.temperature(finals[1].v)):.2f}")

    # ---- the compressed model, f64 tables at stride 0.005 over this
    # frame's own normalised s(r) ----
    R, _ = env_mat(ch, bh, th, spec.descriptor)
    s_in = normalize_env_mat(R, th, ph["stats"]["davg"],
                             ph["stats"]["dstd"])[..., 0]
    cms = [compress_model(p_, spec, stride=0.005, sample_inputs=s_in)
           for p_ in (pg, ph)]
    comp = [energy_force_compressed(cm, c_, b_, t_) for cm, c_, b_, t_ in
            zip(cms, (cg, ch), (bg, bh), (tg, th))]
    comp_err = {k: rel(g, w) for k, g, w in zip("EF", comp[0], comp[1])}
    _check(all(v <= DEEPMD_F64_TOL for v in comp_err.values()),
           f"compressed model f64, card against host CPU: {comp_err}")
    table = cms[1].tables[0][0]
    upper = table.lower + table.stride * table.n_intervals
    e_exact = abs(float(want[0]))
    _say("10-deepmd-compressed-f64", stride=0.005,
         table=f"[{table.lower:.3f},{upper:.3f}]x{table.n_intervals}",
         rel_err_card_vs_host=json.dumps(
             {k: f"{v:.3g}" for k, v in comp_err.items()}).replace(" ", ""),
         tol=DEEPMD_F64_TOL,
         vs_exact_e_rel=f"{abs(float(comp[1][0] - want[0])) / e_exact:.3g}",
         vs_exact_f_abs=f"{float((comp[1][1] - want[1]).abs().max()):.3g}")

    # ---- f32 timings on the card ----
    p32, c32, b32, t32 = on(dev, torch.float32)
    cb32 = torch.as_tensor(cb_np, dtype=torch.float32, device=dev)
    bb32 = torch.as_tensor(bb_np, dtype=torch.float32, device=dev)
    e32 = energy_force_virial(p32, spec, c32, b32, t32)
    err32 = {k: rel(g, w) for k, g, w in zip("EFW", e32, want)}
    _check(all(v <= DEEPMD_F32_TOL for v in err32.values()),
           f"DeePMD E/F/W f32 on the card against f64: {err32}")

    def single():
        return energy_force_virial(p32, spec, c32, b32, t32)

    @torch.no_grad()
    def forward():
        return total_energy(p32, spec, c32, b32, t32)

    def batched():
        return energy_force_virial(p32, spec, cb32, bb32, t32)

    cm32 = compressed_to(cms[0], dtype=torch.float32)

    def compressed():
        return energy_force_compressed(cm32, c32, b32, t32)

    def pot_eval():
        return pot32.eval(coord_np, box_np, types_np)

    flops = _deepmd_flops(spec, n)
    # weights and coordinates read once, E/F/W written once (f32)
    leaves = []
    map_tree(leaves.append, p32)
    n_weights = sum(x.numel() for x in leaves)
    bound = _bound(4.0 * (n_weights + 2 * n * 3 + 10), flops["total"])
    bound_b = _bound(4.0 * (n_weights + nb * (2 * n * 3 + 10)),
                     nb * flops["total"])
    bound_f = _bound(4.0 * (n_weights + n * 3 + 10), flops["forward"])
    out = {}
    for name, fn in (("eval", single), ("forward-only", forward),
                     ("batch8", batched), ("compressed", compressed),
                     ("deeppot", pot_eval)):
        # one call per timing: a call launches hundreds of kernels, more
        # than the device's launch queue lets the host run ahead by twice.
        # DeepPot.eval copies its host arrays in, which waits on the
        # device: it has no device time apart from its wall time
        dms = float("nan") if fn is pot_eval else statistics.median(
            device_ms(fn, device=dev, reps=1) for _ in range(9))
        wall = _wall_ms(fn, reps=20)
        acts = device_activities(fn)
        busy = sum(us for _, us in acts) / 1e3
        out[name] = (dms, wall, len(acts), busy)
    for name, (dms, wall, kern, busy) in out.items():
        b_ms, b_by = {"batch8": bound_b, "forward-only": bound_f}.get(
            name, bound)
        _say(f"10-deepmd-{name}-f32", frames=nb if name == "batch8" else 1,
             device_ms=f"{dms:.4f}", host_wall_ms=f"{wall:.4f}",
             device_kernels=kern, device_busy_ms=f"{busy:.4f}",
             device_idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
             bound_ms=f"{b_ms:.4f}", bound_by=b_by,
             share_of_bound=f"{b_ms / dms:.4f}")
    integ = NVTIntegrator(lambda x: energy_force_virial(
        p32, spec, x, b32, t32)[1], masses, box_np, device=dev,
        dtype=torch.float32)
    state, f = integ.initial_state(coord_np, v0)
    for _ in range(5):
        state, f = integ.step(state, f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        state, f = integ.step(state, f)
    torch.cuda.synchronize()
    md_ms = (time.perf_counter() - t0) / 100 * 1e3
    _check(bool(torch.isfinite(state.x).all() and torch.isfinite(f).all()),
           "f32 NVT state not finite")
    step_acts = device_activities(lambda: integ.step(state, f))
    step_busy = sum(us for _, us in step_acts) / 1e3
    _say("10-deepmd-md-f32", steps=100, ms_per_step=f"{md_ms:.4f}",
         device_kernels_per_step=len(step_acts),
         device_busy_ms_per_step=f"{step_busy:.4f}",
         device_idle_share=f"{max(0.0, 1 - step_busy / md_ms):.3f}",
         final_T=f"{float(integ.temperature(state.v)):.2f}",
         f32_rel_err_vs_f64=json.dumps(
             {k: f"{v:.3g}" for k, v in err32.items()}).replace(" ", ""))
    _say("10-deepmd-flops", dense_flops_forward=flops["forward"],
         dense_flops_eval=flops["total"],
         dense_flops_own_type_only=flops["own_type_only"],
         weights=n_weights, bound_ms_f32=f"{bound[0]:.4f}",
         bound_by=bound[1],
         hand_kernel_launches=sum(mod.LAUNCHES for mod in launch_mods))



def _ewald_recp_loop(pos, q, box, beta: float, spacing: float):
    """Host numpy reference of the reciprocal-space Ewald energy and forces
    (ewald.cc's formula), a Python loop over the k vectors, each a sum over
    the charges: E = C/(2 pi V) sum_m w(m) |S(m)|^2, F_j = -dE/dr_j."""
    import numpy as np
    c_conv = 14.39964535475696995031
    kk = []
    for d in range(3):
        ll = float(np.sqrt((box[d] ** 2).sum()))
        k = int(ll / spacing)
        k += k * spacing < ll
        kk.append(k + k % 2)
    rec = np.linalg.inv(box)
    frac = pos @ rec
    vol = abs(np.linalg.det(box))
    e, f = 0.0, np.zeros_like(pos)
    for mx in range(-kk[0] // 2, kk[0] // 2 + 1):
        for my in range(-kk[1] // 2, kk[1] // 2 + 1):
            for mz in range(-kk[2] // 2, kk[2] // 2 + 1):
                if mx == my == mz == 0:
                    continue
                m = np.array([mx, my, mz], np.float64)
                theta = 2.0 * np.pi * (frac @ m)
                cos, sin = np.cos(theta), np.sin(theta)
                sr, si = q @ cos, q @ sin
                b = rec @ m                     # the cartesian k / (2 pi)
                nm2 = b @ b
                w = np.exp(-np.pi ** 2 * nm2 / beta ** 2) / nm2
                e += w * (sr * sr + si * si)
                f -= (2.0 * w * q * (si * cos - sr * sin))[:, None] * b
    return e * c_conv / (2.0 * np.pi * vol), f * c_conv / vol


def _deepmd_tail(dev) -> None:
    """Phase 16: the rest of DeePMD at the water model's width on
    __graft_entry__.py's 192-atom frame (phase 10's), random weights from
    seeded CPU generators. f64 checks, the card against the host CPU, each
    relative to the largest magnitude of its reference; f32 timings as
    phase 10 prints them."""
    import itertools
    import socket
    import statistics
    import struct
    import tempfile
    import threading

    import numpy as np
    import torch

    from g4s_tpu_torch.ckpt import tree_leaves
    from g4s_tpu_torch.models.deepmd import (WATER_SPEC, DeepPot,
                                             energy_force_virial, freeze,
                                             init_params, total_energy)
    from g4s_tpu_torch.models.deepmd import calculator, dplr, ipi, nvnmd
    from g4s_tpu_torch.models.deepmd.descriptor import (
        DescriptorSpec, atomic_descriptor_ef, compute_stats, env_mat,
        env_mat_celllist, env_mat_nopbc)
    from g4s_tpu_torch.models.deepmd.fit_tensor import (atomic_dipole,
                                                        init_tensor_fit)
    from g4s_tpu_torch.models.deepmd.model import ModelSpec, params_to
    from g4s_tpu_torch.models.deepmd.train import (LossConfig, LRConfig,
                                                   Trainer, batch_to)
    from g4s_tpu_torch.obs.timings import device_activities, device_ms
    from g4s_tpu_torch.ops import bwell_spmv, route, segment, wsell_spmv

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    launch_mods = (route, wsell_spmv, bwell_spmv, segment)
    for mod in launch_mods:
        mod.LAUNCHES = 0
    n, L = DEEPMD_TAIL_FRAME
    n_o = n // 3
    types_np = np.concatenate([np.zeros(n_o, np.int64),
                               np.ones(n - n_o, np.int64)])
    coord_np = np.random.default_rng(0).uniform(0, L, size=(n, 3))
    box_np = np.eye(3) * L
    nb = 8
    cb_np = coord_np[None] + np.random.default_rng(1).normal(
        scale=0.05, size=(nb, n, 3))
    bb_np = np.repeat(box_np[None], nb, axis=0)
    tmp = tempfile.TemporaryDirectory()

    def on(device, dtype=f64):
        return (torch.as_tensor(coord_np, dtype=dtype, device=device),
                torch.as_tensor(box_np, dtype=dtype, device=device),
                torch.as_tensor(types_np, device=device))

    cg, bg, tg = on(dev)
    ch, bh, th = on(cpu)

    def rel(got, want) -> float:
        return _rel_err(got.detach().cpu().double(),
                        want.detach().cpu().double())

    def errs(got, want, keys="EFW") -> dict:
        return {k: rel(g, w) for k, g, w in zip(keys, got, want)}

    def fmt(d: dict) -> str:
        return json.dumps({k: f"{v:.3g}" for k, v in d.items()}).replace(
            " ", "")

    def f32_timing(fn) -> dict:
        # as phase 10: one call per device timing, the wall time of
        # synchronized calls, the kernels of one profiled call
        dms = statistics.median(device_ms(fn, device=dev, reps=1)
                                for _ in range(5))
        wall = _wall_ms(fn, reps=10)
        acts = device_activities(fn)
        busy = sum(us for _, us in acts) / 1e3
        return dict(device_ms=f"{dms:.4f}", host_wall_ms=f"{wall:.4f}",
                    device_kernels=len(acts), device_busy_ms=f"{busy:.4f}",
                    device_idle_share=f"{max(0.0, 1 - busy / wall):.3f}")

    # ---- 1. the six descriptors ----
    se_e3 = ModelSpec(DescriptorSpec(5.8, 0.5, (40, 80), 2), (2, 4, 8), 16,
                      (240, 240, 240), descriptor_type="se_t")
    specs = {t: WATER_SPEC._replace(descriptor_type=t)
             for t in ("se_atten", "se_a_ebd", "hybrid", "loc_frame",
                       "se_a_mask")}
    specs["se_t"] = se_e3
    frozen_atten = None
    for i, (name, spec) in enumerate(specs.items()):
        params = init_params(torch.Generator().manual_seed(100 + i), spec)
        if name != "loc_frame":
            # davg/dstd from the frame, as dp train computes them
            R, _ = (env_mat_nopbc(ch, th, spec.descriptor)
                    if name == "se_a_mask"
                    else env_mat(ch, bh, th, spec.descriptor))
            davg, dstd = compute_stats([R], [types_np], 2,
                                       spec.descriptor.nnei)
            params["stats"]["davg"] = torch.as_tensor(davg)
            params["stats"]["dstd"] = torch.as_tensor(dstd)
        pg = params_to(params, device=dev)
        t0 = time.perf_counter()
        want = energy_force_virial(params, spec, ch, bh, th)
        host_s = time.perf_counter() - t0
        got = energy_force_virial(pg, spec, cg, bg, tg)
        e_err = errs(got, want)
        _check(max(e_err.values()) <= DEEPMD_F64_TOL,
               f"{name} E/F/W f64, card against host CPU: {e_err}")
        path = os.path.join(tmp.name, f"{name}.npz")
        freeze(params, spec, path, type_map=["O", "H"])
        pot = DeepPot(path, device=dev)
        fr_err = errs(pot.eval(coord_np, box_np, types_np), got)
        _check(max(fr_err.values()) <= DEEPMD_F64_TOL,
               f"{name}: DeepPot of its frozen file against "
               f"energy_force_virial: {fr_err}")
        batch = pot.eval(cb_np, bb_np, types_np)
        b_err = max(max(errs([b[k] for b in batch],
                             pot.eval(cb_np[k], box_np, types_np)).values())
                    for k in range(nb))
        _check(b_err <= DEEPMD_F64_TOL,
               f"{name}: DeepPot batch of {nb} against {nb} single calls: "
               f"{b_err}")
        extra = {}
        if name == "se_a_mask":
            # the frame as a finite cluster, its last 16 atoms virtual
            mask = np.arange(n) >= 0
            mask[-16:] = False
            res = []
            for p_, c_, t_ in ((pg, cg, tg), (params, ch, th)):
                x = c_.clone().requires_grad_(True)
                e = total_energy(p_, spec, x, None, t_,
                                 atom_mask=torch.as_tensor(mask,
                                                           device=x.device))
                (g,) = torch.autograd.grad(e, x)
                res.append((e.detach(), -g))
            m_err = errs(res[0], res[1], "EF")
            _check(max(m_err.values()) <= DEEPMD_F64_TOL
                   and float(res[0][1][-16:].abs().max()) == 0.0,
                   f"se_a_mask with 16 virtual atoms, card against host "
                   f"CPU: {m_err}; the virtual atoms' largest force "
                   f"{float(res[0][1][-16:].abs().max())}")
            extra = dict(masked_rel_err_card_vs_host=fmt(m_err),
                         masked_e=f"{float(res[0][0]):.10g}",
                         virtual_atoms=16)
        if name == "se_atten":
            frozen_atten = (path, pot, params)
        p32 = params_to(params, device=dev, dtype=f32)
        c32, b32, t32 = on(dev, f32)
        e32 = energy_force_virial(p32, spec, c32, b32, t32)
        err32 = errs(e32, want)
        _check(max(err32.values()) <= DEEPMD_F32_TOL,
               f"{name} E/F/W f32 on the card against f64: {err32}")
        timing = f32_timing(lambda: energy_force_virial(p32, spec, c32, b32,
                                                        t32))
        _say(f"16-deepmd-{name}", atoms=n,
             widths="se_e3" if name == "se_t" else "WATER_SPEC",
             e=f"{float(got[0]):.10g}", rel_err_card_vs_host=fmt(e_err),
             frozen_deeppot_rel_err=f"{max(fr_err.values()):.3g}",
             batch8_vs_single_rel_err=f"{b_err:.3g}", tol=DEEPMD_F64_TOL,
             host_cpu_eval_s=f"{host_s:.3f}", **extra,
             f32_rel_err_vs_f64=fmt(err32), **{f"f32_{k}": v for k, v in
                                                timing.items()})
        del pg, p32, pot, batch

    # ---- the f64 Trainer step of se_atten, card against host CPU ----
    spec = specs["se_atten"]
    params = frozen_atten[2]
    r = np.random.default_rng(12)
    raw = dict(coord=coord_np[None], box=box_np[None],
               energy=r.normal(size=1), force=r.normal(size=(1, n, 3)),
               types=types_np)
    tr = Trainer(spec, LossConfig(), LRConfig())
    runs = {}
    for device in (dev, cpu):
        p = params_to(params, device=device)
        t0 = time.perf_counter()
        p, _, loss, _ = tr._update(p, tr.init(p),
                                   batch_to(raw, tree_leaves(p)[0]), 0)
        runs[device.type] = (p, float(loss), time.perf_counter() - t0)
    (pgt, lg, _), (pct, lc, host_s) = runs[dev.type], runs["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    leaf_err = max(_rel_err(g.cpu(), c) for g, c in
                   zip(tree_leaves(pgt), tree_leaves(pct)))
    _check(loss_err <= DEEPMD_TRAIN_F64_TOL
           and leaf_err <= DEEPMD_TRAIN_F64_TOL,
           f"se_atten Trainer step f64, card against host CPU: loss "
           f"{loss_err}, leaves {leaf_err}")
    p32 = params_to(params, device=dev, dtype=f32)
    b32 = batch_to(raw, tree_leaves(p32)[0])
    state = tr.init(p32)
    step_ms = []
    for step in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p32, state, loss, _ = tr._update(p32, state, b32, step)
        torch.cuda.synchronize()
        if step >= 3:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    _check(bool(torch.isfinite(loss)), "se_atten f32 training loss not "
                                       "finite")
    acts = device_activities(lambda: tr._update(p32, state, b32, 8))
    busy = sum(us for _, us in acts) / 1e3
    wall = statistics.median(step_ms)
    _say("16-deepmd-se_atten-train", frames_per_step=1,
         loss_f64=f"{lg:.10g}", loss_rel_err=f"{loss_err:.3g}",
         leaf_rel_err=f"{leaf_err:.3g}", leaves=len(tree_leaves(pgt)),
         tol=DEEPMD_TRAIN_F64_TOL, host_cpu_step_s=f"{host_s:.3f}",
         f32_ms_per_step=f"{wall:.4f}", f32_device_kernels=len(acts),
         f32_device_busy_ms=f"{busy:.4f}",
         f32_device_idle_share=f"{max(0.0, 1 - busy / wall):.3f}")
    del runs, pgt, pct, p32, state

    # ---- 2. the cell list ----
    dspec = WATER_SPEC.descriptor

    def tiled(k):
        shifts = np.array(list(itertools.product(range(k), repeat=3)),
                          np.float64) * L
        c = (coord_np[None] + shifts[:, None]).reshape(-1, 3)
        return c, np.eye(3) * L * k, np.tile(types_np, k ** 3)

    small, large = DEEPMD_TAIL_TILES
    c_np, bx_np, ty_np = tiled(small)
    res = {}
    for device in (dev, cpu):
        c_, b_, t_ = (torch.as_tensor(x, device=device)
                      for x in (c_np, bx_np, ty_np))
        res[device.type] = (env_mat_celllist(c_, b_, t_, dspec),
                            env_mat(c_, b_, t_, dspec))
    (Rc, nlc), (Ra, nla) = res[dev.type]
    (Rch, nlch), _ = res["cpu"]

    def same_sets(a, b) -> bool:
        return torch.equal(torch.sort(a, dim=-1)[0].cpu(),
                           torch.sort(b, dim=-1)[0].cpu())
    cl_err = rel(Rc, Ra)
    cl_host_err = rel(Rc, Rch)
    _check(cl_err <= 1e-12 and same_sets(nlc, nla),
           f"env_mat_celllist against env_mat on the card at "
           f"{len(c_np)} atoms: R {cl_err}, neighbor sets equal "
           f"{same_sets(nlc, nla)}")
    _check(cl_host_err <= 1e-12 and same_sets(nlc, nlch),
           f"env_mat_celllist, card against host CPU: R {cl_host_err}, "
           f"neighbor sets equal {same_sets(nlc, nlch)}")
    try:
        env_mat_celllist(cg, bg, tg, dspec)
    except ValueError:
        refused = True
    else:
        refused = False
    _check(refused, f"env_mat_celllist took the {n}-atom box "
                    f"({int(L // dspec.rcut)} cells per side)")
    del res, Rc, Ra, Rch, nlc, nla, nlch
    c_np, bx_np, ty_np = tiled(large)
    c_, b_, t_ = (torch.as_tensor(c_np, dtype=f32, device=dev),
                  torch.as_tensor(bx_np, dtype=f32, device=dev),
                  torch.as_tensor(ty_np, device=dev))
    big = {}
    for fname, fn in (("celllist", lambda: env_mat_celllist(c_, b_, t_,
                                                            dspec)),
                      ("all_pairs", lambda: env_mat(c_, b_, t_, dspec))):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        big[fname] = (_wall_ms(fn, reps=5), peak)
    _say("16-deepmd-celllist", atoms_checked=len(tiled(small)[0]),
         cells_per_side_checked=int(L * small // dspec.rcut),
         r_rel_err_vs_env_mat=f"{cl_err:.3g}",
         r_rel_err_card_vs_host=f"{cl_host_err:.3g}",
         neighbor_sets_equal=True, refused_at_atoms=n,
         atoms_timed=len(c_np),
         cells_per_side_timed=int(L * large // dspec.rcut),
         f32_celllist_wall_ms=f"{big['celllist'][0]:.4f}",
         f32_celllist_peak_mib=f"{big['celllist'][1]:.1f}",
         f32_all_pairs_wall_ms=f"{big['all_pairs'][0]:.4f}",
         f32_all_pairs_peak_mib=f"{big['all_pairs'][1]:.1f}")
    del c_, b_, t_

    # ---- 3. se_a_ef ----
    pp_ = init_params(torch.Generator().manual_seed(21), WATER_SPEC)
    pv_ = init_params(torch.Generator().manual_seed(22), WATER_SPEC)
    ef = np.random.default_rng(5).normal(size=(n, 3))
    Ds = [atomic_descriptor_ef(params_to(pp_, device=d),
                               params_to(pv_, device=d), WATER_SPEC, c_, b_,
                               t_, torch.as_tensor(ef, device=d))
          for d, c_, b_, t_ in ((dev, cg, bg, tg), (cpu, ch, bh, th))]
    ef_err = rel(Ds[0], Ds[1])
    _check(ef_err <= DEEPMD_F64_TOL and Ds[0].shape == (n, 2 * 1600),
           f"atomic_descriptor_ef, card against host CPU: {ef_err}, "
           f"shape {tuple(Ds[0].shape)}")
    _say("16-deepmd-se_a_ef", shape=list(Ds[0].shape),
         rel_err_card_vs_host=f"{ef_err:.3g}", tol=DEEPMD_F64_TOL)
    del Ds

    # ---- 4. DPLR (examples/water/dplr's charges and Ewald settings) ----
    dip = init_params(torch.Generator().manual_seed(31), WATER_SPEC)
    nets = init_tensor_fit(torch.Generator().manual_seed(32), WATER_SPEC)
    kw = dict(model_charge_map=[-8.0, 0.0], sys_charge_map=[6.0, 1.0],
              ewald_h=1.0, ewald_beta=0.4)
    mods = [dplr.DipoleChargeModifier(params_to(dip, device=d),
                                      params_to(nets, device=d), WATER_SPEC,
                                      **kw) for d in (dev, cpu)]
    outs = [m.eval(coord_np, box_np, types_np) for m in mods]
    dplr_err = errs(outs[0], outs[1])
    _check(max(dplr_err.values()) <= DEEPMD_F64_TOL,
           f"DipoleChargeModifier f64, card against host CPU: {dplr_err}")
    kk = dplr.ewald_kgrid(box_np, kw["ewald_h"])
    # the modifier's charge system: ions on the atoms, model charges on the
    # predicted Wannier centroids
    with torch.no_grad():
        wc = (cg + atomic_dipole(mods[0].params, mods[0].nets, WATER_SPEC,
                                 cg, bg, tg)).cpu().numpy()
    pos = np.concatenate([coord_np, wc])
    q = np.concatenate([np.asarray(kw["sys_charge_map"])[types_np],
                        np.asarray(kw["model_charge_map"])[types_np]])
    t0 = time.perf_counter()
    e_loop, f_loop = _ewald_recp_loop(pos, q, box_np, kw["ewald_beta"],
                                      kw["ewald_h"])
    loop_s = time.perf_counter() - t0
    e_k, f_k, _ = dplr.ewald_recp(pos, q, box_np, beta=kw["ewald_beta"],
                                  spacing=kw["ewald_h"], device=dev)
    ew_err = {"E": abs(float(e_k) - e_loop) / abs(e_loop),
              "F": _rel_err(f_k.cpu(), f_loop)}
    _check(max(ew_err.values()) <= DEEPMD_F64_TOL,
           f"ewald_recp on the card against the host loop over k: "
           f"{ew_err}")
    dplr_ms = _wall_ms(lambda: mods[0].eval(coord_np, box_np, types_np),
                       reps=5)
    _say("16-deepmd-dplr", kgrid="x".join(str(int(k)) for k in kk),
         k_vectors=int(np.prod(kk + 1) - 1),
         de=f"{float(outs[0][0]):.10g}",
         rel_err_card_vs_host=fmt(dplr_err),
         ewald_recp_rel_err_vs_loop=fmt(ew_err), host_loop_s=f"{loop_s:.3f}",
         tol=DEEPMD_F64_TOL, f64_ms_per_eval=f"{dplr_ms:.4f}")
    del mods, outs

    # ---- 5. i-PI, in process: the driver on one end of a socket pair ----
    path, pot, _ = frozen_atten
    names = ["O" if x == 0 else "H" for x in types_np]
    nmap = {"O": 0, "H": 1}
    cell = (box_np.T / ipi.CVT_LEN).astype("<f8")
    posdata = (b"POSDATA".ljust(12) + cell.tobytes()
               + np.linalg.inv(cell).astype("<f8").tobytes()
               + struct.pack("<i", n)
               + (coord_np / ipi.CVT_LEN).astype("<f8").tobytes())
    reply_len = 12 + 8 + 4 + 24 * n + 72 + 4 + 7

    def recvn(sock, k):
        buf = b""
        while len(buf) < k:
            chunk = sock.recv(k - len(buf))
            _check(bool(chunk), "i-PI driver closed the connection")
            buf += chunk
        return buf

    def exchange(sock):
        sock.sendall(b"STATUS".ljust(12))
        _check(recvn(sock, 12).strip() == b"READY", "i-PI: not READY")
        sock.sendall(posdata + b"STATUS".ljust(12))
        _check(recvn(sock, 12).strip() == b"HAVEDATA", "i-PI: no HAVEDATA")
        sock.sendall(b"GETFORCE".ljust(12))
        msg = recvn(sock, reply_len)
        _check(msg[:12].strip() == b"FORCEREADY"
               and msg[-11:] == struct.pack("<i", 7) + b"nothing",
               "i-PI: malformed FORCEREADY")
        e = struct.unpack_from("<d", msg, 12)[0]
        f = np.frombuffer(msg[24: 24 + 24 * n], "<f8").reshape(n, 3)
        v = np.frombuffer(msg[24 + 24 * n: 96 + 24 * n], "<f8")
        return e, f, v.reshape(3, 3)

    drv = ipi.IPIDriver(pot, names, nmap)
    srv, drv.sock = socket.socketpair()
    th_drv = threading.Thread(target=drv.serve_forever, daemon=True)
    th_drv.start()
    got = exchange(srv)
    t0 = time.perf_counter()
    for _ in range(DEEPMD_TAIL_IPI_EXCHANGES):
        got = exchange(srv)
    ipi_ms = (time.perf_counter() - t0) / DEEPMD_TAIL_IPI_EXCHANGES * 1e3
    srv.close()
    th_drv.join(timeout=30)
    _check(not th_drv.is_alive(), "i-PI driver did not stop")
    we, wf, wv = pot.eval(ipi.wrap_coords(coord_np, box_np), box_np,
                          types_np)
    want = (float(we) / ipi.CVT_ENER, wf.cpu().numpy() / ipi.CVT_F,
            wv.cpu().numpy().T / ipi.CVT_ENER)
    ipi_err = {k: _rel_err(g, w) for k, g, w in zip("EFV", got, want)}
    _check(max(ipi_err.values()) <= DEEPMD_F64_TOL,
           f"i-PI decoded E/F/V against DeepPot.eval: {ipi_err}")
    # main() with a json config, on an abstract unix socket
    xyz = os.path.join(tmp.name, "frame.xyz")
    with open(xyz, "w") as fh:
        fh.write(f"{n}\nwater\n" + "".join(
            f"{a} {x:.8f} {y:.8f} {z:.8f}\n"
            for a, (x, y, z) in zip(names, coord_np)))
    prefix = f"\0g4s_ipi_{os.getpid()}_"
    cfg = os.path.join(tmp.name, "ipi.json")
    with open(cfg, "w") as fh:
        json.dump(dict(graph_file=path, coord_file=xyz, atom_type=nmap,
                        host="p16", use_unix=True, unix_prefix=prefix), fh)
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(prefix + "p16")
    listener.listen(1)
    main_out = {}

    def serve_main():
        conn, _ = listener.accept()
        main_out["efv"] = exchange(conn)
        conn.sendall(b"EXIT".ljust(12))
        conn.close()
    th_srv = threading.Thread(target=serve_main, daemon=True)
    th_srv.start()
    ipi.main([cfg, "--device", dev.type])
    th_srv.join(timeout=30)
    listener.close()
    _check("efv" in main_out and not th_srv.is_alive(),
           "i-PI main() made no exchange")
    main_err = max(_rel_err(g, w) for g, w in zip(main_out["efv"], want))
    _check(main_err <= DEEPMD_F64_TOL,
           f"i-PI main() against DeepPot.eval: {main_err}")

    # ---- 6. the calculator ----
    out = calculator.calc_ase_free(path, coord_np, box_np, names, ["O", "H"],
                                   device=dev)
    ref = pot.eval(coord_np, box_np, types_np)
    calc_err = {"E": abs(out["energy"] - float(ref[0])) / abs(float(ref[0])),
                "F": _rel_err(out["forces"], ref[1].cpu()),
                "W": _rel_err(out["virial"], ref[2].cpu())}
    _check(max(calc_err.values()) <= DEEPMD_F64_TOL,
           f"calc_ase_free against DeepPot: {calc_err}")
    _say("16-deepmd-ipi-calculator", model="se_atten f64",
         exchanges=DEEPMD_TAIL_IPI_EXCHANGES,
         wall_ms_per_exchange=f"{ipi_ms:.4f}",
         rel_err_vs_deeppot=fmt(ipi_err), main_unix_rel_err=f"{main_err:.3g}",
         calc_ase_free_rel_err=fmt(calc_err), tol=DEEPMD_F64_TOL)

    # ---- 7. NVNMD at its default widths ----
    nspec = nvnmd.NvnmdSpec(DescriptorSpec(6.0, 0.5, (46, 92), 2))
    npar = nvnmd.init_nvnmd_params(torch.Generator().manual_seed(41), nspec)
    # per-type scalar stats of s and h over the frame's neighbors
    u, _, valid = nvnmd._neighbor_u(ch, bh, th, nspec.descriptor)
    s, h = nvnmd._s_h_of_u(u, nspec.descriptor)
    of_type = [(th == t)[:, None] & valid for t in range(2)]
    npar["stats"] = {"avg": torch.stack([s[m].mean() for m in of_type]),
                     "std_s": torch.stack([s[m].std() for m in of_type]),
                     "std_h": torch.stack([h[m].std() for m in of_type])}
    quantum = 2.0 ** -nspec.nbit_data_fl
    both = [(params_to(npar, device=d), c_, b_, t_)
            for d, c_, b_, t_ in ((dev, cg, bg, tg), (cpu, ch, bh, th))]

    def diff(a, b):
        """(largest |a - b|, outputs that differ at all, outputs that differ
        by half a quantum or more, outputs)."""
        a = torch.cat([x.detach().cpu().reshape(-1) for x in a])
        b = torch.cat([x.detach().cpu().reshape(-1) for x in b])
        d = (a - b).abs()
        return (float(d.max()), int((d > 0).sum()),
                int((d >= quantum / 2).sum()), a.numel())
    cnn = [nvnmd.nvnmd_energy_force(p_, nspec, c_, b_, t_, stage="cnn")
           for p_, c_, b_, t_ in both]
    cnn_err = errs(cnn[0], cnn[1], "EF")
    _check(max(cnn_err.values()) <= DEEPMD_F64_TOL,
           f"NVNMD CNN E/F, card against host CPU: {cnn_err}")
    qnn = [nvnmd.nvnmd_energy_force(p_, nspec, c_, b_, t_, stage="qnn")
           for p_, c_, b_, t_ in both]
    q_abs, q_n, q_flip, n_out = diff(qnn[0], qnn[1])
    _check(q_abs <= 4 * quantum, f"NVNMD QNN E/F, card against host CPU: "
                                 f"{q_abs} > 4 quanta")
    tabs = [nvnmd.build_map(p_, nspec) for p_, _, _, _ in both]

    def scaled(tb):
        cgc = tb.coef_g.cpu()
        nf = int(tb.cfg_s2g[0, 4])
        dx = torch.where(torch.arange(cgc.shape[1]) < nf,
                         float(tb.cfg_s2g[0, 2]), float(tb.cfg_s2g[1, 2]))
        c = cgc.reshape(cgc.shape[:2] + (-1, 4))
        return c * dx[None, :, None, None] ** torch.arange(4)
    tab_err = {"coef_s": rel(tabs[0].coef_s, tabs[1].coef_s),
               "coef_h": rel(tabs[0].coef_h, tabs[1].coef_h),
               "coef_g_ckdxk": rel(scaled(tabs[0]), scaled(tabs[1])),
               "cfg_s2g": _rel_err(tabs[0].cfg_s2g, tabs[1].cfg_s2g)}
    _check(max(tab_err.values()) <= DEEPMD_F64_TOL,
           f"NVNMD build_map, card against host CPU: {tab_err}")
    maps = [nvnmd.nvnmd_map_energy_force(p_, nspec, tb, c_, b_, t_)
            for (p_, c_, b_, t_), tb in zip(both, tabs)]
    m_abs, m_n, m_flip, _ = diff(maps[0], maps[1])
    _check(m_abs <= 4 * quantum, f"NVNMD mapped E/F, card against host "
                                 f"CPU: {m_abs} > 4 quanta")
    wrapped = os.path.join(tmp.name, "model.nvnmd")
    again = os.path.join(tmp.name, "again.nvnmd")
    nvnmd.wrap_model(both[0][0], nspec, tabs[0], wrapped)
    p2, s2, t2 = nvnmd.load_wrapped(wrapped, device=dev)
    nvnmd.wrap_model(p2, s2, t2, again)
    with np.load(wrapped) as z1, np.load(again) as z2:
        same = sorted(z1.files) == sorted(z2.files) and all(
            np.array_equal(z1[k], z2[k]) for k in z1.files)
    e_a = nvnmd.nvnmd_map_energy(p2, s2, t2, cg, bg, tg)
    e_b = nvnmd.nvnmd_map_energy(p2, s2, t2, cg, bg, tg)
    _check(same and s2 == nspec and bool(torch.equal(e_a, e_b)),
           "NVNMD wrap_model -> load_wrapped on the card: not bitwise")
    # two-stage training, labels from a teacher evaluated on the host
    teacher = nvnmd.init_nvnmd_params(torch.Generator().manual_seed(42),
                                      nspec)
    teacher["stats"] = {k: v.clone() for k, v in npar["stats"].items()}
    e_t, f_t = nvnmd.nvnmd_energy_force(teacher, nspec, ch, bh, th)
    losses, train_s = {}, {}
    for p_, c_, b_, t_ in both:
        d = c_.device
        t0 = time.perf_counter()
        _, lc_, lq_ = nvnmd.train_two_stage(
            p_, nspec, [(c_, b_, t_, e_t.to(d), f_t.to(d))], lr=2e-4,
            steps_cnn=DEEPMD_TAIL_NVNMD_STEPS,
            steps_qnn=DEEPMD_TAIL_NVNMD_STEPS)
        train_s[d.type] = time.perf_counter() - t0
        losses[d.type] = np.array(lc_ + lq_)
    tr_err = _rel_err(losses[dev.type], losses["cpu"])
    _check(tr_err <= 1e-8, f"NVNMD train_two_stage losses, card against "
                           f"host CPU: {tr_err}")
    qnn_ms = _wall_ms(lambda: nvnmd.nvnmd_energy_force(
        both[0][0], nspec, cg, bg, tg, stage="qnn"), reps=5)
    map_ms = _wall_ms(lambda: nvnmd.nvnmd_map_energy_force(
        both[0][0], nspec, tabs[0], cg, bg, tg), reps=5)
    _say("16-deepmd-nvnmd", spec="NvnmdSpec defaults, rcut 6, sel 46/92",
         cnn_rel_err_card_vs_host=fmt(cnn_err),
         qnn_max_abs_diff_quanta=f"{q_abs / quantum:.3g}",
         qnn_outputs_differing=f"{q_n}/{n_out}",
         qnn_outputs_off_by_half_a_quantum=q_flip,
         map_max_abs_diff_quanta=f"{m_abs / quantum:.3g}",
         map_outputs_differing=f"{m_n}/{n_out}",
         map_outputs_off_by_half_a_quantum=m_flip,
         tables_rel_err_card_vs_host=fmt(tab_err), wrap_reload_bitwise=same,
         train_steps=f"{DEEPMD_TAIL_NVNMD_STEPS}+{DEEPMD_TAIL_NVNMD_STEPS}",
         train_losses=",".join(f"{x:.8g}" for x in losses[dev.type]),
         train_loss_rel_err=f"{tr_err:.3g}",
         train_s_card_host=f"{train_s[dev.type]:.2f}/{train_s['cpu']:.2f}",
         f64_qnn_ms_per_eval=f"{qnn_ms:.4f}",
         f64_map_ms_per_eval=f"{map_ms:.4f}")
    tmp.cleanup()
    _say("16-deepmd-tail", hand_kernel_launches=json.dumps(
        {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES
         for m in launch_mods}).replace(" ", ""),
         seconds=f"{time.perf_counter() - t_phase:.1f}")


def _deepmd_train_flops(spec, n_atoms: int, frames: int) -> int:
    """Dense floating-point operations of one training step on `frames`
    frames: the eval's (E, F and W, _deepmd_flops) and the backward pass of
    that whole graph to the parameters, which takes every product of the
    eval twice more (each matmul x W of the eval needs dx and dW, each
    contraction both operands' gradients): 3 times the eval's."""
    return 3 * frames * _deepmd_flops(spec, n_atoms)["total"]


def _deepmd_train(dev) -> None:
    """Phase 12: DeePMD training at the flagship width (WATER_SPEC;
    __graft_entry__.py's 192-atom water frame and 31 copies perturbed by
    0.05 A from seed 3; energy and force labels from a teacher model with
    other random weights; the student's stats and energy bias from the
    data, as `dp train` computes them). f64: three Trainer steps on the
    card against the host CPU, the loss per step and every parameter leaf
    within DEEPMD_TRAIN_F64_TOL. f32: ms/step (median of 10 steps after 3
    of warm-up, each synchronized), device-busy ms, kernels and idle share
    per step at 1 frame (the water example's batch_size "auto") and at 8,
    beside the dense FLOPs and their bound. Then `dp train` through main()
    on an input at WATER_SPEC width for 100 steps on the frames written to
    a system directory: the lcurve must be written and its last rmse_f
    below its first; `dp train --restart` on its checkpoint for 5 steps,
    whose first rmse_f must be below the first run's; `dp freeze` and
    DeepPot on the card, whose f32 energy must equal the restarted run's
    final parameters' within DEEPMD_FREEZE_F32_TOL."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.ckpt import tree_leaves
    from g4s_tpu_torch.drivers import dp as dp_cli
    from g4s_tpu_torch.models.deepmd import (WATER_SPEC, DeepPot,
                                             energy_force_virial,
                                             init_params)
    from g4s_tpu_torch.models.deepmd.descriptor import (compute_stats,
                                                        env_mat)
    from g4s_tpu_torch.models.deepmd.model import params_to
    from g4s_tpu_torch.models.deepmd.train import (LossConfig, LRConfig,
                                                   Trainer, batch_to)
    from g4s_tpu_torch.obs.timings import device_activities
    from g4s_tpu_torch.ops import bwell_spmv, route, segment, wsell_spmv

    spec = WATER_SPEC
    cpu = torch.device("cpu")
    launch_mods = (route, wsell_spmv, bwell_spmv, segment)
    for mod in launch_mods:
        mod.LAUNCHES = 0
    n, L, nf = 192, 12.444661, 32
    types_np = np.concatenate([np.zeros(64, np.int64),
                               np.ones(128, np.int64)])
    coord0 = np.random.default_rng(0).uniform(0, L, size=(n, 3))
    coords = np.concatenate([coord0[None], coord0[None]
                             + np.random.default_rng(3).normal(
                                 scale=0.05, size=(nf - 1, n, 3))])
    boxes = np.repeat(np.eye(3)[None] * L, nf, axis=0)
    types_d = torch.as_tensor(types_np, device=dev)
    teacher = params_to(init_params(torch.Generator().manual_seed(2), spec),
                        device=dev)
    e_t, f_t, _ = energy_force_virial(
        teacher, spec, torch.as_tensor(coords, device=dev),
        torch.as_tensor(boxes, device=dev), types_d)
    energy, force = e_t.cpu().numpy(), f_t.cpu().numpy()
    del teacher, e_t, f_t

    # the student: phase 10's weights, stats and bias from the data
    R, _ = env_mat(torch.as_tensor(coords[:10], device=dev),
                   torch.as_tensor(boxes[:10], device=dev), types_d,
                   spec.descriptor)
    davg, dstd = compute_stats(list(R.cpu().numpy()), [types_np] * 10, 2,
                               spec.descriptor.nnei)
    counts = np.tile(np.bincount(types_np, minlength=2), (nf, 1))
    bias = np.linalg.lstsq(counts.astype(float), energy, rcond=None)[0]
    params = init_params(torch.Generator().manual_seed(1), spec,
                         bias_atom_e=bias)
    params["stats"]["davg"] = torch.as_tensor(davg)
    params["stats"]["dstd"] = torch.as_tensor(dstd)

    def raw(first: int, frames: int) -> dict:
        idx = np.arange(first, first + frames) % nf
        return dict(coord=coords[idx], box=boxes[idx], energy=energy[idx],
                    force=force[idx], types=types_np)

    # ---- f64: three steps, the card against the host CPU ----
    tr = Trainer(spec, LossConfig(), LRConfig())
    runs = {}
    for device in (dev, cpu):
        p = params_to(params, device=device)
        state = tr.init(p)
        losses = []
        t0 = time.perf_counter()
        for step in range(3):
            p, state, loss, _ = tr._update(
                p, state, batch_to(raw(step, 1), tree_leaves(p)[0]), step)
            losses.append(float(loss))
        runs[device.type] = (p, losses, time.perf_counter() - t0)
    (pg, lg, _), (pc, lc, host_s) = runs[dev.type], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    leaf_err = max(_rel_err(g.cpu(), c) for g, c in
                   zip(tree_leaves(pg), tree_leaves(pc)))
    _check(loss_err <= DEEPMD_TRAIN_F64_TOL
           and leaf_err <= DEEPMD_TRAIN_F64_TOL,
           f"DeePMD train f64, card against host CPU: loss {loss_err}, "
           f"leaves {leaf_err}")
    _say("12-deepmd-train-f64", steps=3, frames_per_step=1,
         loss=",".join(f"{x:.10g}" for x in lg),
         loss_rel_err=f"{loss_err:.3g}", leaf_rel_err=f"{leaf_err:.3g}",
         leaves=len(tree_leaves(pg)), tol=DEEPMD_TRAIN_F64_TOL,
         host_cpu_s_3_steps=f"{host_s:.3f}")
    del runs, pg, pc

    # ---- f32 step timings ----
    p32 = params_to(params, device=dev, dtype=torch.float32)
    n_weights = sum(x.numel() for x in tree_leaves(p32))
    for frames in (1, 8):
        batches = [batch_to(raw(i * frames, frames), tree_leaves(p32)[0])
                   for i in range(4)]
        p, state = p32, tr.init(p32)
        step_ms = []
        for step in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, loss, aux = tr._update(p, state, batches[step % 4],
                                             step)
            torch.cuda.synchronize()
            if step >= 3:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        _check(bool(torch.isfinite(loss)), "f32 training loss not finite")
        acts = device_activities(
            lambda: tr._update(p, state, batches[0], 13))
        busy = sum(us for _, us in acts) / 1e3
        wall = statistics.median(step_ms)
        flops = _deepmd_train_flops(spec, n, frames)
        # parameters, mu and nu read and written once; the batch read
        bound = _bound(4.0 * (6 * n_weights
                              + frames * (2 * n * 3 + 10)), flops)
        _say("12-deepmd-train-step-f32", frames=frames,
             ms_per_step=f"{wall:.4f}",
             ms_per_step_min_max=f"{min(step_ms):.4f}/"
                                 f"{max(step_ms):.4f}",
             device_kernels=len(acts), device_busy_ms=f"{busy:.4f}",
             device_idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
             dense_flops=flops, bound_ms=f"{bound[0]:.4f}",
             bound_by=bound[1], share_of_bound=f"{bound[0] / wall:.4f}",
             rmse_f=f"{float(aux['rmse_f']):.4g}")
    del p32, p, state, batches

    # ---- `dp train` through main(), --restart, freeze, DeepPot ----
    with tempfile.TemporaryDirectory() as tmp:
        sysd = os.path.join(tmp, "water", "set.000")
        os.makedirs(sysd)
        np.savetxt(os.path.join(tmp, "water", "type.raw"), types_np,
                   fmt="%d")
        np.save(os.path.join(sysd, "coord.npy"), coords.reshape(nf, -1))
        np.save(os.path.join(sysd, "box.npy"), boxes.reshape(nf, 9))
        np.save(os.path.join(sysd, "energy.npy"), energy)
        np.save(os.path.join(sysd, "force.npy"), force.reshape(nf, -1))
        lcurve = os.path.join(tmp, "lcurve.out")
        d = spec.descriptor
        inp = os.path.join(tmp, "input.json")
        with open(inp, "w") as f:
            json.dump({
                "model": {"type_map": ["O", "H"],
                          "descriptor": {"type": "se_e2_a", "rcut": d.rcut,
                                         "rcut_smth": d.rcut_smth,
                                         "sel": list(d.sel),
                                         "neuron": list(spec.embed_neurons),
                                         "axis_neuron": spec.axis_neuron,
                                         "resnet_dt": False},
                          "fitting_net": {"neuron": list(spec.fit_neurons),
                                          "resnet_dt": True}},
                "learning_rate": {"start_lr": 1e-3, "stop_lr": 1e-5,
                                  "decay_steps": 20},
                "loss": {"start_pref_e": 0.02, "limit_pref_e": 1,
                         "start_pref_f": 1000, "limit_pref_f": 1},
                "training": {"numb_steps": 100, "disp_freq": 10, "seed": 10,
                             "disp_file": lcurve,
                             "training_data": {"systems": ["water"],
                                               "batch_size": "auto"}}}, f)
        ck = os.path.join(tmp, "model.ckpt.npz")
        argv = ["train", inp, "--device", dev.type]
        t0 = time.perf_counter()
        dp_cli.main(argv + ["--checkpoint", ck])
        train_s = time.perf_counter() - t0
        with open(lcurve) as f:
            rows = [line.split() for line in f if not line.startswith("#")]
        rmse_f = [float(r[2]) for r in rows]
        _check(len(rows) == 11 and rmse_f[-1] < rmse_f[0],
               f"dp train lcurve: {len(rows)} rows, rmse_f {rmse_f}")
        ck2 = os.path.join(tmp, "restart.ckpt.npz")
        out = dp_cli.main(argv + ["--restart", ck, "--steps", "5",
                                  "--checkpoint", ck2])
        with open(lcurve) as f:
            restart_f = [float(line.split()[2]) for line in f
                         if not line.startswith("#")]
        _check(restart_f[0] < rmse_f[0],
               f"dp train --restart did not start from the trained "
               f"parameters: rmse_f {restart_f[0]} against {rmse_f[0]}")
        frozen = os.path.join(tmp, "frozen_model.npz")
        dp_cli.main(["freeze", "-c", ck2, "-o", frozen])
        pot = DeepPot(frozen, device=dev)
        e_pot = float(pot.eval(coords[0], boxes[0], types_np)[0])
        e_tr = float(energy_force_virial(
            out["params"], out["spec"],
            torch.as_tensor(coords[0], dtype=torch.float32, device=dev),
            torch.as_tensor(boxes[0], dtype=torch.float32, device=dev),
            types_d)[0])
        frozen_err = abs(e_pot - e_tr) / abs(e_tr)
        _check(pot.dtype == torch.float32
               and frozen_err <= DEEPMD_FREEZE_F32_TOL,
               f"frozen model against the trained parameters (f32): "
               f"{frozen_err}")
    _say("12-deepmd-dp-train", steps=100, batch="auto(1)", dtype="f32",
         wall_s_with_setup=f"{train_s:.2f}",
         rmse_f_first=f"{rmse_f[0]:.4g}", rmse_f_last=f"{rmse_f[-1]:.4g}",
         restart_steps=5, restart_rmse_f_first=f"{restart_f[0]:.4g}",
         frozen_vs_trained_e_rel=f"{frozen_err:.3g}",
         tol=DEEPMD_FREEZE_F32_TOL,
         hand_kernel_launches=sum(mod.LAUNCHES for mod in launch_mods))


def _sync_ms(fn, reps: int = 10) -> float:
    """Median host wall ms of one fn() call, synchronized before and
    after: the time a host-bound caller waits for it."""
    import statistics
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _syncs(fn) -> int:
    """How many times one fn() call makes the host wait for the device, as
    torch.cuda's sync debug mode reports them."""
    import warnings
    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _cantera_host_run(path: str, T0: float, P0: float, rtol: float,
                      atol: float) -> dict:
    """Phase 13's host-CPU reference: ShockTubeBenchmark.run_single on the
    host CPU as the CLI runs it on the card (the protocol's end time), one
    torch thread. Runs in a process of its own, beside the card's runs.
    Per phase: tau, end time, BDF steps and wall s."""
    import torch
    torch.set_num_threads(1)
    from g4s_tpu_torch.models.cantera import ShockTubeBenchmark
    out = ShockTubeBenchmark(path, device="cpu").run_single(
        T0, P0, rtol=rtol, atol=atol)
    return {name: {"tau": out[f"tau_{name}"],
                   "t_end": out[f"result_{name}"].t,
                   "steps": out[f"result_{name}"].steps,
                   "wall_s": out[f"wall_{name}"]}
            for name in ("RG", "IG")}


def _cantera_shock_tube(dev) -> None:
    """Phase 13: Cantera's NonIdealShockTube protocol on the card, at the
    n-dodecane mechanism's size (a synthetic mechanism with its counts,
    _synthetic_mechanism_yaml, seed CANTERA_SEED; nDodecane_Reitz.yaml is
    not in the repository). (1) The CLI, `python -m
    g4s_tpu_torch.drivers.shock_tube --mech FILE` through its main() on
    its default device (the card): ShockTubeBenchmark.run_single at
    1000 K and 40 atm with rtol 1e-8 and atol 1e-14; per phase
    (Redlich-Kwong RG, ideal IG) tau, BDF steps, n_fev, n_jev, wall s and
    host reads per step; device kernels and busy ms per step from a
    profiled window of CANTERA_WINDOW steps from the state at tau/2 (the
    solver's set-up, one RHS, one Jacobian and one LU, taken out), the
    host waits on the device in that window (torch.cuda's sync debug
    mode), and the idle share against the run's wall per step. (2) host
    wall ms (synchronized), kernels, busy ms and host waits per call of
    one RHS, one jacfwd Jacobian and one LU factor + solve at n = 101.
    (3) f64, the card against the host CPU: RHS and Jacobian at y0 and at
    tau/2 within CANTERA_F64_TOL of the largest entry, the initial state
    within CANTERA_Y0_TOL, and the CPU's run_single of the CLI's case,
    started in a process of its own when the phase starts so that it runs
    beside the card's work: tau within CANTERA_TAU_TOL. (4) The card's
    run: success, each element within CANTERA_ELEMENT_TOL and U within
    CANTERA_U_TOL of their initial values, a temperature rise of at least
    CANTERA_T_RISE, and the RK tau apart from the IG tau. (2b) The RK
    advance to tau/2 run twice: the states within CANTERA_REPEAT_TOL. No hand kernel lies on this path (launch counts
    printed, 0). Returns the ideal-gas reactor and its final state, for
    phase 18, and the 1000 K case's tau, wall s and steps per phase, for
    phase 20."""
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.drivers import shock_tube as shock_tube_cli
    from g4s_tpu_torch.models.cantera import (R_GAS, ShockTubeBenchmark,
                                              stoich_mixture)
    from g4s_tpu_torch.obs.timings import device_activities
    from g4s_tpu_torch.ops import bwell_spmv, odeint, route, segment, \
        wsell_spmv

    launch_mods = (route, wsell_spmv, bwell_spmv, segment)
    for mod in launch_mods:
        mod.LAUNCHES = 0
    cpu = torch.device("cpu")
    T0, P0, rtol, atol = 1000.0, 40 * 101325.0, 1e-8, 1e-14
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "ndodecane_synthetic.yaml")
    _synthetic_mechanism_yaml(path, seed=CANTERA_SEED, **CANTERA_COUNTS)
    # ---- 3 (host CPU): the CPU's run of the CLI's case starts now, in a
    # process of its own, and is read after the card's checks ----
    pool = multiprocessing.get_context("spawn").Pool(1)
    t_cpu = time.perf_counter()
    host_run = pool.apply_async(_cantera_host_run,
                                (path, T0, P0, rtol, atol))
    t0 = time.perf_counter()
    bench = ShockTubeBenchmark(path, device=dev)
    load_s = time.perf_counter() - t0
    host = ShockTubeBenchmark(path, device=cpu)
    m = bench.mech_rk
    imbalance = float(np.abs((m.nu_prod - m.nu_reac) @ m.mol_weights).max())
    i = m.species_index("c12h26")
    tc = (m.rk_a[i, 0] * 0.08664 / (0.42748 * R_GAS * m.rk_b[i])) ** (2 / 3)
    kin = bench.r_rk.kin
    layouts = {g.variant for g in (kin.g_reac, kin.g_prod, kin.g_net)}
    counts = (m.nspec, m.nrxn, int(m.is_falloff.sum()),
              int(m.is_three_body.sum()))
    _check(counts == tuple(CANTERA_COUNTS.values()) and imbalance <= 1e-10
           and 600.0 < tc < 700.0 and layouts == {"dense"},
           f"synthetic mechanism: counts {counts}, mass imbalance "
           f"{imbalance}, c12h26 Tc {tc}, stoichiometry layouts {layouts}")
    _say("13-cantera-mechanism", species=counts[0], reactions=counts[1],
         falloff=counts[2], three_body=counts[3], seed=CANTERA_SEED,
         mass_imbalance=f"{imbalance:.3g}", c12h26_Tc=f"{tc:.3f}",
         stoich_layout="dense", load_s=f"{load_s:.2f}")

    # ---- 1: the protocol through the CLI, on its default device ----
    t0 = time.perf_counter()
    out = shock_tube_cli.main(["--mech", path])
    run_s = time.perf_counter() - t0
    phases = {"RG": (bench.r_rk, host.r_rk), "IG": (bench.r_ig, host.r_ig)}
    n = m.nspec + 1
    for name, (r, r_cpu) in phases.items():
        res, tau = out[f"result_{name}"], out[f"tau_{name}"]
        wall = out[f"wall_{name}"]
        X = stoich_mixture(r.mech)
        y0 = r.initial_state(T0, P0, X)
        # ---- 4: the card's run holds the reference's invariants ----
        y1 = res.y
        el_err = 0.0
        for el in ("C", "H", "O", "N"):
            n_el = torch.as_tensor([c.get(el, 0.0) for c in
                                    r.mech.compositions], dtype=y0.dtype,
                                   device=dev)
            before = float(torch.dot(y0[1:], n_el))
            after = float(torch.dot(y1[1:], n_el))
            el_err = max(el_err, abs(after - before) / before)
        u0 = float(r._U_vol(y0[0], y0[1:]))
        u1 = float(r._U_vol(y1[0], torch.clamp_min(y1[1:], 0.0)))
        u_err = abs(u1 - u0) / abs(u0)
        t_rise = float(y1[0]) - T0
        _say(f"13-cantera-run-{name}", tau_us=f"{tau * 1e6:.4f}",
             steps=res.steps, n_fev=res.n_fev, n_jev=res.n_jev,
             wall_s=f"{wall:.3f}",
             wall_ms_per_step=f"{wall / res.steps * 1e3:.4f}",
             host_reads_per_step=f"{res.host_reads / res.steps:.3f}",
             T_end=f"{float(y1[0]):.3f}", element_rel_err=f"{el_err:.3g}",
             U_rel_err=f"{u_err:.3g}")
        _check(res.success and el_err <= CANTERA_ELEMENT_TOL
               and u_err <= CANTERA_U_TOL and t_rise >= CANTERA_T_RISE,
               f"shock tube {name} on the card: success {res.success}, "
               f"elements {el_err}, U {u_err}, T rise {t_rise}")

        # ---- 2: the parts, at the state at tau/2 ----
        half = r.advance(y0, tau / 2, rtol=CANTERA_HALF_RTOL, atol=atol)
        y_half = half.y
        if name == "RG":
            # ---- 2b: the RK advance to tau/2 again on the card, right
            # after it: the state within CANTERA_REPEAT_TOL, and whether
            # the steps, RHS and Jacobian calls and the state are equal bit
            # for bit (printed: past ignition they are not after some
            # histories of the process, ROADMAP.md section 3) ----
            t0 = time.perf_counter()
            again = r.advance(y0, tau / 2, rtol=CANTERA_HALF_RTOL,
                              atol=atol)
            rep_s = time.perf_counter() - t0
            bitwise = ((half.steps, half.n_fev, half.n_jev)
                       == (again.steps, again.n_fev, again.n_jev)
                       and torch.equal(half.y, again.y))
            y_err = _rel_err(again.y.cpu(), half.y.cpu())
            _check(again.success and y_err <= CANTERA_REPEAT_TOL,
                   f"shock tube RK: a second card run to tau/2 ends "
                   f"{y_err} from the first")
            _say("13-cantera-rk-repeat", t_end_us=f"{tau / 2 * 1e6:.4f}",
                 rtol=CANTERA_HALF_RTOL, steps_first=half.steps,
                 steps_repeat=again.steps,
                 n_fev=f"{half.n_fev},{again.n_fev}",
                 n_jev=f"{half.n_jev},{again.n_jev}", bitwise_equal=bitwise,
                 y_rel_err=f"{y_err:.3g}", tol=CANTERA_REPEAT_TOL,
                 wall_s=f"{rep_s:.3f}")
        jac = torch.func.jacfwd(r.rhs, argnums=1)
        eye = torch.eye(n, dtype=y0.dtype, device=dev)
        J = jac(0.0, y_half)

        def lu():
            LU, piv, _ = torch.linalg.lu_factor_ex(eye - 1e-7 * J)
            return torch.linalg.lu_solve(LU, piv, y_half[:, None])

        def window():
            return odeint.bdf_solve(r.rhs, y_half, 0.0, 1.0, rtol=rtol,
                                    atol=atol, max_steps=CANTERA_WINDOW)

        parts = {}
        for part, fn in (("rhs", lambda: r.rhs(0.0, y_half)),
                         ("jac", lambda: jac(0.0, y_half)), ("lu", lu)):
            acts = device_activities(fn)
            parts[part] = (_sync_ms(fn), len(acts),
                           sum(us for _, us in acts) / 1e3, _syncs(fn))
        acts = device_activities(window)
        res_w = window()
        syncs_w = _syncs(window)
        k_step = (len(acts) - sum(v[1] for v in parts.values())) \
            / res_w.steps
        busy_step = (sum(us for _, us in acts) / 1e3
                     - sum(v[2] for v in parts.values())) / res_w.steps
        wall_step = wall / res.steps * 1e3
        _say(f"13-cantera-parts-{name}", n=n, **{
            f"{p}_{k}": f"{v:.4f}" if isinstance(v, float) else v
            for p, vals in parts.items()
            for k, v in zip(("wall_ms", "kernels", "busy_ms", "syncs"),
                            vals)})
        _say(f"13-cantera-step-{name}", window_steps=res_w.steps,
             window_host_reads=res_w.host_reads, window_syncs=syncs_w,
             device_kernels_per_step=f"{k_step:.1f}",
             device_busy_ms_per_step=f"{busy_step:.4f}",
             run_wall_ms_per_step=f"{wall_step:.4f}",
             device_idle_share=f"{max(0.0, 1 - busy_step / wall_step):.3f}")

        # ---- 3: f64, the card against the host CPU ----
        y0_c = r_cpu.initial_state(T0, P0, X)
        y0_err = _rel_err(y0.cpu(), y0_c)
        errs = {}
        for where, y in (("y0", y0), ("tau_half", y_half)):
            y_c = y.cpu()
            errs[f"rhs_{where}"] = _rel_err(r.rhs(0.0, y).cpu(),
                                            r_cpu.rhs(0.0, y_c))
            errs[f"jac_{where}"] = _rel_err(
                jac(0.0, y).cpu(),
                torch.func.jacfwd(r_cpu.rhs, argnums=1)(0.0, y_c))
        _check(y0_err <= CANTERA_Y0_TOL
               and max(errs.values()) <= CANTERA_F64_TOL,
               f"shock tube {name}, card against host CPU: initial state "
               f"{y0_err}, {errs}")
        phases[name] = (r, r_cpu, res, tau, y0_err, errs)

    t0 = time.perf_counter()
    out_c = host_run.get(timeout=CANTERA_HOST_TIMEOUT)
    cpu_wait_s = time.perf_counter() - t0
    cpu_s = time.perf_counter() - t_cpu
    pool.close()
    pool.join()
    for name, (r, r_cpu, res, tau, y0_err, errs) in phases.items():
        c = out_c[name]
        tau_c = c["tau"]
        tau_err = abs(tau - tau_c) / tau_c
        _check(tau_err <= CANTERA_TAU_TOL,
               f"shock tube {name}: tau {tau} on the card, {tau_c} on the "
               f"host CPU")
        _say(f"13-cantera-card-vs-cpu-{name}",
             cpu_t_end_ms=f"{c['t_end'] * 1e3:.4f}",
             y0_rel_err=f"{y0_err:.3g}",
             **{k: f"{v:.3g}" for k, v in errs.items()},
             tol=CANTERA_F64_TOL, tau_card_us=f"{tau * 1e6:.4f}",
             tau_cpu_us=f"{tau_c * 1e6:.4f}", tau_rel_err=f"{tau_err:.3g}",
             steps_card=res.steps, steps_cpu=c["steps"],
             cpu_wall_s=f"{c['wall_s']:.3f}")
    _check(out["tau_RG"] != out["tau_IG"],
           f"RK and IG ignition delays equal: {out['tau_RG']}")

    tmp.cleanup()
    _say("13-cantera", cli_run_s=f"{run_s:.3f}",
         tau_RG_over_IG=f"{out['tau_RG'] / out['tau_IG']:.6f}",
         cpu_run_single_s=f"{cpu_s:.3f}",
         cpu_run_waited_s=f"{cpu_wait_s:.3f}",
         hand_kernel_launches=sum(mod.LAUNCHES for mod in launch_mods))
    return bench.r_ig, out["result_IG"].y, {
        "T": T0, **{f"{k}_{ph}": v for ph in ("RG", "IG") for k, v in (
            ("tau", out[f"tau_{ph}"]), ("wall", out[f"wall_{ph}"]),
            ("steps", out[f"result_{ph}"].steps))}}


def _flame_inlets(mech):
    """Phase 18's inlets as mass fractions: stoichiometric n-dodecane/air,
    and the counterflow's fuel (30 % n-dodecane in N2 by mass) and air."""
    import numpy as np
    W = np.asarray(mech.mol_weights)
    X = np.zeros(mech.nspec)
    for name, v in (("c12h26", 1.0), ("o2", 18.5), ("n2", 18.5 * 3.76)):
        X[mech.species_index(name)] = v
    Yf = np.zeros(mech.nspec)
    Yf[mech.species_index("c12h26")] = 0.3
    Yf[mech.species_index("n2")] = 0.7
    Yo = np.zeros(mech.nspec)
    Yo[mech.species_index("o2")] = 0.233
    Yo[mech.species_index("n2")] = 0.767
    return X * W / (X * W).sum(), Yf, Yo


def _flame_make(kind: str, mech, tr, device):
    """One of phase 18's flames on `device` and its initial profile."""
    from g4s_tpu_torch.models.cantera import flame
    Y, Yf, Yo = _flame_inlets(mech)
    if kind == "burner":
        f = flame.BurnerFlame(mech, tr, **FLAME_BURNER, device=device)
        return f, f.initial_profile(Y)
    if kind == "burner_multi_soret":
        f = flame.BurnerFlame(mech, tr, **{**FLAME_BURNER,
                                           "n_points": FLAME_MULTI_POINTS},
                              transport="multi", soret=True, device=device)
        return f, f.initial_profile(Y)
    if kind == "counterflow":
        f = flame.CounterflowDiffusionFlame(
            mech, tr, n_points=FLAME_CHECK_POINTS, width=0.02, T_fuel=400.0,
            device=device)
        return f, f.initial_profile(Yf, Yo)
    if kind == "jet":
        f = flame.ImpingingJet(mech, tr, n_points=FLAME_CHECK_POINTS,
                               width=0.01, T_inlet=400.0, device=device)
        return f, f.initial_profile(Y)
    raise ValueError(kind)


def _flame_transport(mech, tr, mech_rk, tr_rk, device) -> dict:
    """Phase 18's transport outputs as numpy arrays, computed on `device`:
    the mixture-averaged, L-matrix and multicomponent properties at every
    point of the burner's initial profile, Stefan-Maxwell velocities on a
    seeded state with every species present (at the profile's absent
    species, floored at 1e-16, its system is singular: a 1e-16 change of
    input moves them by 25 %), the high-pressure model on the
    Redlich-Kwong phase at 1500 K and 40 atm, and DustyGas."""
    import numpy as np
    import torch
    from torch.func import vmap
    from g4s_tpu_torch.models.cantera import multi_transport as mt
    from g4s_tpu_torch.models.cantera import transport as tp
    from g4s_tpu_torch.models.cantera import transport_models as tm
    from g4s_tpu_torch.models.cantera.thermo import cp0_R
    f, s = _flame_make("burner", mech, tr, device)
    K, P = mech.nspec, f.P
    s = s.reshape(f.n, K + 1)
    T = s[:, 0]
    x = s[:, 1:] / f.W
    x = x / x.sum(dim=1, keepdim=True)
    cp = vmap(lambda t: cp0_R(mech, t))(T)
    rng = np.random.default_rng(CANTERA_SEED)
    r = torch.as_tensor(rng.random((f.n, K)), dtype=x.dtype, device=device)
    xs = 0.9 * x + 0.1 * r / r.sum(dim=1, keepdim=True)
    gx = torch.gradient(xs, spacing=(f.z,), dim=0)[0]
    out = {
        "mixture_viscosity": vmap(lambda t, xx: tp.mixture_viscosity(
            mech, tr, t, xx))(T, x),
        "thermal_conductivity": vmap(lambda t, xx, c: tp.thermal_conductivity(
            mech, tr, t, xx, c))(T, x, cp),
        "mixture_diffusion": vmap(lambda t, xx: tp.mixture_diffusion_coeffs(
            mech, tr, t, P, xx))(T, x),
        "stefan_maxwell": vmap(lambda t, xx, g: tp.stefan_maxwell_velocities(
            mech, tr, t, P, xx, g))(T, xs, gx),
        "multicomponent_conductivity": vmap(
            lambda t, xx, c: mt.multicomponent_conductivity(
                mech, tr, t, xx, c))(T, x, cp),
        "thermal_diffusion": vmap(lambda t, xx, c: mt.thermal_diff_coeffs(
            mech, tr, t, xx, c))(T, x, cp),
        "multicomponent_diffusion": vmap(
            lambda t, xx: mt.multicomponent_diff_coeffs(
                mech, tr, t, P, xx))(T, x)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    x_in = x[0].cpu().numpy()
    hp = tm.HighPressureGasTransport(mech_rk, tr_rk, device=device)
    T_hp, P_hp = 1500.0, 40 * 101325.0
    cp_hp = cp0_R(mech_rk, torch.as_tensor(
        T_hp, dtype=torch.float64, device=device)).cpu().numpy()
    out["hp_binary_diffusion"] = hp.binary_diff_coeffs(T_hp, P_hp, x_in)
    out["hp_viscosity"] = np.asarray(hp.viscosity(T_hp, P_hp, x_in))
    out["hp_conductivity"] = np.asarray(
        hp.thermal_conductivity(T_hp, P_hp, x_in, cp_hp))
    dg = tm.DustyGas(mech, tr, device=device)
    Y2 = xs[-1].cpu().numpy() * mech.mol_weights
    out["dusty_diffusion"] = dg.multi_diff_coeffs(
        T_hp, 101325.0, x_in).cpu().numpy()
    out["dusty_fluxes"] = dg.molar_fluxes(
        600.0, 650.0, 1.2, 1.0, _flame_inlets(mech)[0], Y2 / Y2.sum(),
        1e-3).cpu().numpy()
    return out


def _flame_surface(mech, surf_path: str, device):
    """advance_coverages of phase 18's interface for 1 ms at 900 K in a
    lean n-dodecane/air/H2O/CO gas, from half Pt and half H coverage, on
    `device`: (coverages as numpy, BDF result)."""
    import numpy as np
    from g4s_tpu_torch.models.cantera import surface
    ik = surface.load_interface(surf_path, mech, device=device)
    X = np.zeros(mech.nspec)
    for name, v in (("c12h26", 0.01), ("o2", 0.2), ("h2o", 0.05),
                    ("co", 0.02), ("n2", 0.72)):
        X[mech.species_index(name)] = v
    conc = X / X.sum() * 101325.0 / (8.314462618 * 900.0)
    th0 = np.zeros(ik.surf.nspec)
    th0[ik.surf.species_index("pt(s)")] = 0.5
    th0[ik.surf.species_index("h(s)")] = 0.5
    th, res = surface.advance_coverages(ik, mech, 900.0, conc, th0, 1e-3)
    return th.cpu().numpy(), res


def _flame_host(task: str, path: str, surf_path: str, state=None) -> dict:
    """Phase 18's host-CPU side of one check, in a process of its own with
    one torch thread (outputs as numpy, and the wall s it took): the
    transport set, the interface's coverages, or a flame's RHS and
    Jacobian at `state` (its initial profile when None)."""
    import torch
    torch.set_num_threads(1)
    from g4s_tpu_torch.models.cantera import load_mechanism, load_transport
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    mech = load_mechanism(path, "nDodecane_IG")
    tr = load_transport(path, mech)
    if task == "transport":
        mech_rk = load_mechanism(path, "nDodecane_RK")
        out = _flame_transport(mech, tr, mech_rk,
                               load_transport(path, mech_rk), cpu)
    elif task == "surface":
        th, res = _flame_surface(mech, surf_path, cpu)
        out = {"theta": th, "steps": res.steps}
    else:
        f, y = _flame_make(task, mech, tr, cpu)
        if state is not None:
            y = torch.from_numpy(state)
        out = {"rhs": f.rhs(0.0, y).numpy(),
               "jac": f.jacobian(0.0, y).numpy()}
    out["host_s"] = time.perf_counter() - t0
    return out


def _cantera_flames(dev, ig_reactor, ig_final) -> None:
    """Phase 18 (see the module docstring): Cantera's 1-D flames,
    equilibrium, transport, surface kinetics and SolutionArray at phase
    13's mechanism on the card, each check against the host CPU, whose
    side runs in spawned one-thread processes started first (the host
    CPU's LAPACK is called one thread at a time). `ig_reactor` and
    `ig_final` are phase 13's ideal-gas reactor and final state."""
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.models.cantera import (R_GAS, SolutionArray,
                                              equilibrium, flame,
                                              load_mechanism, load_transport)
    from g4s_tpu_torch.models.cantera.thermo import h0_RT
    from g4s_tpu_torch.obs.timings import device_activities
    from g4s_tpu_torch.ops import bwell_spmv, odeint, route, segment, \
        wsell_spmv

    launch_mods = (route, wsell_spmv, bwell_spmv, segment)
    for mod in launch_mods:
        mod.LAUNCHES = 0
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "ndodecane_synthetic.yaml")
    surf_path = os.path.join(tmp.name, "pt_synthetic.yaml")
    _synthetic_mechanism_yaml(path, seed=CANTERA_SEED, **CANTERA_COUNTS)
    surf_counts = _synthetic_interface_yaml(surf_path, seed=CANTERA_SEED)
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        host = {task: pool.apply_async(_flame_host, (task, path, surf_path))
                for task in ("burner", "burner_multi_soret", "counterflow",
                             "jet", "transport", "surface")}

        def got(task):
            return host[task].get(timeout=FLAME_HOST_TIMEOUT)

        mech = load_mechanism(path, "nDodecane_IG")
        tr = load_transport(path, mech)
        mech_rk = load_mechanism(path, "nDodecane_RK")
        tr_rk = load_transport(path, mech_rk)
        K = mech.nspec
        _check(K == CANTERA_COUNTS["nspec"] and surf_counts == {
            "species": 12, "reactions": 24},
            f"phase 18 inputs: {K} species, interface {surf_counts}")
        Y_in = _flame_inlets(mech)[0]
        W = np.asarray(mech.mol_weights)
        x_in = Y_in / W / (Y_in / W).sum()

        # ---- 2: equilibrium of the inlet (both sides in this process: the
        # element-potential Newton is numpy, its potentials on the device) --
        T_u = FLAME_BURNER["T_burner"]
        h_in = float(x_in @ (h0_RT(mech, torch.as_tensor(
            T_u, dtype=torch.float64)).numpy() * R_GAS * T_u)) \
            / float(x_in @ W)
        t0 = time.perf_counter()
        T_ad, x_ad = equilibrium.equilibrate_hp(mech, h_in, 101325.0, x_in,
                                                device=dev)
        hp_s = time.perf_counter() - t0
        T_ad_c, x_ad_c = equilibrium.equilibrate_hp(mech, h_in, 101325.0,
                                                    x_in, device=cpu)
        A, _ = equilibrium.element_matrix(mech)
        b0, b1 = A.T @ x_in, A.T @ x_ad
        on = b0 > 0
        ratio = b1[on] / b0[on]
        el_err = float(np.abs(ratio / ratio[0] - 1.0).max())
        t_err = abs(T_ad - T_ad_c) / T_ad_c
        x_err = _rel_err(x_ad, x_ad_c)
        _check(el_err <= FLAME_EQ_TOL and t_err <= FLAME_EQ_TOL
               and x_err <= FLAME_EQ_TOL,
               f"equilibrate_hp: elements {el_err}, T {T_ad} card "
               f"{T_ad_c} host, x {x_err}")
        T_ig = float(ig_final[0])
        t0 = time.perf_counter()
        T_uv, _ = equilibrium.equilibrium_temperature_uv(ig_reactor,
                                                         ig_final)
        uv_s = time.perf_counter() - t0
        _check(np.isfinite(T_uv), f"equilibrium_temperature_uv: {T_uv}")
        _say("18-cantera-equilibrium", T_ad=f"{T_ad:.6f}",
             element_rel_err=f"{el_err:.3g}", T_rel_err=f"{t_err:.3g}",
             x_rel_err=f"{x_err:.3g}", tol=FLAME_EQ_TOL,
             hp_wall_s=f"{hp_s:.3f}", ig_T_end=f"{T_ig:.4f}",
             ig_T_uv_equilibrium=f"{T_uv:.4f}", uv_wall_s=f"{uv_s:.3f}")

        # ---- 3: the burner flame's march --------------------------------
        card, s0 = _flame_make("burner", mech, tr, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, reduction = card.solve(s0, **FLAME_MARCH)
        torch.cuda.synchronize()
        march_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        y1 = res.y
        host["burner_marched"] = pool.apply_async(
            _flame_host, ("burner", path, surf_path, y1.cpu().numpy()))
        T_prof, Y_prof = card.unpack(y1)
        _check(res.success and np.isfinite(T_prof).all()
               and T_prof[-1] <= T_ad + FLAME_T_MARGIN,
               f"burner march: success {res.success}, downstream T "
               f"{T_prof[-1]} against T_ad {T_ad}")
        jac_ms = _sync_ms(lambda: card.jacobian(0.0, y1), reps=3)
        rhs_ms = _sync_ms(lambda: card.rhs(0.0, y1), reps=5)
        # two card runs of the first steps, bitwise
        runs = [odeint.bdf_solve(card.rhs, s0, 0.0, FLAME_MARCH["t_end"],
                                 rtol=FLAME_MARCH["rtol"],
                                 atol=FLAME_MARCH["atol"],
                                 max_steps=FLAME_REPEAT_STEPS,
                                 jac=card.jacobian) for _ in range(2)]
        bitwise = (torch.equal(runs[0].y, runs[1].y)
                   and (runs[0].steps, runs[0].n_fev, runs[0].n_jev)
                   == (runs[1].steps, runs[1].n_fev, runs[1].n_jev))
        _check(bitwise, "burner march: two card runs of the first "
               f"{FLAME_REPEAT_STEPS} steps differ")
        # a profiled window of steps from the marched state, the solver's
        # set-up (one RHS, one Jacobian, one LU) taken out
        n_state = y1.shape[0]
        eye = torch.eye(n_state, dtype=y1.dtype, device=dev)
        Jm = card.jacobian(0.0, y1)

        def lu():
            LU, piv, _ = torch.linalg.lu_factor_ex(eye - 1e-6 * Jm)
            return torch.linalg.lu_solve(LU, piv, y1[:, None])

        def window():
            return odeint.bdf_solve(card.rhs, y1, 0.0, 1.0,
                                    rtol=FLAME_MARCH["rtol"],
                                    atol=FLAME_MARCH["atol"],
                                    max_steps=FLAME_WINDOW,
                                    jac=card.jacobian)

        parts = {}
        for part, fn in (("rhs", lambda: card.rhs(0.0, y1)),
                         ("jac", lambda: card.jacobian(0.0, y1)),
                         ("lu", lu)):
            acts = device_activities(fn)
            parts[part] = (len(acts), sum(us for _, us in acts) / 1e3)
        acts = device_activities(window)
        t0 = time.perf_counter()
        res_w = window()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        k_step = (len(acts) - sum(v[0] for v in parts.values())) \
            / res_w.steps
        busy_step = (sum(us for _, us in acts) / 1e3
                     - sum(v[1] for v in parts.values())) / res_w.steps
        wall_step = march_s / res.steps * 1e3
        _say("18-cantera-burner-march", n=card.n, species=K,
             unknowns=n_state, t_end=FLAME_MARCH["t_end"],
             rtol=FLAME_MARCH["rtol"], steps=res.steps, n_fev=res.n_fev,
             n_jev=res.n_jev, wall_s=f"{march_s:.3f}",
             s_per_step=f"{march_s / res.steps:.4f}",
             residual_reduction=f"{reduction:.4g}",
             reduction_under_0_05=reduction < 0.05,
             T_downstream=f"{T_prof[-1]:.3f}", T_ad=f"{T_ad:.3f}",
             T_max=f"{T_prof.max():.3f}", peak_gb=f"{peak_gb:.3f}",
             jac_ms=f"{jac_ms:.3f}", rhs_ms=f"{rhs_ms:.3f}",
             first_steps_bitwise_equal=bitwise)
        _say("18-cantera-burner-step", window_steps=res_w.steps,
             window_wall_s=f"{window_s:.3f}",
             rhs_kernels=parts["rhs"][0],
             rhs_busy_ms=f"{parts['rhs'][1]:.4f}",
             jac_kernels=parts["jac"][0],
             jac_busy_ms=f"{parts['jac'][1]:.4f}",
             lu_kernels=parts["lu"][0], lu_busy_ms=f"{parts['lu'][1]:.4f}",
             device_kernels_per_step=f"{k_step:.1f}",
             device_busy_ms_per_step=f"{busy_step:.4f}",
             march_wall_ms_per_step=f"{wall_step:.4f}",
             device_idle_share=f"{max(0.0, 1 - busy_step / wall_step):.3f}")

        # ---- 4: the free flame's eigenvalue ------------------------------
        free = flame.FreeFlame(mech, tr, n_points=FLAME_FREE_POINTS,
                               width=FLAME_FREE_WIDTH, T_inlet=T_u,
                               device=dev)
        sf = free.initial_profile(Y_in, mdot_guess=0.4)
        t0 = time.perf_counter()
        y_core, mdot, err_cells = flame.solve_flame_speed(
            free, sf, iters=3, **FLAME_FREE_MARCH)
        torch.cuda.synchronize()
        speed_s = time.perf_counter() - t0
        rho_u = 101325.0 * float(x_in @ W) / (R_GAS * T_u)
        T_free = y_core.reshape(free.n, -1)[:, 0].cpu().numpy()
        _check(np.isfinite(T_free).all() and mdot > 0,
               f"free flame: mdot {mdot}, T finite "
               f"{np.isfinite(T_free).all()}")
        # one damped Newton on the anchored system; its host solve timed
        host_solve = [0.0]
        solve_fn = flame._newton_linear_solve

        def timed_solve(*a):
            t = time.perf_counter()
            try:
                return solve_fn(*a)
            finally:
                host_solve[0] += time.perf_counter() - t

        y0 = torch.cat([free._t([mdot]), y_core])
        w = flame._flame_weights(free, int(y0.shape[0]))
        w[0] = 10.0
        flame._newton_linear_solve = timed_solve
        try:
            t0 = time.perf_counter()
            yn, nrm, ok = flame.damped_newton(
                flame.anchored_residual(free), y0, weights=w,
                max_iter=FLAME_NEWTON_ITERS, tol=1e-6,
                chunk=free.tangent_chunk())
            torch.cuda.synchronize()
            newton_s = time.perf_counter() - t0
        finally:
            flame._newton_linear_solve = solve_fn
        _check(np.isfinite(nrm), f"damped_newton: norm {nrm}")
        _say("18-cantera-free-flame", n=free.n, unknowns=int(y0.shape[0]),
             **FLAME_FREE_MARCH,
             mdot=f"{mdot:.6f}", Su=f"{mdot / rho_u:.6f}",
             position_err_cells=f"{err_cells:.4f}",
             T_max=f"{T_free.max():.3f}", speed_wall_s=f"{speed_s:.3f}",
             newton_iters=FLAME_NEWTON_ITERS, newton_norm=f"{nrm:.6g}",
             newton_converged=ok, newton_wall_s=f"{newton_s:.3f}",
             host_solve_s=f"{host_solve[0]:.3f}",
             host_solve_share=f"{host_solve[0] / newton_s:.3f}")

        # ---- 2 (cont.): SolutionArray over the marched flame's points ----
        Xp = Y_prof / W
        sol = SolutionArray(mech, T=T_prof, P=card.P, X=Xp, device=dev)
        sol_c = SolutionArray(mech, T=T_prof, P=card.P, X=Xp, device=cpu)
        names = ("density", "cp_mole", "enthalpy_mole", "entropy_mole",
                 "net_production_rates")
        sol_err = {k: _rel_err(getattr(sol, k).cpu(), getattr(sol_c, k))
                   for k in names}
        sol.equilibrate("TP")
        sol_c.equilibrate("TP")
        sol_err["equilibrate_TP"] = _rel_err(sol.X.cpu(), sol_c.X)
        _check(max(v for k, v in sol_err.items() if k != "equilibrate_TP")
               <= FLAME_TOL and sol_err["equilibrate_TP"] <= FLAME_EQ_TOL,
               f"SolutionArray, card against host CPU: {sol_err}")
        _say("18-cantera-solution-array", states=len(sol),
             **{k: f"{v:.3g}" for k, v in sol_err.items()},
             tol=FLAME_TOL, equilibrate_tol=FLAME_EQ_TOL)

        # ---- 1: transport at full width --------------------------------
        t0 = time.perf_counter()
        tp_card = _flame_transport(mech, tr, mech_rk, tr_rk, dev)
        tp_s = time.perf_counter() - t0
        tp_host = got("transport")
        tp_err = {k: _rel_err(v, tp_host[k]) for k, v in tp_card.items()}
        _check(max(tp_err.values()) <= FLAME_TOL,
               f"transport, card against host CPU: {tp_err}")
        _say("18-cantera-transport", points=card.n, species=K,
             **{k: f"{v:.3g}" for k, v in tp_err.items()}, tol=FLAME_TOL,
             card_wall_s=f"{tp_s:.3f}",
             host_wall_s=f"{tp_host['host_s']:.3f}")

        # ---- 3, 5: RHS and Jacobians, card against host CPU ---------------
        flames = {"burner": (card, s0), "burner_marched": (card, y1)}
        for kind in ("burner_multi_soret", "counterflow", "jet"):
            flames[kind] = _flame_make(kind, mech, tr, dev)
        for kind, (f, y) in flames.items():
            t0 = time.perf_counter()
            r_c = f.rhs(0.0, y).cpu()
            j_c = f.jacobian(0.0, y).cpu()
            card_s = time.perf_counter() - t0
            h = got(kind)
            errs = (_rel_err(r_c, h["rhs"]), _rel_err(j_c, h["jac"]))
            _check(max(errs) <= FLAME_TOL,
                   f"{kind}: RHS {errs[0]}, Jacobian {errs[1]}, card "
                   f"against host CPU")
            _say(f"18-cantera-{kind}", unknowns=int(y.shape[0]),
                 rhs_rel_err=f"{errs[0]:.3g}", jac_rel_err=f"{errs[1]:.3g}",
                 tol=FLAME_TOL, card_wall_s=f"{card_s:.3f}",
                 host_wall_s=f"{h['host_s']:.3f}")

        # ---- 6: the surface ------------------------------------------------
        t0 = time.perf_counter()
        th, res_s = _flame_surface(mech, surf_path, dev)
        surf_s = time.perf_counter() - t0
        h = got("surface")
        th_err = float(np.abs(th - h["theta"]).max())
        sum_err = abs(float(th.sum()) - 1.0)
        _check(res_s.success and th_err <= FLAME_COVERAGE_TOL
               and sum_err <= 1e-12,
               f"advance_coverages: card against host CPU {th_err}, sum "
               f"{th.sum()}, success {res_s.success}")
        _say("18-cantera-surface", surface_species=surf_counts["species"],
             reactions=surf_counts["reactions"], steps=res_s.steps,
             steps_host=h["steps"], theta_abs_err=f"{th_err:.3g}",
             tol=FLAME_COVERAGE_TOL, theta_sum_err=f"{sum_err:.3g}",
             wall_s=f"{surf_s:.3f}", host_wall_s=f"{h['host_s']:.3f}")
    finally:
        pool.terminate()
        pool.join()
        tmp.cleanup()
    _say("18-cantera-flames", phase_s=f"{time.perf_counter() - t_phase:.3f}",
         hand_kernel_launches=sum(mod.LAUNCHES for mod in launch_mods))


# ---- phase 19: Cantera's phase models --------------------------------------

# the pure fluids' NASA7 ideal-gas anchors (GRI-Mech 3.0 low-range rows) and
# states: the two-phase T of set_TX, a liquid (T, P) and a gas (T, P)
_PF_NASA = {"N2": [3.298677, 1.4082404e-3, -3.963222e-6, 5.641515e-9,
                   -2.444854e-12, -1020.8999, 3.950372],
            "CO2": [2.35677352, 8.98459677e-3, -7.12356269e-6,
                    2.45919022e-9, -1.43699548e-13, -48371.9697,
                    9.90105222]}
_PF_STATES = {"N2": (90.0, (70.0, 1e6), (100.0, 1e5)),
              "CO2": (280.0, (250.0, 5e6), (300.0, 1e6))}
# the two molality sets of the reference's Debye-Huckel tests
_DH_MOLALITIES = (
    {"Na+": 9.3549, "Cl-": 9.3549, "H+": 1.0499e-8, "OH-": 1.3765e-6,
     "NaCl(aq)": 0.98492},
    {"Na+": 3.0, "Cl-": 3.0, "H+": 1.0499e-8, "OH-": 1.3765e-6,
     "NaCl(aq)": 0.98492})
_CONDENSED_PROPS = ("ideal-solid", "lattice", "margules", "redlich-kister",
                    "tabulated", "electron-cloud", "stoich-sub")


def _steam_grid(shape):
    """The steam table's states on the host: shape = (nT, nP) liquid
    states, T 275-550 K and P 10-100 MPa (all above saturation)."""
    import torch
    nT, nP = shape
    T, P = torch.meshgrid(
        torch.linspace(275.0, 550.0, nT, dtype=torch.float64),
        torch.linspace(1e7, 1e8, nP, dtype=torch.float64), indexing="ij")
    return T.reshape(-1), P.reshape(-1)


def _steam_table(T, P) -> dict:
    """torch.func.vmap of the IAPWS-95 density (60 Newton steps each) and
    of h, s, p and alpha at it, over the states (T, P)."""
    from torch.func import vmap

    from g4s_tpu_torch.models.cantera import water
    rho = vmap(water.density)(T, P)
    return {"rho": rho, "h": vmap(water.enthalpy_mole)(T, rho),
            "s": vmap(water.entropy_mole)(T, rho),
            "p": vmap(water.pressure)(T, rho),
            "alpha": vmap(water.thermal_expansion_coeff)(T, rho)}


def _steam_ops_per_state() -> float:
    """Element operations one steam-table state costs (its density, 60
    Newton steps, and h, s, p, alpha): the output elements of every
    pointwise aten op plus the input elements of every reduction, counted
    under TorchDispatchMode on one state on the host CPU (exp, pow and log
    count as one operation each)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                o = out if isinstance(out, torch.Tensor) else out[0]
                self.n += o.numel()
            elif func.overloadpacket.__name__ in ("sum", "dot", "mv"):
                self.n += args[0].numel()
            return out

    T, P = _steam_grid((1, 1))
    with Count() as c:
        _steam_table(T[:1], P[:1])
    return float(c.n)


def _hmw_states(ph, n: int):
    """n (T, molalities) of a seeded sweep: T 275-370 K,
    the seawater state's major ions scaled by 0.5-6 (ionic strength about
    0.35 to 4.3 mol/kg), the minor species as they are."""
    import numpy as np
    rng = np.random.default_rng(PHASE19_SEED)
    out = []
    for T, f in zip(rng.uniform(275.0, 370.0, n),
                    rng.uniform(0.5, 6.0, n)):
        m = np.zeros(ph.nspec)
        for k, v in ph.state_molalities.items():
            m[ph.species_index(k)] = v * (f if v > 1e-4 else 1.0)
        out.append((float(T), m))
    return out


def _vcs_run(dev, brine: str, phases: str) -> dict:
    """The reference's NaCl_equil layout: the brine's NaCl phase, the
    air-water gas read by load_mechanism and NaCl(S) as a Shomate
    stoichiometric phase; 2 mol H2O(L), 4 mol N2, 5 mol NaCl(S) at 298.15 K
    and 1 atm. Returns the result with the species' compositions."""
    import numpy as np

    from g4s_tpu_torch.models.cantera import load_mechanism, vcs_multiphase
    T, P = 298.15, 101325.0
    sol = vcs_multiphase.hmw_solution_phase(brine, "NaCl-brine", T, P,
                                            device=dev)
    gas = vcs_multiphase.gas_solution_phase(
        load_mechanism(phases, "air-water"), T, P, device=dev)
    solid = vcs_multiphase.stoich_phase_from_yaml(brine, "NaCl(S)", T, P)
    res = vcs_multiphase.vcs_multiphase_tp(
        [sol, gas, solid], [np.array([2.0, 0.0, 0.0, 0.0, 0.0]),
                            np.array([4.0, 0.0, 0.0]), np.array(5.0)],
        T, P)
    comps = {solid.name: solid.composition}
    for ph in (sol, gas):
        comps.update(zip(ph.species_names, ph.compositions))
    res["comps"] = comps
    return res


def _phase_block(block: str, dev, brine: str, phases: str, sizes: dict,
                 part=None) -> dict:
    """Phase 19's block `block` on `dev`: its outputs as flat numpy arrays
    (keys starting "check:" are checked, not compared with the other
    device). sizes: {"steam": (nT, nP), "hmw": states}; `part` = (lo, hi)
    takes a slice of the steam table."""
    import numpy as np
    import torch

    from g4s_tpu_torch.models.cantera import (condensed, electrolyte, hmw,
                                              plasma, purefluid, water)
    out = {}

    def put(key, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        out[key] = np.asarray(v, np.float64)

    if block == "steam":
        T, P = _steam_grid(sizes["steam"])
        lo, hi = part if part is not None else (0, T.numel())
        for k, v in _steam_table(T[lo:hi].to(dev), P[lo:hi].to(dev)).items():
            put(k, v)
    elif block == "water":
        put("p500", water.pressure(500.0, 838.025, device=dev))
        put("rho298", water.density(298.15, 101325.0, device=dev))
        put("mu0_423", water.WaterStandardState(device=dev).mu0(423.15))
        put("alpha", torch.stack([water.thermal_expansion_coeff(
            T, water.density(T, 101325.0, device=dev))
            for T in (276.15, 300.0)]))
    elif block == "hmw":
        ph = hmw.load_hmw(brine, "seawater")
        for i, (T, m) in enumerate(_hmw_states(ph, sizes["hmw"])):
            rho = water.density(T, 101325.0, device=dev)
            act = hmw.activity_all(ph, m, T, rho_water=rho, device=dev)
            pmp = hmw.partial_molar_props(ph, T, 101325.0, m, device=dev)
            for k in ("acMol", "activities", "osmotic", "a_w"):
                put(f"{i}:act:{k}", act[k])
            for k in ("acoeff", "vbar", "hbar", "mu0", "V0", "H0"):
                put(f"{i}:pmp:{k}", pmp[k])
    elif block == "dh":
        for name in DH_PHASES:
            ph = electrolyte.load_debye_huckel(phases, name)
            for j, ms in enumerate(_DH_MOLALITIES):
                m = np.zeros(ph.nspec)
                for k, v in ms.items():
                    m[ph.species_index(k)] = v
                put(f"{name}:{j}:gamma",
                    electrolyte.molality_activity_coefficients(
                        ph, m, device=dev))
                put(f"{name}:{j}:I",
                    electrolyte.ionic_strength(ph, m, device=dev))
    elif block == "condensed":
        rng = np.random.default_rng(PHASE19_SEED)
        for name in _CONDENSED_PROPS:
            ph = condensed.load_phase(phases, name)
            X = rng.dirichlet(np.ones(len(ph.species)))
            pr = condensed.props(ph, 600.0, 2e6, X, device=dev)
            for k in pr._fields:
                put(f"{name}:{k}", getattr(pr, k))
            put(f"{name}:density",
                condensed.density(ph, 600.0, 2e6, X, device=dev))
        mk = condensed.load_phase(phases, "maskell")
        put("maskell:mu", condensed.maskell_chem_potentials(
            mk, 450.0, 2e5, np.array([0.35, 0.65]), device=dev))
        cl = condensed.load_phase(phases, "compound-lattice")
        for k, v in zip(("h", "s", "v", "mw", "mu"),
                        condensed.compound_lattice_props(
                            cl, 600.0, 4e6, [np.array([0.3, 0.7]),
                                             np.array([1.0])], device=dev)):
            put(f"compound-lattice:{k}", v)
        ifn = condensed.load_phase(phases, "ions-from-neutral")
        for k, v in condensed.ions_props(ifn, 800.0, 101325.0,
                                         np.array([0.3, 0.2, 0.5]),
                                         device=dev).items():
            put(f"ions-from-neutral:{k}", v)
        im = condensed.load_phase(phases, "ideal-molal")
        for k, v in condensed.ideal_molal_props(
                im, 320.0, 3e5, np.array([0.5, 1.5]), device=dev).items():
            put(f"ideal-molal:{k}", v)
    elif block == "purefluid":
        for name, (T_sat, liq, gas) in _PF_STATES.items():
            pf = purefluid.PureFluid(purefluid.SUBSTANCES[name],
                                     _PF_NASA[name], device=dev)
            put(f"{name}:offsets", [pf.h_off, pf.s_off])
            sat = purefluid.update_sat(pf.sub, T_sat, device=dev)
            put(f"{name}:sat", sat)
            g = [float(purefluid.g_mass(pf.sub, r, T_sat, device=dev))
                 for r in sat[1:]]
            out[f"check:{name}:sat_residual"] = \
                abs(g[0] - g[1]) / max(abs(g[0]), abs(g[1]))
            put(f"{name}:two_phase", pf.set_TX(T_sat, 0.5))
            for label, (T, Pr) in (("liquid", liq), ("gas", gas)):
                rho = pf.set_TP(T, Pr)[0]
                pr = pf.props(T, rho)
                put(f"{name}:{label}", [rho, pr["h_mole"], pr["s_mole"],
                                        pr["g_mole"]])
    elif block == "plasma":
        X = np.random.default_rng(PHASE19_SEED).dirichlet(np.ones(5))
        for name in PLASMA_PHASES:
            ph = plasma.load_plasma(phases, name, device=dev)
            put(f"{name}:dist", ph.dist)
            put(f"{name}:Te", ph.Te)
            put(f"{name}:em", ph.mean_energy())
            for T in (300.0, 1200.0):
                for f in ("h0_RT", "s0_R", "cp0_R"):
                    put(f"{name}:{T}:{f}", getattr(ph, f)(T))
                put(f"{name}:{T}:h", ph.enthalpy_mole(T, X))
            put(f"{name}:rate", plasma.two_temp_plasma_rate(
                3.2e-9, 0.7, 400.0, 1500.0, 500.0, ph.Te, device=dev))
    elif block == "vcs":
        res = _vcs_run(dev, brine, phases)
        for name, d in res["phases"].items():
            put(f"{name}:N", d["N"])
            put(f"{name}:x", list(d["x"].values()))
        tot = {}
        for d in res["phases"].values():
            for sp, x in d["x"].items():
                for e, v in res["comps"][sp].items():
                    tot[e] = tot.get(e, 0.0) + d["N"] * x * v
        b0 = {"H": 4.0, "O": 2.0, "N": 8.0, "NA": 5.0, "CL": 5.0, "E": 0.0}
        out["check:element_err"] = max(abs(tot.get(e, 0.0) - v)
                                       for e, v in b0.items()) / 8.0
        out["check:outer"] = res["outer"]
        out["check:newton"] = res["newton"]
        out["check:nacl_s"] = res["phases"]["NaCl(S)"]["N"]
    else:
        raise ValueError(block)
    return out


def _phase_host(block: str, brine: str, phases: str, sizes: dict,
                part=None) -> dict:
    """Phase 19's host-CPU side of one block, in a process of its own with
    one torch thread: its outputs, and the wall s it took."""
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = _phase_block(block, torch.device("cpu"), brine, phases, sizes,
                       part)
    if block == "steam" and part is not None and part[0] == 0:
        out["check:ops_per_state"] = _steam_ops_per_state()
    out["check:host_s"] = time.perf_counter() - t0
    return out


def _steam_host_start() -> dict:
    """Phase 19's host-CPU steam table in PHASE19_STEAM_CHUNKS spawned
    one-thread processes, started with phase 13: the table is most of
    phase 19's host work (a chunk of 16,384 states took 41 s on the card
    machine's host), and while phases 13 and 17 run a few host-bound
    processes the host has cores to spare. Returns the pool and the
    chunks' async results; _steam_host_stop ends them."""
    sizes = {"steam": PHASE19_STEAM, "hmw": PHASE19_HMW_STATES}
    n = PHASE19_STEAM[0] * PHASE19_STEAM[1]
    chunks = [(i * n // PHASE19_STEAM_CHUNKS,
               (i + 1) * n // PHASE19_STEAM_CHUNKS)
              for i in range(PHASE19_STEAM_CHUNKS)]
    pool = multiprocessing.get_context("spawn").Pool(PHASE19_STEAM_CHUNKS)
    return {"pool": pool, "chunks": {c: pool.apply_async(
        _phase_host, ("steam", "", "", sizes, c)) for c in chunks}}


def _steam_host_stop(run: dict) -> None:
    run["pool"].terminate()
    run["pool"].join()


def _phase_models(dev, steam_host: dict) -> None:
    """Phase 19 (see the module docstring): Cantera's phase models on the
    card, each block against the host CPU, whose side runs in spawned
    one-thread processes started first (the steam table's in
    `steam_host`, from _steam_host_start). Each block prints one line: its
    largest relative error against the host CPU, the wall ms of one call of
    its main function, that call's device kernels, busy ms and idle share
    in one profile."""
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.models.cantera import (condensed, electrolyte, hmw,
                                              plasma, purefluid, water)
    from g4s_tpu_torch.obs.timings import device_activities
    from g4s_tpu_torch.ops import bwell_spmv, route, segment, wsell_spmv

    launch_mods = (route, wsell_spmv, bwell_spmv, segment)
    for mod in launch_mods:
        mod.LAUNCHES = 0
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    brine = os.path.join(tmp.name, "brine_synthetic.yaml")
    phases = os.path.join(tmp.name, "phase_models.yaml")
    counts = _synthetic_brine_yaml(brine, seed=CANTERA_SEED)
    _phase_models_yaml(phases)
    _check(counts["solutes"] == 11, f"phase 19 brine: {counts}")
    sizes = {"steam": PHASE19_STEAM, "hmw": PHASE19_HMW_STATES}
    n_states = PHASE19_STEAM[0] * PHASE19_STEAM[1]
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        # the two long blocks start on workers of their own; the card
        # takes them after the short ones
        host = {b: pool.apply_async(_phase_host, (b, brine, phases, sizes))
                for b in ("water", "hmw", "purefluid", "dh", "condensed",
                          "plasma", "vcs")}

        def got(key):
            return host[key].get(timeout=PHASE19_HOST_TIMEOUT)

        def compare(block, card, ref):
            errs = {k: _rel_err(v, ref[k]) for k, v in card.items()
                    if not k.startswith("check:")}
            worst = max(errs, key=errs.get)
            _check(errs[worst] <= PHASE19_TOL[block],
                   f"phase 19 {block}, card against host CPU: {worst} "
                   f"{errs[worst]} > {PHASE19_TOL[block]}")
            return errs[worst], worst

        def profile(fn, wall_ms):
            acts = device_activities(fn)
            busy = sum(us for _, us in acts) / 1e3
            return {"kernels_per_call": len(acts),
                    "busy_ms": f"{busy:.3f}",
                    "device_idle_share": f"{max(0.0, 1 - busy / wall_ms):.3f}"}

        def run(block):
            t0 = time.perf_counter()
            out = _phase_block(block, dev, brine, phases, sizes)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # ---- IAPWS-95: the release values on the card
        card, block_s = run("water")
        err, worst = compare("water", card, got("water"))
        _check(abs(float(card["p500"]) / 1e6 - 10.0003858) < 2e-5
               and abs(float(card["rho298"]) - 997.0476) < 1e-3
               and abs(float(card["mu0_423"]) / 1e6 + 317.175792) < 2e-6
               and card["alpha"][0] < 0.0 < card["alpha"][1],
               f"IAPWS-95 release values on the card: {card}")
        rho_call = lambda: water.density(298.15, 101325.0,  # noqa: E731
                                         device=dev)
        wall = _sync_ms(rho_call, reps=3)
        T1, P1 = torch.full((), 298.15, dtype=torch.float64, device=dev), \
            torch.full((), 101325.0, dtype=torch.float64, device=dev)
        eager_ms = _sync_ms(lambda: water._newton(T1, P1, water._start(
            T1, P1, water.WATER_LIQUID)), reps=1)
        _say("19-water", p_500K_838kgm3_MPa=f"{float(card['p500']) / 1e6:.7f}",
             rho_298K_1atm=f"{float(card['rho298']):.4f}",
             mu0_423K_kJ_per_gmol=f"{float(card['mu0_423']) / 1e6:.6f}",
             alpha_276K=f"{card['alpha'][0]:.4g}",
             alpha_300K=f"{card['alpha'][1]:.4g}",
             max_rel_err=f"{err:.3g}", tol=PHASE19_TOL["water"],
             density_eager_ms=f"{eager_ms:.2f}",
             density_graph_replay_ms=f"{wall:.3f}",
             **profile(rho_call, wall))

        # ---- Debye-Huckel, the five forms at the two molality sets
        card, block_s = run("dh")
        ref = got("dh")
        err, worst = compare("dh", card, ref)
        dh = electrolyte.load_debye_huckel(phases, "dh-bdot-ak")
        m = np.zeros(dh.nspec)
        for k, v in _DH_MOLALITIES[0].items():
            m[dh.species_index(k)] = v
        m = torch.as_tensor(m, device=dev)
        dh_call = lambda: electrolyte.molality_activity_coefficients(  # noqa
            dh, m)
        wall = _sync_ms(dh_call, reps=10)
        _say("19-debye-huckel", forms=len(DH_PHASES), molality_sets=2,
             max_rel_err=f"{err:.3g}", worst=worst, tol=PHASE19_TOL["dh"],
             block_s=f"{block_s:.3f}", gamma_wall_ms=f"{wall:.3f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(dh_call, wall))

        # ---- condensed families
        card, block_s = run("condensed")
        ref = got("condensed")
        err, worst = compare("condensed", card, ref)
        cd = condensed.load_phase(phases, "ideal-solid")
        X = np.full(3, 1.0 / 3.0)
        cd_call = lambda: condensed.props(cd, 600.0, 2e6, X,  # noqa: E731
                                          device=dev)
        wall = _sync_ms(cd_call, reps=5)
        _say("19-condensed", families=len(_CONDENSED_PROPS) + 4,
             max_rel_err=f"{err:.3g}", worst=worst,
             tol=PHASE19_TOL["condensed"], block_s=f"{block_s:.3f}",
             props_wall_ms=f"{wall:.3f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(cd_call, wall))

        # ---- plasma
        card, block_s = run("plasma")
        ref = got("plasma")
        err, worst = compare("plasma", card, ref)
        pl = plasma.load_plasma(phases, "plasma-druyvesteyn", device=dev)
        Xp = np.full(5, 0.2)
        pl_call = lambda: (pl.h0_RT(300.0), pl.enthalpy_mole(  # noqa: E731
            300.0, Xp), plasma.two_temp_plasma_rate(
            3.2e-9, 0.7, 400.0, 1500.0, 500.0, pl.Te, device=dev))
        wall = _sync_ms(pl_call, reps=5)
        _say("19-plasma", distributions=len(PLASMA_PHASES),
             levels=PLASMA_LEVELS,
             Te_maxwell_K=f"{float(card['plasma-maxwell:Te']):.3f}",
             Te_druyvesteyn_K=f"{float(card['plasma-druyvesteyn:Te']):.3f}",
             Te_discretized_K=f"{float(card['plasma-discretized:Te']):.3f}",
             max_rel_err=f"{err:.3g}", worst=worst,
             tol=PHASE19_TOL["plasma"], block_s=f"{block_s:.3f}",
             thermo_rate_wall_ms=f"{wall:.3f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(pl_call, wall))

        # ---- HMW seawater, 16 states
        card, block_s = run("hmw")
        ref = got("hmw")
        err, worst = compare("hmw", card, ref)
        ph = hmw.load_hmw(brine, "seawater")
        T0, m0 = _hmw_states(ph, PHASE19_HMW_STATES)[0]
        pmp_call = lambda: hmw.partial_molar_props(  # noqa: E731
            ph, T0, 101325.0, m0, device=dev)
        wall = _sync_ms(pmp_call, reps=3)
        _say("19-hmw", species=counts["species"],
             interactions=counts["interactions"], states=PHASE19_HMW_STATES,
             max_rel_err=f"{err:.3g}", worst=worst, tol=PHASE19_TOL["hmw"],
             block_s=f"{block_s:.2f}",
             partial_molar_props_wall_ms=f"{wall:.2f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(pmp_call, wall))

        # ---- pure fluids
        card, block_s = run("purefluid")
        ref = got("purefluid")
        err, worst = compare("purefluid", card, ref)
        sat_res = max(v for k, v in card.items() if k.endswith(
            "sat_residual"))
        _check(sat_res <= PHASE19_SAT_TOL,
               f"pure fluids: equal-Gibbs residual {sat_res}")
        T_l, P_l = _PF_STATES["N2"][1]
        rho_call = lambda: purefluid.rho_tp(  # noqa: E731
            purefluid.NITROGEN, T_l, P_l, 800.0, device=dev)
        wall = _sync_ms(rho_call, reps=3)
        t0 = time.perf_counter()
        purefluid.update_sat(purefluid.NITROGEN, _PF_STATES["N2"][0],
                             device=dev)
        sat_ms = (time.perf_counter() - t0) * 1e3
        _say("19-pure-fluids", fluids="N2,CO2",
             N2_liquid_rho=f"{card['N2:liquid'][0]:.6f}",
             CO2_psat_280K=f"{card['CO2:sat'][0]:.2f}",
             sat_residual=f"{sat_res:.3g}", sat_tol=PHASE19_SAT_TOL,
             max_rel_err=f"{err:.3g}", worst=worst,
             tol=PHASE19_TOL["purefluid"], block_s=f"{block_s:.2f}",
             update_sat_ms=f"{sat_ms:.1f}", rho_tp_wall_ms=f"{wall:.2f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(rho_call, wall))

        # ---- VCS multiphase
        card, block_s = run("vcs")
        ref = got("vcs")
        err, worst = compare("vcs", card, ref)
        _check(card["check:outer"] == ref["check:outer"]
               and card["check:element_err"] <= PHASE19_ELEMENT_TOL
               and 0.0 < card["check:nacl_s"] < 5.0,
               f"VCS: outer sweeps {card['check:outer']} card, "
               f"{ref['check:outer']} host; element error "
               f"{card['check:element_err']}; NaCl(S) "
               f"{card['check:nacl_s']}")
        vcs_call = lambda: _vcs_run(dev, brine, phases)  # noqa: E731
        _say("19-vcs", outer_sweeps=card["check:outer"],
             outer_sweeps_host=ref["check:outer"],
             newton_iters=card["check:newton"],
             nacl_s_mol=f"{card['check:nacl_s']:.9f}",
             element_rel_err=f"{card['check:element_err']:.3g}",
             element_tol=PHASE19_ELEMENT_TOL, max_rel_err=f"{err:.3g}",
             worst=worst, tol=PHASE19_TOL["vcs"],
             solve_wall_ms=f"{block_s * 1e3:.1f}",
             host_wall_s=f"{ref['check:host_s']:.2f}",
             **profile(vcs_call, block_s * 1e3))
        # ---- the steam table, its host side started with phase 13
        T_all, P_all = _steam_grid(PHASE19_STEAM)
        Td, Pd = T_all.to(dev), P_all.to(dev)
        card, block_s = run("steam")
        ref = {}
        for c, res in steam_host["chunks"].items():
            part = res.get(timeout=PHASE19_HOST_TIMEOUT)
            for k, v in part.items():
                ref.setdefault(k, []).append(v)
        ops = ref.pop("check:ops_per_state")[0] * n_states
        host_s = max(ref.pop("check:host_s"))
        ref = {k: np.concatenate(v) for k, v in ref.items()}
        err, worst = compare("steam", card, ref)
        key_errs = {k: _rel_err(card[k], ref[k]) for k in ref}
        _check(all(key_errs[k] <= t for k, t in PHASE19_STEAM_TIGHT.items())
               and _rel_err(card["p"], P_all.numpy()) <= 1e-10,
               f"steam table, card against host CPU: {key_errs}; p(T, rho) "
               f"against P {_rel_err(card['p'], P_all.numpy())}")
        table = lambda: _steam_table(Td, Pd)  # noqa: E731
        wall = _sync_ms(table, reps=1)
        bound = ops / F64_OPS_PER_S * 1e3
        _say("19-steam-table", states=n_states, newton_steps=60,
             **{f"rel_err_{k}": f"{v:.3g}" for k, v in key_errs.items()},
             tol_rho_h_s=PHASE19_STEAM_TIGHT["rho"],
             tol_p_alpha=PHASE19_TOL["steam"], ms_per_call=f"{wall:.2f}",
             us_per_state=f"{wall * 1e3 / n_states:.4f}",
             element_ops=f"{ops:.4g}", f64_bound_ms=f"{bound:.4f}",
             bound_share=f"{bound / wall:.4g}",
             host_wall_s=f"{host_s:.2f}", **profile(table, wall))
    finally:
        pool.terminate()
        pool.join()
        tmp.cleanup()
    _say("19-phase-models", phase_s=f"{time.perf_counter() - t_phase:.3f}",
         hand_kernel_launches=sum(mod.LAUNCHES for mod in launch_mods))


def _timed_steps(s, steps: int, step):
    """`steps` synchronized steps of `step(s) -> (s, diag)`: wall s/step,
    inner iterations and host syncs per step, and the last state."""
    import torch
    from g4s_tpu_torch.models.citcoms import solvers
    torch.cuda.synchronize()
    solvers.HOST_SYNCS = 0
    inner = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        s, d = step(s)
        inner += d.inner_iterations
    torch.cuda.synchronize()
    return {"s": s, "wall_s": (time.perf_counter() - t0) / steps,
            "inner": inner / steps,
            "host_syncs": solvers.HOST_SYNCS / steps}


def _profiled_step(step, s):
    """Device kernels, busy ms and segment sums of one more step(s) under
    torch.profiler, and the kernels that took the most of its busy time
    ("top": name, launches, ms), and the profiles it took ("tries")."""
    from g4s_tpu_torch.obs import timings
    t0 = time.perf_counter()
    acts = timings.device_activities(lambda: step(s))
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, us in acts:
        by_name[name][0] += 1
        by_name[name][1] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return {"kernels": len(acts), "seconds": time.perf_counter() - t0,
            "tries": timings.PROFILE_TRIES,
            "busy_ms": sum(us for _, us in acts) / 1e3,
            "segment_sums": sum("sorted_segment_sum_kernel" in name
                                for name, _ in acts),
            "top": ";".join(f"{name[:48].replace(' ', '_')}:{n}:{ms:.2f}"
                            for name, (n, ms) in top)}


def _state_err(a, b, names=("T", "Tdot", "V", "P", "dt", "time")) -> dict:
    return {k: _rel_err(getattr(a, k).cpu(), getattr(b, k).cpu())
            for k in names}


def _to_host(model_h, s):
    from g4s_tpu_torch.models.citcoms import state_from_numpy
    return state_from_numpy(model_h, dict(
        {k: getattr(s, k).cpu() for k in ("T", "Tdot", "V", "P", "time",
                                          "dt")}, step=s.step))


def _segment_sum_case(phase, shape, dtype, flat, ids, order, n_seg, ms_of):
    """The segment-sum kernel at one shape a CitcomS path gives it: bitwise
    repeatable and equal to the host CPU's in-order sum, within 1e-12 (f64)
    or REL_TOL (f32) of the largest sum from its plain version (gather +
    index_add_, whose atomics on the card add in another order), and timed
    beside its bytes bound, the plain version and one index_add_ of the
    unsorted rows (its zero fill included), the same function."""
    import torch
    from g4s_tpu_torch.ops import segment
    seg_sum = lambda: segment.sorted_segment_sum(flat, ids, n_seg,
                                                 order=order)
    seg_plain = lambda: segment._sorted_segment_sum_plain(flat, ids, n_seg,
                                                          order=order)
    ids_by_row = torch.empty_like(ids)
    ids_by_row[order] = ids
    seg_lib = lambda: torch.zeros(
        (n_seg,) + tuple(flat.shape[1:]), dtype=flat.dtype,
        device=flat.device).index_add_(0, ids_by_row, flat)
    got = seg_sum()
    _check(torch.equal(got, seg_sum()) and torch.equal(
        got.cpu(), segment._sorted_segment_sum_plain(
            flat.cpu(), ids.cpu(), n_seg, order=order.cpu())),
        f"segment sum at the {shape} ({dtype}): not bitwise repeatable or "
        "not the host CPU's sum")
    want = seg_plain()
    e = float((got - want).abs().max())
    _check(e <= (1e-12 if dtype == "f64" else REL_TOL)
           * float(want.abs().max()),
           f"segment sum at the {shape} ({dtype}) vs plain: {e}")
    cols = flat[0].numel()
    run = torch.bincount(ids.long(), minlength=n_seg).max()
    r = {"err": e, "ms": ms_of(seg_sum, reps=50),
         "plain_ms": ms_of(seg_plain, reps=50),
         "library_ms": ms_of(seg_lib, reps=50),
         # rows, ids and order read as passed; the sums written; one add
         # per element
         "bound": _bound(flat.numel() * flat.element_size()
                         + ids.numel() * ids.element_size()
                         + order.numel() * order.element_size()
                         + n_seg * cols * flat.element_size(),
                         flat.numel())}
    _say(phase, shape=shape, dtype=dtype, rows=order.numel(), cols=cols,
         segments=n_seg, longest_run=int(run),
         index=str(ids.dtype).replace("torch.", ""),
         bitwise_repeatable=True, equals_host_cpu=True,
         max_abs_err_vs_index_add=f"{e:.3g}", kernel_ms=f"{r['ms']:.4f}",
         plain_ms=f"{r['plain_ms']:.4f}",
         index_add_ms=f"{r['library_ms']:.4f}",
         bound_ms=f"{r['bound'][0]:.4f}",
         share_of_bound=f"{r['bound'][0] / r['ms']:.3f}")
    return r


def _citcoms_tail(dev, cookbook2, cg9: dict, ms_of) -> dict:
    """Phase 14: the rest of regional CitcomS at Cookbook2's 33x33x9 nodes
    (multigrid, thermochemical tracers, phase changes, TALA, anisotropy,
    lith_age, bc files, the CLI's output, checkpoints, restart and
    graceful stop). `cg9` carries phase 9's CG numbers, printed beside
    multigrid's. Returns the segment-sum kernel's launches over the phase's
    card runs and its reading at the finest restriction in f64."""
    import shutil
    import signal
    import tempfile
    import numpy as np
    import torch
    from g4s_tpu_torch.drivers import citcoms_regional
    from g4s_tpu_torch.models.citcoms import CitcomModel, bc_files, tracers
    from g4s_tpu_torch.models.citcoms.observables import rms_velocity
    from g4s_tpu_torch.ops import segment
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    f64 = torch.float64
    tol = CITCOMS_TAIL_TOL
    segment.LAUNCHES = 0
    lap = [t_phase]

    def since() -> str:
        """Host seconds since the last call (each part's own time)."""
        t, lap[0] = lap[0], time.perf_counter()
        return f"{lap[0] - t:.1f}"

    # ---- (a) Solver=multigrid, levels 3: 33x33x9 -> 17x17x5 -> 9x9x3 ----
    mgcfg = dataclasses.replace(cookbook2, solver_type="multigrid", levels=3)

    def mg_run(model, steps=CITCOMS_MG_F64_STEPS):
        """[(state, (Uzawa, V-cycles))] after the initial solve and each
        step."""
        s, mon = model.initial_solve(model.init_state())
        states = [(s, (mon.outer_iterations, mon.inner_iterations))]
        for _ in range(steps):
            s, d = model.step(s)
            states.append((s, (d.uzawa_iterations, d.inner_iterations)))
        return states

    t0 = time.perf_counter()
    mg64 = CitcomModel(mgcfg, dtype=f64, device=dev)
    build_s = time.perf_counter() - t0
    levels = ",".join(f"{lv.cfg.nodex}x{lv.cfg.nodey}x{lv.cfg.nodez}"
                      for lv in mg64.mg.levels)
    _check(len(mg64.mg.levels) == 3, f"multigrid levels {levels}")
    run_a = mg_run(mg64)
    run_b = mg_run(mg64)
    _check(all(ca == cb and all(torch.equal(getattr(sa, k), getattr(sb, k))
                                for k in ("T", "Tdot", "V", "P", "dt"))
               for (sa, ca), (sb, cb) in zip(run_a, run_b)),
           "multigrid f64: two card runs differ")
    mg_h = CitcomModel(mgcfg, dtype=f64, device="cpu")
    t0 = time.perf_counter()
    run_h = mg_run(mg_h)
    host_s = time.perf_counter() - t0
    mg_err = []
    for (sg, cg_), (sh, ch) in zip(run_a, run_h):
        _check(cg_ == ch, f"multigrid f64 counts, card {cg_} host CPU {ch}")
        e = _state_err(sg, sh, ("T", "V", "P", "dt") if sg.step else
                       ("V", "P"))
        mg_err.append(max(e.values()))
    _check(max(mg_err) <= tol,
           f"multigrid f64, card against host CPU: {mg_err}")
    vrms_mg = float(rms_velocity(mg64, run_a[0][0].V))
    vrms_rel = abs(vrms_mg - cg9["vrms0"]) / cg9["vrms0"]
    _check(vrms_rel <= CITCOMS_MG_VRMS_TOL,
           f"multigrid initial vrms {vrms_mg} against CG {cg9['vrms0']}")
    _say("14-multigrid-f64", levels=levels,
         model_build_s=f"{build_s:.2f}", runs=2, deterministic=True,
         uzawa_vcycles=",".join(f"{c[0]}/{c[1]}" for _, c in run_a),
         rel_err_vs_host_cpu=",".join(f"{e:.3g}" for e in mg_err), tol=tol,
         host_cpu_s=f"{host_s:.2f}", vrms0=f"{vrms_mg:.10g}",
         cg_vrms0=f"{cg9['vrms0']:.10g}", vrms_rel=f"{vrms_rel:.3g}",
         seconds=since())
    del run_b, run_h, mg_h
    mg32 = CitcomModel(mgcfg, dtype=torch.float32, device=dev)
    s32, _ = mg32.initial_solve(mg32.init_state())
    s32, _ = mg32.step(s32)                                   # warm-up
    t32 = _timed_steps(s32, CITCOMS_MG_F32_STEPS, mg32.step)
    p32 = _profiled_step(mg32.step, t32["s"])
    wall = t32["wall_s"]
    _say("14-multigrid-f32", warmup_steps=1,
         timed_steps=CITCOMS_MG_F32_STEPS,
         s_per_step=f"{wall:.4f}", vcycles_per_step=t32["inner"],
         host_syncs_per_step=t32["host_syncs"],
         device_kernels_per_step=p32["kernels"],
         device_busy_ms_per_step=f"{p32['busy_ms']:.2f}",
         device_idle_share=f"{max(0.0, 1 - p32['busy_ms'] / 1e3 / wall):.3f}",
         segment_sums_per_step=p32["segment_sums"],
         cg_s_per_step=cg9["s_per_step"], cg_inner_per_step=cg9["inner"],
         cg_host_syncs_per_step=cg9["host_syncs"],
         cg_device_kernels_per_step=cg9["kernels"],
         cg_device_busy_ms_per_step=cg9["busy_ms"],
         cg_device_idle_share=cg9["idle"],
         profile_s=f"{p32['seconds']:.1f}",
         profile_tries=p32["tries"], seconds=since())
    # the segment sums' inputs at the shapes this phase adds, held and
    # timed after its launches are read: restriction at both levels
    seg_inputs = {}
    for name, m in (("f64", mg64), ("f32", mg32)):
        for li in (1, 2):
            ip = m.mg.levels[li].interp
            fine = m.mg.levels[li - 1]
            r = torch.from_numpy(np.random.default_rng(li).standard_normal(
                (fine.mesh.nno, 3))).to(dev, m.dtype)
            key = (f"project_down_{fine.cfg.nodex}x{fine.cfg.nodey}x"
                   f"{fine.cfg.nodez}", name)
            if (li, name) == (1, "f64"):
                finest = key
            seg_inputs[key] = (
                (ip.w[:, :, None] * r[:, None, :]).reshape(-1, 3),
                ip.seg_ids, ip.order, ip.nno_coarse)
    del mg64, mg32, s32, t32, run_a

    # ---- (b) the thermochemical step: 10 tracers per element ------------
    tcfg = dataclasses.replace(cookbook2, tracer=True, chemical_buoyancy=True,
                               buoyancy_ratio=1.0)
    tm = CitcomModel(tcfg, dtype=f64, device=dev)
    tm_h = CitcomModel(tcfg, dtype=f64, device="cpu")
    pos0, fl0 = tracers.seed_tracers(tm.mesh, CITCOMS_TRACERS_PER_ELEMENT,
                                     seed=0, flavor_boundary_r=tcfg.z_interface)
    s0, _ = tm.initial_solve(tm.init_state())
    sg, sh = s0, _to_host(tm_h, s0)
    pg = torch.from_numpy(pos0).to(dev)
    ph = torch.from_numpy(pos0)
    flg, flh = torch.from_numpy(fl0).to(dev), torch.from_numpy(fl0)
    tf = tm.tracer_field
    tr_err = []
    for _ in range(3):
        sg, dg, pg = tm.step_tracers(sg, pg, flg)
        sh, dh, ph = tm_h.step_tracers(sh, ph, flh)
        _check((dg.uzawa_iterations, dg.inner_iterations)
               == (dh.uzawa_iterations, dh.inner_iterations),
               f"thermochemical counts {dg} {dh}")
        cg_, _ = tracers.element_composition(tf, pg, flg)
        ch, _ = tracers.element_composition(tf, ph, flh)
        _check(torch.equal(cg_.cpu(), ch),
               "thermochemical f64: element compositions differ")
        tr_err.append((_rel_err(pg.cpu(), ph),
                       max(_state_err(sg, sh).values())))
    _check(max(e for e, _ in tr_err) <= tol,
           f"tracer positions, card against host CPU: {tr_err}")
    _say("14-thermochemical-f64", tracers=pos0.shape[0], seed=0,
         buoyancy_ratio=1.0, steps=3, compositions_equal=True,
         pos_rel_err=",".join(f"{e:.3g}" for e, _ in tr_err),
         field_rel_err=",".join(f"{e:.3g}" for _, e in tr_err), tol=tol,
         seconds=since())
    for name, dt in (("f64", f64), ("f32", torch.float32)):
        seg_inputs[("composition_to_nodes", name)] = (
            cg_[1].to(dt)[:, None].expand(-1, 8).reshape(-1, 1),
            tm.plan.seg_ids, tm.plan.order, tm.plan.nno)
    del tm_h, sh, ph
    tm32 = CitcomModel(tcfg, dtype=torch.float32, device=dev)
    box = {"pos": torch.from_numpy(pos0).to(dev, torch.float32)}

    def tstep(s):
        s, d, box["pos"] = tm32.step_tracers(s, box["pos"], flg)
        return s, d

    s32, _ = tm32.initial_solve(tm32.init_state())
    s32, _ = tstep(s32)                                       # warm-up
    t32 = _timed_steps(s32, 3, tstep)
    pr = _profiled_step(tstep, t32["s"])
    _say("14-thermochemical-f32", tracers=pos0.shape[0], timed_steps=3,
         ms_per_step=f"{t32['wall_s'] * 1e3:.2f}",
         inner_cg_per_step=t32["inner"],
         host_syncs_per_step=t32["host_syncs"],
         device_kernels_per_step=pr["kernels"],
         device_busy_ms_per_step=f"{pr['busy_ms']:.2f}",
         device_idle_share=f"{max(0.0, 1 - pr['busy_ms'] / 1e3 / t32['wall_s']):.3f}",
         profile_s=f"{pr['seconds']:.1f}",
         profile_tries=pr["tries"], seconds=since())
    del tm, tm32, s32, t32

    # ---- (c) one f64 step of each other branch, card against host CPU ---
    # The parameters of the reference's tests of each branch
    # (tests/test_citcoms.py:763-940,1040-1187,2053-2110) on this mesh, from
    # the state after the initial solve. Each step runs on the card and the
    # host CPU with every solver loop at a fixed cap (accuracy 0: 3 Uzawa
    # iterations of 60 CG), held to CITCOMS_TAIL_TOL with equal counts, as
    # phase 9's fixed-count step: run to their tolerance, the anisotropic
    # and bc-file steps go to piterations, and there a 1e-15 change of T
    # moves the host CPU's own step by about 1e-7
    work = tempfile.mkdtemp(prefix="citcoms_tail_")
    nsf = cookbook2.nodex * cookbook2.nodey
    np.savetxt(os.path.join(work, "ages.txt"),
               np.where(np.arange(nsf) % cookbook2.nodex < 16, 300.0,
                        3000.0))
    for age, mag in ((1, 0.02), (2, 0.04)):
        vb = np.zeros((nsf, 2))
        vb[:, 0] = mag
        np.savetxt(os.path.join(work, f"vel{age}"), vb)
        np.savetxt(os.path.join(work, f"temp{age}"), np.full(nsf, 0.01 * age))
    phase = dict(Ra_410=2e4, clapeyron410=0.1, transT410=0.5, z_410=0.2,
                 width410=0.05)
    branches = {
        "phase_change": phase,
        "tala_latent": dict(phase, disptn_number=0.5, surfaceT=0.1),
        "anisotropic": dict(ANIVISC=True, ani_vis2_factor=0.5),
        "lith_age": dict(lith_age=True, lith_age_depth=0.12,
                         lith_age_file=os.path.join(work, "ages.txt")),
        "bc_files": dict(start_age=1.5, vbcs_file=True,
                         vel_bound_file=os.path.join(work, "vel"),
                         tbcs_file=True,
                         temp_bound_file=os.path.join(work, "temp"))}
    fixed_cap = dict(accuracy=0.0, piterations=3, vlowstep=60)

    def branch_step(model, s):
        if bc_files.uses_bc_files(model.cfg):
            return model.step_with_bcs(s, bc_files.step_bcs(model,
                                                            float(s.time)))
        return model.step(s)

    br = {}
    for name, kw in branches.items():
        cfg = dataclasses.replace(cookbook2, **kw)
        fixed = dataclasses.replace(cfg, **fixed_cap)
        mg_, mh = (CitcomModel(fixed, dtype=f64, device=d)
                   for d in (dev, "cpu"))
        start = s0
        if name == "lith_age":
            _check(torch.equal(mg_.init_state().T.cpu(), mh.init_state().T),
                   "lith_age initial T differs")
            start = dataclasses.replace(s0, T=mg_.init_state().T)
        rg, dg = branch_step(mg_, start)
        rh, dh = branch_step(mh, _to_host(mh, start))
        _check((dg.uzawa_iterations, dg.inner_iterations)
               == (dh.uzawa_iterations, dh.inner_iterations) == (3, 240),
               f"{name} at a fixed count: {dg} {dh}")
        br[name] = max(_state_err(rg, rh).values())
    _check(max(br.values()) <= tol,
           f"branch steps at a fixed count, card against host CPU: {br}")
    _say("14-branches-f64", tol=tol, fixed_uzawa_cg="3/240",
         **{k: f"{e:.3g}" for k, e in br.items()}, seconds=since())

    # ---- (d) the CLI: output, checkpoints, restart, graceful stop -------
    def cli_cfg(tag):
        """Cookbook2's parameters as a config file (the dump parses back
        to the same configuration) with a datadir of its own."""
        path = os.path.join(work, f"{tag}.cfg")
        with open(path, "w") as f:
            f.write(cookbook2.dump() + f"datadir={os.path.join(work, tag)}\n"
                    "storage_spacing=2 checkpoint_frequency=2\n")
        return path

    cfg_run = cli_cfg("run")
    on = dev.type
    s4, h4 = citcoms_regional.main([cfg_run, "--device", on, "--steps", "4"])
    files = sorted(os.listdir(os.path.join(work, "run")))
    stem = cookbook2.datafile
    want = {f"{stem}.chkpt.0.2", f"{stem}.chkpt.0.4", f"{stem}.coord.0.0"}
    want |= {f"{stem}.{k}.0.{i}" for k in ("velo", "visc") for i in (0, 2, 4)}
    _check(s4.step == 4 and len(h4) == 4 and set(files) == want,
           f"CLI files {files}")
    r4, _ = citcoms_regional.main([
        cfg_run, "--device", on, "--steps", "2", "--restart",
        os.path.join(work, "run", f"{stem}.chkpt.0.2")])
    same = r4.step == s4.step == 4 and all(
        torch.equal(getattr(r4, k), getattr(s4, k))
        for k in ("T", "Tdot", "V", "P", "time", "dt"))
    _check(same, "restart from step 2 did not reproduce step 4 bitwise")
    cfg_stop = cli_cfg("stop")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "g4s_tpu_torch.drivers.citcoms_regional",
         cfg_stop, "--device", on, "--steps", "200"], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("step 1:"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += rest.splitlines()
    stops = [ln for ln in lines if ln.startswith("# graceful stop at step")]
    _check(proc.returncode == 0 and len(stops) == 1,
           f"SIGTERM: rc {proc.returncode}, output {lines[-6:]}")
    stop_step = int(stops[0].split()[5].rstrip(";"))
    ck = os.path.join(work, "stop", f"{stem}.chkpt.0.{stop_step}")
    _check(os.path.exists(ck), f"SIGTERM wrote no checkpoint {ck}")
    _say("14-cli", device=on, steps=4, files=",".join(files),
         restart_step4_bitwise=True, sigterm_stop_step=stop_step,
         sigterm_checkpoint=os.path.basename(ck), seconds=since())
    shutil.rmtree(work)
    launches = segment.LAUNCHES
    _check(launches > 0, "phase 14 launched no segment-sum kernel")
    seg = {key: _segment_sum_case("14-segment-sum", key[0], key[1], *inp,
                                  ms_of=ms_of)
           for key, inp in seg_inputs.items()}
    _say("14-citcoms-tail", segment_sum_launches=launches,
         segment_sum_cases_s=since(),
         seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launches,
            "segment_sum": seg[finest]}


def _citcoms_full(dev, cookbook2, ms_of) -> dict:
    """Phase 15: the CitcomS full sphere at CITCOMS_FULL_NODES per cap
    (FullSphereModel, its tracers, the coupled Exchanger step with
    Cookbook2 inside it). Returns the segment-sum kernel's launches over
    the phase and its reading at the f64 assembly scatter."""
    import copy
    import numpy as np
    import torch
    from g4s_tpu_torch.models.citcoms import (CitcomModel, CoupledRun,
                                              FullSphereModel, full_tracers,
                                              solvers)
    from g4s_tpu_torch.models.citcoms.observables import rms_velocity
    from g4s_tpu_torch.ops import segment
    t_phase = time.perf_counter()
    lap = [t_phase]

    def since() -> str:
        t, lap[0] = lap[0], time.perf_counter()
        return f"{lap[0] - t:.1f}"

    f64, f32 = torch.float64, torch.float32
    tol = CITCOMS_FULL_TOL
    segment.LAUNCHES = 0
    n, nz = CITCOMS_FULL_NODES
    base = dataclasses.replace(
        cookbook2, nodex=n, nodey=n, nodez=nz, radius_inner=0.55,
        radius_outer=1.0, rayleigh=1e5, num_mat=1, topvbc=0,
        topvbxval=0.0, topvbyval=0.0)
    fixed = dataclasses.replace(base, **CITCOMS_FULL_FIXED)

    def blob_state(model):
        """tests/test_citcoms.py's blob on the conductive profile."""
        s = model.init_state()
        blob = np.exp(-np.sum((model._xyz - np.array([0.6, 0.3, 0.2])) ** 2,
                              axis=1) / 0.05)
        T = np.clip(s.T.cpu().double().numpy() + 0.3 * blob, 0, 1)
        return dataclasses.replace(s, T=torch.as_tensor(
            T, dtype=model.dtype, device=model.device))

    def with_caps(model, cfg):
        """The model on the same mesh with cfg's solver caps."""
        m = copy.copy(model)
        m.cfg = cfg
        m.uzawa_params = solvers.UzawaParams(
            cfg.accuracy, cfg.inner_accuracy_scale, cfg.piterations,
            cfg.vlowstep, cfg.check_pressure_convergence)
        return m

    def fixed_run(model):
        s, mon = model.initial_solve(blob_state(model))
        s1, d = model.step(s)
        return s, s1, (mon.outer_iterations, mon.inner_iterations,
                       d.uzawa_iterations, d.inner_iterations)

    def counts(d):
        return d.uzawa_iterations, d.inner_iterations

    def equal(a, b, names=("T", "Tdot", "V", "P", "dt", "time")):
        return all(torch.equal(getattr(a, k), getattr(b, k)) for k in names)

    # ---- (a) f64 at a fixed cap, card against host CPU ------------------
    t0 = time.perf_counter()
    g64 = FullSphereModel(fixed, dtype=f64, device=dev)
    build_s = time.perf_counter() - t0
    h64 = FullSphereModel(fixed, dtype=f64, device="cpu")
    ga, gb = fixed_run(g64), fixed_run(g64)
    _check(ga[2] == gb[2] and equal(ga[0], gb[0]) and equal(ga[1], gb[1]),
           "full sphere f64: two card runs differ")
    t0 = time.perf_counter()
    ha = fixed_run(h64)
    host_s = time.perf_counter() - t0
    _check(ga[2] == ha[2] == (1, 40, 1, 40),
           f"full sphere f64 counts, card {ga[2]} host CPU {ha[2]}")
    err = [max(_state_err(ga[0], ha[0], ("V", "P")).values()),
           max(_state_err(ga[1], ha[1]).values())]
    _check(max(err) <= tol, f"full sphere f64, card against host CPU: {err}")
    s1 = ga[1]
    rot = _rel_err(g64.remove_net_rotation(s1.V).cpu(), s1.V.cpu())
    _check(rot <= tol, f"remove_net_rotation moved the step's V by {rot}")
    torch.cuda.synchronize()
    rot_syncs = _syncs(lambda: g64.remove_net_rotation(s1.V))
    solvers.HOST_SYNCS = 0
    step_syncs = _syncs(lambda: g64.step(ga[0]))
    _check(rot_syncs == 0 and step_syncs == solvers.HOST_SYNCS,
           f"full sphere step: {step_syncs} host waits, "
           f"{solvers.HOST_SYNCS} counted; net rotation {rot_syncs}")
    # a longer fixed cap: the card against the host CPU beside how far a
    # 1e-15 change of T moves the host CPU's own step
    cap = dataclasses.replace(base, **CITCOMS_FULL_SPREAD_CAP)
    g3, h3 = with_caps(g64, cap), with_caps(h64, cap)
    sg3, dg3 = g3.step(ga[0])
    sh0 = _to_host(h64, ga[0])
    sh3, dh3 = h3.step(sh0)
    wiggle = 1 + 1e-15 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(h64.mesh.nno))
    sw3, _ = h3.step(dataclasses.replace(sh0, T=sh0.T * wiggle))
    e3 = max(_state_err(sg3, sh3).values())
    spread3 = max(_state_err(sw3, sh3).values())
    _check(counts(dg3) == counts(dh3) == (3, 240)
           and e3 <= max(tol, CITCOMS_FULL_SPREAD_FACTOR * spread3),
           f"full sphere f64 at 3 x 60: card against host CPU {e3}, a "
           f"1e-15 change of T on the host CPU {spread3}")
    _say("15-full-f64", nodes_per_cap=f"{n}x{n}x{nz}", nel=g64.mesh.nel,
         nno=g64.mesh.nno, model_build_s=f"{build_s:.2f}", runs=2,
         deterministic=True, uzawa_cg="1/40,1/40",
         rel_err_vs_host_cpu=",".join(f"{e:.3g}" for e in err), tol=tol,
         net_rotation_rel=f"{rot:.3g}", step_host_waits=step_syncs,
         counted_reads=solvers.HOST_SYNCS, net_rotation_waits=rot_syncs,
         cap_3x60_rel_err_vs_host_cpu=f"{e3:.3g}",
         cap_3x60_host_cpu_1e15_spread=f"{spread3:.3g}",
         host_cpu_s=f"{host_s:.2f}", seconds=since())
    del gb, sg3, sh3, sw3, g3, h3

    # ---- (b) f32 to tolerance, timed ------------------------------------
    g32 = FullSphereModel(base, dtype=f32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s32, mon32 = g32.initial_solve(blob_state(g32))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s32, _ = g32.step(s32)                                    # warm-up
    t32 = _timed_steps(s32, CITCOMS_FULL_F32_STEPS, g32.step)
    p32 = _profiled_step(g32.step, t32["s"])
    vrms = float(rms_velocity(g32, t32["s"].V))
    _check(bool(torch.isfinite(t32["s"].V).all()) and vrms > 0,
           f"full sphere f32: vrms {vrms}")
    wall = t32["wall_s"]
    _say("15-full-f32", initial_uzawa_cg=f"{mon32.outer_iterations}/"
         f"{mon32.inner_iterations}", initial_solve_s=f"{init_s:.3f}",
         warmup_steps=1, timed_steps=CITCOMS_FULL_F32_STEPS,
         s_per_step=f"{wall:.4f}", inner_cg_per_step=t32["inner"],
         host_syncs_per_step=t32["host_syncs"],
         device_kernels_per_step=p32["kernels"],
         device_busy_ms_per_step=f"{p32['busy_ms']:.2f}",
         device_idle_share=f"{max(0.0, 1 - p32['busy_ms'] / 1e3 / wall):.3f}",
         segment_sums_per_step=p32["segment_sums"], vrms=f"{vrms:.6g}",
         top_kernels_name_launches_ms=p32["top"],
         profile_s=f"{p32['seconds']:.1f}",
         profile_tries=p32["tries"], seconds=since())

    # ---- (c) the thermochemical step -------------------------------------
    pos0, fl0 = full_tracers.seed_tracers(
        g64.mesh, CITCOMS_TRACERS_PER_ELEMENT, seed=0)
    flg, flh = torch.from_numpy(fl0).to(dev), torch.from_numpy(fl0)
    sg, dg, pg, Cg = g64.step_tracers(ga[0], torch.from_numpy(pos0).to(dev),
                                      flg)
    sh, dh, ph, Ch = h64.step_tracers(_to_host(h64, ga[0]),
                                      torch.from_numpy(pos0), flh)
    comp_g, _ = full_tracers.element_composition(g64.tracer_field, g64.mesh,
                                                 pg, flg)
    comp_h, _ = full_tracers.element_composition(h64.tracer_field, h64.mesh,
                                                 ph, flh)
    pos_err = _rel_err(pg.cpu(), ph)
    t_err = max(_state_err(sg, sh).values())
    _check(counts(dg) == counts(dh) and pos_err <= CITCOMS_FULL_POS_TOL
           and torch.equal(comp_g.cpu(), comp_h) and torch.equal(Cg.cpu(), Ch)
           and t_err <= tol and 0.0 <= float(Cg.min())
           and float(Cg.max()) <= 1.0,
           f"full-sphere tracer step, card against host CPU: counts "
           f"{counts(dg)} {counts(dh)}, positions {pos_err}, fields {t_err}")
    _say("15-full-thermochemical-f64", tracers=pos0.shape[0], seed=0,
         compositions_equal=True, nodal_C_equal=True,
         pos_rel_err=f"{pos_err:.3g}", pos_tol=CITCOMS_FULL_POS_TOL,
         field_rel_err=f"{t_err:.3g}", tol=tol, seconds=since())
    del sh, ph, Ch, comp_h
    box = {"pos": torch.from_numpy(pos0).to(dev, f32)}

    def tstep(s):
        s, d, box["pos"], box["C"] = g32.step_tracers(s, box["pos"], flg)
        return s, d

    st, _ = tstep(t32["s"])                                   # warm-up
    tt = _timed_steps(st, CITCOMS_FULL_TRACER_STEPS, tstep)
    pt = _profiled_step(tstep, tt["s"])
    C = box["C"]
    _check(bool(torch.isfinite(tt["s"].V).all()) and float(C.min()) >= 0.0
           and float(C.max()) <= 1.0,
           f"full-sphere tracer step f32: C in [{float(C.min())}, "
           f"{float(C.max())}]")
    _say("15-full-thermochemical-f32", tracers=pos0.shape[0],
         timed_steps=CITCOMS_FULL_TRACER_STEPS,
         s_per_step=f"{tt['wall_s']:.4f}", inner_cg_per_step=tt["inner"],
         host_syncs_per_step=tt["host_syncs"],
         device_kernels_per_step=pt["kernels"],
         device_busy_ms_per_step=f"{pt['busy_ms']:.2f}",
         device_idle_share=f"{max(0.0, 1 - pt['busy_ms'] / 1e3 / tt['wall_s']):.3f}",
         C_min=f"{float(C.min()):.4g}", C_max=f"{float(C.max()):.4g}",
         top_kernels_name_launches_ms=pt["top"],
         profile_s=f"{pt['seconds']:.1f}",
         profile_tries=pt["tries"], seconds=since())
    del box, st, tt

    # ---- (d) the coupled step: Cookbook2 inside the full sphere ---------
    fine_fixed = dataclasses.replace(cookbook2, accuracy=0.0, piterations=3,
                                     vlowstep=60)
    fg = CitcomModel(fine_fixed, dtype=f64, device=dev)
    fh = CitcomModel(fine_fixed, dtype=f64, device="cpu")
    cp_err = {}
    for two_way in (False, True):
        rg = CoupledRun(g64, fg, two_way=two_way, device=dev)
        rh = CoupledRun(h64, fh, two_way=two_way, device="cpu")
        scg, sfg, (dcg, dfg) = rg.step(ga[0], fg.init_state())
        sch, sfh, (dch, dfh) = rh.step(_to_host(h64, ga[0]), fh.init_state())
        e = max(max(_state_err(scg, sch).values()),
                max(_state_err(sfg, sfh).values()))
        _check((counts(dcg), counts(dfg)) == (counts(dch), counts(dfh))
               and e <= tol,
               f"coupled step (two_way={two_way}), card against host CPU: "
               f"{e}, counts {counts(dcg)} {counts(dfg)} / {counts(dch)} "
               f"{counts(dfh)}")
        if two_way:
            inside = rg.interior_ids
            want = rg.restrict(torch.zeros_like(scg.T), sfg.T)[inside]
            _check(torch.equal(scg.T[inside], want),
                   "two-way: the coarse interior is not the fine T")
        else:
            tbc_val, _ = rg.exchange(scg.T, scg.V)
            b = rg.b_nodes
            gap = float((sfg.T[b] - tbc_val[b]).abs().max())
            _check(gap <= tol, f"fine boundary T off the coarse "
                               f"interpolation by {gap}")
        cp_err["two_way" if two_way else "one_way"] = e
    _say("15-coupled-f64", fine=f"{cookbook2.nodex}x{cookbook2.nodey}x"
         f"{cookbook2.nodez}", boundary_nodes=len(rg.b_nodes),
         coarse_interior_nodes=int(rg.interior_ids.numel()),
         **{f"{k}_rel_err_vs_host_cpu": f"{v:.3g}" for k, v in cp_err.items()},
         fine_boundary_gap=f"{gap:.3g}", tol=tol, seconds=since())
    del fg, fh, rg, rh, h64
    # one f32 two-way step, timed; every kernel it runs ran above at these
    # shapes (the fine model's in phase 9). The fine Stokes solve, its six
    # faces' velocities imposed from the coarse solution, may run to its
    # Uzawa cap, so the step is not profiled
    f32m = CitcomModel(cookbook2, dtype=f32, device=dev)
    r32 = CoupledRun(g32, f32m, two_way=True, device=dev)
    sf0, _ = f32m.initial_solve(f32m.init_state())
    torch.cuda.synchronize()
    solvers.HOST_SYNCS = 0
    t0 = time.perf_counter()
    sc1, sf1, (dc, df) = r32.step(t32["s"], sf0)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    _check(bool(torch.isfinite(sf1.T).all() & torch.isfinite(sc1.T).all()),
           "coupled f32 step: non-finite T")
    _say("15-coupled-f32", s_per_step=f"{cwall:.4f}",
         coarse_uzawa_cg=f"{dc.uzawa_iterations}/{dc.inner_iterations}",
         fine_uzawa_cg=f"{df.uzawa_iterations}/{df.inner_iterations}",
         host_syncs=solvers.HOST_SYNCS, seconds=since())
    del f32m, r32, sf0, sc1, sf1

    # ---- (e) the segment sum at the full sphere's two shapes -------------
    launches = segment.LAUNCHES
    _check(launches > 0, "phase 15 launched no segment-sum kernel")
    rng = np.random.default_rng(15)
    seg = {}
    for name, m, s_ in (("f64", g64, ga[1]), ("f32", g32, t32["s"])):
        p_el = torch.from_numpy(rng.standard_normal(m.mesh.nel)).to(
            dev, m.dtype)
        cases = {
            "full_assembly_scatter": (
                (m.G * p_el[:, None, None]).reshape(-1, 3).contiguous(),
                m.plan.seg_ids, m.plan.order, m.plan.nno),
            "full_layer_sum": (m.cfg.rayleigh * s_.T * m.nmass,
                               m._layer_sorted, m._layer_order, nz)}
        for shape, inp in cases.items():
            seg[(shape, name)] = _segment_sum_case(
                "15-segment-sum", shape, name, *inp, ms_of=ms_of)
    _say("15-citcoms-full", segment_sum_launches=launches,
         segment_sum_cases_s=since(),
         seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launches,
            "segment_sum": seg[("full_assembly_scatter", "f64")]}


def _tile_overlap(fn, tiles: int, tries: int = 8) -> float:
    """How far the chain's tile kernels overlap in one fn() call, as
    torch.profiler records them: the sum of the `tiles` kernels' durations
    over the span from the first start to the last end (1.0 or less when
    they run one after another). The call is queued behind a device sleep,
    as device_ms queues its calls, so the tiles run as the device takes
    them and not as the host, slowed by the tracer, enqueues them. The
    tracer can lose the first activities of a profile, so short sleeps run
    first, more in each profile taken again (as obs.timings.
    device_activities runs them), until one holds all the tiles, up to
    `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8 << attempt):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            torch.cuda._sleep(1 << 25)     # ~20 ms: the 63 launches queue
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "static_tile_" in e.name]
        if len(spans) == tiles:
            return sum(t.elapsed_us() for t in spans) / (
                max(t.end for t in spans) - min(t.start for t in spans))
    raise RuntimeError(f"torch.profiler recorded {len(spans)} of the "
                       f"{tiles} tile kernels")


def _start_static_builds(ws, dev):
    """Phase 11's two per-matrix builds of phase 3's pack `ws`, one nvcc
    each, started in background threads so that they run beside phases
    4-10 (the one-kernel form's nvcc takes about 68 s). Returns the pack's
    window starts and counts and, per form, a future of (kernel, seconds
    from this call until it was built)."""
    import concurrent.futures
    from g4s_tpu_torch.ops import static_spmv
    starts_h, kc_h = static_spmv.static_windows(ws)
    t0 = time.perf_counter()

    def built(fn, *args, **kw):
        return fn(*args, **kw), time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        "static_spmv_chain": pool.submit(built, static_spmv.build_static_chain,
                                         ws, starts_h, kc_h, device=dev),
        "static_spmv_one": pool.submit(
            built, static_spmv.build_static_one_kernel, ws, starts_h, kc_h,
            STATIC_ONE_TILES, device=dev)}
    pool.shutdown(wait=False)
    return starts_h, kc_h, futures


def _static_kernels(dev, ws, x_pad, a_p, err, ms, plain_ms, library_ms,
                    bound, launches, ms_of, flush_l2, builds) -> None:
    """Phase 11: both per-matrix WSELL-K kernels (ops/static_spmv.py, the
    reference's two probes) on phase 3's stencil pack `ws`, its x and its
    RCM-renumbered matrix `a_p`: each built by nvcc for this pack, against
    its plain version and scipy f64 within a relative 1e-5, against the
    wsell_spmv kernel (the same products in the same order), and timed warm
    and cold beside the bound of WSELL's row, its plain version and
    cuSPARSE's CSR SpMV of the same rows. The one kernel covers the first
    STATIC_ONE_TILES tiles (all when None). `builds` is
    _start_static_builds's result: the kernels were built beside phases
    4-10, and this waits for them."""
    import numpy as np
    import torch
    from g4s_tpu_torch.ops import static_spmv, wsell_spmv
    starts_h, kc_h, futures = builds
    # the plain version's timing takes them on the card: a copy from the
    # host would make each call wait for the device
    starts_d = torch.from_numpy(starts_h).to(dev)
    kc_d = torch.from_numpy(kc_h).to(dev)
    tiles = ws.lanes.shape[0]
    t0 = time.perf_counter()
    done = {name: f.result() for name, f in futures.items()}
    waited_s = time.perf_counter() - t0
    forms = {name: r[0] for name, r in done.items()}
    build_s = max(r[1] for r in done.values())
    n = a_p.shape[0]
    y_ws = wsell_spmv.spmv_wsell_chain(ws, x_pad)
    y64 = a_p.astype(np.float64) @ x_pad[:n].cpu().numpy().astype(np.float64)
    static_spmv.CHAIN_LAUNCHES = static_spmv.ONE_LAUNCHES = 0
    ys = {name: f(x_pad) for name, f in forms.items()}
    torch.cuda.synchronize()
    launches["static_spmv_chain"] = static_spmv.CHAIN_LAUNCHES
    launches["static_spmv_one"] = static_spmv.ONE_LAUNCHES
    _check((launches["static_spmv_chain"], launches["static_spmv_one"])
           == (tiles, 1), f"static kernel launches {launches}")
    for name, f in forms.items():
        y = ys[name]
        rows = f.n_tiles * ws.ppt * ws.rows_per_pack
        r = min(n, rows)
        want = static_spmv._static_spmv_plain(ws, starts_h, kc_h, x_pad,
                                              f.n_tiles)
        rel_pl = _rel_err(y.cpu(), want.cpu())
        rel_sp = _rel_err(y[:r].cpu(), y64[:r])
        vs_wsell = float((y - y_ws[: f.n_out]).abs().max())
        err[name] = float((y - want).abs().max())
        _check(rel_pl <= REL_TOL and rel_sp <= REL_TOL,
               f"{name}: rel err vs plain {rel_pl}, vs scipy f64 {rel_sp}")
        a_rows = _csr_tensor(a_p[:r].tocsr(), dev)
        x_n = x_pad[:n].contiguous()
        ms[name] = ms_of(lambda: f(x_pad))
        cold = ms_of(lambda: f(x_pad), before=flush_l2)
        plain_ms[name] = ms_of(lambda: static_spmv._static_spmv_plain(
            ws, starts_d, kc_d, x_pad, f.n_tiles))
        library_ms[name] = ms_of(lambda: torch.mv(a_rows, x_n))
        # as WSELL's row: the tiles' codes (int16), values, window starts
        # and x read, y written; one FMA per stored slot
        slots = f.n_tiles * ws.ppt * 1024
        bound[name] = _bound(slots * 6 + f.n_tiles * ws.ppt * ws.k * 4
                             + x_pad.numel() * 4 + f.n_out * 4, 2.0 * slots)
        extra = {}
        if not f.one_kernel:
            overlap = _tile_overlap(lambda: f(x_pad), tiles)
            extra["profiler_overlap"] = f"{overlap:.3f}"
        _say("11-static", kernel=name, tiles=f"{f.n_tiles}/{tiles}",
             packs=starts_h.shape[0], K=ws.k, kc_mean=f"{kc_h.mean():.3f}",
             nvcc_s=f"{f.nvcc_s:.2f}", build_wall_s=f"{build_s:.2f}",
             phase11_waited_s=f"{waited_s:.2f}",
             launches_per_call=launches[name],
             rel_err_vs_plain=f"{rel_pl:.3g}",
             rel_err_vs_scipy_f64=f"{rel_sp:.3g}",
             max_abs_err_vs_wsell_kernel=f"{vs_wsell:.3g}",
             device_ms=f"{ms[name]:.4f}", cold_ms=f"{cold:.4f}",
             bound_ms=f"{bound[name][0]:.4f}",
             share_of_bound=f"{bound[name][0] / ms[name]:.3f}",
             plain_ms=f"{plain_ms[name]:.4f}",
             cusparse_ms=f"{library_ms[name]:.4f}", **extra)
        del a_rows


# ---- phase 20: the integrator tail ----------------------------------------
# The lockstep batched NTC sweep at the dodecane size (phase 13's mechanism
# and tolerances), cut to fit: at least 4 temperatures over 800-1250 K with
# 1000 K among them, t_end just past the latest lane's OH peak (the steps
# before a peak do not depend on t_end), in a process of its own beside
# phases 13, 18 and 19. Each lane's tau is held to the in-turn
# ignition_delay of its case within NTC_BATCH_TOL: at 1000 K phase 13's run
# on the card, the others on the host CPU in spawned one-thread processes
# beside phases 14-16.
NTC_BATCH_TEMPS = (800.0, 1000.0, 1100.0, 1250.0)
# the lanes' OH peaks on the H100 at the protocol's 5 ms: 2.284, 3.043,
# 0.733 and 0.120 ms (RK; IG within 1.4 % of them; PERF.md section 6)
NTC_BATCH_T_END = 3.1e-3
NTC_BATCH_RTOL, NTC_BATCH_ATOL = 1e-8, 1e-14      # phase 13's
NTC_BATCH_TOL = 1e-8
NTC_BATCH_TIMEOUT = 900
# the Brusselator of tests/test_banded.py at BRUSS_POINTS grid points
# (n = 2 * BRUSS_POINTS), integrated to BRUSS_T_END with the banded and the
# dense Newton paths
BRUSS_POINTS = 2000
BRUSS_T_END = 2e-3
BRUSS_RTOL, BRUSS_ATOL = 1e-6, 1e-9
BRUSS_DENSE_TOL = 1e-6
PHASE20_TOL = 1e-10
PHASE20_HOST_PROCS = 4
PHASE20_HOST_TIMEOUT = 900


def _brusselator(n_pts: int):
    """tests/test_banded.py's 1-D Brusselator MOL right-hand side (two
    species interleaved, nearest-neighbour diffusion: half-bandwidth 3) and
    its initial state."""
    import math
    import torch
    A, B, D = 1.0, 3.0, 0.02
    h2 = (1.0 / (n_pts + 1)) ** 2

    def rhs(t, y):
        u, v = y[0::2], y[1::2]
        up = torch.nn.functional.pad(u, (1, 1), value=A)
        vp = torch.nn.functional.pad(v, (1, 1), value=B / A)
        du = A - (B + 1) * u + u * u * v + D * (up[2:] - 2 * u + up[:-2]) / h2
        dv = B * u - u * u * v + D * (vp[2:] - 2 * v + vp[:-2]) / h2
        return torch.stack([du, dv], dim=1).reshape(-1)

    x = torch.linspace(0.0, 1.0, n_pts, dtype=torch.float64)
    y0 = torch.stack([1.0 + 0.1 * torch.sin(math.pi * x),
                      torch.full_like(x, 3.0)], dim=1).reshape(-1)
    return rhs, y0


def _robertson():
    """Robertson's kinetics with its rate constants as parameters, its
    index-1 DAE form (the third equation the conservation law), and the
    consistent initial state and derivative."""
    import torch

    def f_p(p, t, y):
        return torch.stack([-p[0] * y[0] + p[2] * y[1] * y[2],
                            p[0] * y[0] - p[1] * y[1] ** 2
                            - p[2] * y[1] * y[2], p[1] * y[1] ** 2])

    def F(t, y, yp):
        return torch.stack([yp[0] + 0.04 * y[0] - 1e4 * y[1] * y[2],
                            yp[1] - 0.04 * y[0] + 3e7 * y[1] ** 2
                            + 1e4 * y[1] * y[2], y[0] + y[1] + y[2] - 1.0])

    p0 = torch.tensor([0.04, 3e7, 1e4], dtype=torch.float64)
    y0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    return f_p, F, p0, y0, f_p(p0, 0.0, y0)


def _tail_solves(device):
    """Phase 20's Robertson DAE (to t = 100, rtol 1e-9, atol 1e-12) and
    forward sensitivities (to t = 10, rtol 1e-8, atol 1e-12) on `device`,
    as host arrays with their step counts."""
    from g4s_tpu_torch.ops import odeint
    f_p, F, p0, y0, yd0 = _robertson()
    dae = odeint.dae_solve(F, y0.to(device), yd0.to(device), 0.0, 100.0,
                           rtol=1e-9, atol=1e-12)
    res, sens = odeint.bdf_solve_with_sensitivities(
        f_p, p0.to(device), y0.to(device), 0.0, 10.0, rtol=1e-8, atol=1e-12)
    return {"dae_y": dae.y.cpu().numpy(), "dae_steps": dae.steps,
            "dae_success": dae.success, "sens_y": res.y.cpu().numpy(),
            "sens": sens.cpu().numpy(), "sens_steps": res.steps,
            "sens_success": res.success}


def _tail_host(task: str, kw: dict) -> dict:
    """Phase 20's host-CPU references, one torch thread, in a spawned
    process: "tau" (one in-turn ignition_delay case), "bruss" (the banded
    Brusselator run) and "solves" (_tail_solves)."""
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if task == "tau":
        from g4s_tpu_torch.models.cantera import (IdealGasConstVolumeReactor,
                                                  ignition_delay,
                                                  load_mechanism,
                                                  stoich_mixture)
        mech = load_mechanism(kw["path"], kw["phase"])
        r = IdealGasConstVolumeReactor(mech, real_gas=kw["real_gas"],
                                       device="cpu")
        tau, res = ignition_delay(r, kw["T0"], kw["P0"],
                                  stoich_mixture(mech), t_end=kw["t_end"],
                                  rtol=kw["rtol"], atol=kw["atol"])
        out = {"tau": tau, "steps": res.steps}
    elif task == "bruss":
        from g4s_tpu_torch.ops import odeint
        rhs, y0 = _brusselator(kw["n_pts"])
        res = odeint.bdf_solve(rhs, y0, 0.0, kw["t_end"], rtol=kw["rtol"],
                               atol=kw["atol"], bandwidth=(3, 3))
        out = {"y": res.y.numpy(), "steps": res.steps}
    else:
        out = _tail_solves(torch.device("cpu"))
    out["wall_s"] = time.perf_counter() - t0
    return out


def _ntc_batch_run(path: str, temps, t_end: float, rtol: float,
                   atol: float, device: str = "cuda") -> dict:
    """Phase 20's batched sweep, in a spawned process of its own on the
    card: ShockTubeBenchmark.run_ntc_sweep_batched over `temps` at 40 atm,
    both phases; then, per phase, a window of CANTERA_WINDOW lockstep
    iterations from the cases' initial states, profiled (device kernels
    and busy ms per iteration) and timed, and a window in turn: the lane
    at 1000 K alone, CANTERA_WINDOW bdf_solve steps from its initial
    state, timed in this process. Returns the taus,
    walls, iterations, per-lane steps and host reads and the windows'
    numbers."""
    import torch
    from g4s_tpu_torch.models.cantera import ShockTubeBenchmark, \
        stoich_mixture
    from g4s_tpu_torch.obs.timings import device_activities
    from g4s_tpu_torch.ops.odeint import _bdf_solve_batched, bdf_solve
    torch.set_num_threads(1)
    dev = torch.device(device)
    P0 = 40 * 101325.0
    bench = ShockTubeBenchmark(path, device=dev)
    out = bench.run_ntc_sweep_batched(list(temps), P0, t_end=t_end,
                                      rtol=rtol, atol=atol)
    res = {"T": out["T"]}
    for name, r in (("RG", bench.r_rk), ("IG", bench.r_ig)):
        b = out[f"result_{name}"]
        y0 = torch.stack([r.initial_state(T, P0, stoich_mixture(r.mech))
                          for T in temps])

        def window():
            return _bdf_solve_batched(r.rhs, y0, 0.0, t_end, rtol=rtol,
                                      atol=atol, max_steps=CANTERA_WINDOW)

        def in_turn():
            return bdf_solve(r.rhs, y0[list(temps).index(1000.0)], 0.0,
                             t_end, rtol=rtol, atol=atol,
                             max_steps=CANTERA_WINDOW)

        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0
        # the card's activities (none are recorded on the CPU)
        acts = device_activities(window) if dev.type == "cuda" else []
        w, w_s = timed(window)
        one, one_s = timed(in_turn)
        iters = int(w.steps.max())
        res[name] = {
            "tau": out[f"tau_{name}"], "wall_s": out[f"wall_{name}"],
            "iterations": int(b.steps.max()), "steps": b.steps.tolist(),
            "n_jev": b.n_jev.tolist(), "host_reads": b.host_reads,
            "success": bool(b.success.all()),
            "window_iterations": iters,
            "window_kernels_per_iteration": len(acts) / iters,
            "window_busy_ms_per_iteration":
                sum(us for _, us in acts) / 1e3 / iters,
            "window_wall_ms_per_iteration": w_s * 1e3 / iters,
            "in_turn_window_steps": one.steps,
            "in_turn_window_wall_ms_per_step": one_s * 1e3 / one.steps}
    return res


def _ntc_batch_start(path: str) -> dict:
    """Start phase 20's batched sweep in a spawned process (Pool of 1)."""
    pool = multiprocessing.get_context("spawn").Pool(1)
    return {"pool": pool, "t0": time.perf_counter(),
            "res": pool.apply_async(_ntc_batch_run, (
                path, NTC_BATCH_TEMPS, NTC_BATCH_T_END, NTC_BATCH_RTOL,
                NTC_BATCH_ATOL))}


def _tail_host_start(path: str, dev_taus: dict) -> dict:
    """Start phase 20's host-CPU references in PHASE20_HOST_PROCS spawned
    one-thread processes: the in-turn cases of the batch's lanes that no
    card phase runs (every temperature but 1000 K, both phases), the banded
    Brusselator run and the Robertson solves."""
    pool = multiprocessing.get_context("spawn").Pool(PHASE20_HOST_PROCS)
    jobs = {}
    for T in NTC_BATCH_TEMPS:
        if T in dev_taus:
            continue
        for name, phase, real in (("RG", "nDodecane_RK", True),
                                  ("IG", "nDodecane_IG", False)):
            jobs[(name, T)] = pool.apply_async(_tail_host, ("tau", dict(
                path=path, phase=phase, real_gas=real, T0=T,
                P0=40 * 101325.0, t_end=NTC_BATCH_T_END,
                rtol=NTC_BATCH_RTOL, atol=NTC_BATCH_ATOL)))
    jobs["bruss"] = pool.apply_async(_tail_host, ("bruss", dict(
        n_pts=BRUSS_POINTS, t_end=BRUSS_T_END, rtol=BRUSS_RTOL,
        atol=BRUSS_ATOL)))
    jobs["solves"] = pool.apply_async(_tail_host, ("solves", {}))
    return {"pool": pool, "jobs": jobs}


def _pool_stop(run) -> None:
    if run is not None:
        run["pool"].terminate()
        run["pool"].join()


CAPI_FRAME_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
extern int g4s_init(const char*);
extern int g4s_deeppot_load(const char*);
extern int g4s_deeppot_eval(int, int, const double*, const double*,
                            const int*, double*, double*, double*);
/* argv: repo frozen natoms coord.bin box.bin types.bin out.bin */
static void* slurp(const char* path, size_t n) {
  void* buf = malloc(n);
  FILE* f = fopen(path, "rb");
  if (!f || fread(buf, 1, n, f) != n) exit(9);
  fclose(f);
  return buf;
}
int main(int argc, char** argv) {
  int n = atoi(argv[3]);
  double* coord = slurp(argv[4], (size_t)n * 3 * sizeof(double));
  double* box = slurp(argv[5], 9 * sizeof(double));
  int* types = slurp(argv[6], (size_t)n * sizeof(int));
  double e, v[9];
  double* f = malloc((size_t)n * 3 * sizeof(double));
  if (g4s_init(argv[1])) return 1;
  int h = g4s_deeppot_load(argv[2]);
  if (h < 0) return 2;
  if (g4s_deeppot_eval(h, n, coord, box, types, &e, f, v)) return 3;
  FILE* o = fopen(argv[7], "wb");
  fwrite(&e, sizeof(double), 1, o);
  fwrite(f, sizeof(double), (size_t)n * 3, o);
  fclose(o);
  printf("CAPI_OK natoms=%d e=%.17g\n", n, e);
  return 0;
}
"""


def _capi_frame(dev) -> dict:
    """Phase 20's C API check: a C program built against
    g4s_tpu_torch/runtime/native/capi.c (capi_impl.build_capi, the running
    interpreter's embedding flags) evaluates phase 10's water model
    (WATER_SPEC, weights from torch.Generator().manual_seed(1)), frozen in
    f64, at phase 10's 192-atom frame, on the card (G4S_TORCH_DEVICE=cuda);
    E and F against DeepPot.eval in this process."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from g4s_tpu_torch.models.deepmd import (WATER_SPEC, DeepPot, freeze,
                                             init_params)
    from g4s_tpu_torch.models.deepmd.model import params_to
    from g4s_tpu_torch.runtime import capi_impl
    gcc = shutil.which("gcc") or shutil.which("cc")
    _check(gcc is not None and capi_impl.libpython_path() is not None,
           f"C API: compiler {gcc}, libpython {capi_impl.libpython_path()}")
    rng = np.random.default_rng(0)
    n, L = 192, 12.444661
    types = np.concatenate([np.zeros(64, np.int32), np.ones(128, np.int32)])
    coord = rng.uniform(0, L, size=(n, 3))
    box = np.eye(3) * L
    params = params_to(init_params(torch.Generator().manual_seed(1),
                                   WATER_SPEC), dtype=torch.float64)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        frozen = os.path.join(tmp, "water_f64.npz")
        freeze(params, WATER_SPEC, frozen, type_map=["O", "H"])
        for name, arr in (("coord", coord), ("box", box), ("types", types)):
            arr.tofile(os.path.join(tmp, f"{name}.bin"))
        t0 = time.perf_counter()
        capi_impl.build_capi(tmp)
        with open(os.path.join(tmp, "main.c"), "w") as f:
            f.write(CAPI_FRAME_MAIN)
        _, ld = capi_impl.embed_flags()
        subprocess.run([gcc, os.path.join(tmp, "main.c"), "-o",
                        os.path.join(tmp, "frame"), f"-L{tmp}",
                        "-lg4s_torch_capi", f"-Wl,-rpath,{tmp}"] + ld,
                       check=True, capture_output=True)
        build_s = time.perf_counter() - t0
        env = dict(os.environ, G4S_TORCH_DEVICE=dev.type,
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [os.path.join(tmp, "frame"), here, frozen, str(n)]
            + [os.path.join(tmp, f"{k}.bin") for k in ("coord", "box",
                                                       "types", "out")],
            env=env, capture_output=True, text=True, timeout=300)
        run_s = time.perf_counter() - t0
        _check(proc.returncode == 0, f"C API program exited "
               f"{proc.returncode}: {proc.stdout[-2000:]}"
               f"{proc.stderr[-4000:]}")
        out = np.fromfile(os.path.join(tmp, "out.bin"), np.float64)
        e_ref, f_ref, _ = DeepPot(frozen, device=dev).eval(coord, box,
                                                           types)
    e_ref = float(e_ref.cpu())
    f_ref = f_ref.cpu().numpy().reshape(-1)
    errs = {"E": abs(out[0] - e_ref) / abs(e_ref),
            "F": _rel_err(out[1:], f_ref)}
    _check(max(errs.values()) <= PHASE20_TOL,
           f"C API program against DeepPot.eval on the card: {errs}")
    return {"e": out[0], "errs": errs, "build_s": build_s, "run_s": run_s}


def _integrator_tail(dev, batch: dict, host: dict, p13: dict,
                     mc_res: dict) -> None:
    """Phase 20: the integrator tail on the card, f64. (1) The batched NTC
    sweep's results (started with phase 13 in a process of its own): each
    lane's tau within NTC_BATCH_TOL of its in-turn case (1000 K: phase 13's
    card run; the others: the host CPU), with the batch's wall s, lockstep
    iterations, host reads and the window's kernels, busy ms, wall and
    idle share per iteration, an in-turn window's ms per step from the
    same process and the estimate of the in-turn sweep's wall over the
    batch's they give, beside phase 13's in-turn walls and phase 17's
    sweep. (2) The banded BDF on the Brusselator at BRUSS_POINTS points:
    the card against the host CPU within PHASE20_TOL and against the dense
    path on the card within BRUSS_DENSE_TOL; s per step, the device
    activities (the profiler's count), busy ms and wall ms of one band
    factor and of one band solve, and the dense LU's ms. (3) dae_solve
    and bdf_solve_with_sensitivities on Robertson, the card against the
    host CPU within PHASE20_TOL. (4) The C API at phase 10's frame
    (_capi_frame)."""
    import numpy as np
    import torch

    from g4s_tpu_torch.ops import banded, odeint
    from g4s_tpu_torch.obs.timings import device_activities, device_ms

    t_phase = time.perf_counter()
    # ---- 1: the batched sweep ----
    t0 = time.perf_counter()
    b = batch["res"].get(timeout=max(
        1.0, NTC_BATCH_TIMEOUT - (time.perf_counter() - batch["t0"])))
    batch_wait_s = time.perf_counter() - t0
    host_res = {}
    for key, job in host["jobs"].items():
        host_res[key] = job.get(timeout=PHASE20_HOST_TIMEOUT)
    temps = b["T"]
    for name in ("RG", "IG"):
        r = b[name]
        errs = []
        for T, tau in zip(temps, r["tau"]):
            ref = p13[f"tau_{name}"] if T == p13["T"] \
                else host_res[(name, T)]["tau"]
            errs.append(abs(tau - ref) / ref)
        _check(r["success"] and max(errs) <= NTC_BATCH_TOL
               and max(r["tau"]) < NTC_BATCH_T_END,
               f"batched sweep {name}: taus {r['tau']}, rel errs {errs}, "
               f"success {r['success']}")
        wall_it = r["wall_s"] * 1e3 / r["iterations"]
        busy_it = r["window_busy_ms_per_iteration"]
        w_it = r["window_wall_ms_per_iteration"]
        one_it = r["in_turn_window_wall_ms_per_step"]
        _say(f"20-ntc-batched-{name}", lanes=len(temps),
             T=",".join(f"{t:g}" for t in temps),
             t_end_ms=f"{NTC_BATCH_T_END * 1e3:.4f}",
             tau_us=",".join(f"{t * 1e6:.4f}" for t in r["tau"]),
             tau_rel_err_vs_in_turn=",".join(f"{e:.3g}" for e in errs),
             tol=NTC_BATCH_TOL, in_turn_ref="1000K:card_phase13,"
             "others:host_cpu", steps_per_lane=",".join(map(str, r["steps"])),
             lockstep_iterations=r["iterations"], host_reads=r["host_reads"],
             wall_s=f"{r['wall_s']:.3f}",
             wall_ms_per_iteration=f"{wall_it:.3f}",
             window_kernels_per_iteration=
             f"{r['window_kernels_per_iteration']:.1f}",
             window_busy_ms_per_iteration=f"{busy_it:.4f}",
             window_wall_ms_per_iteration=f"{w_it:.3f}",
             # the window's busy ms over the same window's wall
             window_device_idle_share=f"{max(0.0, 1 - busy_it / w_it):.3f}",
             in_turn_window_steps=r["in_turn_window_steps"],
             in_turn_window_wall_ms_per_step=f"{one_it:.3f}",
             # an estimate, not a run: the lanes' steps at the in-turn
             # window's ms per step over the lockstep iterations at the
             # batched window's ms per iteration
             in_turn_over_batch_estimate=
             f"{sum(r['steps']) * one_it / (r['iterations'] * w_it):.3f}",
             in_turn_card_wall_s_1000K=f"{p13[f'wall_{name}']:.3f}",
             in_turn_card_steps_1000K=p13[f"steps_{name}"],
             host_cpu_in_turn_wall_s=",".join(
                 f"{host_res[(name, T)]['wall_s']:.1f}" for T in temps
                 if T != p13["T"]))
    ntc = mc_res["ntc"]
    _say("20-ntc-batched", batch_wait_s=f"{batch_wait_s:.1f}",
         phase17_in_turn_cases=len(ntc["T"]),
         phase17_in_turn_sweep_s=f"{ntc['sweep_s']:.1f}")

    # ---- 2: the banded BDF on the Brusselator ----
    rhs, y0 = _brusselator(BRUSS_POINTS)
    y0 = y0.to(dev)
    kw = dict(rtol=BRUSS_RTOL, atol=BRUSS_ATOL)
    t0 = time.perf_counter()
    band = odeint.bdf_solve(rhs, y0, 0.0, BRUSS_T_END, bandwidth=(3, 3), **kw)
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = odeint.bdf_solve(rhs, y0, 0.0, BRUSS_T_END, **kw)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    hb = host_res["bruss"]
    err_host = _rel_err(band.y.cpu(), hb["y"])
    err_dense = _rel_err(band.y.cpu(), dense.y.cpu())
    _check(band.success and dense.success and err_host <= PHASE20_TOL
           and err_dense <= BRUSS_DENSE_TOL,
           f"banded Brusselator: card vs host CPU {err_host}, vs dense "
           f"{err_dense}")
    n = y0.shape[0]
    Jb = banded.banded_jac(rhs, 0.0, y0, 3, 3)
    fac = banded.newton_band_factor(Jb, 1e-3, ml=3, mu=3)

    def factor():
        return banded.newton_band_factor(Jb, 1e-3, ml=3, mu=3)

    def solve():
        return banded.band_solve(fac, y0, ml=3, mu=3)
    # the profiler's device activities (kernels, copies, fills) of one
    # factor and one solve
    acts_f = device_activities(factor)
    acts_s = device_activities(solve)
    factor_ms = _sync_ms(factor, reps=3)
    solve_ms = _sync_ms(solve, reps=3)
    Jd = torch.func.jacfwd(rhs, argnums=1)(0.0, y0)
    eye = torch.eye(n, dtype=Jd.dtype, device=dev)
    lu_ms = device_ms(lambda: torch.linalg.lu_factor_ex(eye - 1e-3 * Jd),
                      device=dev, reps=10)
    _say("20-banded-bdf", points=BRUSS_POINTS, n=n, ml=3, mu=3,
         t_end=BRUSS_T_END, rtol=BRUSS_RTOL, atol=BRUSS_ATOL,
         steps=band.steps, n_fev=band.n_fev, n_jev=band.n_jev,
         rel_err_vs_host_cpu=f"{err_host:.3g}", tol=PHASE20_TOL,
         rel_err_vs_dense=f"{err_dense:.3g}", dense_tol=BRUSS_DENSE_TOL,
         banded_s_per_step=f"{band_s / band.steps:.4f}",
         dense_s_per_step=f"{dense_s / dense.steps:.4f}",
         dense_steps=dense.steps, host_cpu_banded_s=f"{hb['wall_s']:.2f}",
         band_factor_device_activities=len(acts_f),
         band_factor_busy_ms=f"{sum(us for _, us in acts_f) / 1e3:.2f}",
         band_factor_ms=f"{factor_ms:.2f}",
         band_solve_device_activities=len(acts_s),
         band_solve_busy_ms=f"{sum(us for _, us in acts_s) / 1e3:.2f}",
         band_solve_ms=f"{solve_ms:.2f}", dense_lu_ms=f"{lu_ms:.3f}")
    del Jd, eye, dense, band

    # ---- 3: the DAE and the sensitivities on Robertson ----
    got = _tail_solves(dev)
    want = host_res["solves"]
    errs = {k: _rel_err(got[k], want[k]) for k in ("dae_y", "sens_y",
                                                    "sens")}
    _check(got["dae_success"] and got["sens_success"]
           and max(errs.values()) <= PHASE20_TOL
           and abs(float(got["dae_y"].sum()) - 1.0) < 1e-10,
           f"DAE / sensitivities, card against host CPU: {errs}")
    _say("20-dae-sens", dae_steps=got["dae_steps"],
         dae_steps_host=want["dae_steps"], sens_steps=got["sens_steps"],
         sens_steps_host=want["sens_steps"],
         **{f"{k}_rel_err_vs_host_cpu": f"{v:.3g}" for k, v in errs.items()},
         tol=PHASE20_TOL,
         dk1_dy=",".join(f"{x:.6g}" for x in got["sens"][:, 0]))

    # ---- 4: the C API ----
    c = _capi_frame(dev)
    _say("20-capi", atoms=192, model="WATER_SPEC f64", e=f"{c['e']:.12g}",
         rel_err_vs_deeppot=json.dumps({k: f"{v:.3g}" for k, v in
                                        c["errs"].items()}).replace(" ", ""),
         tol=PHASE20_TOL, build_s=f"{c['build_s']:.2f}",
         program_s=f"{c['run_s']:.2f}")
    _say("20-integrator-tail", seconds=f"{time.perf_counter() - t_phase:.1f}")


# `--batch-overlap`: phase 13's RK case advanced this many BDF steps from
# its initial state, BATCH_OVERLAP_RUNS times in each setting
BATCH_OVERLAP_STEPS = 200
BATCH_OVERLAP_RUNS = 3
BATCH_OVERLAP_START_S = 40.0


def _batch_overlap(dev) -> int:
    """`python3 chip_smoke.py --batch-overlap`: whether phase 20's batch,
    which runs beside phase 13 in a process of its own, slows phase 13's
    host-bound BDF steps. Phase 13's RK case (1000 K, 40 atm, rtol 1e-8,
    atol 1e-14) is advanced BATCH_OVERLAP_STEPS steps from its initial
    state on the card, BATCH_OVERLAP_RUNS times in each of three settings
    in turn: alone; while _ntc_batch_run runs (started
    BATCH_OVERLAP_START_S before, so that it is past its set-up, and
    checked still running after); and alone again after that process is
    ended. Prints the ms per step of every run, with its steps and
    Jacobians (the same work in every run), and the host's load."""
    import torch
    from g4s_tpu_torch.models.cantera import ShockTubeBenchmark, \
        stoich_mixture
    from g4s_tpu_torch.ops import odeint
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "ndodecane_synthetic.yaml")
    _synthetic_mechanism_yaml(path, seed=CANTERA_SEED, **CANTERA_COUNTS)
    r = ShockTubeBenchmark(path, device=dev).r_rk
    y0 = r.initial_state(1000.0, 40 * 101325.0, stoich_mixture(r.mech))

    def run(steps):
        t0 = time.perf_counter()
        res = odeint.bdf_solve(r.rhs, y0, 0.0, NTC_BATCH_T_END,
                               rtol=NTC_BATCH_RTOL, atol=NTC_BATCH_ATOL,
                               max_steps=steps)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / res.steps, res

    run(10)                                            # warm-up
    walls = {}
    batch = None
    try:
        for setting in ("alone", "beside_batch", "alone_after"):
            if setting == "beside_batch":
                batch = _ntc_batch_start(path)
                time.sleep(BATCH_OVERLAP_START_S)
            if setting == "alone_after":
                _check(not batch["res"].ready(),
                       "the batch ended before the runs beside it did")
                _pool_stop(batch)
                batch = None
            for i in range(BATCH_OVERLAP_RUNS):
                ms, res = run(BATCH_OVERLAP_STEPS)
                walls.setdefault(setting, []).append(ms)
                _say("batch-overlap-run", setting=setting, run=i,
                     steps=res.steps, n_jev=res.n_jev,
                     ms_per_step=f"{ms:.4f}",
                     load_1min=f"{os.getloadavg()[0]:.2f}")
    finally:
        _pool_stop(batch)
        tmp.cleanup()
    alone = walls["alone"] + walls["alone_after"]
    beside = walls["beside_batch"]
    ratio = (sum(beside) / len(beside)) / (sum(alone) / len(alone))
    _say("batch-overlap", steps=BATCH_OVERLAP_STEPS,
         alone_ms_per_step=",".join(f"{x:.4f}" for x in alone),
         beside_batch_ms_per_step=",".join(f"{x:.4f}" for x in beside),
         beside_over_alone_mean=f"{ratio:.4f}",
         host_cpus=os.cpu_count())
    return 0


def _multichip_start() -> dict:
    """Phase 17, first part: write the dodecane-size mechanism and start
    the multi-rank dry run at full width (g4s_tpu_torch/drivers/multichip.py
    --full-width --check) on min(cards, MULTICHIP_MAX_WORLD) ranks, NCCL,
    one card each, as a process group of its own, so that it runs beside
    phase 13 (both are host-bound: the card idles 0.90-0.98 of their
    time). Returns the running driver; _multichip_wait reads it and
    _multichip_stop ends its group."""
    import tempfile
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    world = min(torch.cuda.device_count(), MULTICHIP_MAX_WORLD)
    tmp = tempfile.TemporaryDirectory()
    mech = os.path.join(tmp.name, "mech.yaml")
    _synthetic_mechanism_yaml(mech, **CANTERA_COUNTS, seed=CANTERA_SEED)
    run = {"world": world, "tmp": tmp,
           "res_path": os.path.join(tmp.name, "multichip.json"),
           "out_path": os.path.join(tmp.name, "driver.out"),
           "err_path": os.path.join(tmp.name, "driver.err")}
    cmd = [sys.executable, "-m", "g4s_tpu_torch.drivers.multichip",
           "--world", str(world), "--device", "cuda", "--mech", mech,
           "--full-width", "--check", "--json-out", run["res_path"]]
    env = dict(os.environ, PYTHONPATH=here)
    with open(run["out_path"], "w") as out, open(run["err_path"], "w") as err:
        run["t0"] = time.perf_counter()
        run["p"] = subprocess.Popen(cmd, cwd=here, env=env,
                                    stdin=subprocess.DEVNULL, stdout=out,
                                    stderr=err, start_new_session=True)
    return run


def _multichip_stop(run: dict) -> None:
    """End the multichip driver's process group (the driver and its rank
    processes) if it still runs, and remove its files."""
    p = run["p"]
    if p.poll() is None:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    run["tmp"].cleanup()


def _multichip_wait(run: dict) -> dict:
    """Phase 17, second part: wait for the multichip driver (at most
    MULTICHIP_TIMEOUT s from its start), print its lines and what its
    ranks checked, and fail unless it exited 0 with every check passed.
    Returns its JSON result."""
    import torch
    p, world = run["p"], run["world"]
    try:
        p.wait(timeout=max(1.0, MULTICHIP_TIMEOUT
                           - (time.perf_counter() - run["t0"])))
    except subprocess.TimeoutExpired:
        _multichip_stop(run)
        _check(False, f"the multichip driver ran past {MULTICHIP_TIMEOUT} s")
    driver_s = time.perf_counter() - run["t0"]
    with open(run["out_path"]) as f:
        stdout = f.read()
    for line in stdout.splitlines():
        print(f"[17-driver] {line}", flush=True)
    if p.returncode != 0:
        with open(run["err_path"]) as f:
            print(f.read()[-6000:], file=sys.stderr, flush=True)
    _check(p.returncode == 0,
           f"the multichip driver exited with {p.returncode}")
    last = (stdout.strip().splitlines() or [""])[-1]
    _check(last.endswith(" OK"), f"multichip: {last}")
    with open(run["res_path"]) as f:
        res = json.load(f)
    _check(res["world"] == world and res["backend"] == "nccl",
           f"multichip ran world {res['world']} on {res['backend']}")
    _say("17-multichip", world=world, backend=res["backend"],
         cards_visible=torch.cuda.device_count(),
         exchanges=("no_neighbour_at_one_rank:_the_CPU_tests_hold_"
                    "multi-rank_exchanges" if world == 1 else
                    f"{world}_ranks"),
         ran_beside="phase_13", driver_s=f"{driver_s:.1f}",
         stage_s=",".join(f"{v['seconds']:.1f}"
                          for v in res["stages"].values()),
         checks_s=f"{res['seconds'] - sum(v['seconds'] for v in res['stages'].values()):.1f}")

    def num(d):
        return json.dumps({k: (f"{v:.4g}" if isinstance(v, float) else v)
                           for k, v in d.items()}).replace(" ", "")

    _say("17-dp", frames=world, loss=f"{res['dp']['loss']:.6f}",
         f32_step_s=f"{res['dp']['f32_step_s']:.4f}",
         f64_leaf_rel_err_vs_one_process=f"{res['dp']['f64_leaf_rel_err']:.3g}",
         tol=res["dp"]["tol"])
    rg = res["regional"]
    _say("17-regional-f64", nodes=rg["nodes"], px=rg["px"], py=rg["py"],
         uzawa_cg=rg["f64_uzawa_cg"], bitwise_runs=rg["bitwise_runs"],
         rel_err_vs_one_device_eltk=num(rg["f64_rel_err_vs_one_device"]),
         tol=rg["tol"])
    for key in ("f32_distributed", "f32_one_device_eltk"):
        _say(f"17-regional-{key.replace('_', '-')}", **{
            k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in rg[key].items()})
    fs = res["full"]
    _say("17-full-f64", nodes_per_cap=fs["nodes_per_cap"], nel=fs["nel"],
         uzawa_cg=fs["f64_uzawa_cg"], bitwise_runs=fs["bitwise_runs"],
         rel_err_vs_one_device=num(fs["f64_rel_err_vs_one_device"]),
         tol=fs["tol"])
    for key in ("f32_sharded_step", "f32_one_device_step"):
        _say(f"17-full-{key.replace('_', '-')}", **{
            k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in fs[key].items()})
    cp = fs["coupled"]
    _say("17-coupled-f64", bc_rel_err_vs_unsharded=num(
        cp["bc_rel_err_vs_unsharded"]), tol=cp["tol"],
         coarse_uzawa_cg=cp["coarse_uzawa_cg"],
         fine_uzawa_cg=cp["fine_uzawa_cg"])
    sp_ = res["sparse"]
    _say("17-dist-sparse", **{k: (f"{v:.3g}" if isinstance(v, float)
                                  else v) for k, v in sp_.items()})
    nt = res["ntc"]
    _say("17-ntc", cases=len(nt["T"]), cases_per_rank=nt["cases_per_rank"],
         T=",".join(f"{t:g}" for t in nt["T"]),
         tau_RG_us=",".join(f"{t * 1e6:.2f}" for t in nt["tau_RG"]),
         tau_IG_us=",".join(f"{t * 1e6:.2f}" for t in nt["tau_IG"]),
         t_end=nt["t_end"], rtol=nt["rtol"], sweep_s=f"{nt['sweep_s']:.1f}",
         tau_rel_err_vs_rank_rerun=f"{nt['tau_rel_err_vs_rank_rerun']:.3g}",
         tol=nt["tol"])
    return res


def _multichip(dev, ms_of, res: dict) -> dict:
    """Phase 17, last part, after phase 16: the multichip driver's
    segment-sum launches (its four stages only), and the kernel timed at
    the distributed regional step's block scatter on a card that nothing
    else uses. Returns the launches and that reading."""
    import numpy as np
    import torch
    from g4s_tpu_torch.models.citcoms import assembly, load_config
    from g4s_tpu_torch.models.citcoms.distributed import (DistributedCitcom,
                                                          _block_slices)
    from g4s_tpu_torch.parallel.mesh import device_mesh_shape
    here = os.path.dirname(os.path.abspath(__file__))
    world = res["world"]
    launches = res["launches"]
    _check(launches["sorted_segment_sum"] > 0,
           "the multichip stages launched no segment-sum kernel")

    # the segment-sum kernel at the distributed regional step's block
    # scatter (assemble_grad_p's (nel_loc*8, 3) rows into nno_loc nodes),
    # f32 as stage 2 runs it
    cfg = load_config(os.path.join(here, "g4s_tpu_torch", "models",
                                   "citcoms", "cookbook2.cfg"))
    px, py = device_mesh_shape(world, 2)
    nxl = _block_slices(cfg.nodex, px)[0][1] - _block_slices(cfg.nodex,
                                                            px)[0][0]
    nyl = _block_slices(cfg.nodey, py)[0][1] - _block_slices(cfg.nodey,
                                                            py)[0][0]
    ien = DistributedCitcom._local_ien(nyl, nxl, cfg.nodez)
    nno = nyl * nxl * cfg.nodez
    plan = assembly.ScatterPlan.build(ien, nno, dev)
    rng = np.random.default_rng(17)
    rows = torch.from_numpy(rng.standard_normal((ien.shape[0] * 8, 3))).to(
        dev, torch.float32)
    r = _segment_sum_case("17-segment-sum", "dist_block_scatter", "f32",
                          rows, plan.seg_ids, plan.order, nno, ms_of)
    _say("17-launches", **launches)
    return {"launches": launches["sorted_segment_sum"], "segment_sum": r}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # a SIGTERM ends the script through its finally blocks, which stop
    # the processes it started
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(143))
    global HBM_BYTES_PER_S, F32_OPS_PER_S, F64_OPS_PER_S
    from g4s_tpu_torch.obs.profile import PEAKS, detect_platform
    peaks = PEAKS[detect_platform()]
    HBM_BYTES_PER_S = peaks["hbm_gbs"] * 1e9
    F32_OPS_PER_S = peaks["f32_tflops"] * 1e12
    F64_OPS_PER_S = peaks["f64_tflops"] * 1e12
    if sys.argv[1:] == ["--batch-overlap"]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        return _batch_overlap(torch.device("cuda"))
    import warnings

    import numpy as np
    import scipy.sparse as sp

    # torch's notes that its sparse CSR support is in beta (the library
    # yardsticks below use it)
    warnings.filterwarnings("ignore", message="Sparse")

    from g4s_tpu_torch.drivers import mv_bench, reg_mm
    from g4s_tpu_torch.engine import build_graph, dispatch, mxv
    from g4s_tpu_torch.kernels import _build
    from g4s_tpu_torch.models.citcoms import (CitcomModel, assembly,
                                              load_config, nodal,
                                              state_from_numpy)
    from g4s_tpu_torch.obs.timings import (device_activities, device_kernels,
                                           device_ms)
    from g4s_tpu_torch.ops import (bwell_spmv, route, segment, spgemm_esc,
                                   static_spmv, wsell_spmv)
    from g4s_tpu_torch.runtime import native_lib
    from g4s_tpu_torch.sparse import CSR, dense_to_csr

    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    cookbook2 = load_config(os.path.join(
        here, "g4s_tpu_torch", "models", "citcoms", "cookbook2.cfg"))
    with open(os.path.join(here, "benchmarks",
                           "cookbook2_blessed_f64.json")) as f:
        blessed = json.load(f)["trajectory"]

    def ms_of(fn, reps: int = 20, before=None) -> float:
        return device_ms(fn, device=dev, reps=reps, before=before)

    # writing 128 MiB evicts the 50 MB L2: the cold timings run this
    # before each call
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush_l2():
        flush_buf.fill_(1)

    def permute_path(phase, name, sigma, n_z, n_out):
        """The permute kernel at one of the main path's permutations: held
        bit-exact against its plain version on a z of the path's length in
        f32 and f64, and timed warm and cold beside its plain version,
        z[sigma] (z padded with zeros where sigma reaches past it, the
        gather the unfused code ran), the bound, and the kernel over the
        identity sigma of the same length, whose reads of z are whole
        lines: the gap between the two is the cost of sigma's random
        32-byte sector reads. Two library passes that read and write
        whole lines time what one pass over these lengths costs on the
        card: a copy of n_out elements, and an add of two n_out-element
        vectors into a third, which moves the bound's bytes (the int32
        sigma read as f32)."""
        m_ = sigma.shape[0]
        z = torch.from_numpy(np.random.default_rng(m_).standard_normal(n_z)
                             .astype(np.float32)).to(dev)
        for zz in (z, z.double()):
            got = route.permute_gather(zz, sigma, n_out=n_out)
            _check(torch.equal(got, route._apply_permute_plain(
                zz, sigma, n_out=n_out)),
                f"permute_gather at {name} {zz.dtype}: not bit-exact")
        top = int(sigma.max()) + 1
        z_lib = z if top <= n_z else torch.cat([z, z.new_zeros(top - n_z)])
        # the z elements sigma reaches, each read once
        reads = int(torch.unique(sigma[sigma < n_z]).numel())
        ident = torch.arange(m_, dtype=torch.int32, device=dev)
        src = torch.zeros(n_out, device=dev)
        sig_f = torch.zeros(n_out, device=dev)
        sig_f[:m_] = sigma.view(torch.float32)
        dst = torch.empty(n_out, device=dev)

        def gather():
            return route.permute_gather(z, sigma, n_out=n_out)

        r = {
            "ms": ms_of(gather), "cold_ms": ms_of(gather, before=flush_l2),
            "identity_ms": ms_of(lambda: route.permute_gather(
                z, ident, n_out=n_out)),
            "plain_ms": ms_of(lambda: route._apply_permute_plain(
                z, sigma, n_out=n_out)),
            "copy_ms": ms_of(lambda: dst.copy_(src)),
            "add_ms": ms_of(lambda: torch.add(src, sig_f, out=dst)),
            "add_cold_ms": ms_of(lambda: torch.add(src, sig_f, out=dst),
                                 before=flush_l2),
            "library_ms": ms_of(lambda: z_lib[sigma]),
            "library_cold_ms": ms_of(lambda: z_lib[sigma], before=flush_l2),
            # sigma (int32) and the z it reaches read, out written (f32)
            "bound": _bound(4.0 * (m_ + reads + n_out), 0),
        }
        # random sector reads per second that the gap between sigma and the
        # identity pays for; none where launch costs hide the gap
        gap = r["ms"] - r["identity_ms"]
        rate = (f"{reads / 1e6 / gap:.1f}" if gap > 0.2 * r["identity_ms"]
                else "n/a")
        _say(phase, path=name, m=m_, n_z=n_z, n_out=n_out,
             bit_exact="f32,f64", kernel_ms=f"{r['ms']:.4f}",
             kernel_cold_ms=f"{r['cold_ms']:.4f}",
             x_sigma_ms=f"{r['library_ms']:.4f}",
             x_sigma_cold_ms=f"{r['library_cold_ms']:.4f}",
             plain_ms=f"{r['plain_ms']:.4f}",
             bound_ms=f"{r['bound'][0]:.4f}",
             share_of_bound=f"{r['bound'][0] / r['ms']:.3f}",
             cold_share_of_bound=f"{r['bound'][0] / r['cold_ms']:.3f}",
             identity_sigma_ms=f"{r['identity_ms']:.4f}",
             random_sectors_g_per_s=rate,
             library_copy_ms=f"{r['copy_ms']:.4f}",
             library_add_same_bytes_ms=f"{r['add_ms']:.4f}",
             library_add_cold_ms=f"{r['add_cold_ms']:.4f}")
        return r

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc_ver = _run([_build.nvcc(), "--version"]).splitlines()[-1]
    _say("0-machine", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=repr(nvcc_ver), card=repr(smi),
         count=torch.cuda.device_count())

    # each phase's start on the host clock, for the phase-seconds line
    laps = [(1, time.perf_counter())]
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    _say("1-build", seconds=f"{build_s:.2f}", lib=lib_path.name,
         sources=",".join(s.name for s in _build.sources()))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())
    # the permute kernel's launch at the 2^20 gathers of phase 2 (sigma is
    # read straight from device memory: no stages in shared memory)
    for dt in (torch.float32, torch.float64):
        sh = route.permute_launch_shape(dt, 1 << 20, device=dev)
        print(f"    ptxas: permute_gather {str(dt)[6:]} launch at n_out "
              f"2^20: tile {sh['tile']}, threads {sh['threads']}, "
              f"blocks/SM {sh['blocks_per_sm']}, grid {sh['grid']}, "
              f"dynamic smem {sh['smem_bytes']} B")

    laps.append((2, time.perf_counter()))
    # ---- 2: each kernel against its plain version, small cases ----------
    rng = np.random.default_rng(0)
    err = {"permute_gather": 0.0, "wsell_spmv": 0.0, "bwell_spmv": 0.0}
    m = 1 << 20
    sigma = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)
    for dt in (torch.float32, torch.float64):
        z = torch.from_numpy(rng.standard_normal(m)).to(dev, dt)
        got = route.permute_gather(z, sigma)
        want = route._apply_permute_plain(z, sigma)
        _check(torch.equal(got, want), f"permute_gather {dt} not bit-exact")
    _say("2-permute", m=m, dtypes="f32,f64", bit_exact=True)
    # the fused cases: lengths 2^20 + r, z 1000 shorter than sigma's range,
    # n_out past len(sigma), sigma and z as views at offsets 0-3 into their
    # allocations
    n_cases = 0
    for dt in (torch.float32, torch.float64):
        for r in range(8):
            mr, off_s, off_z = m + r, r % 4, (r // 2) % 4
            sig = torch.from_numpy(rng.permutation(mr + off_s)
                                   .astype(np.int32)).to(dev)[off_s:]
            z = torch.from_numpy(rng.standard_normal(mr - 1000 + off_z)) \
                .to(dev, dt)[off_z:]
            n_out = mr + 8 + r
            got = route.permute_gather(z, sig, n_out=n_out)
            _check(got.shape == (n_out,) and torch.equal(
                got, route._apply_permute_plain(z, sig, n_out=n_out)),
                f"permute_gather fused {dt} r={r}: not bit-exact")
            n_cases += 1
    _say("2-permute-fused", cases=n_cases, lengths="2^20+0..7",
         dtypes="f32,f64", sigma_past_z=1000, n_out="m+8+r",
         offsets="sigma 0..3, z 0..3", bit_exact=True)
    # the segment-sum kernel on 2^20 values that cancel heavily (each
    # with both signs, magnitudes 1e-8..1e8) over sorted ids: two calls
    # bitwise equal, and equal to the host CPU's in-order index_add_
    rs = np.random.default_rng(11)
    for dt in (torch.float64, torch.float32):
        big = rs.standard_normal(m // 2) * 10.0 ** rs.integers(-8, 9, m // 2)
        data = torch.from_numpy(np.concatenate([big, -big])[rs.permutation(m)])
        ids = torch.from_numpy(np.sort(rs.integers(0, 4096, m)))
        d, i = data.to(dev, dt), ids.to(dev)
        got = segment.sorted_segment_sum(d, i, 5000)
        _check(torch.equal(got, segment.sorted_segment_sum(d, i, 5000))
               and torch.equal(got.cpu(), segment._sorted_segment_sum_plain(
                   d.cpu(), ids, 5000)),
               f"sorted_segment_sum {dt}: not repeatable or not the host "
               "CPU's sum")
    _say("2-segment-sum", m=m, segments=5000, dtypes="f64,f32",
         bitwise_repeatable=True, equals_host_cpu=True)
    for name, a in _wsell_cases():
        packed = wsell_spmv.pack_wsell(CSR.from_scipy(a), device=dev,
                                       packs_per_tile=2)
        n_pad = wsell_spmv._chain_pad(packed)
        x_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        x_pad[: a.shape[1]] = torch.from_numpy(
            rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev)
        got = wsell_spmv.spmv_wsell_chain(packed, x_pad)
        want = wsell_spmv._spmv_wsell_plain(packed, x_pad)
        rel = _rel_err(got.cpu(), want.cpu())
        err["wsell_spmv"] = max(err["wsell_spmv"],
                                float((got - want).abs().max()))
        _check(rel <= REL_TOL, f"wsell_spmv {name}: rel err {rel}")
        _check(bool((got[packed.n_rows:] == 0).all()),
               f"wsell_spmv {name}: non-zero tail")
        _say("2-wsell", case=name, shape=a.shape, W=packed.width,
             k=packed.k, rel_err=f"{rel:.3g}")

    laps.append((3, time.perf_counter()))
    # ---- 3: the main path, shuffled 3D 7-point stencil -----------------
    A = _stencil(101, seed=0)
    n = A.shape[0]
    t0 = time.perf_counter()
    g = build_graph(CSR.from_scipy(A), device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    _check(g.variant == "wsell" and g.perm is not None,
           f"stencil dispatched to {g.variant!r}, perm "
           f"{'set' if g.perm is not None else 'None'}")
    _say("3-plan", n=n, nnz=A.nnz, variant=g.variant,
         k=g.wsell.k, groups=list(g.wsell.groups), width=g.wsell.width,
         host_build_s=f"{plan_s:.2f}")

    x_np = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    n_pad = wsell_spmv._chain_pad(g.wsell)
    x_pad = torch.zeros(n_pad, device=dev)
    x_pad[:n] = x
    # kernels vs plain at the main path's shapes: the permute gathers x
    # into the chain-padded input and the padded y back to n
    p_in = permute_path("3-permute-path", "stencil.perm", g.perm, n, n_pad)
    permute_path("3-permute-path", "stencil.iperm", g.iperm, n_pad, n)
    w_k = wsell_spmv.spmv_wsell_chain(g.wsell, x_pad)
    w_p = wsell_spmv._spmv_wsell_plain(g.wsell, x_pad)
    rel = _rel_err(w_k.cpu(), w_p.cpu())
    _check(rel <= REL_TOL, f"wsell_spmv at the stencil pack: rel {rel}")
    err["wsell_spmv"] = max(err["wsell_spmv"], float((w_k - w_p).abs().max()))

    # library calls computing the same functions: z[sigma] for the
    # permute, cuSPARSE SpMV of the pack's (renumbered) matrix for WSELL
    perm_np = g.perm.cpu().numpy()
    A_p = A[perm_np][:, perm_np].tocsr()
    A_p_t = _csr_tensor(A_p, dev)
    x_n = x_pad[:n].contiguous()        # the hoisted kernel's input
    rel_lib = _rel_err(torch.mv(A_p_t, x_n).cpu(), w_k[:n].cpu())
    _check(rel_lib <= REL_TOL, f"cuSPARSE vs wsell_spmv: rel {rel_lib}")
    ms = {
        "permute_gather": p_in["ms"],
        "wsell_spmv": ms_of(
            lambda: wsell_spmv.spmv_wsell_chain(g.wsell, x_pad)),
    }
    plain_ms = {
        "permute_gather": p_in["plain_ms"],
        "wsell_spmv": ms_of(
            lambda: wsell_spmv._spmv_wsell_plain(g.wsell, x_pad)),
    }
    library_ms = {
        "permute_gather": p_in["library_ms"],
        "wsell_spmv": ms_of(lambda: torch.mv(A_p_t, x_n)),
    }
    ws = g.wsell
    bound = {
        "permute_gather": p_in["bound"],
        # codes (int16), values, window starts, x read; y written; one FMA
        # per stored slot
        "wsell_spmv": _bound(ws.lanes.numel() * 2 + ws.vals.numel() * 4
                             + ws.starts.numel() * 4 + 2 * x_pad.numel() * 4,
                             2.0 * ws.vals.numel()),
    }

    def mxv_plain():
        xp = route._apply_permute_plain(x, g.perm, n_out=n_pad)
        y_p = wsell_spmv._spmv_wsell_plain(g.wsell, xp)
        return route._apply_permute_plain(y_p, g.iperm)

    mxv_ms = ms_of(lambda: mxv(g, x))
    mxv_plain_ms = ms_of(mxv_plain)
    mxv_host_us = _host_us(lambda: mxv(g, x))
    stencil_bytes = A.nnz * 8 + n * 8          # bench.py's byte count
    _say("3-time", mxv_ms=f"{mxv_ms:.4f}", mxv_plain_ms=f"{mxv_plain_ms:.4f}",
         mxv_host_wall_us=f"{mxv_host_us:.2f}",
         device_idle_share=f"{max(0.0, 1 - mxv_ms * 1e3 / mxv_host_us):.3f}",
         hoisted_wsell_ms=f"{ms['wsell_spmv']:.4f}",
         wsell_plain_ms=f"{plain_ms['wsell_spmv']:.4f}",
         wsell_cusparse_ms=f"{library_ms['wsell_spmv']:.4f}",
         wsell_bound_ms=f"{bound['wsell_spmv'][0]:.4f}",
         permute_ms=f"{ms['permute_gather']:.4f}",
         permute_plain_ms=f"{plain_ms['permute_gather']:.4f}",
         permute_library_ms=f"{library_ms['permute_gather']:.4f}",
         permute_bound_ms=f"{bound['permute_gather'][0]:.4f}",
         gbs_mxv=f"{stencil_bytes / mxv_ms / 1e6:.1f}",
         gbs_hoisted=f"{stencil_bytes / ms['wsell_spmv'] / 1e6:.1f}")
    del A_p_t

    route.LAUNCHES = 0
    wsell_spmv.LAUNCHES = 0
    y = mxv(g, x)
    torch.cuda.synchronize()
    launches = {"permute_gather": route.LAUNCHES,
                "wsell_spmv": wsell_spmv.LAUNCHES}
    _check(launches["wsell_spmv"] >= 1 and launches["permute_gather"] >= 2,
           f"main path launches {launches}")
    _check(tuple(y.shape) == (n,), f"mxv shape {tuple(y.shape)}")
    rel = _rel_err(y.cpu(), A.astype(np.float64) @ x_np.astype(np.float64))
    _check(rel <= REL_TOL, f"stencil mxv vs scipy f64: rel {rel}")
    _say("3-mxv", launches=json.dumps(launches).replace(" ", ""),
         rel_err_vs_scipy_f64=f"{rel:.3g}")
    names = device_kernels(lambda: mxv(g, x))
    n_perm = sum("permute_gather" in k for k in names)
    _check(len(names) == 3 and n_perm == 2
           and sum("wsell_spmv" in k for k in names) == 1,
           f"stencil mxv runs {len(names)} device kernels: {names}")
    _say("3-kernels", device_kernels_per_mxv=len(names),
         permute_gather=n_perm, names=_kernel_names(names))
    # phase 11 runs the per-matrix kernels on this pack, x and matrix;
    # their nvcc builds start now and overlap phases 4-10
    ws3, x_pad3 = g.wsell, x_pad
    static_builds = _start_static_builds(ws3, dev)
    del g, A

    laps.append((4, time.perf_counter()))
    # ---- 4: RCM-DIA: the shuffled 16-diagonal band ----------------------
    nb = 1 << 20
    band = _band(nb)
    p_ = rng.permutation(nb)
    shuf = band[p_][:, p_].tocsr()
    g4 = build_graph(CSR.from_scipy(shuf), device=dev)
    _check(g4.variant == "dia" and g4.perm is not None,
           f"band dispatched to {g4.variant!r}")
    xb = rng.standard_normal(nb).astype(np.float32)
    route.LAUNCHES = 0
    yb = mxv(g4, torch.from_numpy(xb).to(dev))
    torch.cuda.synchronize()
    _check(route.LAUNCHES >= 2, f"dia permute launches {route.LAUNCHES}")
    rel = _rel_err(yb.cpu(), shuf.astype(np.float64) @ xb.astype(np.float64))
    _check(rel <= REL_TOL, f"dia mxv vs scipy f64: rel {rel}")
    _say("4-dia", n=nb, variant=g4.variant, ndiag=g4.dia.ndiag,
         permute_launches=route.LAUNCHES, rel_err_vs_scipy_f64=f"{rel:.3g}")
    permute_path("4-permute-path", "dia.perm", g4.perm, nb, nb)
    del g4, shuf

    laps.append((5, time.perf_counter()))
    # ---- 5: the streaming schedule: uniform random 2^17 x 8 -------------
    nr = 1 << 17
    rr = np.random.default_rng(1)
    nnz_r = nr * 8
    rand = sp.coo_matrix(
        (rr.normal(size=nnz_r).astype(np.float32),
         (rr.integers(0, nr, nnz_r), rr.integers(0, nr, nnz_r))),
        shape=(nr, nr)).tocsr()
    t0 = time.perf_counter()
    g5 = build_graph(CSR.from_scipy(rand), device=dev, reorder=False)
    stream_plan_s = time.perf_counter() - t0
    _check(g5.variant == "stream", f"random dispatched to {g5.variant!r}")
    xr = rr.standard_normal(nr).astype(np.float32)
    xr_d = torch.from_numpy(xr).to(dev)
    route.LAUNCHES = 0
    yr = mxv(g5, xr_d)
    torch.cuda.synchronize()
    _check(route.LAUNCHES == 3, f"stream permute launches {route.LAUNCHES}")
    rel = _rel_err(yr.cpu(), rand.astype(np.float64) @ xr.astype(np.float64))
    _check(rel <= REL_TOL, f"stream mxv vs scipy f64: rel {rel}")
    stream_ms = ms_of(lambda: mxv(g5, xr_d))
    stream_host_us = _host_us(lambda: mxv(g5, xr_d))
    _say("5-stream", n=nr, nnz=rand.nnz, variant=g5.variant,
         stream_m=g5.stream.m, permute_launches=3,
         rel_err_vs_scipy_f64=f"{rel:.3g}", mxv_ms=f"{stream_ms:.4f}",
         mxv_host_wall_us=f"{stream_host_us:.2f}",
         host_build_s=f"{stream_plan_s:.2f}")
    names = device_kernels(lambda: mxv(g5, xr_d))
    n_perm = sum("permute_gather" in k for k in names)
    _check(n_perm == 3, f"stream mxv runs {n_perm} permutes: {names}")
    _say("5-kernels", device_kernels_per_mxv=len(names),
         permute_gather=n_perm, names=_kernel_names(names))
    s5 = g5.stream
    permute_path("5-permute-path", "stream.xplan", s5.xplan.sigma, nr,
                 s5.nc_pad)
    permute_path("5-permute-path", "stream.route2", s5.route2.sigma, s5.m,
                 s5.m)
    permute_path("5-permute-path", "stream.rowplan",
                 s5.rowplan.sigma[: s5.n_rows], s5.n_rows, s5.n_rows)
    del g5

    laps.append((6, time.perf_counter()))
    # ---- 6: the BWELL path: spmv_bwell ---------------------------------
    def bwell_pad(p, xv):
        xp = torch.zeros(p.n_cols + bwell_spmv.X_PAD, device=dev)
        xp[: p.n_cols] = xv
        return xp

    for name, a, mode, ppt in _bwell_cases():
        p = bwell_spmv.pack_bwell(CSR.from_scipy(a), packs_per_tile=ppt,
                                  mode=mode, device=dev)
        xp = bwell_pad(p, torch.from_numpy(
            rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev))
        got = bwell_spmv.spmv_bwell_padded(p, xp)
        want = bwell_spmv._spmv_bwell_plain(p, xp)
        rel = _rel_err(got.cpu(), want.cpu())
        err["bwell_spmv"] = max(err["bwell_spmv"],
                                float((got - want).abs().max()))
        _check(rel <= REL_TOL, f"bwell_spmv {name}: rel err {rel}")
        _say("6-bwell-small", case=name, shape=a.shape, mode=p.mode,
             W=p.width, rel_err=f"{rel:.3g}")

    clustered = _clustered(nb, seed=1)
    t0 = time.perf_counter()
    pb = bwell_spmv.pack_bwell(CSR.from_scipy(band), mode="pack",
                               device=dev)
    pr = bwell_spmv.pack_bwell(CSR.from_scipy(clustered), mode="auto",
                               device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    _check(pb.mode == "pack" and pb.width == 16,
           f"band packed as {pb.mode} W={pb.width}")
    _check(pr.mode == "row", f"clustered matrix packed as {pr.mode!r}: "
           "mode pack should have rejected it")
    xs = {k: torch.from_numpy(np.random.default_rng(s).standard_normal(nb)
                              .astype(np.float32)).to(dev)
          for k, s in (("pack", 2), ("row", 3))}
    bwell_spmv.LAUNCHES = 0
    ys = {"pack": bwell_spmv.spmv_bwell(pb, xs["pack"]),
          "row": bwell_spmv.spmv_bwell(pr, xs["row"])}
    torch.cuda.synchronize()
    launches["bwell_spmv"] = bwell_spmv.LAUNCHES
    _check(launches["bwell_spmv"] == 2,
           f"bwell path launches {launches['bwell_spmv']}")
    bw = {}
    for mode, p, a in (("pack", pb, band), ("row", pr, clustered)):
        y = ys[mode]
        _check(tuple(y.shape) == (nb,), f"spmv_bwell shape {tuple(y.shape)}")
        rel_sp = _rel_err(y.cpu(), a.astype(np.float64)
                          @ xs[mode].cpu().numpy().astype(np.float64))
        xp = bwell_pad(p, xs[mode])
        yk = bwell_spmv.spmv_bwell_padded(p, xp)
        yp = bwell_spmv._spmv_bwell_plain(p, xp)
        rel_pl = _rel_err(yk.cpu(), yp.cpu())
        err["bwell_spmv"] = max(err["bwell_spmv"],
                                float((yk - yp).abs().max()))
        _check(rel_sp <= REL_TOL and rel_pl <= REL_TOL,
               f"bwell {mode} n=2^20: rel vs scipy {rel_sp}, vs plain "
               f"{rel_pl}")
        a_t = _csr_tensor(a, dev)
        xv = xs[mode]
        bw[mode] = {
            "ms": ms_of(lambda: bwell_spmv.spmv_bwell_padded(p, xp)),
            "plain_ms": ms_of(lambda: bwell_spmv._spmv_bwell_plain(p, xp)),
            "library_ms": ms_of(lambda: torch.mv(a_t, xv)),
            # lanes, values, window starts and x read; y written
            "bound": _bound(p.lanes.numel() * 4 + p.vals.numel() * 4
                            + p.starts.numel() * 4 + xp.numel() * 4
                            + p.rows_padded * 4, 2.0 * p.vals.numel()),
        }
        _say("6-bwell", n=nb, nnz=a.nnz, mode=p.mode, W=p.width,
             slots=p.vals.numel(), rel_err_vs_scipy_f64=f"{rel_sp:.3g}",
             rel_err_vs_plain=f"{rel_pl:.3g}",
             kernel_ms=f"{bw[mode]['ms']:.4f}",
             plain_ms=f"{bw[mode]['plain_ms']:.4f}",
             cusparse_ms=f"{bw[mode]['library_ms']:.4f}",
             bound_ms=f"{bw[mode]['bound'][0]:.4f}")
        del a_t
    _say("6-bwell-path", launches=launches["bwell_spmv"],
         host_pack_s=f"{pack_s:.2f}")
    del pb, pr, band, clustered

    laps.append((7, time.perf_counter()))
    # ---- 7: the SpGEMM path: mxm ----------------------------------------
    # the native host library that mxm's host plan runs in, built by g++
    # from the checkout
    native_path, gxx_s = native_lib.build()
    native_lib.get_lib()
    _say("7-native-build", lib=native_path.name, gxx_s=f"{gxx_s:.2f}")
    built = []
    esc_plan = spgemm_esc.esc_plan

    def recording_esc_plan(*args, **kw):
        t0 = time.perf_counter()
        plan = esc_plan(*args, **kw)
        torch.cuda.synchronize()
        built.append((plan, time.perf_counter() - t0))
        return plan

    t0 = time.perf_counter()
    m32 = CitcomModel(cookbook2, dtype=torch.float32, device=dev)
    model_s = time.perf_counter() - t0
    fem_k = _fem_stiffness(m32)
    _say("7-fem-k", case="fem_k_citcoms_33", n=fem_k.shape[0],
         nnz=fem_k.nnz, model_build_s=f"{model_s:.2f}")
    spgemm_esc.esc_plan = recording_esc_plan    # mxm looks it up per call
    try:
        for name, a in (("er_32768_16", _erdos_renyi(1 << 15, 16, seed=42)),
                        ("rmat_32768", _rmat_like(1 << 15, 1 << 19)),
                        ("er_131072_16", _erdos_renyi(1 << 17, 16,
                                                      seed=43)),
                        ("fem_k_citcoms_33", fem_k)):
            A_c = CSR.from_scipy(a)
            built.clear()
            t0 = time.perf_counter()
            C = dispatch.mxm(A_c, A_c, device=dev)
            torch.cuda.synchronize()
            mxm_s = time.perf_counter() - t0
            _check(len(built) == 1, f"mxm {name} did not take ESC")
            plan, plan_s = built[0]
            a64 = a.astype(np.float64)
            ref = (a64 @ a64).tocsr()
            ref.sort_indices()
            _check(np.array_equal(C.indptr.cpu().numpy(), ref.indptr)
                   and np.array_equal(C.indices.cpu().numpy(), ref.indices),
                   f"mxm {name}: C's structure differs from scipy's")
            rel = _rel_err(C.data.cpu(), ref.data)
            _check(rel <= REL_TOL, f"mxm {name} vs scipy f64: rel {rel}")
            # the same host plan in numpy: array for array equal
            t0 = time.perf_counter()
            plan_np = esc_plan(A_c, A_c, device=dev, use_native=False)
            torch.cuda.synchronize()
            numpy_plan_s = time.perf_counter() - t0
            _check(all(torch.equal(getattr(plan, f.name),
                                   getattr(plan_np, f.name))
                       if isinstance(getattr(plan, f.name), torch.Tensor)
                       else getattr(plan, f.name) == getattr(plan_np, f.name)
                       for f in dataclasses.fields(plan)),
                   f"esc_plan {name}: the native and numpy plans differ")
            del plan_np
            t0 = time.perf_counter()
            pd = spgemm_esc.esc_plan_device(A_c, A_c, device=dev)
            torch.cuda.synchronize()
            dev_plan_s = time.perf_counter() - t0
            _check(pd.nnz == plan.nnz and pd.flops == plan.flops,
                   f"esc_plan_device {name}: nnz {pd.nnz} vs {plan.nnz}")
            a_d = A_c.data.to(dev)
            num_ms = ms_of(lambda: spgemm_esc.esc_numeric(a_d, a_d, plan),
                           reps=5)
            if name == "er_32768_16":
                _, stages = spgemm_esc.esc_numeric_staged(a_d, a_d, plan)
                _say("7-esc-stages", case=name,
                     **{k: f"{v:.4f}" for k, v in stages.items()})
            num_us = _host_us(
                lambda: spgemm_esc.esc_numeric(a_d, a_d, plan), reps=10)
            a_t = _csr_tensor(a, dev)
            lib_ms = _wall_ms(lambda: torch.sparse.mm(a_t, a_t))
            _say("7-mxm", case=name, n=a.shape[0], nnz=a.nnz,
                 products=plan.flops, nnz_c=plan.nnz, engine="esc",
                 classes=len(plan.classes),
                 m2_over_flops=f"{plan.m2 / plan.flops:.3f}",
                 rel_err_vs_scipy_f64=f"{rel:.3g}",
                 mxm_s=f"{mxm_s:.2f}", esc_plan_host_s=f"{plan_s:.2f}",
                 esc_plan_host_numpy_s=f"{numpy_plan_s:.2f}",
                 plans_equal=True, esc_plan_device_s=f"{dev_plan_s:.2f}",
                 esc_numeric_ms=f"{num_ms:.3f}",
                 esc_numeric_host_wall_us=f"{num_us:.1f}",
                 gflops=f"{2 * plan.flops / num_ms / 1e6:.2f}",
                 sparse_mm_wall_ms=f"{lib_ms:.3f}")
            del C, plan, pd, a_t, built[:]
    finally:
        spgemm_esc.esc_plan = esc_plan

    # K x through the engine's SpMV path, and cuSPARSE's SpMV on the same K
    # (the library yardstick of phase 9's stencil matvec)
    g7 = build_graph(CSR.from_scipy(fem_k), device=dev)
    xk_np = np.random.default_rng(9).standard_normal(fem_k.shape[0]) \
        .astype(np.float32)
    xk = torch.from_numpy(xk_np).to(dev)
    route.LAUNCHES = wsell_spmv.LAUNCHES = 0
    yk = mxv(g7, xk)
    torch.cuda.synchronize()
    k_launches = {"permute_gather": route.LAUNCHES,
                  "wsell_spmv": wsell_spmv.LAUNCHES}
    rel = _rel_err(yk.cpu(), fem_k.astype(np.float64)
                   @ xk_np.astype(np.float64))
    _check(rel <= REL_TOL, f"fem K mxv vs scipy f64: rel {rel}")
    fem_t = _csr_tensor(fem_k, dev)
    fem_cusparse_ms = ms_of(lambda: torch.mv(fem_t, xk))
    _say("7-fem-mxv", n=fem_k.shape[0], nnz=fem_k.nnz, variant=g7.variant,
         perm=g7.perm is not None,
         launches=json.dumps(k_launches).replace(" ", ""),
         device_kernels=_kernel_names(device_kernels(lambda: mxv(g7, xk))),
         rel_err_vs_scipy_f64=f"{rel:.3g}",
         mxv_ms=f"{ms_of(lambda: mxv(g7, xk)):.4f}",
         cusparse_ms=f"{fem_cusparse_ms:.4f}")
    del g7, fem_t

    rs = np.random.default_rng(7)
    M = (rs.random((200, 200)) < 0.06) * rs.standard_normal((200, 200))
    pat = sp.random(24, 24, 0.2, random_state=np.random.RandomState(5),
                    format="csr")
    K = sp.bsr_matrix((rs.standard_normal((pat.nnz, 3, 3)), pat.indices,
                       pat.indptr), shape=(72, 72), blocksize=(3, 3)).tocsr()
    for name, mat in (("random_200", dense_to_csr(M)),
                      ("blocked_72", CSR.from_scipy(K))):
        res = reg_mm.run(mat, mat, verbose=False, device=dev)
        _check(all(ok for ok, _ in res.values()),
               f"reg_mm {name}: {res}")
        _say("7-reg_mm", case=name, strategies=",".join(res),
             all_pass=True,
             max_err=f"{max(e for _, e in res.values()):.3g}")

    laps.append((8, time.perf_counter()))
    # ---- 8: the mv suite: dense BLAS2 at dim 4096 -----------------------
    mv = mv_bench.run(4096, verbose=False, device=dev)
    _say("8-mv", dim=4096, **{k: f"{v:.4f}" for k, v in mv.items()})

    laps.append((9, time.perf_counter()))
    # ---- 9: CitcomS regional Cookbook2 ---------------------------------
    t0 = time.perf_counter()
    m64 = CitcomModel(cookbook2, dtype=torch.float64, device=dev)
    model_s = time.perf_counter() - t0
    launch_mods = (route, wsell_spmv, bwell_spmv)
    for mod in launch_mods + (segment,):
        mod.LAUNCHES = 0
    f64_keys = ("vrms", "nu_top", "nu_bot", "dt", "T_mean")
    r64 = _cookbook2(m64, 10, blessed, f64_keys, COOKBOOK2_F64_TOL)
    # a second run in the same process: every sum on the card has one
    # order, so each step's diagnostics and counts must be bitwise equal
    r64b = _cookbook2(m64, 10, blessed, f64_keys, COOKBOOK2_F64_TOL)
    _check(r64b["trace"] == r64["trace"],
           f"Cookbook2 f64: two runs differ: {r64['trace']} against "
           f"{r64b['trace']}")
    _say("9-cookbook2-f64", grid="33x33x9", nel=m64.mesh.nel, steps=10,
         runs=2, deterministic=True,
         model_build_s=f"{model_s:.2f}",
         s_per_step=f"{r64['wall_s']:.4f},{r64b['wall_s']:.4f}",
         inner_cg_per_step=r64["inner"],
         host_syncs_per_step=r64["host_syncs"],
         uzawa_cg_per_step=",".join(r64["counts"]),
         max_rel_err=json.dumps({k: f"{v:.3g}" for k, v in
                                 r64["err"].items()}).replace(" ", ""),
         per_step_max_rel_err=",".join(r64["per_step_err"]),
         within_1e_6=max(r64["err"].values()) <= COOKBOOK2_F64_GOAL)
    # f64 on the card against f64 on the host CPU: one step from the card's
    # state after its initial solve, every solver loop run to its cap
    # (accuracy 0: 3 Uzawa iterations of 60 CG each), so no stopping test
    # can part the two
    fixed = dataclasses.replace(cookbook2, accuracy=0.0, piterations=3,
                                vlowstep=60)
    sg, dg = CitcomModel(fixed, device=dev).step(r64["s0"])
    m_host = CitcomModel(fixed, device="cpu")
    s0 = r64["s0"]
    sh, dh = m_host.step(state_from_numpy(m_host, dict(
        {k: getattr(s0, k).cpu() for k in ("T", "Tdot", "V", "P", "time",
                                           "dt")}, step=s0.step)))
    _check((dg.uzawa_iterations, dg.inner_iterations)
           == (dh.uzawa_iterations, dh.inner_iterations) == (3, 240),
           f"fixed-count step counts {dg} {dh}")
    fixed_err = {k: _rel_err(getattr(sg, k).cpu(), getattr(sh, k))
                 for k in ("T", "V", "P", "dt")}
    _check(all(v <= COOKBOOK2_FIXED_TOL for v in fixed_err.values()),
           f"f64 fixed-count step, card against host CPU: {fixed_err}")
    _say("9-cookbook2-f64-card-vs-host", uzawa_cg="3/240",
         rel_err=json.dumps({k: f"{v:.3g}" for k, v in
                             fixed_err.items()}).replace(" ", ""),
         tol=COOKBOOK2_FIXED_TOL)
    del s0, sg, sh, m_host
    r32 = _cookbook2(m32, 5, blessed, ("vrms", "nu_top", "dt"),
                     COOKBOOK2_F32_TOL, after=1)
    r32b = _cookbook2(m32, 5, blessed, ("vrms", "nu_top", "dt"),
                      COOKBOOK2_F32_TOL, after=1)
    _check(r32b["trace"] == r32["trace"],
           f"Cookbook2 f32: two runs differ: {r32['trace']} against "
           f"{r32b['trace']}")
    torch.cuda.synchronize()
    cb_launches = sum(mod.LAUNCHES for mod in launch_mods)
    launches["sorted_segment_sum"] = segment.LAUNCHES
    _check(launches["sorted_segment_sum"] > 0,
           "Cookbook2 launched no segment-sum kernel")
    # one more step under torch.profiler: its device activities and the
    # device time they add up to, against the step's wall time above
    step_acts = device_activities(lambda: m32.step(r32["s"]))
    busy_ms = sum(us for _, us in step_acts) / 1e3
    # the segment sums' part of that step: launches and device time
    seg_acts = [us for name, us in step_acts
                if "sorted_segment_sum_kernel" in name]
    _check(len(seg_acts) > 0, "the profiled step ran no segment-sum kernel")
    _say("9-cookbook2-f32", warmup_steps=1, timed_steps=5, runs=2,
         deterministic=True,
         s_per_step=f"{r32['wall_s']:.4f},{r32b['wall_s']:.4f}",
         pr4_s_per_step="0.0961-0.2090", inner_cg_per_step=r32["inner"],
         host_syncs_per_step=r32["host_syncs"],
         device_kernels_per_step=len(step_acts),
         device_busy_ms_per_step=f"{busy_ms:.2f}",
         device_idle_share=f"{max(0.0, 1 - busy_ms / 1e3 / r32['wall_s']):.3f}",
         uzawa_cg_per_step=",".join(r32["counts"]),
         max_rel_err=json.dumps({k: f"{v:.3g}" for k, v in
                                 r32["err"].items()}).replace(" ", ""),
         per_step_max_rel_err=",".join(r32["per_step_err"]),
         spmv_kernel_launches_f64_f32=cb_launches,
         segment_sum_launches_f64_f32=launches["sorted_segment_sum"],
         segment_sum_launches_per_step=len(seg_acts),
         segment_sum_device_ms_per_step=f"{sum(seg_acts) / 1e3:.4f}",
         segment_sum_share_of_busy=f"{sum(seg_acts) / 1e3 / busy_ms:.4f}")
    # phase 9's CG numbers, printed beside multigrid's in phase 14
    from g4s_tpu_torch.models.citcoms.observables import rms_velocity
    cg9 = {"vrms0": float(rms_velocity(m64, r64["s0"].V)),
           "s_per_step": f"{r32['wall_s']:.4f}", "inner": r32["inner"],
           "host_syncs": r32["host_syncs"], "kernels": len(step_acts),
           "busy_ms": f"{busy_ms:.2f}",
           "idle": f"{max(0.0, 1 - busy_ms / 1e3 / r32['wall_s']):.3f}"}
    for name, m in (("f32", m32), ("f64", m64)):
        s_ = r32["s"] if name == "f32" else r64["s"]
        ops = m._build_ops(s_.T, V=s_.V)
        st = nodal.build_stencil(ops.elt_k, m.stencil_plan)
        u = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (m.mesh.nno, 3))).to(dev, m.dtype)
        stencil = lambda: nodal.nodal_matvec(st, u, m.vbc_mask)
        eltk = lambda: assembly.assemble_del2_u(ops, u)
        # the two forms sum the same products in other orders
        tol = REL_TOL if name == "f32" else 1e-12
        rel = _rel_err(stencil().cpu(), eltk().cpu())
        _check(rel <= tol, f"stencil and element-by-element K u differ "
                           f"({name}): rel {rel}")
        size = u.element_size()
        # W, u and the mask read, K u written; one FMA per stencil entry.
        # The (nno, 27) int64 neighbour index the port reads is left out: a
        # 27-point stencil on a regular grid needs none
        b_ms, b_by = _bound(st.W.numel() * size + 2 * u.numel() * size
                            + m.vbc_mask.numel(), 2.0 * st.W.numel())
        _say("9-stencil-matvec", dtype=name, nno=m.mesh.nno,
             device_ms=f"{ms_of(stencil):.4f}", bound_ms=f"{b_ms:.4f}",
             bound_by=b_by, rel_err_vs_eltk=f"{rel:.3g}",
             index_mb=f"{st.nbr.numel() * 8 / 1e6:.2f}",
             device_kernels_per_call=len(device_kernels(
                 lambda: [stencil() for _ in range(10)])) / 10,
             eltk_device_ms=f"{ms_of(eltk):.4f}",
             cusparse_k_f32_ms=f"{fem_cusparse_ms:.4f}")
    # the segment-sum kernel at every shape the Cookbook2 step gives it, in
    # f64 and f32, through the model's int32 plans: the stencil build (the
    # (nel*64, 9) element blocks into nno*27 stencil slots), an assembly
    # scatter (assemble_grad_p: (nel*8, 3) into nno nodes) and the buoyancy
    # layer sums (nno values into nodez layers, runs of nno/nodez). Each is
    # bitwise repeatable and equal to the host CPU's in-order sum, and timed
    # beside its bytes bound, its plain version (gather + index_add_, whose
    # atomics on the card add in another order: within 1e-12 of the
    # largest sum in f64, 1e-5 in f32) and one index_add_ of the unsorted
    # blocks (its zero fill included), the same function. The kernels
    # line keeps the f64 stencil build
    rng9 = np.random.default_rng(9)
    for name, m, s_ in (("f64", m64, r64["s"]), ("f32", m32, r32["s"])):
        ops = m._build_ops(s_.T, V=s_.V)
        p_el = torch.from_numpy(rng9.standard_normal(m.mesh.nel)).to(
            dev, m.dtype)
        cases = {
            "stencil_build": (
                ops.elt_k.reshape(-1, 8, 3, 8, 3).permute(0, 1, 3, 2, 4)
                .reshape(-1, 9).contiguous(), m.stencil_plan.seg_ids,
                m.stencil_plan.order, m.mesh.nno * 27),
            "assembly_scatter": (
                (ops.G * p_el[:, None, None]).reshape(-1, 3).contiguous(),
                m.plan.seg_ids, m.plan.order, m.plan.nno),
            "layer_sum": (cookbook2.rayleigh * s_.T * m._layer_weights,
                          m._layer_sorted, m._layer_order, cookbook2.nodez)}
        for shape, (flat, ids, order, n_seg) in cases.items():
            r = _segment_sum_case("9-segment-sum", shape, name, flat, ids,
                                  order, n_seg, ms_of)
            if (shape, name) == ("stencil_build", "f64"):
                err["sorted_segment_sum"] = r["err"]
                ms["sorted_segment_sum"] = r["ms"]
                plain_ms["sorted_segment_sum"] = r["plain_ms"]
                library_ms["sorted_segment_sum"] = r["library_ms"]
                bound["sorted_segment_sum"] = r["bound"]
    del m32, m64, ops, flat, cases

    laps.append((10, time.perf_counter()))
    # ---- 10: DeePMD se_e2_a water at the flagship width -----------------
    _deepmd_water(dev)

    laps.append((11, time.perf_counter()))
    # ---- 11: the per-matrix static kernels at the stencil of phase 3 -----
    _static_kernels(dev, ws3, x_pad3, A_p, err, ms, plain_ms, library_ms,
                    bound, launches, ms_of, flush_l2, static_builds)
    del ws3, x_pad3, A_p

    laps.append((12, time.perf_counter()))
    # ---- 12: DeePMD training at the flagship width ----------------------
    _deepmd_train(dev)

    laps.append((13, time.perf_counter()))
    # ---- 13: Cantera's NonIdealShockTube at the dodecane size, then phases
    # 18 and 19, with phase 17's multi-rank run beside them in processes of its
    # own; the script waits for that run to end before phase 14, so that
    # phases 14-16 have the card to themselves ----------------------------
    mc_run = _multichip_start()
    steam_host = batch = None
    tail_dir = tempfile.TemporaryDirectory()
    ntc_mech = os.path.join(tail_dir.name, "ndodecane_synthetic.yaml")
    _synthetic_mechanism_yaml(ntc_mech, seed=CANTERA_SEED, **CANTERA_COUNTS)
    try:
        steam_host = _steam_host_start()
        # ---- 20, first part: the batched NTC sweep, in a process of its
        # own beside phases 13, 18 and 19 ----
        batch = _ntc_batch_start(ntc_mech)
        ig_reactor, ig_final, p13 = _cantera_shock_tube(dev)
        laps.append((18, time.perf_counter()))
        # ---- 18: Cantera's 1-D flames, equilibrium, transport and
        # surfaces, in the time phase 13 leaves before phase 17 ends ----
        _cantera_flames(dev, ig_reactor, ig_final)
        del ig_reactor, ig_final
        laps.append((19, time.perf_counter()))
        # ---- 19: Cantera's phase models, in what is left of that time --
        _phase_models(dev, steam_host)
        laps.append(("17_after_19", time.perf_counter()))
        mc_res = _multichip_wait(mc_run)
    except BaseException:
        _pool_stop(batch)
        raise
    finally:
        _multichip_stop(mc_run)
        if steam_host is not None:
            _steam_host_stop(steam_host)
    # ---- 20, second part: the host-CPU references, beside phases 14-16 --
    tail_host = None
    try:
        tail_host = _tail_host_start(ntc_mech, {p13["T"]: p13})
        laps.append((14, time.perf_counter()))
        # ---- 14: the rest of regional CitcomS at Cookbook2's size --------
        tail = _citcoms_tail(dev, cookbook2, cg9, ms_of)
        # phase 14's segment sums are an entry of their own, read at the
        # finest restriction: multigrid's restrictions make most of its
        # launches, and this is the larger of their two shapes
        launches["sorted_segment_sum_citcoms_tail"] = tail["launches"]
        err["sorted_segment_sum_citcoms_tail"] = tail["segment_sum"]["err"]
        for d, k in ((ms, "ms"), (plain_ms, "plain_ms"),
                     (library_ms, "library_ms"), (bound, "bound")):
            d["sorted_segment_sum_citcoms_tail"] = tail["segment_sum"][k]

        laps.append((15, time.perf_counter()))
        # ---- 15: the CitcomS full sphere, its tracers and the coupled
        # step ----
        full = _citcoms_full(dev, cookbook2, ms_of)
        # phase 15's segment sums are an entry of their own, read at the
        # assembly scatter, the shape of most of its launches
        launches["sorted_segment_sum_citcoms_full"] = full["launches"]
        err["sorted_segment_sum_citcoms_full"] = full["segment_sum"]["err"]
        for d, k in ((ms, "ms"), (plain_ms, "plain_ms"),
                     (library_ms, "library_ms"), (bound, "bound")):
            d["sorted_segment_sum_citcoms_full"] = full["segment_sum"][k]

        laps.append((16, time.perf_counter()))
        # ---- 16: the rest of DeePMD at the water model's width ----------
        _deepmd_tail(dev)

        laps.append((17, time.perf_counter()))
        # ---- 17: the multi-rank dry run's segment-sum kernel ------------
        mc = _multichip(dev, ms_of, mc_res)
        # phase 17's segment sums are an entry of their own: the launches of
        # the multichip driver's four stages, read at the regional block's
        # scatter
        launches["sorted_segment_sum_multichip"] = mc["launches"]
        err["sorted_segment_sum_multichip"] = mc["segment_sum"]["err"]
        for d, k in ((ms, "ms"), (plain_ms, "plain_ms"),
                     (library_ms, "library_ms"), (bound, "bound")):
            d["sorted_segment_sum_multichip"] = mc["segment_sum"][k]

        laps.append((20, time.perf_counter()))
        # ---- 20: the integrator tail: the batched sweep's results, the
        # banded BDF, the DAE and sensitivities, and the C API ----------
        _integrator_tail(dev, batch, tail_host, p13, mc_res)
    finally:
        _pool_stop(batch)
        _pool_stop(tail_host)
        tail_dir.cleanup()

    laps.append((None, time.perf_counter()))
    _say("phase-seconds", **{f"p{k}": f"{t1 - t0:.1f}" for (k, t0), (_, t1)
                             in zip(laps, laps[1:])},
         total=f"{laps[-1][1] - laps[0][1]:.1f}")
    sources = {"permute_gather": "g4s_tpu_torch/csrc/permute.cu",
               "wsell_spmv": "g4s_tpu_torch/csrc/wsell_spmv.cu",
               "bwell_spmv": "g4s_tpu_torch/csrc/bwell_spmv.cu",
               "sorted_segment_sum": "g4s_tpu_torch/csrc/segment_sum.cu",
               "sorted_segment_sum_citcoms_tail":
                   "g4s_tpu_torch/csrc/segment_sum.cu",
               "sorted_segment_sum_citcoms_full":
                   "g4s_tpu_torch/csrc/segment_sum.cu",
               "sorted_segment_sum_multichip":
                   "g4s_tpu_torch/csrc/segment_sum.cu",
               # CUDA generated per matrix by this module
               "static_spmv_chain": "g4s_tpu_torch/ops/static_spmv.py",
               "static_spmv_one": "g4s_tpu_torch/ops/static_spmv.py"}
    replaces = {
        "permute_gather": "g4s_tpu/ops/route.py:417 (_lane_benes_kernel) "
                          "+ g4s_tpu/ops/route.py:438 (_mid_kernel)",
        "wsell_spmv": "g4s_tpu/ops/pallas_spmv.py:491 (_wsell_kernel)",
        "bwell_spmv": "g4s_tpu/ops/pallas_spmv.py:178 (_kernel)",
        "sorted_segment_sum": "g4s_tpu/ops/segment.py:23 (jax.ops."
                              "segment_sum(indices_are_sorted=True); XLA, "
                              "no Pallas kernel)",
        "sorted_segment_sum_citcoms_tail":
            "g4s_tpu/models/citcoms/multigrid.py:106 (project_down: "
            "jax.ops.segment_sum; XLA, no Pallas kernel)",
        "sorted_segment_sum_citcoms_full":
            "g4s_tpu/models/citcoms/assembly.py:52 (ScatterPlan.scatter "
            "on the full sphere: jax.ops.segment_sum; XLA, no Pallas "
            "kernel)",
        "sorted_segment_sum_multichip":
            "g4s_tpu/models/citcoms/distributed.py:225 (the block's "
            "ScatterPlan.scatter inside shard_map: jax.ops.segment_sum; "
            "XLA, no Pallas kernel)",
        "static_spmv_chain": "benchmarks/static_spmv_probe.py:42 "
                             "(_static_kernel)",
        "static_spmv_one": "benchmarks/static_spmv_probe2.py:42 "
                           "(build_static_one_kernel)"}
    ms["bwell_spmv"] = bw["pack"]["ms"]
    plain_ms["bwell_spmv"] = bw["pack"]["plain_ms"]
    library_ms["bwell_spmv"] = bw["pack"]["library_ms"]
    bound["bwell_spmv"] = bw["pack"]["bound"]
    kernels = [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": err[k], "ms": ms[k], "plain_ms": plain_ms[k],
         "bound_ms": bound[k][0], "bound_by": bound[k][1],
         "library_ms": library_ms[k]}
        for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

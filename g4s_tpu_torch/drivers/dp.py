"""`dp`-style CLI: train / freeze / compress / test / neighbor-stat /
model-devi / md (counterpart of g4s_tpu/drivers/dp.py).

Mirrors the reference's entry point surface (deepmd/deepmd/entrypoints/
main.py: subcommands train, freeze, compress, test, neighbor-stat,
model-devi) plus an `md` subcommand that replaces the LAMMPS driver step
of the benchmark (examples/water/lmp/in.lammps). `train` writes
`<checkpoint>` and `<checkpoint>.model.npz` in the reference's formats, so
either package's `freeze` takes either package's training output.
Commands that compute take `--device` (default cuda; cpu runs on the
host).

Usage:
  python -m g4s_tpu_torch.drivers.dp train input.json [--steps N]
      [--restart ckpt | --init-model frozen | --finetune frozen]
      [--checkpoint model.ckpt.npz] [--dtype f32|f64]
  python -m g4s_tpu_torch.drivers.dp freeze -c checkpoint.npz -o frozen.npz
  python -m g4s_tpu_torch.drivers.dp compress -i frozen.npz -o compressed.pkl
  python -m g4s_tpu_torch.drivers.dp test -m frozen.npz -s system_dir
  python -m g4s_tpu_torch.drivers.dp neighbor-stat -s system_dir -r 6.0
  python -m g4s_tpu_torch.drivers.dp model-devi -m a.npz b.npz -s system_dir
  python -m g4s_tpu_torch.drivers.dp md -m frozen.npz --data water.lmp
"""

from __future__ import annotations

import argparse
import json
import os


def _load_input(path):
    with open(path) as f:
        return json.load(f)


def _numb_steps(jdata) -> int:
    """numb_steps with the pre-v2 `stop_batch` alias (utils/compat.py
    input upgrading role)."""
    tr = jdata["training"]
    return tr.get("numb_steps") or tr["stop_batch"]


def _lr_config(jdata):
    """The LR schedule of the input file. Its decay horizon is the file's
    numb_steps, NOT a --steps override: a short run sees the lr trajectory
    the full run would (utils/learning_rate.py decays to stop_step)."""
    from g4s_tpu_torch.models.deepmd.train import LRConfig
    lr_j = jdata.get("learning_rate", {})
    return LRConfig(lr_j.get("start_lr", 1e-3), lr_j.get("stop_lr", 3.51e-8),
                    lr_j.get("decay_steps", 5000), _numb_steps(jdata))


def _stats(spec, frames_R, types_np, dtype, device):
    """davg, dstd (compute_input_stats) of env mats (F, N, nnei, 4) as
    tensors of the parameters' dtype."""
    import torch
    from g4s_tpu_torch.models.deepmd.descriptor import compute_stats
    davg, dstd = compute_stats(list(frames_R), [types_np] * len(frames_R),
                               spec.descriptor.ntypes, spec.descriptor.nnei)
    return (torch.as_tensor(davg, dtype=dtype, device=device),
            torch.as_tensor(dstd, dtype=dtype, device=device))


def _init(spec, seed, dtype, device, **kw):
    """init_params from a seeded host generator, moved to device (the same
    weights on every device)."""
    import torch
    from g4s_tpu_torch.models.deepmd.model import init_params, params_to
    params = init_params(torch.Generator().manual_seed(seed), spec,
                         dtype=dtype, **kw)
    return params_to(params, device=device)


def cmd_train(args):
    import numpy as np
    import torch
    from g4s_tpu_torch import ckpt
    from g4s_tpu_torch.models.deepmd.data import DataSystem
    from g4s_tpu_torch.models.deepmd.descriptor import (DescriptorSpec,
                                                        env_mat)
    from g4s_tpu_torch.models.deepmd.model import ModelSpec
    from g4s_tpu_torch.models.deepmd.train import LossConfig, Trainer
    from g4s_tpu_torch.sparse.containers import resolve_device

    device = resolve_device(args.device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    jdata = _load_input(args.input)
    desc = jdata["model"]["descriptor"]
    fit = jdata["model"]["fitting_net"]
    sel = tuple(desc["sel"])
    ntypes = len(jdata["model"]["type_map"])
    if jdata["model"].get("spin"):
        # atomic-spin model (utils/spin.py): one virtual type per
        # spin-carrying real type; virtual types reuse the spin types'
        # sel (se_a.py sel_a_spin)
        from g4s_tpu_torch.models.deepmd.spin import (SpinSpec,
                                                      expand_ntypes,
                                                      expand_sel)
        sj = jdata["model"]["spin"]
        sp = SpinSpec(tuple(sj["use_spin"]), tuple(sj["virtual_len"]),
                      tuple(sj["spin_norm"]))
        sel = expand_sel(sel, sp)
        ntypes = expand_ntypes(ntypes, sp)
        print(f"# spin model: {sp.ntypes_spin} virtual type(s), "
              f"sel -> {list(sel)}")
    spec = ModelSpec(
        DescriptorSpec(desc["rcut"], desc["rcut_smth"], sel, ntypes),
        tuple(desc["neuron"]), desc.get("axis_neuron", 16),
        tuple(fit["neuron"]), desc.get("resnet_dt", False),
        fit.get("resnet_dt", True),
        numb_fparam=fit.get("numb_fparam", 0),
        numb_aparam=fit.get("numb_aparam", 0))
    tr_d = jdata["training"]["training_data"]
    base = os.path.dirname(os.path.abspath(args.input))
    systems = [os.path.join(base, s) for s in tr_d["systems"]]
    if fit.get("type") in ("dipole", "polar"):
        # tensor-supervised training (loss/tensor.py + DipoleFittingSeA:
        # the water_tensor examples' `dp train dipole_input.json` path)
        return _train_tensor_cli(args, jdata, spec, systems, dtype, device)
    if fit.get("type") == "dos":
        # density-of-states fitting (fit/dos.py + loss/dos.py: the
        # examples/dos heat-221 path)
        return _train_dos_cli(args, jdata, spec, systems, dtype, device)
    seed = jdata["training"].get("seed", 10)
    data = DataSystem(systems, batch_size=tr_d.get("batch_size", "auto"),
                      seed=seed)
    numb_steps = args.steps or _numb_steps(jdata)
    lr = _lr_config(jdata)
    lo = jdata.get("loss", {})
    loss = LossConfig(lo.get("start_pref_e", 0.02), lo.get("limit_pref_e", 1),
                      lo.get("start_pref_f", 1000), lo.get("limit_pref_f", 1),
                      lo.get("start_pref_v", 0), lo.get("limit_pref_v", 0))

    # stats + bias from data
    ntypes = spec.descriptor.ntypes
    sys0 = data.systems[0]
    n_stat = min(10, sys0.nframes)
    R, _ = env_mat(torch.as_tensor(sys0.coord[:n_stat], device=device),
                   torch.as_tensor(sys0.box[:n_stat], device=device),
                   torch.as_tensor(sys0.types, device=device),
                   spec.descriptor)
    params = _init(spec, seed, dtype, device,
                   bias_atom_e=data.energy_bias(ntypes))
    if spec.numb_fparam:
        favg, fstd = data.fparam_stats()
        params["stats"]["fparam_avg"] = torch.as_tensor(favg, dtype=dtype,
                                                        device=device)
        params["stats"]["fparam_std"] = torch.as_tensor(fstd, dtype=dtype,
                                                        device=device)
    params["stats"]["davg"], params["stats"]["dstd"] = _stats(
        spec, R.cpu().numpy(), sys0.types, dtype, device)
    if args.restart:
        # `dp train --restart` (entrypoints/main.py restart): resume the
        # parameters (stats and bias included) from a saved checkpoint;
        # the optimizer and the step count start afresh, as the
        # reference's do
        tree, meta = ckpt.load_deepmd(args.restart, params)
        params = tree["params"]
        print(f"# restarted from {args.restart} (step {meta.get('step')})")
    elif args.init_model or args.finetune:
        # init-from-frozen / finetune (trainer.py:1326-1416): start from a
        # frozen model's parameters; --finetune also re-anchors the
        # per-type energy bias on the NEW data by least-squares of the
        # pretrained model's residual (change_energy_bias)
        from g4s_tpu_torch.models.deepmd.freeze import load_frozen
        from g4s_tpu_torch.models.deepmd.model import params_to
        src = args.init_model or args.finetune
        params, spec_loaded = load_frozen(src, device=device)
        if spec_loaded.descriptor != spec.descriptor:
            raise SystemExit("pretrained model descriptor != input.json")
        spec = spec_loaded
        params = params_to(params, dtype=dtype)
        if args.finetune:
            from g4s_tpu_torch.models.deepmd.train import change_energy_bias
            params, delta = change_energy_bias(params, spec, data, ntypes)
            print(f"# finetune: energy bias shifted by {delta}")
        else:
            print(f"# initialized from frozen model {src}")

    trainer = Trainer(spec, loss, lr)
    disp = jdata["training"].get("disp_freq", 100)
    lcurve = jdata["training"].get("disp_file", "lcurve.out")
    print(f"# training {numb_steps} steps, batch {data.batch_size}, "
          f"lcurve -> {lcurve}")
    params = trainer.train(params, data, numb_steps, disp_freq=disp,
                           lcurve_path=lcurve,
                           callback=lambda s, a: print(
                               f"step {s}: rmse_e/atom="
                               f"{float(a['rmse_e']):.4e} "
                               f"rmse_f={float(a['rmse_f']):.4e} "
                               f"lr={float(a['lr']):.2e}"))
    ckpt.save_deepmd(args.checkpoint, params, step=numb_steps)
    # the frozen model beside the checkpoint, for `dp freeze`
    from g4s_tpu_torch.models.deepmd.freeze import freeze as freeze_fn
    freeze_fn(params, spec, args.checkpoint + ".model.npz")
    print(f"# saved checkpoint to {args.checkpoint}")
    return {"params": params, "spec": spec}


def _train_tensor_cli(args, jdata, spec, systems, dtype, device):
    """dp train with fitting_net.type dipole|polar: tensor-label training
    over water_tensor-style systems (atomic and/or global labels, mixed
    systems round-robin like DeepmdDataSystem sampling), one Adam state
    over the model and the tensor nets."""
    import numpy as np
    import torch
    from g4s_tpu_torch import ckpt
    from g4s_tpu_torch.models.deepmd import fit_tensor as ft
    from g4s_tpu_torch.models.deepmd.descriptor import env_mat, env_mat_nopbc
    from g4s_tpu_torch.models.deepmd.model import params_to
    from g4s_tpu_torch.models.deepmd.train import (Adam, batch_to,
                                                   value_and_grad)

    fit = jdata["model"]["fitting_net"]
    kind = fit["type"]
    label = "dipole" if kind == "dipole" else "polarizability"
    tensor_fn = ft.atomic_dipole if kind == "dipole" else ft.atomic_polar
    sel_type = tuple(fit["sel_type"]) if fit.get("sel_type") is not None \
        else None
    loaded = [ft.load_tensor_system(s, label, sel_type) for s in systems]
    types0 = loaded[0]["types"]
    for sy in loaded[1:]:
        if not np.array_equal(sy["types"], types0):
            raise SystemExit("tensor systems must share composition")
    types = torch.as_tensor(types0, device=device)
    nopbc = loaded[0]["nopbc"]

    numb_steps = args.steps or _numb_steps(jdata)
    lr = _lr_config(jdata)
    lo = jdata.get("loss", {})
    loss_cfg = ft.TensorLossConfig(lo.get("pref", 1.0),
                                   lo.get("pref_atomic", 1.0),
                                   lo.get("scale", 1.0), sel_type)

    # normalization stats from a few frames of the first system
    fr0 = loaded[0]["frames"]
    n_stat = min(10, fr0["coord"].shape[0])
    c = torch.as_tensor(fr0["coord"][:n_stat], device=device)
    if nopbc:
        R, _ = env_mat_nopbc(c, types, spec.descriptor)
    else:
        R, _ = env_mat(c, torch.as_tensor(fr0["box"][:n_stat], device=device),
                       types, spec.descriptor)
    seed = jdata["training"].get("seed", 10)
    params = _init(spec, seed, dtype, device)
    params["stats"]["davg"], params["stats"]["dstd"] = _stats(
        spec, R.cpu().numpy(), types0, dtype, device)
    nets = params_to(ft.init_tensor_fit(
        torch.Generator().manual_seed(seed + 1), spec, dtype=dtype),
        device=device)

    opt = Adam(lr.lr_at_count)
    tparams = (params, nets)
    opt_state = opt.init(tparams)
    loss_fn = ft.make_tensor_loss_fn(spec, loss_cfg, tensor_fn, nopbc=nopbc)
    rng = np.random.default_rng(seed)
    bs = jdata["training"]["training_data"].get("batch_size", 8)
    if not isinstance(bs, int):
        bs = 8
    disp = jdata["training"].get("disp_freq", 100)
    print(f"# tensor training ({kind}): {numb_steps} steps over "
          f"{len(loaded)} systems, nopbc={nopbc}")
    loss_by_key = {}
    aux = {}
    for step in range(numb_steps):
        frames = loaded[step % len(loaded)]["frames"]
        nf = frames["coord"].shape[0]
        idx = rng.integers(0, nf, min(bs, nf))
        batch = batch_to({k: v[idx] for k, v in frames.items()},
                         params["stats"]["davg"])
        loss, aux, grads = value_and_grad(loss_fn, tparams, batch, types)
        tparams, opt_state = opt.update(grads, opt_state, tparams)
        key = tuple(sorted(batch.keys()))
        loss_by_key.setdefault(key, []).append(float(loss))
        if step % disp == 0 or step == numb_steps - 1:
            bits = " ".join(f"{k}={float(v):.4e}" for k, v in aux.items())
            print(f"step {step}: loss={float(loss):.4e} {bits}")
    params, nets = tparams
    ckpt.save_pytree(args.checkpoint, {"params": params, "nets": nets},
                     meta={"kind": f"deepmd_{kind}", "step": numb_steps})
    print(f"# saved tensor checkpoint to {args.checkpoint}")
    return {"final_aux": {k: float(v) for k, v in aux.items()},
            "loss_curves": loss_by_key}


def _train_dos_cli(args, jdata, spec, systems, dtype, device):
    """dp train with fitting_net.type dos (DOSFitting + DOSLoss)."""
    import numpy as np
    import torch
    from g4s_tpu_torch import ckpt
    from g4s_tpu_torch.models.deepmd import fit_dos as fd
    from g4s_tpu_torch.models.deepmd.descriptor import env_mat
    from g4s_tpu_torch.models.deepmd.model import params_to

    fit = jdata["model"]["fitting_net"]
    numb_dos = fit["numb_dos"]
    loaded = [fd.load_dos_system(s) for s in systems]
    types0 = loaded[0]["types"]
    fr = loaded[0]["frames"]
    if len(loaded) > 1:
        fr = {k: np.concatenate([sy["frames"][k] for sy in loaded])
              for k in fr}

    numb_steps = args.steps or _numb_steps(jdata)
    lr = _lr_config(jdata)
    lo = jdata.get("loss", {})
    loss_cfg = fd.DOSLossConfig(
        lo.get("start_pref_dos", 1.0), lo.get("limit_pref_dos", 1.0),
        lo.get("start_pref_cdf", 0.0), lo.get("limit_pref_cdf", 0.0),
        lo.get("start_pref_ados", 0.0), lo.get("limit_pref_ados", 0.0),
        lo.get("start_pref_acdf", 0.0), lo.get("limit_pref_acdf", 0.0))

    ntypes = spec.descriptor.ntypes
    n_stat = min(10, fr["coord"].shape[0])
    R, _ = env_mat(torch.as_tensor(fr["coord"][:n_stat], device=device),
                   torch.as_tensor(fr["box"][:n_stat], device=device),
                   torch.as_tensor(types0, device=device), spec.descriptor)
    seed = jdata["training"].get("seed", 10)
    params = _init(spec, seed, dtype, device)
    params["stats"]["davg"], params["stats"]["dstd"] = _stats(
        spec, R.cpu().numpy(), types0, dtype, device)
    # output bias from data (compute_output_stats): mean atomic dos per
    # type
    bias = np.zeros((ntypes, numb_dos))
    if "atom_dos" in fr:
        for t in range(ntypes):
            m = types0 == t
            if m.any():
                bias[t] = fr["atom_dos"][:, m, :].mean(axis=(0, 1))
    elif "dos" in fr:
        bias[:] = fr["dos"].mean(axis=0) / types0.size
    nets = params_to(fd.init_dos_fit(
        torch.Generator().manual_seed(seed + 1), spec, numb_dos,
        bias_dos=bias, dtype=dtype), device=device)

    bs = jdata["training"]["training_data"].get("batch_size", 4)
    if not isinstance(bs, int):
        bs = 4
    print(f"# dos training: {numb_steps} steps, numb_dos={numb_dos}")
    hist = []
    (params, nets), aux = fd.train_dos(
        params, nets, spec, fr, types0, numb_steps=numb_steps,
        loss_cfg=loss_cfg, lr_cfg=lr, batch_size=bs, seed=seed,
        callback=lambda s, l, a: (hist.append(l), print(
            f"step {s}: loss={l:.4e} " + " ".join(
                f"{k}={v:.4e}" for k, v in a.items())))[-1])
    ckpt.save_pytree(args.checkpoint, {"params": params, "nets": nets},
                     meta={"kind": "deepmd_dos", "step": numb_steps})
    print(f"# saved dos checkpoint to {args.checkpoint}")
    return {"final_aux": aux, "loss_head": hist[0] if hist else None,
            "loss_tail": hist[-1] if hist else None}


def cmd_freeze(args):
    import shutil
    src = args.checkpoint + ".model.npz" if os.path.exists(
        args.checkpoint + ".model.npz") else args.checkpoint
    shutil.copyfile(src, args.output)
    print(f"# frozen model -> {args.output}")


def cmd_compress(args):
    # tabulation differentiates the embedding nets twice (quintic Hermite
    # needs g''); in f32 those second derivatives are noisy at the 1e-3
    # level, which surfaces as ~1% force errors in the compressed model,
    # so the tables are built in f64
    import numpy as np
    import torch
    from g4s_tpu_torch.models.deepmd.compress import (compress_model,
                                                      save_compressed)
    from g4s_tpu_torch.models.deepmd.freeze import load_frozen
    from g4s_tpu_torch.models.deepmd.model import params_to
    params, spec = load_frozen(args.input, device=args.device)
    params = params_to(params, dtype=torch.float64)
    dev = params["stats"]["davg"].device
    samples = None
    if args.system:
        # data-driven table range (the reference's check_freq sampling
        # role, utils/tabulate.py): tabulate over what the data reaches
        from g4s_tpu_torch.models.deepmd.data import load_system
        from g4s_tpu_torch.models.deepmd.descriptor import (
            env_mat, normalize_env_mat)
        sysd = load_system(args.system)
        types = torch.as_tensor(sysd.types, device=dev)
        ss = []
        for i in range(min(5, sysd.nframes)):
            R, _ = env_mat(torch.as_tensor(sysd.coord[i], device=dev),
                           torch.as_tensor(sysd.box[i], device=dev),
                           types, spec.descriptor)
            Rn = normalize_env_mat(R, types, params["stats"]["davg"],
                                   params["stats"]["dstd"])
            ss.append(Rn[:, :, 0].cpu().numpy().ravel())
        samples = np.concatenate(ss)
    cm = compress_model(params, spec, stride=args.stride,
                        sample_inputs=samples)
    save_compressed(cm, args.output)
    print(f"# compressed model -> {args.output}")


def cmd_test(args):
    import numpy as np
    import torch
    from g4s_tpu_torch.models.deepmd.data import load_system
    from g4s_tpu_torch.models.deepmd.infer import DeepPot
    dp = DeepPot(args.model, device=args.device)
    sysd = load_system(args.system)
    n = min(args.numb_test, sysd.nframes)
    e, f, _ = dp.eval(sysd.coord[:n], sysd.box[:n], sysd.types)
    e = e.to(torch.float64).cpu().numpy()
    f = f.to(torch.float64).cpu().numpy()
    rmse_e = float(np.sqrt(np.mean((e - sysd.energy[:n]) ** 2))) \
        / sysd.natoms
    rmse_f = float(np.sqrt(np.mean((f - sysd.force[:n]) ** 2)))
    print(f"# {n} frames: rmse_e/atom = {rmse_e:.6e}  rmse_f = {rmse_f:.6e}")
    return rmse_e, rmse_f


def cmd_md(args):
    from g4s_tpu_torch.models.deepmd.freeze import load_frozen
    from g4s_tpu_torch.models.deepmd.md import water_md
    params, spec = load_frozen(args.model, device=args.device)
    state, log = water_md(params, spec, n_steps=args.steps,
                          data_file=args.data, verbose=True,
                          device=args.device)
    print(f"# MD done: {args.steps} steps, final T = {log[-1][1]:.1f} K")
    return state, log


def cmd_neighbor_stat(args):
    """`dp neighbor-stat` (deepmd/entrypoints/main.py neighbor_stat
    subcommand): report max neighbors per type within rcut and the
    suggested `sel` for the training input."""
    import numpy as np
    from g4s_tpu_torch.models.deepmd.data import load_system
    from g4s_tpu_torch.models.deepmd.descriptor import neighbor_stat
    sys_ = load_system(args.system)
    ntypes = int(np.asarray(sys_.types).max()) + 1
    nf = min(10, sys_.nframes)
    coords = [np.asarray(sys_.coord[i]).reshape(-1, 3) for i in range(nf)]
    boxes = [np.asarray(sys_.box[i]).reshape(3, 3) for i in range(nf)]
    max_nbor, sel = neighbor_stat(coords, boxes, sys_.types,
                                  args.rcut, ntypes)
    names = args.type_map or [str(i) for i in range(ntypes)]
    for t, (m, s_) in enumerate(zip(max_nbor, sel)):
        print(f"type {names[t]}: max_nbor {int(m)}  suggested sel {int(s_)}")
    print("sel =", list(int(x) for x in sel))
    return max_nbor, sel


def cmd_model_devi(args):
    """`dp model-devi` (deepmd/infer/model_devi.py make_model_devi):
    force deviation across an ensemble of frozen models."""
    import numpy as np
    from g4s_tpu_torch.models.deepmd.data import load_system
    from g4s_tpu_torch.models.deepmd.infer import DeepPot, calc_model_devi
    sys_ = load_system(args.system)
    pots = [DeepPot(m, device=args.device) for m in args.models]
    rows = []
    for i in range(min(sys_.nframes, 50)):
        mx, mn, av = calc_model_devi(pots, sys_.coord[i], sys_.box[i],
                                     sys_.types)
        rows.append([i, float(mx[0]), float(mn[0]), float(av[0])])
    arr = np.asarray(rows)
    np.savetxt(args.output, arr,
               header="frame max_devi_f min_devi_f avg_devi_f")
    print(f"wrote {args.output}: mean max_devi_f "
          f"{arr[:, 1].mean():.3e}")
    return arr


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dp")
    sub = ap.add_subparsers(dest="cmd", required=True)
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda",
                           help="cuda (default) or cpu")

    p = sub.add_parser("train", parents=[on_device])
    p.add_argument("input")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--restart", default=None,
                   help="checkpoint to resume parameters from")
    p.add_argument("--init-model", default=None, dest="init_model",
                   help="frozen model to initialize parameters from")
    p.add_argument("--finetune", default=None,
                   help="frozen model to finetune (re-anchors energy "
                        "bias on the new data)")
    p.add_argument("--checkpoint", default="model.ckpt.npz")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("freeze")
    p.add_argument("-c", "--checkpoint", default="model.ckpt.npz")
    p.add_argument("-o", "--output", default="frozen_model.npz")
    p.set_defaults(fn=cmd_freeze)

    p = sub.add_parser("compress", parents=[on_device])
    p.add_argument("-i", "--input", default="frozen_model.npz")
    p.add_argument("-o", "--output", default="compressed_model.pkl")
    p.add_argument("--stride", type=float, default=0.01)
    p.add_argument("-s", "--system", default=None,
                   help="data system for data-driven table ranges")
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("test", parents=[on_device])
    p.add_argument("-m", "--model", default="frozen_model.npz")
    p.add_argument("-s", "--system", required=True)
    p.add_argument("-n", "--numb-test", type=int, default=10)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("neighbor-stat")
    p.add_argument("-s", "--system", required=True)
    p.add_argument("-r", "--rcut", type=float, required=True)
    p.add_argument("-t", "--type-map", nargs="+", default=None)
    p.set_defaults(fn=cmd_neighbor_stat)

    p = sub.add_parser("model-devi", parents=[on_device])
    p.add_argument("-m", "--models", nargs="+", required=True)
    p.add_argument("-s", "--system", required=True)
    p.add_argument("-o", "--output", default="model_devi.out")
    p.set_defaults(fn=cmd_model_devi)

    p = sub.add_parser("md", parents=[on_device])
    p.add_argument("-m", "--model", default="frozen_model.npz")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--data", required=True,
                   help="LAMMPS data file (water.lmp)")
    p.set_defaults(fn=cmd_md)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

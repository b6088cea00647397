"""`dp`-style CLI: freeze / compress / test / neighbor-stat / model-devi / md
(counterpart of g4s_tpu/drivers/dp.py).

Mirrors the reference's entry point surface (deepmd/deepmd/entrypoints/
main.py: subcommands freeze, compress, test, neighbor-stat, model-devi)
plus an `md` subcommand that replaces the LAMMPS driver step of the
benchmark (examples/water/lmp/in.lammps). `train` is not ported yet
(ROADMAP.md queue 1, item 8), so `freeze` takes a checkpoint written by
the reference's `dp train` (its `<checkpoint>.model.npz`) or a frozen
model. Commands that compute take `--device` (default cuda; cpu runs on
the host).

Usage:
  python -m g4s_tpu_torch.drivers.dp freeze -c checkpoint.npz -o frozen.npz
  python -m g4s_tpu_torch.drivers.dp compress -i frozen.npz -o compressed.pkl
  python -m g4s_tpu_torch.drivers.dp test -m frozen.npz -s system_dir
  python -m g4s_tpu_torch.drivers.dp neighbor-stat -s system_dir -r 6.0
  python -m g4s_tpu_torch.drivers.dp model-devi -m a.npz b.npz -s system_dir
  python -m g4s_tpu_torch.drivers.dp md -m frozen.npz --data water.lmp
"""

from __future__ import annotations

import argparse
import os


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
    ap = argparse.ArgumentParser(
        prog="dp", epilog="`train` is not ported to g4s_tpu_torch yet "
                          "(ROADMAP.md queue 1, item 8): train with "
                          "g4s_tpu.drivers.dp and freeze its checkpoint.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda",
                           help="cuda (default) or cpu")

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

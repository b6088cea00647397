"""Python side of the C embedding API (runtime/native/capi.c), the
counterpart of g4s_tpu/runtime/capi_impl.py.

Stateless per call: handles index a module-level registry, and arrays
cross the C boundary as raw bytes (f64/i32 little-endian), so the C side
needs no numpy headers. The models run on the device named by the
environment variable G4S_TORCH_DEVICE, which the embedding host sets (the
role JAX_PLATFORMS plays for the JAX package's library): "cuda" when
unset, which raises without a card, or "cpu".

`build_capi` compiles capi.c into libg4s_torch_capi.so with the running
interpreter's embedding flags (`embed_flags`: python3-config --embed where
it exists, else sysconfig).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

DEVICE_ENV = "G4S_TORCH_DEVICE"
NATIVE = Path(__file__).resolve().parent / "native"

_POTS: list = []


def device():
    """The device the embedding host asked for (G4S_TORCH_DEVICE)."""
    from g4s_tpu_torch.sparse.containers import resolve_device
    return resolve_device(os.environ.get(DEVICE_ENV, "cuda"))


def deeppot_load(path: str) -> int:
    from g4s_tpu_torch.models.deepmd.infer import DeepPot
    _POTS.append(DeepPot(path, device=device()))
    return len(_POTS) - 1


def deeppot_eval(handle: int, natoms: int, coord_b: bytes, box_b: bytes,
                 types_b: bytes):
    pot = _POTS[handle]
    coord = np.frombuffer(coord_b, np.float64).reshape(natoms, 3).copy()
    box = np.frombuffer(box_b, np.float64).reshape(3, 3).copy()
    types = np.frombuffer(types_b, np.int32).copy()
    e, f, v = pot.eval(coord, box, types)
    return (float(e.cpu()),
            np.asarray(f.cpu(), np.float64).tobytes(),
            np.asarray(v.cpu(), np.float64).reshape(-1)[:9].tobytes())


def ignition_delay(mech_yaml: str, phase: str, T0: float, P0: float) -> float:
    """The shock tube's ignition delay (ShockTubeBenchmark's protocol: time
    of peak OH) at (T0, P0): stoichiometric n-dodecane/air where the
    mechanism has c12h26, else stoichiometric H2/O2 (N2 3.76 per O2 where
    there is N2 and no AR); a Redlich-Kwong reactor when the phase's name
    holds "rk"."""
    from g4s_tpu_torch.models.cantera.mech import load_mechanism
    from g4s_tpu_torch.models.cantera.reactor import \
        IdealGasConstVolumeReactor
    from g4s_tpu_torch.models.cantera.shock_tube import (
        ignition_delay as _idt, stoich_mixture)
    mech = load_mechanism(mech_yaml, phase or None)
    r = IdealGasConstVolumeReactor(
        mech, real_gas="rk" in (phase or "").lower(), device=device())
    if "c12h26" in mech.species_names:
        X = stoich_mixture(mech, "c12h26")
    else:
        X = np.zeros(mech.nspec)
        names = {n.upper(): i for i, n in enumerate(mech.species_names)}
        X[names["H2"]] = 2.0
        X[names["O2"]] = 1.0
        if "N2" in names:
            X[names["N2"]] = 3.76 if "AR" not in names else 0.0
        X = X / X.sum()
    tau, _ = _idt(r, T0, P0, X)
    return float(tau)


def embed_flags() -> tuple[list, list]:
    """(compile flags, link flags) that embed this interpreter: from
    python3-config --embed where it exists, else from sysconfig. The link
    flags carry an rpath to libpython's directory."""
    cfg = shutil.which("python3-config")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    if cfg is not None:
        inc = subprocess.run([cfg, "--includes"], capture_output=True,
                             text=True, check=True).stdout.split()
        ld = subprocess.run([cfg, "--ldflags", "--embed"],
                            capture_output=True, text=True,
                            check=True).stdout.split()
    else:
        inc = [f"-I{sysconfig.get_paths()['include']}"]
        ver = sysconfig.get_config_var("LDVERSION") \
            or sysconfig.get_python_version()
        ld = [f"-L{libdir}", f"-lpython{ver}"] + (
            sysconfig.get_config_var("LIBS") or "").split() + (
            sysconfig.get_config_var("SYSLIBS") or "").split()
    return inc, ld + ([f"-Wl,-rpath,{libdir}"] if libdir else [])


def libpython_path() -> Path | None:
    """The shared or static libpython this interpreter embeds through, or
    None when there is none to link."""
    for var, d in (("LDLIBRARY", "LIBDIR"), ("LIBRARY", "LIBPL"),
                   ("LIBRARY", "LIBDIR")):
        name, where = sysconfig.get_config_var(var), \
            sysconfig.get_config_var(d)
        if name and where and (Path(where) / name).is_file():
            return Path(where) / name
    return None


def build_capi(out_dir, *, cc: str | None = None) -> Path:
    """Compile runtime/native/capi.c into out_dir/libg4s_torch_capi.so;
    raises when the compiler is missing or fails."""
    cc = cc or shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("build_capi: no C compiler (gcc or cc) on PATH")
    inc, ld = embed_flags()
    out = Path(out_dir) / "libg4s_torch_capi.so"
    cmd = [cc, "-shared", "-fPIC", str(NATIVE / "capi.c"), "-o", str(out),
           *inc, *ld]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build_capi: {' '.join(cmd)} failed "
                           f"({proc.returncode})\n{proc.stdout}{proc.stderr}")
    return out

"""Build g4s_tpu_torch/csrc/*.cu into one shared library and load it.

nvcc compiles each source, for Hopper only, in its own process (all
started together) and links the objects into
`g4s_tpu_torch/_build/libg4s_kernels_<hash>.so`, where the hash covers the
sources and the flags: a changed source builds anew, an unchanged one is
loaded as built. The sources expose a plain C interface (no PyTorch
headers), so the build takes seconds. Every C entry point returns the
launch's `cudaGetLastError()`; the wrappers raise when it is not 0.

`build_generated` builds one generated source (a kernel specialised to
one matrix, ops/static_spmv.py) into a library of its own, keyed the same
way by its text and the flags.

Nothing here falls back: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# -Xptxas -v only reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# every pointer and the stream are c_void_p: ctypes would otherwise pass a
# Python int as a 32-bit int and cut the address
SIGNATURES = {
    "g4s_permute_gather_f32": (_P, _I64, _P, _I64, _P, _I64, _P),
    "g4s_permute_gather_f64": (_P, _I64, _P, _I64, _P, _I64, _P),
    "g4s_permute_gather_shape": (_INT, _I64, _P),
    "g4s_wsell_spmv_f32": (_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT,
                           _P),
    "g4s_bwell_spmv_f32": (_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P),
    "g4s_sorted_segment_sum_f32": (_P, _P, _P, _I64, _I64, _P, _I64, _P),
    "g4s_sorted_segment_sum_f64": (_P, _P, _P, _I64, _I64, _P, _I64, _P),
    "g4s_sorted_segment_sum_f32_i32": (_P, _P, _P, _I64, _I64, _P, _I64, _P),
    "g4s_sorted_segment_sum_f64_i32": (_P, _P, _P, _I64, _I64, _P, _I64, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "g4s_tpu_torch kernels are built from csrc/ at first use and need "
        "the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libg4s_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing: one nvcc process
    per source, all started together, then one link. Returns the library's
    path and nvcc's output (empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = "", []
        for cmd, proc in procs:
            text, _ = proc.communicate()
            log += text
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = Path(tmp) / out.name
        cmd = [nvcc(), "-shared", "-o", str(lib),
               *(str(Path(tmp) / f"{s.stem}.o") for s in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        # atomic rename: a concurrent build never loads a partial file
        os.replace(lib, out)
    return out, log + proc.stdout + proc.stderr


def build_generated(name: str, source: str) -> tuple[ctypes.CDLL, float]:
    """Compile a generated CUDA source, with the same flags, into
    `_build/lib<name>_<hash>.so` (the hash covers the source and the flags)
    unless that library exists, and load it. Returns the library and
    nvcc's wall seconds (0.0 when it was already built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            src = Path(tmp) / f"{name}.cu"
            src.write_text(source)
            lib = Path(tmp) / out.name
            cmd = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on the "
                                   f"generated {name}.cu: {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            # atomic rename: a concurrent build never loads a partial file
            os.replace(lib, out)
    return ctypes.CDLL(str(out)), seconds


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")

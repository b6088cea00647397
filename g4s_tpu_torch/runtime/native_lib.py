"""ctypes loader for the native host kernels (runtime/native/host_kernels.cc),
the counterpart of g4s_tpu/runtime/native_lib.py.

g++ compiles the C++ source at first use into
`g4s_tpu_torch/_build/libg4s_host_<hash>.so`, where the hash covers the
source and the flags: a changed source builds anew, an unchanged one is
loaded as built. Nothing falls back: a missing g++ or a failed build
raises, and the callers' numpy paths run only when asked for
(`use_native=False`).

Entry points: `parse_numbers` (the Matrix-Market body),
`spgemm_symbolic_native` (ops/spgemm.spgemm_plan's symbolic phase) and
`esc_plan_core_native` (ops/spgemm_esc.esc_plan's O(flop) passes). The
symbolic phase runs on the host's cores, at most 16 threads; the plan
core on one.
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

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "host_kernels.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_L = ctypes.c_long
SIGNATURES = {
    "g4s_parse_numbers": (_L, [ctypes.c_char_p, _L, _L,
                               ctypes.POINTER(ctypes.c_double), _L]),
    "g4s_spgemm_flops": (_L, [_I64, _I64, _L, _I64]),
    "g4s_spgemm_symbolic": (_L, [_I64, _I64, _L, _I64, _I64, _L, _L, _I64,
                                 _I64, _I32, _I64, _I64]),
    "g4s_esc_plan_core": (_L, [_I64] * 8 + [_L] + [_I64, _I64, _I64, _L]
                          + [_I64, _I64, _L] + [_L] * 8 + [_I32] * 10
                          + [_I64, _I64]),
}


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return Path(build_dir) / f"libg4s_host_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """Compile the library into build_dir unless it is there. Returns its
    path and g++'s wall seconds (0.0 when it was already built). Raises
    when g++ is missing or fails."""
    out = library_path(build_dir)
    if out.exists():
        return out, 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the native host kernels "
            f"({SRC.name}) are built at first use and need a C++ compiler")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        lib = Path(tmp) / out.name
        cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(lib)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        # atomic rename: a concurrent build never loads a partial file
        os.replace(lib, out)
    return out, seconds


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use, with its C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _p64(x):
    return x.ctypes.data_as(_I64)


def _p32(x):
    return x.ctypes.data_as(_I32)


def _as64(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int64)


def parse_numbers(body: str, ncomp: int, max_entries: int) -> np.ndarray:
    """Whitespace-separated numbers to (n, ncomp) float64, n <= max_entries;
    parsing stops at the first token that is not a number."""
    raw = body.encode()
    out = np.empty((max_entries, ncomp), dtype=np.float64)
    n = get_lib().g4s_parse_numbers(
        raw, len(raw), ncomp,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_entries)
    return out[:n]


def esc_plan_core_native(kk, Mv, Lv, Mh, Wv, a_off, b_off, p_off,
                         ac_indptr, ac_rows, csc_of_csr,
                         b_indptr, b_indices, nnz_a, nnz_b,
                         n_min, n_major, F, na, nb_len, m2,
                         order_row: bool, two_key: bool):
    """The O(flop) passes of the ESC SpGEMM plan (spgemm_esc.esc_plan) as
    fused native loops and an LSD radix key sort. Returns (a_rank, b_rank,
    d_a, d_b, d_pad, keys, keys_minor or None, off_c, d_head, c_indices,
    c_indptr, nnz, meta); raises on an internal inconsistency."""
    lib = get_lib()
    kk, Mv, Lv, Mh, Wv = map(_as64, (kk, Mv, Lv, Mh, Wv))
    a_off, b_off, p_off = map(_as64, (a_off, b_off, p_off))
    ac_indptr, ac_rows, csc_of_csr = map(_as64, (ac_indptr, ac_rows,
                                                 csc_of_csr))
    b_indptr, b_indices = _as64(b_indptr), _as64(b_indices)
    a_rank = np.empty(nnz_a, np.int32)
    b_rank = np.empty(nnz_b, np.int32)
    d_a = np.empty(na, np.int32)
    d_b = np.empty(nb_len, np.int32)
    d_pad = np.empty(m2, np.int32)
    keys_dev = np.empty(F, np.int32)
    keys_minor = np.empty(F if two_key else 1, np.int32)
    off_c = np.empty(F, np.int32)
    d_head = np.empty(F, np.int32)
    c_indices = np.empty(F, np.int32)
    c_indptr = np.empty(n_major + 1, np.int64)
    meta = np.zeros(8, np.int64)
    nnz = lib.g4s_esc_plan_core(
        _p64(kk), _p64(Mv), _p64(Lv), _p64(Mh), _p64(Wv), _p64(a_off),
        _p64(b_off), _p64(p_off), len(kk),
        _p64(ac_indptr), _p64(ac_rows), _p64(csc_of_csr), nnz_a,
        _p64(b_indptr), _p64(b_indices), nnz_b,
        n_min, n_major, F, na, nb_len, m2, 1 if order_row else 0,
        1 if two_key else 0,
        _p32(a_rank), _p32(b_rank), _p32(d_a), _p32(d_b), _p32(d_pad),
        _p32(keys_dev), _p32(keys_minor), _p32(off_c), _p32(d_head),
        _p32(c_indices), _p64(c_indptr), _p64(meta))
    if nnz < 0:
        raise RuntimeError("g4s_esc_plan_core: inconsistent plan sizes "
                           f"(F {F}, na {na}, nb_len {nb_len}, m2 {m2})")
    return (a_rank, b_rank, d_a, d_b, d_pad, keys_dev,
            keys_minor if two_key else None, off_c, d_head,
            c_indices[:nnz].copy(), c_indptr, int(nnz), meta)


def spgemm_symbolic_native(a_indptr, a_indices, b_indptr, b_indices,
                           m: int, n: int):
    """The SpGEMM symbolic phase; returns (src_a, src_b, slot, c_rows,
    c_cols, nnz, F)."""
    lib = get_lib()
    a_indptr, a_indices = _as64(a_indptr), _as64(a_indices)
    b_indptr, b_indices = _as64(b_indptr), _as64(b_indices)
    F = lib.g4s_spgemm_flops(_p64(a_indptr), _p64(a_indices), m,
                             _p64(b_indptr))
    src_a = np.empty(F, np.int64)
    src_b = np.empty(F, np.int64)
    slot = np.empty(F, np.int32)
    c_rows = np.empty(max(F, 1), np.int64)
    c_cols = np.empty(max(F, 1), np.int64)
    nnz = lib.g4s_spgemm_symbolic(
        _p64(a_indptr), _p64(a_indices), m, _p64(b_indptr),
        _p64(b_indices), n, F, _p64(src_a), _p64(src_b), _p32(slot),
        _p64(c_rows), _p64(c_cols))
    return src_a, src_b, slot, c_rows[:nnz], c_cols[:nnz], int(nnz), int(F)

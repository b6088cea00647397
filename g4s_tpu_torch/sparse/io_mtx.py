"""Matrix-Market reader/writer and GTgraph edge-list reader.

Counterpart of g4s_tpu/sparse/io_mtx.py, with the same semantics: banner
validation, pattern entries filled with 1, complex entries keeping the real
part, 1-based -> 0-based indices, symmetric / skew-symmetric expansion of
off-diagonals (hermitian rejected), (row, col) sort and COO->CSR
compression. The body's numbers are parsed by the native parser
(runtime/native_lib.parse_numbers), or by numpy with use_native=False.
"""

from __future__ import annotations

import gzip

import numpy as np

from g4s_tpu_torch.sparse.containers import COO, CSR, as_numpy, as_tensor
from g4s_tpu_torch.sparse.convert import coo_to_csr, merge_duplicates

_VALID_TYPES = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRY = ("general", "symmetric", "skew-symmetric", "hermitian")


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mtx(path, *, use_native: bool = True) -> COO:
    """Read a Matrix-Market coordinate file into a CPU COO; the body is
    parsed natively unless use_native=False (numpy)."""
    with _open(path) as f:
        banner = f.readline().split()
        if len(banner) != 5 or banner[0] != "%%MatrixMarket" \
                or banner[1] != "matrix":
            raise ValueError(f"invalid MatrixMarket banner in {path}")
        storage, dtype, symmetry = (banner[2], banner[3].lower(),
                                    banner[4].lower())
        if storage != "coordinate":
            raise ValueError(f"unsupported MatrixMarket storage '{storage}'")
        if dtype not in _VALID_TYPES:
            raise ValueError(f"invalid MatrixMarket data type '{dtype}'")
        if symmetry not in _VALID_SYMMETRY:
            raise ValueError(f"invalid MatrixMarket symmetry '{symmetry}'")
        if symmetry == "hermitian":
            raise ValueError("hermitian matrices are not supported")
        line = f.readline()
        while line.startswith("%") or not line.strip():
            if line == "":  # EOF before the size line
                raise ValueError(f"truncated MatrixMarket file {path}: "
                                 "no size line found")
            line = f.readline()
        rows, cols, nnz = (int(t) for t in line.split())
        body = f.read()

    ncomp = {"pattern": 2, "real": 3, "integer": 3, "complex": 4}[dtype]
    if use_native:
        from g4s_tpu_torch.runtime.native_lib import parse_numbers
        flat = parse_numbers(body, ncomp, nnz)
    else:
        flat = np.array(body.split(), dtype=np.float64)
        flat = flat[: min(flat.size // ncomp, nnz) * ncomp].reshape(-1, ncomp)
    n = flat.shape[0]
    if n < nnz:
        raise ValueError(f"read {n} entries, declared nnz is {nnz}")
    I = flat[:, 0].astype(np.int32) - 1
    J = flat[:, 1].astype(np.int32) - 1
    if dtype == "pattern":
        V = np.ones(nnz, dtype=np.float64)
    else:
        V = flat[:, 2].astype(np.float64)  # complex: keep the real part

    if symmetry != "general":
        off = I != J
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        I, J = np.concatenate([I, J[off]]), np.concatenate([J, I[off]])
        V = np.concatenate([V, sign * V[off]])

    return COO(as_tensor(I), as_tensor(J), as_tensor(V), (rows, cols))


def read_mtx_csr(path) -> CSR:
    """Read a Matrix-Market file straight to sorted CSR (duplicates kept)."""
    return coo_to_csr(read_mtx(path), sort=True, sum_duplicates=False)


def write_mtx(path, m: COO, *, comment: str = "") -> None:
    row = as_numpy(m.row) + 1
    col = as_numpy(m.col) + 1
    val = as_numpy(m.val)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{m.shape[0]} {m.shape[1]} {row.size}\n")
        for r, c, v in zip(row, col, val):
            f.write(f"{r} {c} {v:.17g}\n")


def read_gtgraph(path) -> CSR:
    """GTgraph/DIMACS edge list -> CSR with duplicate arcs summed.

    Format: 'c' comment lines, one 'p sp <n> <m>' problem line, and
    'a <u> <v> <w>' arc lines with 1-based vertex ids.
    """
    n = 0
    rows, cols, vals = [], [], []
    with open(path) as f:
        for line in f:
            if not line or line[0] == "c":
                continue
            if line[0] == "p":
                n = int(line.split()[-2])
            elif line[0] == "a":
                _, u, v, w = line.split()
                rows.append(int(u) - 1)
                cols.append(int(v) - 1)
                vals.append(float(w))
    if n == 0:
        n = max(max(rows, default=0), max(cols, default=0)) + 1
    coo = COO(np.asarray(rows, np.int64), np.asarray(cols, np.int64),
              np.asarray(vals), (n, n))
    return merge_duplicates(coo_to_csr(coo))

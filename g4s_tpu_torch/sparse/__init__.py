from g4s_tpu_torch.sparse.containers import COO, CSR, CSC, DIA, ELL, SELL  # noqa: F401
from g4s_tpu_torch.sparse.convert import (  # noqa: F401
    coo_to_csr, coo_to_csc, csr_to_csc, csc_to_csr, csr_to_coo,
    csr_to_ell, csr_to_sell, csr_to_dia, csr_to_dense, dense_to_csr,
    merge_duplicates, crop,
)
from g4s_tpu_torch.sparse.io_mtx import read_mtx, read_mtx_csr, write_mtx, read_gtgraph  # noqa: F401
from g4s_tpu_torch.sparse.compare import error_tolerant_equal, csr_allclose, EPSILON  # noqa: F401

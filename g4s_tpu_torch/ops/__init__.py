from g4s_tpu_torch.ops.segment import segment_sum, sorted_segment_sum, segment_reduce  # noqa: F401
from g4s_tpu_torch.ops.spmv import (  # noqa: F401
    spmv_ell, spmv_sell, spmv_csr, spmv_dia, spmv, spmv_dense_rows,
)
from g4s_tpu_torch.ops.route import (  # noqa: F401
    PermutePlan, apply_permute, build_permute_plan, permute_gather,
)
from g4s_tpu_torch.ops.wsell_spmv import (  # noqa: F401
    WSELL, pack_wsell, spmv_wsell, spmv_wsell_chain, wsell_block_sort_perm,
)
from g4s_tpu_torch.ops.stream_spmv import (  # noqa: F401
    StreamPlan, build_stream_plan, spmv_stream,
)

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
from g4s_tpu_torch.ops.bwell_spmv import (  # noqa: F401
    BWELL, bwell_from_reference, pack_bwell, spmv_bwell, spmv_bwell_padded,
)
from g4s_tpu_torch.ops.spgemm import (  # noqa: F401
    SpGEMMPlan, spgemm_device_csr, spgemm_device_full,
    spgemm_device_merge, spgemm_expand_map, spgemm_flops, spgemm_numeric,
    spgemm_plan, spgemm_via_csc,
)
from g4s_tpu_torch.ops.spgemm_esc import (  # noqa: F401
    ESCPlan, esc_numeric, esc_numeric_staged, esc_plan, esc_plan_device,
    materialize_structure, spgemm_esc_col,
)
from g4s_tpu_torch.ops.spgemm_block import (  # noqa: F401
    BlockPlan, block_c_to_scipy, block_cover, block_numeric, block_plan,
)

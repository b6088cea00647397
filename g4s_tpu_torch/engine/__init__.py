from g4s_tpu_torch.engine.semiring import Semiring, PLUS_TIMES, MIN_PLUS, MAX_PLUS, MAX_TIMES, OR_AND  # noqa: F401
from g4s_tpu_torch.engine.dispatch import (  # noqa: F401
    Graph, build_graph, graph_from_reference, mxm, mxv, permute_in,
    permute_out, reduce_vector, vxm,
)
from g4s_tpu_torch.engine.operator import (  # noqa: F401
    OperatorGraph, apply_operator, build_operator, register_operator_variant,
)
from g4s_tpu_torch.engine.gas import gather_apply, spmm_dense  # noqa: F401
from g4s_tpu_torch.engine.matmul import dense_matmul  # noqa: F401

# Multi-device support of the port: the sharding rules and their DTensor
# placements (parameters, optimizer state, batches, the search's slots),
# and the gradient compression's numerics (int8 quantisation with error
# feedback).
from .compress import compress_decompress, compress_with_feedback
from .sharding import (
    abstract_mesh,
    batch_spec,
    constrain,
    constrain_search_batch,
    data_axes,
    logical_spec,
    opt_state_shardings,
    param_shardings,
    use_mesh,
)

__all__ = [
    "abstract_mesh",
    "batch_spec",
    "compress_decompress",
    "compress_with_feedback",
    "constrain",
    "constrain_search_batch",
    "data_axes",
    "logical_spec",
    "opt_state_shardings",
    "param_shardings",
    "use_mesh",
]

"""Multi-device execution (port of egohmr_tpu/parallel). Data parallelism
over processes; the opt-in tensor-parallel placement of the JAX package
(`parallel/tp.py`) is not ported yet."""
from .mesh import (
    DataParallel,
    Shard,
    all_reduce_max,
    all_reduce_sum,
    barrier,
    draw_rows,
    gather_rows,
    global_rows,
    init_data_parallel,
    is_main,
    mean_grads,
    mean_metrics,
    replicate,
    rows,
    shard_batch,
    shutdown,
)

__all__ = [
    "DataParallel",
    "Shard",
    "all_reduce_max",
    "all_reduce_sum",
    "barrier",
    "draw_rows",
    "gather_rows",
    "global_rows",
    "init_data_parallel",
    "is_main",
    "mean_grads",
    "mean_metrics",
    "replicate",
    "rows",
    "shard_batch",
    "shutdown",
]

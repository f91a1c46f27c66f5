"""Data parallel over processes (counterpart of cris_tpu/parallel)."""

from .dist import (all_reduce_sum, allgather_floats, barrier, broadcast_int,
                   close_distributed, data_parallel, data_parallel_size,
                   init_distributed, local_process_count, process_count,
                   process_index)

__all__ = ["all_reduce_sum", "allgather_floats", "barrier", "broadcast_int",
           "close_distributed", "data_parallel", "data_parallel_size",
           "init_distributed", "local_process_count", "process_count",
           "process_index"]

"""Data and tensor parallel over processes (counterpart of
cris_tpu/parallel): the rank grid and its collectives (``dist``), and the
JAX mesh's sharding rules with the layers that carry them out
(``tensor``)."""

from .dist import (Grid, all_gather, all_reduce_sum, allgather_floats,
                   barrier, broadcast_int, close_distributed, data_parallel,
                   data_parallel_size, data_rank, grid, init_distributed,
                   init_grid, local_process_count, process_count,
                   process_index)

__all__ = ["Grid", "all_gather", "all_reduce_sum", "allgather_floats",
           "barrier", "broadcast_int", "close_distributed", "data_parallel",
           "data_parallel_size", "data_rank", "grid", "init_distributed",
           "init_grid", "local_process_count", "process_count",
           "process_index"]

from .mesh import (Mesh, RankFailed, all_max, all_reduce_grads, all_sum, all_sum_grad, barrier,
                   broadcast_float, build_train_mesh, create_mesh, global_batch,
                   initialize_distributed, launch,
                   rank, rank_rows, replicate, resolve_devices, shard_batch, shard_microbatches,
                   world_size)

__all__ = ["Mesh", "RankFailed", "all_max", "all_reduce_grads", "all_sum", "all_sum_grad",
           "barrier", "broadcast_float", "build_train_mesh", "create_mesh", "global_batch",
           "initialize_distributed", "launch", "rank", "rank_rows", "replicate",
           "resolve_devices", "shard_batch", "shard_microbatches", "world_size"]

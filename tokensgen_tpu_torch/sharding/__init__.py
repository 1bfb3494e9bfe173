"""Several GPUs: the FIFO's queue axis and the trainers' data axis as
groups of processes (`mesh`), and the ZeRO-1 optimizer-state layout
(`zero`)."""

from tokensgen_tpu_torch.sharding.mesh import (DataGroup, MeshSpec, QueueGroup, check_ranks,
                                               join_env_group, launch, process_batch_shard,
                                               start_followers)

__all__ = ["DataGroup", "MeshSpec", "QueueGroup", "check_ranks", "join_env_group", "launch",
           "process_batch_shard", "start_followers"]

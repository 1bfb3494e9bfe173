"""Several GPUs: the FIFO's queue axis as a group of processes (`mesh`)."""

from tokensgen_tpu_torch.sharding.mesh import (MeshSpec, QueueGroup, check_ranks, launch,
                                               start_followers)

__all__ = ["MeshSpec", "QueueGroup", "check_ranks", "launch", "start_followers"]

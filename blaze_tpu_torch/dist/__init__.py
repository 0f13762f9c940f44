from .mesh import init_distributed, make_mesh, shard_leading, replicated
from .msm_dist import DistributedMSM
from .ntt_dist import DistributedNTT

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_leading",
    "replicated",
    "DistributedMSM",
    "DistributedNTT",
]

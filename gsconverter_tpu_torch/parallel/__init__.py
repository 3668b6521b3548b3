from .mesh import make_mesh, init_multihost
from .sharding import pad_cloud, shard_cloud

__all__ = [
    "make_mesh",
    "init_multihost",
    "pad_cloud",
    "shard_cloud",
]

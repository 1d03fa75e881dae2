"""Counting over several devices and several hosts.

`mesh.py`: a mesh is an ordered list of `torch.device` shards.
`dist.py`: `DistributedCounter`, the counter over a mesh (psum,
psum_scatter, all_to_all, dp_sparse).  `multihost.py`: round-robin input
sharding across hosts and the collective merge over a gloo process group.
`dryrun.py`: every merge mode over a mesh, each checked exactly.

The exports are the reference's less `device_axis` (the name of a
`jax.sharding` mesh axis; the port's mesh has none).
"""

from findkmer_torch.parallel.dist import DistributedCounter
from findkmer_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "DistributedCounter"]

"""The mesh: the key table sharded over several devices driven by one
process (the port of ``gubernator_tpu/parallel/``)."""

from gubernator_tpu_torch.parallel.mesh import make_mesh
from gubernator_tpu_torch.parallel.sharded import ShardedEngine

__all__ = ["make_mesh", "ShardedEngine"]

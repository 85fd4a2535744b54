from gubernator_tpu_torch.peers.hash_ring import ReplicatedConsistentHash
from gubernator_tpu_torch.peers.picker import RegionPicker

__all__ = ["ReplicatedConsistentHash", "RegionPicker"]

"""Peer discovery pools (the port of ``gubernator_tpu/discovery``; host
code, no tensors; reference §L6): "none" (explicit set_peers, the
test-cluster mode, reference daemon.go:258-262), DNS polling (dns.py), etcd
lease registration (etcd.py), member-list gossip (memberlist.py), and
Kubernetes EndpointSlices/Pods (kubernetes.py). All speak plain
sockets/HTTP — no infrastructure client libraries required."""

from gubernator_tpu_torch.discovery.dns import DNSPool, system_resolver
from gubernator_tpu_torch.discovery.etcd import EtcdPool
from gubernator_tpu_torch.discovery.kubernetes import K8sPool
from gubernator_tpu_torch.discovery.memberlist import MemberlistPool

__all__ = ["DNSPool", "EtcdPool", "K8sPool", "MemberlistPool", "system_resolver"]

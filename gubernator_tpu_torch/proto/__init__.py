"""Protobuf message modules, wire-compatible with the reference's
pb.gubernator package: the same schema files and the same serialized
``FileDescriptorProto`` bytes as ``gubernator_tpu/proto``, so both packages
can register them in one process. The modules import each other
package-relative (``peers_pb2`` → ``from . import gubernator_pb2``); nothing
is put on ``sys.path``.

Regenerate the two protoc modules with

    cd gubernator_tpu_torch/proto && protoc --python_out=. -I. gubernator.proto peers.proto

then make the import in ``peers_pb2.py`` package-relative again.
"""

from . import gubernator_pb2, handoff_pb2, peers_pb2

__all__ = ["gubernator_pb2", "handoff_pb2", "peers_pb2"]

# -*- coding: utf-8 -*-
"""TransferState messages for the ownership-handoff peer RPC.

Unlike gubernator_pb2/peers_pb2 (protoc output vendored from the reference's
schema), these messages have no reference counterpart — the handoff protocol
is this repo's own (docs/robustness.md "Topology change & drain") — so the
FileDescriptorProto is built programmatically instead of vendoring protoc
bytes; the result is a normal proto3 wire-compatible message set.

Schema (proto3, package pb.gubernator):

    message TransferStateReq {
      string transfer_id    = 1;  // idempotency scope (one per handoff round)
      uint32 chunk          = 2;  // chunk index within the transfer
      uint32 total_chunks   = 3;
      string source_address = 4;  // advertise address of the handing-off peer
      int64  now_ms         = 5;  // source clock at extract (diagnostic only;
                                  // the receiver merges on its own clock)
      uint32 count          = 6;  // rows in this chunk
      bytes  fps            = 7;  // count × int64 LE fingerprints
      bytes  points         = 8;  // count × uint32 LE ring points
      bytes  slots          = 9;  // count × F × int32 LE slot fields, in the
                                  // sender's slot layout (ops/layout.py)
      uint32 layout         = 10; // sender's slot-layout code (0 = full —
                                  // the proto3 default, so pre-layout
                                  // senders decode as full automatically)
    }
    message TransferStateResp {
      uint32 merged   = 1;  // rows merged/installed by the receiver
      bool  duplicate = 2;  // chunk had already been applied (idempotent replay)
    }

Rows travel as packed little-endian arrays, not repeated messages: a chunk is
a straight memory image of the extract (table2.extract_live_rows), so a 4096-
row chunk costs three buffer copies instead of 4096 message objects each way.
"""

from google.protobuf import descriptor_pb2 as _dpb
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import message_factory as _message_factory

_FD = _dpb.FieldDescriptorProto

_fdp = _dpb.FileDescriptorProto()
_fdp.name = "handoff.proto"
_fdp.package = "pb.gubernator"
_fdp.syntax = "proto3"
_fdp.options.go_package = "github.com/gubernator-io/gubernator"

_req = _fdp.message_type.add()
_req.name = "TransferStateReq"
for _name, _num, _type in (
    ("transfer_id", 1, _FD.TYPE_STRING),
    ("chunk", 2, _FD.TYPE_UINT32),
    ("total_chunks", 3, _FD.TYPE_UINT32),
    ("source_address", 4, _FD.TYPE_STRING),
    ("now_ms", 5, _FD.TYPE_INT64),
    ("count", 6, _FD.TYPE_UINT32),
    ("fps", 7, _FD.TYPE_BYTES),
    ("points", 8, _FD.TYPE_BYTES),
    ("slots", 9, _FD.TYPE_BYTES),
    ("layout", 10, _FD.TYPE_UINT32),
):
    _f = _req.field.add()
    _f.name, _f.number, _f.type = _name, _num, _type
    _f.label = _FD.LABEL_OPTIONAL

_resp = _fdp.message_type.add()
_resp.name = "TransferStateResp"
for _name, _num, _type in (
    ("merged", 1, _FD.TYPE_UINT32),
    ("duplicate", 2, _FD.TYPE_BOOL),
):
    _f = _resp.field.add()
    _f.name, _f.number, _f.type = _name, _num, _type
    _f.label = _FD.LABEL_OPTIONAL

_pool = _descriptor_pool.Default()
try:
    _fd = _pool.Add(_fdp)
except Exception:  # already registered (module re-import under both names)
    _fd = _pool.FindFileByName("handoff.proto")

if hasattr(_message_factory, "GetMessageClass"):
    TransferStateReq = _message_factory.GetMessageClass(
        _fd.message_types_by_name["TransferStateReq"]
    )
    TransferStateResp = _message_factory.GetMessageClass(
        _fd.message_types_by_name["TransferStateResp"]
    )
else:  # protobuf < 4.21
    _factory = _message_factory.MessageFactory(_pool)
    TransferStateReq = _factory.GetPrototype(
        _fd.message_types_by_name["TransferStateReq"]
    )
    TransferStateResp = _factory.GetPrototype(
        _fd.message_types_by_name["TransferStateResp"]
    )

__all__ = ["TransferStateReq", "TransferStateResp"]

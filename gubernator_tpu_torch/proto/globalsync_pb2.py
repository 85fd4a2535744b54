# -*- coding: utf-8 -*-
"""SyncGlobalsWire messages for the inter-slice GLOBAL hit sync.

Like handoff_pb2, these messages have no reference counterpart — the
compact inter-slice sync is this repo's own (docs/architecture.md
"Pod-scale topology") — so the FileDescriptorProto is built
programmatically; the result is a normal proto3 wire-compatible message.

Schema (proto3, package pb.gubernator):

    message SyncGlobalsWireReq {
      string source    = 1;  // sender's advertise address (diagnostics)
      uint32 count     = 2;  // entries in this batch
      int64  base      = 3;  // created_at base of the lane encoding
      bytes  lanes     = 4;  // 5 × count int32 LE — ops/wire.pack_wire_rows
                             // image (fp/limit/duration|algo/flag lanes; the
                             // 18-bit lane hits field is IGNORED on receive)
      bytes  hits      = 5;  // count × int64 LE full-precision accumulated
                             // hits (inter-slice accumulations overflow the
                             // 18-bit lane budget under hot keys)
      bytes  name_lens = 6;  // count × uint16 LE rate-limit name lengths
      bytes  key_lens  = 7;  // count × uint16 LE unique_key lengths
      bytes  strings   = 8;  // concatenated utf8 name_i ‖ unique_key_i
    }
    message SyncGlobalsWireResp {
      uint32 applied = 1;  // entries the owner applied
    }

Numeric config rides the compact lane codec of ops/wire.py (20 B/entry instead of a
nested RateLimitReq message each); the key strings — which the owner needs
to queue its authoritative broadcasts — travel as one length-prefixed blob
instead of per-message string fields. Non-encodable batches (Gregorian
durations, exotic behaviors, oversized fields) fall back to the classic
GetPeerRateLimits proto path with identical semantics.
"""

from google.protobuf import descriptor_pb2 as _dpb
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import message_factory as _message_factory

_FD = _dpb.FieldDescriptorProto

_fdp = _dpb.FileDescriptorProto()
_fdp.name = "globalsync.proto"
_fdp.package = "pb.gubernator"
_fdp.syntax = "proto3"
_fdp.options.go_package = "github.com/gubernator-io/gubernator"

_req = _fdp.message_type.add()
_req.name = "SyncGlobalsWireReq"
for _name, _num, _type in (
    ("source", 1, _FD.TYPE_STRING),
    ("count", 2, _FD.TYPE_UINT32),
    ("base", 3, _FD.TYPE_INT64),
    ("lanes", 4, _FD.TYPE_BYTES),
    ("hits", 5, _FD.TYPE_BYTES),
    ("name_lens", 6, _FD.TYPE_BYTES),
    ("key_lens", 7, _FD.TYPE_BYTES),
    ("strings", 8, _FD.TYPE_BYTES),
):
    _f = _req.field.add()
    _f.name, _f.number, _f.type = _name, _num, _type
    _f.label = _FD.LABEL_OPTIONAL

_resp = _fdp.message_type.add()
_resp.name = "SyncGlobalsWireResp"
_f = _resp.field.add()
_f.name, _f.number, _f.type = "applied", 1, _FD.TYPE_UINT32
_f.label = _FD.LABEL_OPTIONAL

_pool = _descriptor_pool.Default()
try:
    _fd = _pool.Add(_fdp)
except Exception:  # already registered (module re-import under both names)
    _fd = _pool.FindFileByName("globalsync.proto")

if hasattr(_message_factory, "GetMessageClass"):
    SyncGlobalsWireReq = _message_factory.GetMessageClass(
        _fd.message_types_by_name["SyncGlobalsWireReq"]
    )
    SyncGlobalsWireResp = _message_factory.GetMessageClass(
        _fd.message_types_by_name["SyncGlobalsWireResp"]
    )
else:  # protobuf < 4.21
    _factory = _message_factory.MessageFactory(_pool)
    SyncGlobalsWireReq = _factory.GetPrototype(
        _fd.message_types_by_name["SyncGlobalsWireReq"]
    )
    SyncGlobalsWireResp = _factory.GetPrototype(
        _fd.message_types_by_name["SyncGlobalsWireResp"]
    )

__all__ = ["SyncGlobalsWireReq", "SyncGlobalsWireResp"]

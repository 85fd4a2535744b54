# -*- coding: utf-8 -*-
"""SyncRegionsWire messages for the cross-region replication plane.

Like globalsync_pb2, these messages have no reference counterpart — the
reference's MULTI_REGION push loop was never implemented (its README marks
the behavior "not fully implemented") — so the FileDescriptorProto is built
programmatically; the result is a normal proto3 wire-compatible message.

Schema (proto3, package pb.gubernator):

    message SyncRegionsWireReq {
      string source    = 1;   // sender's advertise address (diagnostics)
      string region    = 2;   // sender's data_center label
      uint32 count     = 3;   // entries in this batch
      int64  base      = 4;   // created_at base of the lane encoding
      bytes  lanes     = 5;   // 5 × count int32 LE — ops/wire lane image
                              // (fp/limit/duration|algo/flag lanes; the
                              // 18-bit lane hits field is IGNORED)
      bytes  hits      = 6;   // count × int64 LE per-key HIT DELTAS since
                              // the sender's last successful sync
      bytes  name_lens = 7;   // count × uint16 LE rate-limit name lengths
      bytes  key_lens  = 8;   // count × uint16 LE unique_key lengths
      bytes  strings   = 9;   // concatenated utf8 name_i ‖ unique_key_i
      bytes  slots     = 10;  // count × layout.F int32 LE — the sender's
                              // own stored slot rows in ITS slot layout
                              // (zero row = slot evicted sender-side;
                              // empty buffer = sender shipped no rows)
      uint32 layout    = 11;  // ops/layout code of `slots` (0 = full)
      bytes  cums      = 12;  // count × int64 LE per-key CUMULATIVE hit
                              // counters (total hits the sender has ever
                              // queued toward this region for the key) —
                              // the receiver-side dedup ledger skips
                              // re-shipped batches after a lost ack
                              // EXACTLY (ops/reconcile.dedup_source_
                              // deltas); empty buffer = sender predates
                              // the dedup plane (receiver applies deltas
                              // verbatim — the legacy under-grant rule)
    }
    message SyncRegionsWireResp {
      uint32 applied = 1;  // rows the receiver merged
    }

The receiver reconciles through kernel2.merge2 (ops/reconcile.py), never
the serving path; non-encodable items and pre-upgrade peers ride the
classic GetPeerRateLimits proto fallback with the legacy DRAIN semantics
(docs/robustness.md "Multi-region active-active").
"""

from google.protobuf import descriptor_pb2 as _dpb
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import message_factory as _message_factory

_FD = _dpb.FieldDescriptorProto

_fdp = _dpb.FileDescriptorProto()
_fdp.name = "regionsync.proto"
_fdp.package = "pb.gubernator"
_fdp.syntax = "proto3"
_fdp.options.go_package = "github.com/gubernator-io/gubernator"

_req = _fdp.message_type.add()
_req.name = "SyncRegionsWireReq"
for _name, _num, _type in (
    ("source", 1, _FD.TYPE_STRING),
    ("region", 2, _FD.TYPE_STRING),
    ("count", 3, _FD.TYPE_UINT32),
    ("base", 4, _FD.TYPE_INT64),
    ("lanes", 5, _FD.TYPE_BYTES),
    ("hits", 6, _FD.TYPE_BYTES),
    ("name_lens", 7, _FD.TYPE_BYTES),
    ("key_lens", 8, _FD.TYPE_BYTES),
    ("strings", 9, _FD.TYPE_BYTES),
    ("slots", 10, _FD.TYPE_BYTES),
    ("layout", 11, _FD.TYPE_UINT32),
    ("cums", 12, _FD.TYPE_BYTES),
):
    _f = _req.field.add()
    _f.name, _f.number, _f.type = _name, _num, _type
    _f.label = _FD.LABEL_OPTIONAL

_resp = _fdp.message_type.add()
_resp.name = "SyncRegionsWireResp"
_f = _resp.field.add()
_f.name, _f.number, _f.type = "applied", 1, _FD.TYPE_UINT32
_f.label = _FD.LABEL_OPTIONAL

_pool = _descriptor_pool.Default()
try:
    _fd = _pool.Add(_fdp)
except Exception:  # already registered (module re-import under both names)
    _fd = _pool.FindFileByName("regionsync.proto")

if hasattr(_message_factory, "GetMessageClass"):
    SyncRegionsWireReq = _message_factory.GetMessageClass(
        _fd.message_types_by_name["SyncRegionsWireReq"]
    )
    SyncRegionsWireResp = _message_factory.GetMessageClass(
        _fd.message_types_by_name["SyncRegionsWireResp"]
    )
else:  # protobuf < 4.21
    _factory = _message_factory.MessageFactory(_pool)
    SyncRegionsWireReq = _factory.GetPrototype(
        _fd.message_types_by_name["SyncRegionsWireReq"]
    )
    SyncRegionsWireResp = _factory.GetPrototype(
        _fd.message_types_by_name["SyncRegionsWireResp"]
    )

__all__ = ["SyncRegionsWireReq", "SyncRegionsWireResp"]

# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gubernator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10gubernator.proto\x12\rpb.gubernator"A\n\x10GetRateLimitsReq\x12-\n\x08requests\x18\x01 \x03(\x0b2\x1b.pb.gubernator.RateLimitReq"D\n\x11GetRateLimitsResp\x12/\n\tresponses\x18\x01 \x03(\x0b2\x1c.pb.gubernator.RateLimitResp"\x8a\x03\n\x0cRateLimitReq\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nunique_key\x18\x02 \x01(\t\x12\x0c\n\x04hits\x18\x03 \x01(\x03\x12\r\n\x05limit\x18\x04 \x01(\x03\x12\x10\n\x08duration\x18\x05 \x01(\x03\x12+\n\talgorithm\x18\x06 \x01(\x0e2\x18.pb.gubernator.Algorithm\x12)\n\x08behavior\x18\x07 \x01(\x0e2\x17.pb.gubernator.Behavior\x12\r\n\x05burst\x18\x08 \x01(\x03\x12;\n\x08metadata\x18\t \x03(\x0b2).pb.gubernator.RateLimitReq.MetadataEntry\x12\x17\n\ncreated_at\x18\n \x01(\x03H\x00\x88\x01\x01\x12,\n\x07cascade\x18\x0b \x03(\x0b2\x1b.pb.gubernator.CascadeLevel\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01B\r\n\x0b_created_at"\x99\x02\n\rRateLimitResp\x12%\n\x06status\x18\x01 \x01(\x0e2\x15.pb.gubernator.Status\x12\r\n\x05limit\x18\x02 \x01(\x03\x12\x11\n\tremaining\x18\x03 \x01(\x03\x12\x12\n\nreset_time\x18\x04 \x01(\x03\x12\r\n\x05error\x18\x05 \x01(\t\x12<\n\x08metadata\x18\x06 \x03(\x0b2*.pb.gubernator.RateLimitResp.MetadataEntry\x12-\n\x07cascade\x18\x07 \x03(\x0b2\x1c.pb.gubernator.RateLimitResp\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\x10\n\x0eHealthCheckReq"\x85\x01\n\x0ePeerHealthResp\x12\x14\n\x0cgrpc_address\x18\x01 \x01(\t\x12\x13\n\x0bdata_center\x18\x02 \x01(\t\x12#\n\rbreaker_state\x18\x03 \x01(\tR\x0cbreakerState\x12#\n\rrecent_errors\x18\x04 \x03(\tR\x0crecentErrors"\xda\x01\n\x0fHealthCheckResp\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x12\n\npeer_count\x18\x03 \x01(\x05\x12\x19\n\x11advertise_address\x18\x04 \x01(\t\x122\n\x0blocal_peers\x18\x05 \x03(\x0b2\x1d.pb.gubernator.PeerHealthResp\x123\n\x0cregion_peers\x18\x06 \x03(\x0b2\x1d.pb.gubernator.PeerHealthResp\x12\x0e\n\x06region\x18\x07 \x01(\t"\x0e\n\x0cLiveCheckReq"\x0f\n\rLiveCheckResp"\x8d\x01\n\x0cCascadeLevel\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nunique_key\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x10\n\x08duration\x18\x04 \x01(\x03\x12+\n\talgorithm\x18\x05 \x01(\x0e2\x18.pb.gubernator.Algorithm\x12\r\n\x05burst\x18\x06 \x01(\x03"\x82\x02\n\rLeaseQuotaReq\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nunique_key\x18\x02 \x01(\t\x12\x0e\n\x06tokens\x18\x03 \x01(\x03\x12\r\n\x05limit\x18\x04 \x01(\x03\x12\x10\n\x08duration\x18\x05 \x01(\x03\x12+\n\talgorithm\x18\x06 \x01(\x0e2\x18.pb.gubernator.Algorithm\x12)\n\x08behavior\x18\x07 \x01(\x0e2\x17.pb.gubernator.Behavior\x12\r\n\x05burst\x18\x08 \x01(\x03\x12\x0e\n\x06ttl_ms\x18\t \x01(\x03\x12\x10\n\x08lease_id\x18\n \x01(\t\x12\x15\n\rreturn_tokens\x18\x0b \x01(\x03"\xb8\x01\n\x0eLeaseQuotaResp\x12\x10\n\x08lease_id\x18\x01 \x01(\t\x12\x0f\n\x07granted\x18\x02 \x01(\x03\x12\x12\n\nexpires_at\x18\x03 \x01(\x03\x12\r\n\x05limit\x18\x04 \x01(\x03\x12\x11\n\tremaining\x18\x05 \x01(\x03\x12\x16\n\x0eretry_after_ms\x18\x06 \x01(\x03\x12\x13\n\x0boutstanding\x18\x07 \x01(\x03\x12\r\n\x05error\x18\x08 \x01(\t\x12\x11\n\tshrink_to\x18\t \x01(\x03*d\n\tAlgorithm\x12\x10\n\x0cTOKEN_BUCKET\x10\x00\x12\x10\n\x0cLEAKY_BUCKET\x10\x01\x12\x08\n\x04GCRA\x10\x02\x12\x12\n\x0eSLIDING_WINDOW\x10\x03\x12\x15\n\x11CONCURRENCY_LEASE\x10\x04*\x8d\x01\n\x08Behavior\x12\x0c\n\x08BATCHING\x10\x00\x12\x0f\n\x0bNO_BATCHING\x10\x01\x12\n\n\x06GLOBAL\x10\x02\x12\x19\n\x15DURATION_IS_GREGORIAN\x10\x04\x12\x13\n\x0fRESET_REMAINING\x10\x08\x12\x10\n\x0cMULTI_REGION\x10\x10\x12\x14\n\x10DRAIN_OVER_LIMIT\x10 *)\n\x06Status\x12\x0f\n\x0bUNDER_LIMIT\x10\x00\x12\x0e\n\nOVER_LIMIT\x10\x012\xbf\x02\n\x02V1\x12T\n\rGetRateLimits\x12\x1f.pb.gubernator.GetRateLimitsReq\x1a .pb.gubernator.GetRateLimitsResp"\x00\x12N\n\x0bHealthCheck\x12\x1d.pb.gubernator.HealthCheckReq\x1a\x1e.pb.gubernator.HealthCheckResp"\x00\x12H\n\tLiveCheck\x12\x1b.pb.gubernator.LiveCheckReq\x1a\x1c.pb.gubernator.LiveCheckResp"\x00\x12I\n\nLeaseQuota\x12\x1c.pb.gubernator.LeaseQuotaReq\x1a\x1d.pb.gubernator.LeaseQuotaRespB%Z#github.com/gubernator-io/gubernatorb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gubernator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z#github.com/gubernator-io/gubernator'
  _RATELIMITREQ_METADATAENTRY._options = None
  _RATELIMITREQ_METADATAENTRY._serialized_options = b'8\001'
  _RATELIMITRESP_METADATAENTRY._options = None
  _RATELIMITRESP_METADATAENTRY._serialized_options = b'8\001'
# @@protoc_insertion_point(module_scope)

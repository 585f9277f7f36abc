# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: local.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import patch_pb2 as patch__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0blocal.proto\x12\x08ytpu.api\x1a\x0bpatch.proto\"\x13\n\x11GetVersionRequest\"C\n\x12GetVersionResponse\x12\x10\n\x08\x62uilt_at\x18\x01 \x01(\t\x12\x1b\n\x13version_for_upgrade\x18\x02 \x01(\r\"\x13\n\x11\x41skToLeaveRequest\"\x14\n\x12\x41skToLeaveResponse\"d\n\x13\x41\x63quireQuotaRequest\x12\x1c\n\x14milliseconds_to_wait\x18\x01 \x01(\r\x12\x18\n\x10lightweight_task\x18\x02 \x01(\x08\x12\x15\n\rrequestor_pid\x18\x03 \x01(\r\"\x16\n\x14\x41\x63quireQuotaResponse\",\n\x13ReleaseQuotaRequest\x12\x15\n\rrequestor_pid\x18\x01 \x01(\r\"\x16\n\x14ReleaseQuotaResponse\"9\n\x08\x46ileDesc\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x11\n\ttimestamp\x18\x03 \x01(\x04\"M\n\x14SetFileDigestRequest\x12%\n\tfile_desc\x18\x01 \x01(\x0b\x32\x12.ytpu.api.FileDesc\x12\x0e\n\x06\x64igest\x18\x02 \x01(\t\"\x17\n\x15SetFileDigestResponse\"\xe5\x01\n\x14SubmitCxxTaskRequest\x12\x1c\n\x14requestor_process_id\x18\x01 \x01(\x05\x12\x13\n\x0bsource_path\x18\x02 \x01(\t\x12\x15\n\rsource_digest\x18\x03 \x01(\t\x12%\n\x1d\x63ompiler_invocation_arguments\x18\x04 \x01(\t\x12\x15\n\rcache_control\x18\x05 \x01(\x05\x12$\n\x08\x63ompiler\x18\x06 \x01(\x0b\x32\x12.ytpu.api.FileDesc\x12\x1f\n\x17ignore_timestamp_macros\x18\x07 \x01(\x08\"(\n\x15SubmitCxxTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\"F\n\x15WaitForCxxTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x1c\n\x14milliseconds_to_wait\x18\x02 \x01(\r\"\x8e\x01\n\x16WaitForCxxTaskResponse\x12\x11\n\texit_code\x18\x01 \x01(\x05\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x17\n\x0f\x66ile_extensions\x18\x04 \x03(\t\x12)\n\x07patches\x18\x05 \x03(\x0b\x32\x18.ytpu.api.PatchLocationsb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'local_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GETVERSIONREQUEST._serialized_start=38
  _GETVERSIONREQUEST._serialized_end=57
  _GETVERSIONRESPONSE._serialized_start=59
  _GETVERSIONRESPONSE._serialized_end=126
  _ASKTOLEAVEREQUEST._serialized_start=128
  _ASKTOLEAVEREQUEST._serialized_end=147
  _ASKTOLEAVERESPONSE._serialized_start=149
  _ASKTOLEAVERESPONSE._serialized_end=169
  _ACQUIREQUOTAREQUEST._serialized_start=171
  _ACQUIREQUOTAREQUEST._serialized_end=271
  _ACQUIREQUOTARESPONSE._serialized_start=273
  _ACQUIREQUOTARESPONSE._serialized_end=295
  _RELEASEQUOTAREQUEST._serialized_start=297
  _RELEASEQUOTAREQUEST._serialized_end=341
  _RELEASEQUOTARESPONSE._serialized_start=343
  _RELEASEQUOTARESPONSE._serialized_end=365
  _FILEDESC._serialized_start=367
  _FILEDESC._serialized_end=424
  _SETFILEDIGESTREQUEST._serialized_start=426
  _SETFILEDIGESTREQUEST._serialized_end=503
  _SETFILEDIGESTRESPONSE._serialized_start=505
  _SETFILEDIGESTRESPONSE._serialized_end=528
  _SUBMITCXXTASKREQUEST._serialized_start=531
  _SUBMITCXXTASKREQUEST._serialized_end=760
  _SUBMITCXXTASKRESPONSE._serialized_start=762
  _SUBMITCXXTASKRESPONSE._serialized_end=802
  _WAITFORCXXTASKREQUEST._serialized_start=804
  _WAITFORCXXTASKREQUEST._serialized_end=874
  _WAITFORCXXTASKRESPONSE._serialized_start=877
  _WAITFORCXXTASKRESPONSE._serialized_end=1019
# @@protoc_insertion_point(module_scope)

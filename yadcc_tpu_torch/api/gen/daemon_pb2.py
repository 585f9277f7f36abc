# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: daemon.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import env_desc_pb2 as env__desc__pb2
from . import extra_info_pb2 as extra__info__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x64\x61\x65mon.proto\x12\x08ytpu.api\x1a\x0e\x65nv_desc.proto\x1a\x10\x65xtra_info.proto\"\x83\x02\n\x1eQueueCxxCompilationTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x15\n\rtask_grant_id\x18\x02 \x01(\x04\x12+\n\x08\x65nv_desc\x18\x03 \x01(\x0b\x32\x19.ytpu.api.EnvironmentDesc\x12\x13\n\x0bsource_path\x18\x04 \x01(\t\x12\x1c\n\x14invocation_arguments\x18\x05 \x01(\t\x12\x1d\n\x15\x63ompression_algorithm\x18\x06 \x01(\r\x12\x1b\n\x13\x64isallow_cache_fill\x18\x07 \x01(\x08\x12\x1f\n\x17ignore_timestamp_macros\x18\x08 \x01(\x08\"2\n\x1fQueueCxxCompilationTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\"6\n\x14ReferenceTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\x04\"\x17\n\x15ReferenceTaskResponse\"\x9b\x01\n\x1fWaitForCompilationOutputRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\x04\x12\x1c\n\x14milliseconds_to_wait\x18\x03 \x01(\r\x12)\n!acceptable_compression_algorithms\x18\x04 \x03(\r\x12\x0f\n\x07version\x18\x05 \x01(\r\"\xc5\x01\n WaitForCompilationOutputResponse\x12\x0e\n\x06status\x18\x01 \x01(\r\x12\x11\n\texit_code\x18\x02 \x01(\x05\x12\x17\n\x0fstandard_output\x18\x03 \x01(\x0c\x12\x16\n\x0estandard_error\x18\x04 \x01(\x0c\x12.\n\x08\x63xx_info\x18\x05 \x01(\x0b\x32\x1c.ytpu.api.CxxCompilationInfo\x12\x1d\n\x15\x63ompression_algorithm\x18\x06 \x01(\r\"7\n\x15\x46reeDaemonTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\x04\"\x18\n\x16\x46reeDaemonTaskResponse*\xdf\x01\n\x0c\x44\x61\x65monStatus\x12\x14\n\x10\x44\x41\x45MON_STATUS_OK\x10\x00\x12!\n\x1c\x44\x41\x45MON_STATUS_HEAVILY_LOADED\x10\xe9\x07\x12,\n\'DAEMON_STATUS_ENVIRONMENT_NOT_AVAILABLE\x10\xea\x07\x12 \n\x1b\x44\x41\x45MON_STATUS_ACCESS_DENIED\x10\xeb\x07\x12!\n\x1c\x44\x41\x45MON_STATUS_TASK_NOT_FOUND\x10\xec\x07\x12#\n\x1e\x44\x41\x45MON_STATUS_INVALID_ARGUMENT\x10\xed\x07*y\n\x14\x43ompressionAlgorithm\x12!\n\x1d\x43OMPRESSION_ALGORITHM_UNKNOWN\x10\x00\x12\x1e\n\x1a\x43OMPRESSION_ALGORITHM_NONE\x10\x01\x12\x1e\n\x1a\x43OMPRESSION_ALGORITHM_ZSTD\x10\x02*\xce\x01\n\x15\x43ompilationTaskStatus\x12#\n\x1f\x43OMPILATION_TASK_STATUS_UNKNOWN\x10\x00\x12\"\n\x1e\x43OMPILATION_TASK_STATUS_FAILED\x10\x01\x12#\n\x1f\x43OMPILATION_TASK_STATUS_RUNNING\x10\x02\x12 \n\x1c\x43OMPILATION_TASK_STATUS_DONE\x10\x03\x12%\n!COMPILATION_TASK_STATUS_NOT_FOUND\x10\x04\x32\x93\x03\n\rDaemonService\x12n\n\x17QueueCxxCompilationTask\x12(.ytpu.api.QueueCxxCompilationTaskRequest\x1a).ytpu.api.QueueCxxCompilationTaskResponse\x12P\n\rReferenceTask\x12\x1e.ytpu.api.ReferenceTaskRequest\x1a\x1f.ytpu.api.ReferenceTaskResponse\x12q\n\x18WaitForCompilationOutput\x12).ytpu.api.WaitForCompilationOutputRequest\x1a*.ytpu.api.WaitForCompilationOutputResponse\x12M\n\x08\x46reeTask\x12\x1f.ytpu.api.FreeDaemonTaskRequest\x1a .ytpu.api.FreeDaemonTaskResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'daemon_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DAEMONSTATUS._serialized_start=897
  _DAEMONSTATUS._serialized_end=1120
  _COMPRESSIONALGORITHM._serialized_start=1122
  _COMPRESSIONALGORITHM._serialized_end=1243
  _COMPILATIONTASKSTATUS._serialized_start=1246
  _COMPILATIONTASKSTATUS._serialized_end=1452
  _QUEUECXXCOMPILATIONTASKREQUEST._serialized_start=61
  _QUEUECXXCOMPILATIONTASKREQUEST._serialized_end=320
  _QUEUECXXCOMPILATIONTASKRESPONSE._serialized_start=322
  _QUEUECXXCOMPILATIONTASKRESPONSE._serialized_end=372
  _REFERENCETASKREQUEST._serialized_start=374
  _REFERENCETASKREQUEST._serialized_end=428
  _REFERENCETASKRESPONSE._serialized_start=430
  _REFERENCETASKRESPONSE._serialized_end=453
  _WAITFORCOMPILATIONOUTPUTREQUEST._serialized_start=456
  _WAITFORCOMPILATIONOUTPUTREQUEST._serialized_end=611
  _WAITFORCOMPILATIONOUTPUTRESPONSE._serialized_start=614
  _WAITFORCOMPILATIONOUTPUTRESPONSE._serialized_end=811
  _FREEDAEMONTASKREQUEST._serialized_start=813
  _FREEDAEMONTASKREQUEST._serialized_end=868
  _FREEDAEMONTASKRESPONSE._serialized_start=870
  _FREEDAEMONTASKRESPONSE._serialized_end=894
  _DAEMONSERVICE._serialized_start=1455
  _DAEMONSERVICE._serialized_end=1858
# @@protoc_insertion_point(module_scope)

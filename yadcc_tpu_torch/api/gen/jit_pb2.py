# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: jit.proto
# (pure-python build: yadcc_tpu.api.build_protos --pure)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()

from . import env_desc_pb2 as env__desc__pb2

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tjit.proto\x12\x08ytpu.api\x1a\x0eenv_desc.proto"\xa9\x01\n\x14SubmitJitTaskRequest\x12\x1c\n\x14requestor_process_id\x18\x01 \x01(\x05\x12\x1a\n\x12computation_digest\x18\x02 \x01(\t\x12\x17\n\x0fcompile_options\x18\x03 \x01(\x0c\x12\x0f\n\x07backend\x18\x04 \x01(\t\x12\x16\n\x0ejaxlib_version\x18\x05 \x01(\t\x12\x15\n\rcache_control\x18\x06 \x01(\x05"(\n\x15SubmitJitTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04"F\n\x15WaitForJitTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x1c\n\x14milliseconds_to_wait\x18\x02 \x01(\r"a\n\x16WaitForJitTaskResponse\x12\x11\n\texit_code\x18\x01 \x01(\x05\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\r\n\x05error\x18\x03 \x01(\t\x12\x15\n\rartifact_keys\x18\x04 \x03(\t"!\n\x12JitCacheGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t"\x15\n\x13JitCacheGetResponse"!\n\x12JitCachePutRequest\x12\x0b\n\x03key\x18\x01 \x01(\t"\x15\n\x13JitCachePutResponse"\xf5\x01\n\x1eQueueJitCompilationTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x15\n\rtask_grant_id\x18\x02 \x01(\x04\x12+\n\x08env_desc\x18\x03 \x01(\x0b2\x19.ytpu.api.EnvironmentDesc\x12\x1a\n\x12computation_digest\x18\x04 \x01(\t\x12\x17\n\x0fcompile_options\x18\x05 \x01(\x0c\x12\x0f\n\x07backend\x18\x06 \x01(\t\x12\x1d\n\x15compression_algorithm\x18\x07 \x01(\r\x12\x1b\n\x13disallow_cache_fill\x18\x08 \x01(\x08"2\n\x1fQueueJitCompilationTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'jit_pb2', globals())
# @@protoc_insertion_point(module_scope)

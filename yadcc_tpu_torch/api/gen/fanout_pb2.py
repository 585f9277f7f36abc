# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: fanout.proto
# (pure-python build: yadcc_tpu.api.build_protos --pure)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()

from . import env_desc_pb2 as env__desc__pb2

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cfanout.proto\x12\x08ytpu.api\x1a\x0eenv_desc.proto"T\n\x0fAotTopologySpec\x12\x12\n\nmesh_shape\x18\x01 \x03(\r\x12\x14\n\x0cdevice_count\x18\x02 \x01(\r\x12\x17\n\x0fcompile_options\x18\x03 \x01(\x0c"\xbf\x01\n\x14SubmitAotTaskRequest\x12\x1c\n\x14requestor_process_id\x18\x01 \x01(\x05\x12\x1a\n\x12computation_digest\x18\x02 \x01(\t\x12\x0f\n\x07backend\x18\x03 \x01(\t\x12\x16\n\x0ejaxlib_version\x18\x04 \x01(\t\x12\x15\n\rcache_control\x18\x05 \x01(\x05\x12-\n\ntopologies\x18\x06 \x03(\x0b2\x19.ytpu.api.AotTopologySpec"F\n\x15WaitForAotTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x1c\n\x14milliseconds_to_wait\x18\x02 \x01(\r"k\n\x12FanoutChildVerdict\x12\x11\n\tchild_key\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x11\n\texit_code\x18\x03 \x01(\x05\x12\x10\n\x08attempts\x18\x04 \x01(\r\x12\r\n\x05error\x18\x05 \x01(\t"\x91\x01\n\x16WaitForAotTaskResponse\x12\x11\n\texit_code\x18\x01 \x01(\x05\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\r\n\x05error\x18\x03 \x01(\t\x12\x15\n\rartifact_keys\x18\x04 \x03(\t\x12.\n\x08verdicts\x18\x05 \x03(\x0b2\x1c.ytpu.api.FanoutChildVerdict"\xb7\x01\n\x19SubmitAutotuneTaskRequest\x12\x1c\n\x14requestor_process_id\x18\x01 \x01(\x05\x12\x15\n\rkernel_digest\x18\x02 \x01(\t\x12\x0f\n\x07backend\x18\x03 \x01(\t\x12\x16\n\x0ejaxlib_version\x18\x04 \x01(\t\x12\x15\n\rcache_control\x18\x05 \x01(\x05\x12\x0f\n\x07configs\x18\x06 \x03(\t\x12\x14\n\x0cfanout_width\x18\x07 \x01(\r"K\n\x1aWaitForAutotuneTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x1c\n\x14milliseconds_to_wait\x18\x02 \x01(\r"\xb2\x01\n\x1bWaitForAutotuneTaskResponse\x12\x11\n\texit_code\x18\x01 \x01(\x05\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\r\n\x05error\x18\x03 \x01(\t\x12\x1a\n\x12winner_config_json\x18\x04 \x01(\t\x12\x15\n\rartifact_keys\x18\x05 \x03(\t\x12.\n\x08verdicts\x18\x06 \x03(\x0b2\x1c.ytpu.api.FanoutChildVerdict"\x89\x02\n\x1eQueueAotCompilationTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x15\n\rtask_grant_id\x18\x02 \x01(\x04\x12+\n\x08env_desc\x18\x03 \x01(\x0b2\x19.ytpu.api.EnvironmentDesc\x12\x1a\n\x12computation_digest\x18\x04 \x01(\t\x12\x0f\n\x07backend\x18\x05 \x01(\t\x12\x1d\n\x15compression_algorithm\x18\x06 \x01(\r\x12\x1b\n\x13disallow_cache_fill\x18\x07 \x01(\x08\x12+\n\x08topology\x18\x08 \x01(\x0b2\x19.ytpu.api.AotTopologySpec"2\n\x1fQueueAotCompilationTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04"\xe2\x01\n\x18QueueAutotuneTaskRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x15\n\rtask_grant_id\x18\x02 \x01(\x04\x12+\n\x08env_desc\x18\x03 \x01(\x0b2\x19.ytpu.api.EnvironmentDesc\x12\x15\n\rkernel_digest\x18\x04 \x01(\t\x12\x0f\n\x07backend\x18\x05 \x01(\t\x12\x1d\n\x15compression_algorithm\x18\x06 \x01(\r\x12\x1b\n\x13disallow_cache_fill\x18\x07 \x01(\x08\x12\x0f\n\x07configs\x18\x08 \x03(\t",\n\x19QueueAutotuneTaskResponse\x12\x0f\n\x07task_id\x18\x01 \x01(\x04b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'fanout_pb2', globals())
# @@protoc_insertion_point(module_scope)

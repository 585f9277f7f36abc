# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: env_desc.proto
# (pure-python build: yadcc_tpu.api.build_protos --pure)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()



DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eenv_desc.proto\x12\x08ytpu.api"@\n\x0fEnvironmentDesc\x12\x17\n\x0fcompiler_digest\x18\x01 \x01(\t\x12\x14\n\x0ctenant_scope\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'env_desc_pb2', globals())
# @@protoc_insertion_point(module_scope)

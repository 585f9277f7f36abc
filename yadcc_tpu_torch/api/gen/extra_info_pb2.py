# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: extra_info.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import patch_pb2 as patch__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10\x65xtra_info.proto\x12\x08ytpu.api\x1a\x0bpatch.proto\"?\n\x12\x43xxCompilationInfo\x12)\n\x07patches\x18\x01 \x03(\x0b\x32\x18.ytpu.api.PatchLocationsb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'extra_info_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CXXCOMPILATIONINFO._serialized_start=43
  _CXXCOMPILATIONINFO._serialized_end=106
# @@protoc_insertion_point(module_scope)

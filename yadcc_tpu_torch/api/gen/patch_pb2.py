# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: patch.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bpatch.proto\x12\x08ytpu.api\"M\n\rPatchLocation\x12\x10\n\x08position\x18\x01 \x01(\x04\x12\x12\n\ntotal_size\x18\x02 \x01(\x04\x12\x16\n\x0esuffix_to_keep\x18\x03 \x01(\x0c\"N\n\x0ePatchLocations\x12\x10\n\x08\x66ile_key\x18\x01 \x01(\t\x12*\n\tlocations\x18\x02 \x03(\x0b\x32\x17.ytpu.api.PatchLocationb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'patch_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PATCHLOCATION._serialized_start=25
  _PATCHLOCATION._serialized_end=102
  _PATCHLOCATIONS._serialized_start=104
  _PATCHLOCATIONS._serialized_end=182
# @@protoc_insertion_point(module_scope)

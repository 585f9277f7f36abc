# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cache.proto
# (pure-python build: yadcc_tpu.api.build_protos --pure)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()



DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bcache.proto\x12\x08ytpu.api"q\n\x17FetchBloomFilterRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12%\n\x1dseconds_since_last_full_fetch\x18\x02 \x01(\r\x12 \n\x18seconds_since_last_fetch\x18\x03 \x01(\r"a\n\x18FetchBloomFilterResponse\x12\x13\n\x0bincremental\x18\x01 \x01(\x08\x12\x1c\n\x14newly_populated_keys\x18\x02 \x03(\t\x12\x12\n\nnum_hashes\x18\x03 \x01(\r"0\n\x12TryGetEntryRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t"\x15\n\x13TryGetEntryResponse"-\n\x0fPutEntryRequest\x12\r\n\x05token\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t"\x12\n\x10PutEntryResponse*\xa0\x01\n\x0bCacheStatus\x12\x13\n\x0fCACHE_STATUS_OK\x10\x00\x12\x1b\n\x16CACHE_STATUS_NOT_FOUND\x10\xe9\x07\x12\x1f\n\x1aCACHE_STATUS_ACCESS_DENIED\x10\xea\x07\x12"\n\x1dCACHE_STATUS_INVALID_ARGUMENT\x10\xeb\x07\x12\x1a\n\x15CACHE_STATUS_NO_QUOTA\x10\xec\x072\xf8\x01\n\x0cCacheService\x12Y\n\x10FetchBloomFilter\x12!.ytpu.api.FetchBloomFilterRequest\x1a".ytpu.api.FetchBloomFilterResponse\x12J\n\x0bTryGetEntry\x12\x1c.ytpu.api.TryGetEntryRequest\x1a\x1d.ytpu.api.TryGetEntryResponse\x12A\n\x08PutEntry\x12\x19.ytpu.api.PutEntryRequest\x1a\x1a.ytpu.api.PutEntryResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cache_pb2', globals())
# @@protoc_insertion_point(module_scope)

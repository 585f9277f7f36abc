"""Regenerate the checked-in protobuf Python modules.

Run from the repo root:  python -m yadcc_tpu_torch.api.build_protos

The generated ``*_pb2.py`` files under ``yadcc_tpu_torch/api/gen/`` are
committed so importing the package never requires protoc at runtime;
this script exists to refresh them after editing the ``.proto`` sources.
The wire is byte-identical to the JAX package's by design: the same
``.proto`` texts give the same modules, byte for byte, including the
pure build's header line below, which names the reference package's
generator so that both trees commit one form.

``--pure`` regenerates from a descriptor table built with the protobuf
runtime itself (descriptor_pb2 → serialized FileDescriptorProto →
standard ``AddSerializedFile`` module), for boxes without a protoc
binary.  Only files listed in ``PURE_BUILDERS`` are pure-buildable —
each new proto added this way declares its messages in Python once,
here, and the wire format is identical to a protoc build (the
serialized descriptor fully determines it).
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

API_DIR = pathlib.Path(__file__).resolve().parent
PROTO_DIR = API_DIR / "protos"
GEN_DIR = API_DIR / "gen"

PROTOS = [
    "env_desc.proto",
    "patch.proto",
    "extra_info.proto",
    "scheduler.proto",
    "daemon.proto",
    "cache.proto",
    "local.proto",
    "jit.proto",
    "fanout.proto",
]


# -- pure-python generation (no protoc) ------------------------------------

# Field-type shorthand for _msg(): (proto type enum, label) pairs.
_SCALARS = {
    "string": 9,   # TYPE_STRING
    "bytes": 12,   # TYPE_BYTES
    "int32": 5,    # TYPE_INT32
    "uint32": 13,  # TYPE_UINT32
    "uint64": 4,   # TYPE_UINT64
    "bool": 8,     # TYPE_BOOL
}


def _msg(fd, name: str, *fields):
    """Append message ``name`` with ``(fname, number, type[, opts])``
    fields to FileDescriptorProto ``fd``.  ``type`` is a _SCALARS key,
    ``.ytpu.api.X`` for a message reference, or ``enum:.ytpu.api.X``
    for an enum reference; opts may include ``repeated``."""
    m = fd.message_type.add(name=name)
    for spec in fields:
        fname, number, ftype = spec[:3]
        repeated = "repeated" in spec[3:]
        f = m.field.add(name=fname, number=number,
                        label=3 if repeated else 1)  # REPEATED / OPTIONAL
        if ftype.startswith("enum:"):
            f.type = 14  # TYPE_ENUM
            f.type_name = ftype[len("enum:"):]
        elif ftype.startswith("."):
            f.type = 11  # TYPE_MESSAGE
            f.type_name = ftype
        else:
            f.type = _SCALARS[ftype]
    return m


def _enum(fd, name: str, *values):
    """Append top-level enum ``name`` with ``(vname, number)`` values."""
    e = fd.enum_type.add(name=name)
    for vname, number in values:
        e.value.add(name=vname, number=number)
    return e


def _service(fd, name: str, *methods):
    """Append service ``name`` with ``(mname, in_type, out_type)``
    methods (full type names).  Kept for descriptor fidelity with the
    protoc build; nothing dispatches through it at runtime (services
    are routed by name strings in rpc/)."""
    s = fd.service.add(name=name)
    for mname, in_type, out_type in methods:
        s.method.add(name=mname, input_type=in_type, output_type=out_type)
    return s


def _env_desc_descriptor():
    """env_desc.proto as a FileDescriptorProto — pure-maintained since
    the tenancy ``tenant_scope`` field was added on a box without
    protoc.  MUST stay field-for-field identical to protos/
    env_desc.proto (the human-readable source of truth)."""
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(
        name="env_desc.proto", package="ytpu.api", syntax="proto3")
    _msg(fd, "EnvironmentDesc",
         ("compiler_digest", 1, "string"),
         # Tenant cache-domain secret set by the delegate daemon, so
         # servant-side cache fills land in the submitting tenant's
         # namespace (tenancy/keys.py); empty = legacy shared domain.
         ("tenant_scope", 2, "string"))
    return fd


def _jit_descriptor():
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(
        name="jit.proto", package="ytpu.api", syntax="proto3",
        dependency=["env_desc.proto"])
    _msg(fd, "SubmitJitTaskRequest",
         ("requestor_process_id", 1, "int32"),
         ("computation_digest", 2, "string"),
         ("compile_options", 3, "bytes"),
         ("backend", 4, "string"),
         ("jaxlib_version", 5, "string"),
         ("cache_control", 6, "int32"))
    _msg(fd, "SubmitJitTaskResponse", ("task_id", 1, "uint64"))
    _msg(fd, "WaitForJitTaskRequest",
         ("task_id", 1, "uint64"),
         ("milliseconds_to_wait", 2, "uint32"))
    _msg(fd, "WaitForJitTaskResponse",
         ("exit_code", 1, "int32"),
         ("output", 2, "string"),
         ("error", 3, "string"),
         ("artifact_keys", 4, "string", "repeated"))
    _msg(fd, "JitCacheGetRequest", ("key", 1, "string"))
    _msg(fd, "JitCacheGetResponse")
    _msg(fd, "JitCachePutRequest", ("key", 1, "string"))
    _msg(fd, "JitCachePutResponse")
    _msg(fd, "QueueJitCompilationTaskRequest",
         ("token", 1, "string"),
         ("task_grant_id", 2, "uint64"),
         ("env_desc", 3, ".ytpu.api.EnvironmentDesc"),
         ("computation_digest", 4, "string"),
         ("compile_options", 5, "bytes"),
         ("backend", 6, "string"),
         ("compression_algorithm", 7, "uint32"),
         ("disallow_cache_fill", 8, "bool"))
    _msg(fd, "QueueJitCompilationTaskResponse", ("task_id", 1, "uint64"))
    return fd


def _scheduler_descriptor():
    """scheduler.proto as a FileDescriptorProto — pure-maintained since
    the overload-ladder flow-control fields were added on a box without
    protoc.  MUST stay field-for-field identical to protos/
    scheduler.proto (the human-readable source of truth)."""
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(
        name="scheduler.proto", package="ytpu.api", syntax="proto3",
        dependency=["env_desc.proto"])
    _enum(fd, "SchedulerStatus",
          ("SCHEDULER_STATUS_OK", 0),
          ("SCHEDULER_STATUS_NO_QUOTA_AVAILABLE", 1001),
          ("SCHEDULER_STATUS_NOT_IMPLEMENTED", 1002),
          ("SCHEDULER_STATUS_ACCESS_DENIED", 1003),
          ("SCHEDULER_STATUS_INVALID_ARGUMENT", 1004),
          ("SCHEDULER_STATUS_VERSION_TOO_OLD", 1005),
          ("SCHEDULER_STATUS_ENVIRONMENT_NOT_AVAILABLE", 1006))
    _enum(fd, "ServantPriority",
          ("SERVANT_PRIORITY_UNKNOWN", 0),
          ("SERVANT_PRIORITY_DEDICATED", 1),
          ("SERVANT_PRIORITY_USER", 2))
    _enum(fd, "NotAcceptingTaskReason",
          ("NOT_ACCEPTING_TASK_REASON_NONE", 0),
          ("NOT_ACCEPTING_TASK_REASON_USER_INSTRUCTED", 1),
          ("NOT_ACCEPTING_TASK_REASON_POOR_MACHINE", 2),
          ("NOT_ACCEPTING_TASK_REASON_CGROUPS_PRESENT", 3),
          ("NOT_ACCEPTING_TASK_REASON_BEHIND_NAT", 4),
          ("NOT_ACCEPTING_TASK_REASON_NOT_VERIFIED", 100))
    _enum(fd, "StartingTaskReason",
          ("STARTING_TASK_REASON_UNKNOWN", 0),
          ("STARTING_TASK_REASON_NORMAL", 1),
          ("STARTING_TASK_REASON_PREFETCH", 2))
    # Overload-ladder verdicts on the grant path (doc/robustness.md):
    # the scheduler's explicit alternative to silently granting nothing.
    _enum(fd, "FlowControlVerdict",
          ("FLOW_CONTROL_NONE", 0),
          ("FLOW_CONTROL_COMPILE_LOCALLY", 1),
          ("FLOW_CONTROL_REJECT", 2))
    _msg(fd, "RunningTask",
         ("servant_task_id", 1, "uint64"),
         ("task_grant_id", 2, "uint64"),
         ("servant_location", 3, "string"),
         ("task_digest", 4, "string"))
    _msg(fd, "HeartbeatRequest",
         ("token", 1, "string"),
         ("next_heartbeat_in_ms", 2, "uint32"),
         ("version", 3, "uint32"),
         ("location", 4, "string"),
         ("num_processors", 5, "uint32"),
         ("current_load", 6, "uint32"),
         ("priority", 7, "enum:.ytpu.api.ServantPriority"),
         ("not_accepting_task_reason", 8, "uint32"),
         ("capacity", 9, "uint32"),
         ("total_memory_in_bytes", 10, "uint64"),
         ("memory_available_in_bytes", 11, "uint64"),
         ("env_descs", 12, ".ytpu.api.EnvironmentDesc", "repeated"),
         ("running_tasks", 13, ".ytpu.api.RunningTask", "repeated"))
    _msg(fd, "HeartbeatResponse",
         ("acceptable_tokens", 1, "string", "repeated"),
         ("expired_tasks", 2, "uint64", "repeated"),
         # Sharded control plane (scheduler/shard_router.py): the
         # servant's owning shard, + the redirect endpoint reserved for
         # multi-process shard deployments.
         ("shard_id", 3, "uint32"),
         ("shard_redirect", 4, "string"))
    _msg(fd, "GetConfigRequest", ("token", 1, "string"))
    _msg(fd, "GetConfigResponse", ("serving_daemon_token", 1, "string"))
    _msg(fd, "StartingTaskGrant",
         ("task_grant_id", 1, "uint64"),
         ("servant_location", 2, "string"),
         # Owning (issuing) shard; `stolen` marks grants pulled through
         # the cross-shard steal channel (shard_id is then the donor).
         ("shard_id", 3, "uint32"),
         ("stolen", 4, "bool"),
         # Multi-cell federation (scheduler/federation.py): the cell
         # whose dispatcher owns this grant; `spilled` marks grants
         # forwarded to a peer cell by the SPILLOVER admission rung.
         ("cell_id", 5, "uint32"),
         ("spilled", 6, "bool"))
    _msg(fd, "WaitForStartingTaskRequest",
         ("token", 1, "string"),
         ("milliseconds_to_wait", 2, "uint32"),
         ("env_desc", 3, ".ytpu.api.EnvironmentDesc"),
         ("immediate_reqs", 4, "uint32"),
         ("prefetch_reqs", 5, "uint32"),
         ("next_keep_alive_in_ms", 6, "uint32"),
         ("min_version", 7, "uint32"),
         # Multi-tenant QoS (doc/tenancy.md): the submitting tenant's
         # HMAC credential ("ytpu-tn1.<id>.<mac>").  Verified
         # fail-closed by SchedulerService when tenancy is enabled;
         # empty on untenanted deployments.
         ("tenant_credential", 8, "string"))
    _msg(fd, "WaitForStartingTaskResponse",
         ("grants", 1, ".ytpu.api.StartingTaskGrant", "repeated"),
         ("flow_control", 2, "uint32"),
         ("retry_after_ms", 3, "uint32"),
         ("degradation_rung", 4, "uint32"),
         # Home shard that served the request + how many of `grants`
         # were stolen from donors on its behalf.
         ("shard_id", 5, "uint32"),
         ("stolen_grants", 6, "uint32"),
         # Home cell that served the request + how many of `grants`
         # were spilled to peer cells on its behalf.
         ("cell_id", 7, "uint32"),
         ("spilled_grants", 8, "uint32"))
    _msg(fd, "KeepTaskAliveRequest",
         ("token", 1, "string"),
         ("task_grant_ids", 2, "uint64", "repeated"),
         ("next_keep_alive_in_ms", 3, "uint32"))
    _msg(fd, "KeepTaskAliveResponse",
         ("statuses", 1, "bool", "repeated"))
    _msg(fd, "FreeTaskRequest",
         ("token", 1, "string"),
         ("task_grant_ids", 2, "uint64", "repeated"))
    _msg(fd, "FreeTaskResponse")
    _msg(fd, "GetRunningTasksRequest")
    _msg(fd, "GetRunningTasksResponse",
         ("running_tasks", 1, ".ytpu.api.RunningTask", "repeated"))
    # Warm-standby replication (scheduler/replication.py): the active
    # scheduler streams its lease journal to a standby.  Entries are a
    # JSON-encoded batch (the journal is Python-dict-shaped and
    # schema-fluid; the envelope, not the entries, is the wire
    # contract).  A non-empty snapshot_json replaces the standby's
    # whole state before the entries are applied.
    _msg(fd, "ReplicateRequest",
         ("token", 1, "string"),
         ("first_seq", 2, "uint64"),
         ("entries_json", 3, "bytes"),
         ("snapshot_json", 4, "bytes"),
         ("snapshot_seq", 5, "uint64"))
    _msg(fd, "ReplicateResponse",
         ("acked_seq", 1, "uint64"))
    _service(fd, "SchedulerService",
             ("Heartbeat", ".ytpu.api.HeartbeatRequest",
              ".ytpu.api.HeartbeatResponse"),
             ("GetConfig", ".ytpu.api.GetConfigRequest",
              ".ytpu.api.GetConfigResponse"),
             ("WaitForStartingTask", ".ytpu.api.WaitForStartingTaskRequest",
              ".ytpu.api.WaitForStartingTaskResponse"),
             ("KeepTaskAlive", ".ytpu.api.KeepTaskAliveRequest",
              ".ytpu.api.KeepTaskAliveResponse"),
             ("FreeTask", ".ytpu.api.FreeTaskRequest",
              ".ytpu.api.FreeTaskResponse"),
             ("GetRunningTasks", ".ytpu.api.GetRunningTasksRequest",
              ".ytpu.api.GetRunningTasksResponse"))
    _service(fd, "ReplicationService",
             ("Replicate", ".ytpu.api.ReplicateRequest",
              ".ytpu.api.ReplicateResponse"))
    return fd


def _cache_descriptor():
    """cache.proto as a FileDescriptorProto; pure-maintained since the
    tenant cache-quota status was added on a box without protoc.  MUST
    stay field-for-field identical to protos/cache.proto (the
    human-readable source of truth; lint's wire-drift rule checks)."""
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(
        name="cache.proto", package="ytpu.api", syntax="proto3")
    _enum(fd, "CacheStatus",
          ("CACHE_STATUS_OK", 0),
          ("CACHE_STATUS_NOT_FOUND", 1001),
          ("CACHE_STATUS_ACCESS_DENIED", 1002),
          ("CACHE_STATUS_INVALID_ARGUMENT", 1003),
          # Tenant cache-bytes budget exhausted (doc/tenancy.md).
          ("CACHE_STATUS_NO_QUOTA", 1004))
    _msg(fd, "FetchBloomFilterRequest",
         ("token", 1, "string"),
         ("seconds_since_last_full_fetch", 2, "uint32"),
         ("seconds_since_last_fetch", 3, "uint32"))
    _msg(fd, "FetchBloomFilterResponse",
         ("incremental", 1, "bool"),
         ("newly_populated_keys", 2, "string", "repeated"),
         ("num_hashes", 3, "uint32"))
    _msg(fd, "TryGetEntryRequest",
         ("token", 1, "string"),
         ("key", 2, "string"))
    _msg(fd, "TryGetEntryResponse")
    _msg(fd, "PutEntryRequest",
         ("token", 1, "string"),
         ("key", 2, "string"))
    _msg(fd, "PutEntryResponse")
    _service(fd, "CacheService",
             ("FetchBloomFilter", ".ytpu.api.FetchBloomFilterRequest",
              ".ytpu.api.FetchBloomFilterResponse"),
             ("TryGetEntry", ".ytpu.api.TryGetEntryRequest",
              ".ytpu.api.TryGetEntryResponse"),
             ("PutEntry", ".ytpu.api.PutEntryRequest",
              ".ytpu.api.PutEntryResponse"))
    return fd


def _fanout_descriptor():
    """fanout.proto (workloads 3 & 4: AOT multi-topology builds and
    autotune sweeps) as a FileDescriptorProto.  MUST stay
    field-for-field identical to protos/fanout.proto (the
    human-readable source of truth; lint's wire-drift rule checks)."""
    from google.protobuf import descriptor_pb2

    fd = descriptor_pb2.FileDescriptorProto(
        name="fanout.proto", package="ytpu.api", syntax="proto3",
        dependency=["env_desc.proto"])
    _msg(fd, "AotTopologySpec",
         ("mesh_shape", 1, "uint32", "repeated"),
         ("device_count", 2, "uint32"),
         ("compile_options", 3, "bytes"))
    _msg(fd, "SubmitAotTaskRequest",
         ("requestor_process_id", 1, "int32"),
         ("computation_digest", 2, "string"),
         ("backend", 3, "string"),
         ("jaxlib_version", 4, "string"),
         ("cache_control", 5, "int32"),
         ("topologies", 6, ".ytpu.api.AotTopologySpec", "repeated"))
    _msg(fd, "WaitForAotTaskRequest",
         ("task_id", 1, "uint64"),
         ("milliseconds_to_wait", 2, "uint32"))
    _msg(fd, "FanoutChildVerdict",
         ("child_key", 1, "string"),
         ("status", 2, "string"),
         ("exit_code", 3, "int32"),
         ("attempts", 4, "uint32"),
         ("error", 5, "string"))
    _msg(fd, "WaitForAotTaskResponse",
         ("exit_code", 1, "int32"),
         ("output", 2, "string"),
         ("error", 3, "string"),
         ("artifact_keys", 4, "string", "repeated"),
         ("verdicts", 5, ".ytpu.api.FanoutChildVerdict", "repeated"))
    _msg(fd, "SubmitAutotuneTaskRequest",
         ("requestor_process_id", 1, "int32"),
         ("kernel_digest", 2, "string"),
         ("backend", 3, "string"),
         ("jaxlib_version", 4, "string"),
         ("cache_control", 5, "int32"),
         ("configs", 6, "string", "repeated"),
         ("fanout_width", 7, "uint32"))
    _msg(fd, "WaitForAutotuneTaskRequest",
         ("task_id", 1, "uint64"),
         ("milliseconds_to_wait", 2, "uint32"))
    _msg(fd, "WaitForAutotuneTaskResponse",
         ("exit_code", 1, "int32"),
         ("output", 2, "string"),
         ("error", 3, "string"),
         ("winner_config_json", 4, "string"),
         ("artifact_keys", 5, "string", "repeated"),
         ("verdicts", 6, ".ytpu.api.FanoutChildVerdict", "repeated"))
    _msg(fd, "QueueAotCompilationTaskRequest",
         ("token", 1, "string"),
         ("task_grant_id", 2, "uint64"),
         ("env_desc", 3, ".ytpu.api.EnvironmentDesc"),
         ("computation_digest", 4, "string"),
         ("backend", 5, "string"),
         ("compression_algorithm", 6, "uint32"),
         ("disallow_cache_fill", 7, "bool"),
         ("topology", 8, ".ytpu.api.AotTopologySpec"))
    _msg(fd, "QueueAotCompilationTaskResponse", ("task_id", 1, "uint64"))
    _msg(fd, "QueueAutotuneTaskRequest",
         ("token", 1, "string"),
         ("task_grant_id", 2, "uint64"),
         ("env_desc", 3, ".ytpu.api.EnvironmentDesc"),
         ("kernel_digest", 4, "string"),
         ("backend", 5, "string"),
         ("compression_algorithm", 6, "uint32"),
         ("disallow_cache_fill", 7, "bool"),
         ("configs", 8, "string", "repeated"))
    _msg(fd, "QueueAutotuneTaskResponse", ("task_id", 1, "uint64"))
    return fd


PURE_BUILDERS = {"env_desc.proto": _env_desc_descriptor,
                 "jit.proto": _jit_descriptor,
                 "scheduler.proto": _scheduler_descriptor,
                 "cache.proto": _cache_descriptor,
                 "fanout.proto": _fanout_descriptor}

_PURE_TEMPLATE = '''\
# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: {source}
# (pure-python build: yadcc_tpu.api.build_protos --pure)
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()

{imports}

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({blob!r})

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, {module!r}, globals())
# @@protoc_insertion_point(module_scope)
'''


def _render_pure(name: str) -> str:
    fd = PURE_BUILDERS[name]()
    stem = name[:-len(".proto")]
    imports = "\n".join(
        "from . import {0}_pb2 as {1}__pb2".format(
            d[:-len(".proto")], d[:-len(".proto")].replace("_", "__"))
        for d in fd.dependency)
    return _PURE_TEMPLATE.format(
        source=name, imports=imports, blob=fd.SerializeToString(),
        module=f"{stem}_pb2")


def build_pure(proto_names=None, gen_dir=None) -> None:
    """Generate ``gen/*_pb2.py`` for PURE_BUILDERS entries without
    protoc.  Emitted modules match protoc's runtime shape exactly: the
    descriptor pool consumes the same serialized FileDescriptorProto a
    protoc build would embed."""
    gen_dir = pathlib.Path(gen_dir or GEN_DIR)
    for name in proto_names or PURE_BUILDERS:
        stem = name[:-len(".proto")]
        out = gen_dir / f"{stem}_pb2.py"
        out.write_text(_render_pure(name))
        print(f"pure-generated {out}")


def check_pure(proto_names=None, gen_dir=None) -> int:
    """Byte-idempotence gate: the committed gen modules
    for pure-maintained protos must equal what --pure would emit right
    now, so descriptor drift fails lint instead of shipping.  Returns
    a process exit code (0 clean, 1 drift)."""
    gen_dir = pathlib.Path(gen_dir or GEN_DIR)
    drift = 0
    for name in proto_names or PURE_BUILDERS:
        stem = name[:-len(".proto")]
        out = gen_dir / f"{stem}_pb2.py"
        want = _render_pure(name)
        have = out.read_text() if out.exists() else ""
        if have != want:
            print(f"DRIFT: {out} does not match the pure build of "
                  f"{name} (run python -m yadcc_tpu_torch.api.build_protos "
                  f"--pure)", file=sys.stderr)
            drift = 1
        else:
            print(f"ok: {out.name} is byte-identical to the pure build")
    return drift


def build(gen_dir=None) -> None:
    """protoc over every proto into ``gen_dir`` (default: the committed
    ``gen/``), then the pure builds over their protoc output."""
    gen_dir = pathlib.Path(gen_dir or GEN_DIR)
    gen_dir.mkdir(exist_ok=True)
    (gen_dir / "__init__.py").write_text("")
    cmd = [
        "protoc",
        f"-I{PROTO_DIR}",
        f"--python_out={gen_dir}",
        *[str(PROTO_DIR / p) for p in PROTOS],
    ]
    subprocess.run(cmd, check=True)
    # protoc emits absolute imports (``import patch_pb2``); rewrite them to
    # package-relative so the modules work from inside the gen package.
    for py in gen_dir.glob("*_pb2.py"):
        src = py.read_text()
        src = re.sub(
            r"^import (\w+_pb2) as",
            r"from . import \1 as",
            src,
            flags=re.MULTILINE,
        )
        py.write_text(src)
    # Pure-maintained protos have ONE canonical generated form (the
    # pure build): re-emit them last so a protoc box and a protoc-less
    # box commit byte-identical gen/ modules.
    build_pure(gen_dir=gen_dir)
    print(f"generated {len(PROTOS)} modules into {gen_dir}")


if __name__ == "__main__":
    flags = set(a for a in sys.argv[1:] if a.startswith("--"))
    names = [a for a in sys.argv[1:] if not a.startswith("--")] or None
    if "--check" in flags:
        sys.exit(check_pure(names))
    if "--pure" in flags:
        sys.exit(build_pure(names))
    sys.exit(build())

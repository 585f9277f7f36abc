"""Protocol version ledger (a copy of the JAX package's
yadcc_tpu/version.py; the scheduler gates servants on this number).

Parity with reference yadcc/daemon/common_flags.cc:41-63: a monotonically
increasing integer, checked by the scheduler (--min_daemon_version) and
carried in heartbeats, gates protocol-incompatible daemons out of the
pool.  Both packages speak one wire protocol, so they carry one number.

History:
  1: the initial wire protocol.
  2: cache_control=2 carries Refill semantics end to end (daemon.proto
     disable_cache_fill / local.proto cache-control tri-state) and
     local.proto's ignore-timestamp-macros knob joins the task
     submission surface.
"""

VERSION_FOR_UPGRADE = 2

# Human-readable build stamp served by /local/get_version.
BUILT_AT = "yadcc-tpu dev"

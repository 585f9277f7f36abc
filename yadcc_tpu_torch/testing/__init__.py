"""In-process cluster rigs for tests and tools: the port's scheduler,
cache server, N servant daemons and delegates inside a single process on
ephemeral loopback ports (testing/local_cluster.py), used by the port's
tests and by tools/cluster_sim.py's sweeps and connection storm; the
multi-cell federation rig with a warm standby on one cell
(testing/federated_cluster.py), used by tools/scenarios.py's cell-kill
scenario; and the interleaving explorer of the exactly-once lease path
(testing/interleave.py, imported by name: it is not re-exported here)."""

from .federated_cluster import FederatedCluster  # noqa: F401
from .local_cluster import LocalCluster, make_fake_compiler  # noqa: F401

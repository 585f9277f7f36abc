"""In-process cluster rig for tests: the port's scheduler, cache server,
N servant daemons and one delegate inside a single process on ephemeral
loopback ports."""

from .local_cluster import LocalCluster, make_fake_compiler  # noqa: F401

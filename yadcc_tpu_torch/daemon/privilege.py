"""Privilege dropping (a copy of the JAX package's
yadcc_tpu/daemon/privilege.py).

Parity with reference yadcc/daemon/privilege.cc:27-45 (distcc-inspired):
a daemon started as root must not run compiler subprocesses as root —
drop to the first of ytpu/daemon/nobody that exists before serving.
"""

from __future__ import annotations

import os

from ..utils.logging import get_logger

logger = get_logger("daemon.privilege")

_CANDIDATE_USERS = ("ytpu", "daemon", "nobody")


def drop_privileges() -> None:
    if os.name != "posix" or os.geteuid() != 0:
        return
    import pwd

    for name in _CANDIDATE_USERS:
        try:
            entry = pwd.getpwnam(name)
        except KeyError:
            continue
        os.setgid(entry.pw_gid)
        os.setgroups([entry.pw_gid])
        os.setuid(entry.pw_uid)
        logger.info("dropped privileges to %s (uid %d)", name, entry.pw_uid)
        return
    raise RuntimeError(
        "refusing to serve as root: no unprivileged user available "
        f"(tried {_CANDIDATE_USERS})")

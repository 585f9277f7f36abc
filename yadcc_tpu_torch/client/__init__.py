"""The compiler-masquerading client (a copy of the JAX package's
yadcc_tpu/client/, trimmed to the C++ workload).

Installed as a symlink named ``g++`` (or ``gcc``, ``clang++``) early on
``PATH``, or run as ``python -m yadcc_tpu_torch.client.yadcc_cxx g++
...``: it preprocesses a TU locally under the daemon's quota, submits it
to the daemon's loopback HTTP API (``YTPU_DAEMON_PORT``), long-polls for
the result and writes the outputs where the build expects them, falling
back to a local compile where the cloud cannot help.  It loads no torch,
no jax and nothing of the JAX package: a wrapper runs once a TU."""

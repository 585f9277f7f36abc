"""Quota-only wrapper for non-distributable toolchains (a copy of the JAX
package's yadcc_tpu/client/universal_wrapper.py).

Parity with reference yadcc/client/wrapper/universal_wrapper.cc:29-57
and yadcc/doc/wrapper.md:5-15: tools like javac/jar can't be distributed
but still deserve the daemon's machine-wide concurrency governance —
acquire quota, run the real binary from PATH, release.  Run it as
`python -m yadcc_tpu_torch.client.universal_wrapper javac ...`.
"""

from __future__ import annotations

import os
import sys

from .command import pass_through_to_program
from .task_quota import task_quota
from .yadcc_cxx import find_real_compiler


def entry(argv) -> int:
    real = find_real_compiler(argv[0])
    if real is None:
        print(f"ytpu-wrapper: {argv[0]}: not found", file=sys.stderr)
        return 127
    with task_quota(lightweight=False):
        return pass_through_to_program([real] + list(argv[1:]))


def main() -> None:
    invoked = os.path.basename(sys.argv[0])
    argv = sys.argv[1:] if invoked in (
        "universal_wrapper.py", "ytpu-wrapper", "__main__.py"
    ) and len(sys.argv) > 1 else [invoked] + sys.argv[1:]
    sys.exit(entry(argv))


if __name__ == "__main__":
    main()

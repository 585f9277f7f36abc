"""The exchange buffer of the team-mode kernels (csrc/team_exchange.cuh).

A team launch of K1, K2 or the filter-sharded Bloom kernels is one
launch a card, one block a slice; the slices agree on every cross-slice
step (a bisect total, a tie split, a task's least key) through ONE
buffer in mapped pinned host memory that every card reaches, with or
without peer access: the same code path on one card as on several.

Each launch takes the next epoch from its TeamExchange, so a slot's
generation number ((epoch << 32) | round) is never seen twice, and a
chained stream launch reuses the buffer with no reset.  The first word
is the error word: a kernel whose wait for another slice runs out of
its clock-cycle budget writes a code there and leaves, and so does every
slice that then sees the code.  The wrappers raise on it (``check``) at
their next call, and the callers after their readback.  ``check`` waits
for the team's cards, clears the word and marks every launch issued so
far void before it raises, so a fault fails the calls that see it and
the exchange serves the next launch.

The buffer is allocated by the kernel library that launches on it
(``yadcc_team_alloc``, cudaHostAlloc mapped and portable) and freed
with the object.
"""

from __future__ import annotations

import ctypes
import threading

# The layout of csrc/team_exchange.cuh.
MAX_SLICES = 64
SLOT_WORDS = 4
HEADER_WORDS = 8
BUFFER_WORDS = HEADER_WORDS + 2 * 2 * MAX_SLICES * SLOT_WORDS
# A wait that spins this many clock cycles (a few seconds on an H100)
# gives up and reports ERR_SPIN.
SPIN_LIMIT_CYCLES = 1 << 33
ERR_SPIN = 1


class TeamExchange:
    """One exchange buffer and its launch epochs.  Launches that share
    one must be ordered (one policy's launches on its streams); two
    concurrent users need two."""

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch = 0
        # Launches up to this epoch ran while the error word was set.
        self._void_through = 0
        self._ptr = None
        self._lib = None

    def buffer(self, lib: ctypes.CDLL) -> int:
        """The buffer's address (host and device alike), allocated on
        first use through ``lib``'s allocator."""
        with self._lock:
            if self._ptr is None:
                lib.yadcc_team_alloc.argtypes = [ctypes.c_longlong]
                lib.yadcc_team_alloc.restype = ctypes.c_void_p
                lib.yadcc_team_free.argtypes = [ctypes.c_void_p]
                ptr = lib.yadcc_team_alloc(BUFFER_WORDS * 8)
                if not ptr:
                    raise RuntimeError("team exchange: cudaHostAlloc of "
                                       "the exchange buffer failed")
                self._ptr, self._lib = ptr, lib
            return self._ptr

    def next_epoch(self) -> int:
        with self._lock:
            self._epoch += 1
            return self._epoch

    @property
    def epoch(self) -> int:
        """The epoch of the last launch issued on the buffer."""
        return self._epoch

    def error(self) -> int:
        """The error word (0: no fault), read from host memory: no sync
        with any card.  A kernel still running may set it later."""
        if self._ptr is None:
            return 0
        return ctypes.c_uint64.from_address(self._ptr).value

    def check(self, devices=(), epoch=None) -> None:
        """Raise if a wait ran out, or if the launch of ``epoch`` (0: no
        launch on the card) ran while one had.  On a fault it first waits
        for ``devices`` (the team's cards: every block of the faulted
        launches leaves within about one bound), then clears the error
        word and marks every launch issued so far void, so the next
        launch runs clean."""
        err = self.error()
        if err:
            import torch

            for dev in {torch.device(d) for d in devices}:
                if dev.type == "cuda":
                    # The faulted launches end before the word clears.
                    torch.cuda.synchronize(dev)
            with self._lock:
                self._void_through = self._epoch
                ctypes.c_uint64.from_address(self._ptr).value = 0
            raise RuntimeError(
                f"team exchange: a slice's wait ran out ({err}): a slice "
                f"never reached the step the others waited at; the "
                f"outputs of every launch in flight are not valid")
        if epoch and epoch <= self._void_through:
            raise RuntimeError(
                f"team exchange: launch {epoch} ran while a slice's wait "
                f"had run out; its outputs are not valid")

    def __del__(self):
        if self._ptr is not None and self._lib is not None:
            try:
                self._lib.yadcc_team_free(self._ptr)
            except Exception:
                pass

"""Three small helpers of the port held against the JAX package's:
common/compress.py's decompress_iter (over zstd, and over the zlib frames
in a subprocess without the zstd wheel), client/env_options.py's
compress_level, and utils/logging.py's log_every_n_seconds under a fake
clock."""

from __future__ import annotations

import logging
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from yadcc_tpu.client import env_options as jenv
from yadcc_tpu.common import compress as jcompress
from yadcc_tpu.utils import logging as jlog
from yadcc_tpu_torch.client import env_options as tenv
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.utils import logging as tlog

REPO = pathlib.Path(__file__).resolve().parent.parent


class _Sink:
    def __init__(self):
        self.parts = []

    def write(self, data: bytes) -> int:
        self.parts.append(bytes(data))
        return len(data)


def _streamed(mod, data: bytes, writes: int) -> bytes:
    """One streaming frame of ``data`` from ``mod``'s CompressingWriter,
    written in ``writes`` pieces."""
    sink = _Sink()
    w = mod.CompressingWriter(sink)
    for piece in np.array_split(np.frombuffer(data, np.uint8), writes):
        w.write(piece.tobytes())
    w.close()
    return b"".join(sink.parts)


def _chunks(frame: bytes, rng) -> list:
    cuts = sorted(rng.integers(0, len(frame) + 1, int(rng.integers(0, 9))))
    return [frame[a:b] for a, b in zip([0] + cuts, cuts + [len(frame)])]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decompress_iter_equal_on_zstd(seed):
    assert tcompress.zstandard is not None
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 6, int(rng.integers(0, 300_000)),
                        dtype=np.uint8).tobytes()
    for maker in (jcompress, tcompress):
        frame = _streamed(maker, data, int(rng.integers(1, 5)))
        chunks = _chunks(frame, rng)
        assert tcompress.decompress_iter(chunks) == \
            jcompress.decompress_iter(chunks) == data
    one_shot = tcompress.compress(data)
    assert tcompress.decompress_iter(_chunks(one_shot, rng)) == \
        jcompress.decompress_iter(_chunks(one_shot, rng)) == data


def test_decompress_iter_equal_on_zlib_frames_without_the_zstd_wheel():
    """Both packages' zlib stand-in: streaming frames from either writer,
    cut at seeded points, decode equal in both; a bad magic and a corrupt
    body are refused by both; a one-shot frame decodes in the port, as
    it does over zstd (by design: the port's stand-in reuses the
    decompressor that takes either frame kind)."""
    script = textwrap.dedent(r"""
        import sys, zlib
        import numpy as np
        sys.modules["zstandard"] = None
        from yadcc_tpu.common import compress as j
        from yadcc_tpu_torch.common import compress as t
        assert j.zstandard is None and t.zstandard is None

        class Sink:
            def __init__(self):
                self.parts = []
            def write(self, b):
                self.parts.append(bytes(b))
                return len(b)

        def outcome(mod, chunks):
            try:
                return ("ok", mod.decompress_iter(chunks))
            except mod.CompressionError as e:
                return ("error", str(e))

        for seed in range(6):
            rng = np.random.default_rng(seed)
            data = rng.integers(0, 6, int(rng.integers(0, 200_000)),
                                dtype=np.uint8).tobytes()
            for maker in (j, t):
                sink = Sink()
                w = maker.CompressingWriter(sink)
                for piece in np.array_split(np.frombuffer(data, np.uint8),
                                            int(rng.integers(1, 5))):
                    w.write(piece.tobytes())
                w.close()
                frame = b"".join(sink.parts)
                assert frame[:4] == b"YZFS"
                cuts = sorted(rng.integers(0, len(frame) + 1, 6))
                chunks = [frame[a:b] for a, b in
                          zip([0] + cuts, cuts + [len(frame)])]
                assert outcome(t, chunks) == outcome(j, chunks) == \
                    ("ok", data)
        for bad in ([b"YZ", b"XX", b"body"], [b"YZFS", b"not zlib at all"]):
            assert outcome(t, bad)[0] == outcome(j, bad)[0] == "error", bad
        # A one-shot frame: the port's stand-in decodes it, as zstd does
        # in both packages; the JAX package's stand-in refuses it.
        frame = t.compress(b"one-shot " * 999)
        chunks = [frame[:3], frame[3:20], frame[20:]]
        assert outcome(t, chunks) == ("ok", b"one-shot " * 999)
        assert outcome(j, chunks)[0] == "error"
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("raw", [None, "", "1", "5", "19", "22", "0", "-3",
                                 "abc", "7.5"])
def test_compress_level_equal(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("YTPU_COMPRESS_LEVEL", raising=False)
    else:
        monkeypatch.setenv("YTPU_COMPRESS_LEVEL", raw)
    assert tenv.compress_level() == jenv.compress_level() == \
        tcompress.current_level()


def test_compress_level_reports_what_the_compressor_uses(monkeypatch):
    """The JAX package's own case (tests/test_payload.py), on both."""
    data = b"int interop();\n" * 5000
    monkeypatch.setenv("YTPU_COMPRESS_LEVEL", "1")
    fast = tcompress.compress(data)
    monkeypatch.delenv("YTPU_COMPRESS_LEVEL")
    assert tcompress.decompress(fast) == data
    monkeypatch.setenv("YTPU_COMPRESS_LEVEL", "5")
    assert tenv.compress_level() == jenv.compress_level() == \
        tcompress.current_level() == jcompress.current_level() == 5


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelno, record.getMessage()))


def test_log_every_n_seconds_equal_under_a_fake_clock(monkeypatch):
    """A seeded schedule of calls over three keys and two loggers, with n
    of 0.5, 1 and 3 s: both packages emit the same lines."""
    rng = np.random.default_rng(7)
    steps = rng.exponential(0.4, 400)
    keys = rng.integers(0, 3, 400)
    ns = np.array([0.5, 1.0, 3.0])[rng.integers(0, 3, 400)]
    which = rng.integers(0, 2, 400)
    got = []
    for mod in (jlog, tlog):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "_last_emit", {})
        records = _Records()
        loggers = [logging.getLogger(f"ytpu-every-n-{mod.__name__}-{i}")
                   for i in range(2)]
        for lg in loggers:
            lg.addHandler(records)
            lg.setLevel(logging.DEBUG)
            lg.propagate = False
        try:
            for i in range(400):
                clock.now += float(steps[i])
                mod.log_every_n_seconds(
                    loggers[which[i]], logging.WARNING, f"k{keys[i]}",
                    f"line {i}", n=float(ns[i]))
        finally:
            for lg in loggers:
                lg.removeHandler(records)
        got.append(records.lines)
    assert got[0] == got[1]
    assert 0 < len(got[1]) < 400

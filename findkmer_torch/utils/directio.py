"""O_DIRECT spectrum writer.

The port's copy of `findkmer_tpu/utils/directio.py`.  The first write of
a new output file dirties fresh page-cache pages, which is slow on hosts
whose memory is backed lazily; O_DIRECT writes bypass the page cache.

DirectWriter exposes write()/close() like a binary file object:
incoming buffers are staged into a page-aligned MAP_SHARED mmap and
flushed in aligned BLOCK-multiple O_DIRECT writes; the unaligned tail is
written on close() after clearing O_DIRECT via fcntl.  Any O_DIRECT
failure (unsupported filesystem, EINVAL) falls back to buffered writes
transparently.

Opt-out: FINDKMER_DIRECT_OUT=0 (cli._open_out checks it).
"""

from __future__ import annotations

import mmap
import os

BLOCK = 4096
STAGE = 32 << 20  # staging buffer: 32 MiB, one aligned flush unit


class DirectWriter:
    """Binary writer using O_DIRECT with transparent buffered fallback."""

    def __init__(self, path: str):
        self.path = path
        self._direct = True
        try:
            self.fd = os.open(
                path,
                os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_DIRECT,
                0o644,
            )
        except OSError:
            self.fd = os.open(
                path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644
            )
            self._direct = False
        try:
            self._stage = mmap.mmap(
                -1, STAGE, flags=mmap.MAP_SHARED | mmap.MAP_ANONYMOUS
            )
        except BaseException:
            os.close(self.fd)  # don't leak the fd if staging alloc fails
            raise
        self._mv = memoryview(self._stage)
        self._fill = 0
        self._closed = False

    # ------------------------------------------------------------------
    def write(self, buf) -> int:
        mv = memoryview(buf)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        n = len(mv)
        pos = 0
        while pos < n:
            take = min(n - pos, STAGE - self._fill)
            self._mv[self._fill : self._fill + take] = mv[pos : pos + take]
            self._fill += take
            pos += take
            if self._fill == STAGE:
                self._flush_aligned()
        return n

    def _flush_aligned(self):
        """Write the staged bytes down to a BLOCK boundary."""
        aligned = self._fill - (self._fill % BLOCK)
        if aligned == 0:
            return
        self._write_all(self._mv[:aligned])
        rem = self._fill - aligned
        if rem:
            # move the unaligned remainder to the front of the stage
            self._mv[:rem] = self._mv[aligned : self._fill]
        self._fill = rem

    def _write_all(self, mv):
        pos = 0
        while pos < len(mv):
            try:
                pos += os.write(self.fd, mv[pos:])
            except OSError:
                if not self._direct:
                    raise
                self._drop_direct()

    def _drop_direct(self):
        import fcntl

        fcntl.fcntl(
            self.fd, fcntl.F_SETFL,
            fcntl.fcntl(self.fd, fcntl.F_GETFL) & ~os.O_DIRECT,
        )
        self._direct = False

    # ------------------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._flush_aligned()
            if self._fill:
                if self._direct:
                    self._drop_direct()  # tail write needs no alignment
                self._write_all(self._mv[: self._fill])
                self._fill = 0
        finally:
            os.close(self.fd)
            self._mv.release()
            self._stage.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

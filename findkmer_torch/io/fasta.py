"""Streaming multi-record FASTA reader.

The port's copy of `findkmer_tpu/io/fasta.py`: a block-buffered reader
that yields large contiguous byte chunks per record, suitable for
vectorized encoding (io/encode.py) at chromosome scale with bounded
memory.

Semantics:
  * records are delimited by '>' header lines (at line start);
  * sequence bytes are everything on non-header lines; ASCII whitespace
    (incl. newlines) is dropped here: it is neither a base nor a window
    reset;
  * all other byte values (N, IUPAC codes, digits, ...) pass through to the
    encoder, which marks them invalid (window reset).

Headerless files are treated as a single anonymous record.  The hot path is
vectorized: headers are located with bytes.find on rare "\\n>" boundaries and
whitespace is stripped with one numpy mask per multi-MB block.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


def open_maybe_gzip(path_or_file):
    """Open a path as a binary stream, transparently gunzipping.

    Detection is by magic bytes (1f 8b), not extension, so renamed files
    work; already-open file objects pass through (gzip-wrapped when they
    are seekable and carry the magic).  Returns (stream, owns_handle).
    """
    if isinstance(path_or_file, (str, os.PathLike)):
        f = open(path_or_file, "rb")
        own = True
    else:
        f = path_or_file
        own = False
    def _wrap(fh):
        g = gzip.GzipFile(fileobj=fh)
        if own:
            # make close() close the file WE opened (the gzip.open
            # convention: GzipFile only closes `myfileobj`)
            g.myfileobj = fh
        return g

    try:
        if f.seekable():
            head = f.read(2)
            f.seek(-len(head), 1)
            if head == b"\x1f\x8b":
                return _wrap(f), own
        elif f.readable():
            # non-seekable stream (stdin, pipes): consume the magic
            # bytes robustly (a single peek may return < 2 bytes from a
            # dribbling producer) and push them back via a wrapper
            head = b""
            while len(head) < 2:
                b = f.read(2 - len(head))
                if not b:
                    break
                head += b
            g = pushback_stream(head, f)
            return (_wrap(g) if head == b"\x1f\x8b" else g), own
    except (OSError, ValueError):
        pass
    return f, own


class _PushbackRaw(io.RawIOBase):
    """Raw stream serving a consumed prefix, then the wrapped stream."""

    def __init__(self, head: bytes, f):
        self._head = memoryview(bytes(head))
        self._f = f

    def readable(self):
        return True

    def readinto(self, b):
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._f.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self):
        super().close()
        # ownership stays with the caller; do not close the inner stream


def pushback_stream(head: bytes, f) -> io.BufferedReader:
    """Buffered stream that replays `head` before reading from f."""
    return io.BufferedReader(_PushbackRaw(head, f), 1 << 16)

# ASCII whitespace stripped from sequence data (space, tab, CR, LF, VT, FF)
_WS_TABLE = np.zeros(256, dtype=bool)
for _b in (0x20, 0x09, 0x0D, 0x0A, 0x0B, 0x0C):
    _WS_TABLE[_b] = True


@dataclass
class RecordChunk:
    """One chunk of one record's sequence bytes (whitespace already removed)."""

    record_id: int          # 0-based record ordinal in the stream
    header: str             # header line text (without '>'), '' if anonymous
    data: bytes             # raw sequence bytes (may be empty)
    final: bool             # True on the last chunk of this record


def _strip_ws(b: bytes) -> bytes:
    """Remove ASCII whitespace (incl. newlines) from sequence bytes, fast."""
    if not b:
        return b
    arr = np.frombuffer(b, dtype=np.uint8)
    ws = _WS_TABLE[arr]
    if not ws.any():
        return b
    return arr[~ws].tobytes()


class FastaReader:
    """Block-buffered streaming FASTA reader with bounded memory.

    Reads `block_size` bytes at a time; a 248 Mbp chromosome record
    streams in O(block_size) memory.
    """

    def __init__(self, path_or_file, block_size: int = 1 << 22,
                 strip_ws: bool = True):
        self._f, self._own = open_maybe_gzip(path_or_file)
        self.block_size = int(block_size)
        # strip_ws=False leaves whitespace in chunk data for consumers
        # with a fused strip+encode path (io/native.fk_encode_compact)
        self.strip_ws = bool(strip_ws)

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def chunks(self) -> Iterator[RecordChunk]:
        """Yield RecordChunks in stream order.

        Every record — even an empty one — ends with exactly one chunk whose
        final=True, so record boundaries are always observable downstream
        (windows must not span them).
        """
        leftover = b""
        record_id = -1
        header = ""
        started = False
        at_line_start = True  # start-of-file counts as a line start

        def _process(buf: bytes, eof: bool) -> Iterator[RecordChunk]:
            nonlocal record_id, header, started, at_line_start
            pos = 0
            n = len(buf)
            while pos < n:
                is_header = buf[pos] == 0x3E and at_line_start  # '>'
                if is_header:
                    # a header ends at '\n' OR at a lone '\r' (classic-
                    # Mac line endings: without the CR fallback a
                    # CR-only file would re-buffer forever and emit an
                    # empty spectrum).  For CRLF the CR wins; the LF it
                    # leaves behind is whitespace in the sequence region.
                    nl = buf.find(b"\n", pos)
                    # the CR search stops at the LF: searched to the end of
                    # the block, it made a block of short records quadratic
                    cr = buf.find(b"\r", pos, nl if nl >= 0 else n)
                    if cr >= 0:
                        nl = cr
                    if nl < 0:
                        if not eof:
                            raise _NeedMore(pos)
                        nl = n  # header line unterminated at EOF
                    if started:
                        yield RecordChunk(record_id, header, b"", final=True)
                    record_id += 1
                    started = True
                    header = (
                        buf[pos + 1 : nl].decode("ascii", "replace").strip()
                    )
                    pos = nl + 1
                    at_line_start = True
                else:
                    # sequence region: up to the next header start "\n>"
                    # (also "\r>" for lone-CR line endings).  Fast path:
                    # one memchr for '>' — blocks inside a big record
                    # contain none.
                    nxt = -1
                    g = buf.find(b">", pos + 1)
                    while g > 0:
                        if buf[g - 1] in (0x0A, 0x0D):
                            nxt = g - 1
                            break
                        g = buf.find(b">", g + 1)
                    end = n if nxt < 0 else nxt + 1
                    raw = buf[pos:end]
                    data = _strip_ws(raw) if self.strip_ws else raw
                    if not started:
                        # only actual sequence bytes start the anonymous
                        # record — blank/whitespace lines before the first
                        # '>' are not a phantom empty record
                        has_seq = bool(data if self.strip_ws else _strip_ws(raw))
                        if has_seq:
                            record_id += 1
                            started = True
                            header = ""
                    if started and data:
                        yield RecordChunk(record_id, header, data, final=False)
                    if end > pos:
                        at_line_start = buf[end - 1] in (0x0A, 0x0D)
                    pos = end

        class _NeedMore(Exception):
            def __init__(self, pos):
                self.pos = pos

        while True:
            block = self._f.read(self.block_size)
            eof = not block
            buf = leftover + block
            leftover = b""
            if not buf:
                break
            # Hold back a trailing partial header line: header parsing needs
            # the full line.  Sequence data can be emitted immediately.
            try:
                yield from _process(buf, eof)
            except _NeedMore as nm:
                leftover = buf[nm.pos :]
            if eof:
                break

        if started:
            yield RecordChunk(record_id, header, b"", final=True)

    # ------------------------------------------------------------------
    def records(self) -> Iterator[Tuple[str, bytes]]:
        """Materialize whole records (header, sequence).  For small files."""
        header = ""
        parts: List[bytes] = []
        for ch in self.chunks():
            header = ch.header
            if ch.data:
                parts.append(ch.data)
            if ch.final:
                yield header, b"".join(parts)
                parts = []

"""Block checksums of a byte stream: what the sink keeps of every output
the program writes, and what the reference works out of the bytes it
expects.

A stream is cut into blocks of BLOCK bytes (the last one shorter) and each
block gets its own CRC-32.  Blocks are independent, so a pool of threads
can checksum them (zlib releases the GIL), and two streams are compared
block by block: a block whose CRC or length differs is a block that
differs.
"""

from __future__ import annotations

import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, List

BLOCK = 8 << 20
IN_FLIGHT = 16  # blocks handed to the pool and not yet checksummed


@dataclass
class Digest:
    """Length and block CRCs of one stream."""

    nbytes: int = 0
    crcs: List[int] = field(default_factory=list)


class Digester:
    """Feeds pieces of one stream, of any sizes, into BLOCK-byte blocks
    checksummed on `pool`; at most IN_FLIGHT blocks are held at a time."""

    def __init__(self, pool: ThreadPoolExecutor):
        self.pool = pool
        self.out = Digest()
        self.inflight: deque = deque()
        self.pending = bytearray()

    def _submit(self, block) -> None:
        self.inflight.append(self.pool.submit(zlib.crc32, block))
        while len(self.inflight) > IN_FLIGHT:
            self.out.crcs.append(self.inflight.popleft().result())

    def feed(self, piece) -> None:
        mv = memoryview(piece).cast("B")
        self.out.nbytes += len(mv)
        at = 0
        if self.pending:
            take = min(BLOCK - len(self.pending), len(mv))
            self.pending += mv[:take]
            at = take
            if len(self.pending) == BLOCK:
                self._submit(bytes(self.pending))
                self.pending = bytearray()
        while len(mv) - at >= BLOCK:
            self._submit(bytes(mv[at : at + BLOCK]))
            at += BLOCK
        if at < len(mv):
            self.pending += mv[at:]

    def feed_block(self, block: bytes) -> None:
        """A whole block, BLOCK bytes or the stream's last: the sink's path,
        which fills its blocks itself."""
        self.out.nbytes += len(block)
        self._submit(block)

    def finish(self) -> Digest:
        if self.pending:
            self._submit(bytes(self.pending))
            self.pending = bytearray()
        while self.inflight:
            self.out.crcs.append(self.inflight.popleft().result())
        return self.out


def digest_pieces(pieces: Iterable, pool: ThreadPoolExecutor) -> Digest:
    """Digest of a stream given as an iterable of byte-like pieces."""
    d = Digester(pool)
    for piece in pieces:
        d.feed(piece)
    return d.finish()


def blocks_differing(got: Digest, want: Digest) -> int:
    """Blocks of `want` that `got` does not reproduce, plus blocks `got`
    has beyond `want`'s end."""
    n = max(len(got.crcs), len(want.crcs))
    return sum(
        1 for i in range(n)
        if i >= len(got.crcs) or i >= len(want.crcs)
        or got.crcs[i] != want.crcs[i]
    )

"""The sink: named pipes the program writes its outputs into, drained by a
thread of the benchmark that keeps each stream's length and block CRCs
(`blocks.py`) and the time its writer closed it.  Nothing reaches disk.

The program opens each path as it would a file (`_open_out` takes a pipe
through its buffered fallback: O_DIRECT is refused on a pipe), so the
thread opens the pipes in the order the program writes them: `expect`
queues a job's paths; `wait` returns once each has been closed by its
writer.  `abort` ends a job that failed before it wrote them all.
"""

from __future__ import annotations

import fcntl
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

from kmerbench.blocks import BLOCK, IN_FLIGHT, Digest, Digester

PIPE_BYTES = 1 << 20  # a pipe's buffer: the most unprivileged code sets
F_SETPIPE_SZ = getattr(fcntl, "F_SETPIPE_SZ", 1031)


@dataclass
class Stream:
    path: str
    digest: Digest
    t_close: float  # host clock (perf_counter) when the writer closed it


def make_pipe(path: str) -> str:
    if os.path.lexists(path):
        os.unlink(path)
    os.mkfifo(path)
    return path


class Sink:
    def __init__(self, workers: int = 2):
        self.pool = ThreadPoolExecutor(workers)
        self.ring = [bytearray(BLOCK) for _ in range(IN_FLIGHT + 2)]
        self.todo: "queue.Queue[Optional[str]]" = queue.Queue()
        self.done: "queue.Queue[Stream]" = queue.Queue()
        self.current: Optional[str] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _drain(self, path: str) -> Stream:
        fd = os.open(path, os.O_RDONLY)
        try:
            try:
                fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_BYTES)
            except OSError:
                pass
            d = Digester(self.pool)
            # a block is checksummed in place: it is filled again only
            # once the digester has resolved more than IN_FLIGHT later ones
            at, fill = 0, 0
            mv = memoryview(self.ring[0])
            while True:
                n = os.readv(fd, [mv[fill:]])
                if n == 0:
                    break
                fill += n
                if fill == BLOCK:
                    d.feed_block(self.ring[at])
                    at = (at + 1) % len(self.ring)
                    mv, fill = memoryview(self.ring[at]), 0
            t = time.perf_counter()
            if fill:
                d.feed_block(bytes(mv[:fill]))
            return Stream(path, d.finish(), t)
        finally:
            os.close(fd)

    def _run(self) -> None:
        while True:
            path = self.todo.get()
            if path is None:
                return
            self.current = path
            try:
                self.done.put(self._drain(path))
            except OSError:
                self.done.put(Stream(path, Digest(), time.perf_counter()))
            self.current = None

    def expect(self, paths: List[str]) -> None:
        for p in paths:
            self.todo.put(p)

    def wait(self, n: int) -> List[Stream]:
        """The next n streams, each closed by its writer."""
        return [self.done.get() for _ in range(n)]

    def abort(self, n: int) -> List[Stream]:
        """A job failed: open each pipe it left unwritten, as its writer,
        and close it, so the thread sees an end; -> the n streams."""
        got = []
        while len(got) < n:
            try:
                got.append(self.done.get(timeout=0.05))
                continue
            except queue.Empty:
                pass
            path = self.current
            if path is None:
                continue
            try:
                fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
                os.close(fd)
            except OSError:
                pass
        return got

    def close(self) -> None:
        self.todo.put(None)
        self.thread.join()
        self.pool.shutdown()

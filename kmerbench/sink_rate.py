"""The sink's own rate: bytes a second it drains from one pipe and
checksums, with a writer that does nothing else (`os.write` of 32 MiB
pieces of one prepared buffer, as the program writes formatted chunks).

    python3 -m kmerbench.sink_rate [--gib 8] [--workers 3]

Prints one JSON line.  The sink must drain well above the program's
output rate, or it, not the program, would bound a cell.
"""

import argparse
import json
import os
import tempfile
import time

from kmerbench.sink import Sink, make_pipe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmerbench.sink_rate")
    p.add_argument("--gib", type=float, default=8)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 3, 4])
    args = p.parse_args(argv)
    piece = memoryview(os.urandom(1 << 20) * 32)
    total = int(args.gib * 2 ** 30) // len(piece) * len(piece)
    with tempfile.TemporaryDirectory() as d:
        path = make_pipe(os.path.join(d, "out.tsv"))
        rates = {}
        for workers in args.workers:
            sink = Sink(workers)
            sink.expect([path])
            t0 = time.perf_counter()
            fd = os.open(path, os.O_WRONLY)
            for _ in range(total // len(piece)):
                os.write(fd, piece)
            os.close(fd)
            got = sink.wait(1)[0]
            dt = time.perf_counter() - t0
            sink.close()
            assert got.digest.nbytes == total
            rates[workers] = total / dt
    print(json.dumps({"sink_bytes_per_s_by_workers": rates, "bytes": total,
                      "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The control of a cell: the plain reference put in the program's place,
computed through its configuration's control (`reference/kmers.py`:
"fingerprint32", "count16"), and held by the benchmark's own comparison to
the exact reference.  It has to come out not correct: its numbers are the
upper readings the limits are set below.

    python3 -m kmerbench.control --workload <cell> --seeds <n> [<n> ...]

generates the cell's input of each seed at the cell's size, as a run
does, and prints one JSON line a seed with each number compared, and
whether the run's rule would call it correct.  The benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

from kmerbench import gen, harness


def readings(cell: harness.Cell, seed: int, device: str,
             params: dict = None) -> dict:
    tmp = tempfile.mkdtemp(prefix="kmerbench.control.")
    try:
        made = gen.load(cell.traffic["generator"]).generate(
            tmp, seed, params or cell.traffic["params"])
        want = harness.expected(cell, made["inputs"], device)
        got = harness.expected(cell, made["inputs"], device,
                               cell.config["control"])
        compared = harness.compare([got], want)
    finally:
        gen.common.release()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"seed": seed, "variant": cell.config["control"],
            "compared": compared,
            "correct": all(compared[k] <= harness.LIMITS[k]
                           for k in harness.LIMITS)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmerbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

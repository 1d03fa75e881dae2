"""The benchmark's command:

    python3 -m kmerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, the
last of standard output, and the numbers compared with their limits as
the last lines of standard error.  Exits 3 without as many CUDA cards as
the cell asks for, 4 when jax, jaxlib, flax or findkmer_tpu was loaded,
and with another code than 0 when the program cannot be run; no result is
printed then.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, before imports

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmerbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from kmerbench import harness

    cell = harness.load_cell(args.workload)
    # the program's build caches: a fixed directory of this checkout
    os.environ["FINDKMER_TORCH_CACHE"] = str(harness.CACHE)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"kmerbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), torch sees {have}", file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"kmerbench: loaded in this process: {', '.join(banned)}",
              file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

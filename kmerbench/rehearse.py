"""A rehearsal of a cell on the CPU at the size the tests use:

    python3 -m kmerbench.rehearse --workload <cell> --seed 0 --seconds 2 --trace 1

The whole run (generator, the program through its CLI with --device cpu,
sink, spans, the reference, the comparison) at each generator's `tiny`
parameters.  It prints what the run compared and the host-clock readings
under "rehearsal"; no device metric, and never the benchmark's result
line: numbers from the CPU say nothing of the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmerbench.rehearse")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=2)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from kmerbench import gen, harness

    cell = harness.load_cell(args.workload)
    params = gen.load(cell.traffic["generator"]).tiny(cell.traffic["params"])
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START, harness.Options(device="cpu",
                                                  params=params))
    print(json.dumps({"correct": result["correct"],
                      "attempted": result["attempted"],
                      "failed": result["failed"],
                      "rehearsal": {k: v["value"] for k, v
                                    in result["metrics"].items()},
                      "compared": result["compared"]}))
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())

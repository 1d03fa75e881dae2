"""kmerbench: the end-to-end benchmark of `findkmer_torch` on one card.

    python3 -m kmerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json names a configuration (`configs/<config>.json`) and a
traffic mix (`traffic/<traffic>.json`); the mix names its generator
(`gen/<generator>.py`) and its plain reference (`reference/<kind>.py`);
each per-layer metric is read by `metrics/<metric>.py`.  Nothing here
imports jax or the JAX package, and `reference/` imports nothing of
`findkmer_torch`.
"""

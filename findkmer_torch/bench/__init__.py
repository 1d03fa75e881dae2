"""`findkmer-torch bench`: the quick on-device throughput check.

The port's own copy of what the JAX package's `findkmer bench` reaches in
the repository's root `bench` package (`steps.py`: the staged dense and
sparse steps, and the end-to-end count of a file; `quick.py`: the
subcommand and its `--phases` run), over the port's counter, and of the
repository's `bench.py` (`driver.py`: its five metrics, `python -m
findkmer_torch.bench.driver`).  It imports neither jax nor that package: an
installed port has no repository root.
"""

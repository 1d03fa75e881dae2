"""`histo`'s recount on its two routes: the count-of-counts binned on the
device (`pipeline.count_file(..., histo_max=)` -> `KmerCounter.finalize(
..., histo_max=)` -> C3, whose plain version runs here on the CPU) and the
spectrum pulled and binned on the host (`api.Spectrum.histo`).

Each case runs one argv through the JAX package's CLI (`findkmer_tpu`,
whose `Spectrum.histo` is the reference), the port's CLI as it routes
itself, and the port's CLI with the host route forced
(`pipeline.histo_on_device` false), and compares the three outputs byte
for byte; it also checks which route ran.  The input holds singletons,
a motif seen ~60 times whose codes land in several store rows, and a
poly-A run whose k-mer is seen more than 10,000 times, so every clip
below the default and the default itself have counts above them.  A
traced run checks the route's counter and spans.
"""

import shlex
import time

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import cli as jax_cli
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.utils import prof
from oracle.scalar import count_fasta_file

torch.set_num_threads(1)  # six test workers share the cores

GEOM = "--chunk-len 64 --batch-rows 2 --sparse-compact-entries 256"


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Random sequence with N calls (mostly singletons), a 57-base motif
    60 times, a poly-A run of 10,100 bases inside random sequence."""
    rng = np.random.default_rng(21)
    motif = random_dna(rng, 57)
    recs = [random_dna(rng, 3000, n_prob=0.01), motif * 60,
            random_dna(rng, 800) + "A" * 10100 + random_dna(rng, 300),
            motif[:40]]
    path = tmp_path_factory.mktemp("histo") / "reads.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(path)


@pytest.fixture(scope="module")
def dedup(reads):
    """Options under which the store's per-row distinct counts pass
    --sparse-capacity while the true distinct count does not: the
    cross-row dedup runs."""
    n = len(count_fasta_file(reads, 21, canonical=True))
    return f"{GEOM} --sparse-capacity {n + 3}"


# (name, options, the route that must run: "device" or "host")
CASES = [
    ("k21c_dedup_m5", "-k 21 --canonical {dedup} --max-count 5", "device"),
    ("k21c_dedup_default", "-k 21 --canonical {dedup}", "device"),
    ("k21c_m1", "-k 21 --canonical {geom} --max-count 1", "device"),
    ("k21c_m3_nonzero", "-k 21 --canonical {geom} --max-count 3 "
     "--nonzero-only", "device"),
    ("k21_nonzero", "-k 21 {geom} --nonzero-only", "device"),
    ("k8_dense", "-k 8 {geom}", "device"),
    ("k8_dense_m3_nonzero", "-k 8 {geom} --max-count 3 --nonzero-only",
     "device"),
    ("k11_direct_int64", "-k 11 --table-mode direct --count-dtype int64 "
     "{geom} --max-count 50", "device"),
    ("k21c_spill", "-k 21 --canonical {geom} --sparse-capacity 1024 "
     "--spill {o}/spill", "host"),
    ("k21c_devices2", "-k 21 --canonical {geom} --devices 2", "host"),
    ("k21c_m0", "-k 21 --canonical {geom} --max-count 0", "host"),
]


def _run(main, reads, opts, out, extra=()):
    out.mkdir()
    argv = (["histo", "-i", reads, "-o", str(out / "h.txt")]
            + shlex.split(opts.format(o=out)) + list(extra))
    assert main(argv) == 0
    return (out / "h.txt").read_bytes()


@pytest.mark.parametrize("name,opts,route", CASES, ids=[c[0] for c in CASES])
def test_histo_routes_vs_jax(reads, dedup, tmp_path, monkeypatch, name,
                             opts, route):
    opts = opts.replace("{dedup}", dedup).replace("{geom}", GEOM)
    want = _run(jax_cli.main, reads, opts, tmp_path / "jax")
    ran = []
    on_card = KmerCounter._finalize_histo
    monkeypatch.setattr(KmerCounter, "_finalize_histo",
                        lambda *a: ran.append("device") or on_card(*a))
    deduped = []
    dedup_state = KmerCounter._dedup_state
    monkeypatch.setattr(KmerCounter, "_dedup_state",
                        lambda *a: deduped.append(1) or dedup_state(*a))
    got = _run(torch_cli.main, reads, opts, tmp_path / "port",
               ["--device", "cpu"])
    assert ran == ([route] if route == "device" else [])
    if "dedup" in name:
        assert deduped, "the cross-row dedup did not run"
    monkeypatch.setattr(pipeline, "histo_on_device", lambda *a: False)
    host = _run(torch_cli.main, reads, opts, tmp_path / "host",
                ["--device", "cpu"])
    assert ran == ([route] if route == "device" else [])
    assert got == want and host == want
    assert want or "--max-count 0" in opts
    if "--max-count" not in opts:  # the default clip, with a count past it
        assert want.splitlines()[-1].split(b"\t")[0] == b"10000"
        assert want.splitlines()[-1].split(b"\t")[1] != b"0"


@pytest.mark.parametrize("k", [21, 8])
def test_histo_route_counter_and_spans(reads, tmp_path, k):
    """`histo_on_card` counts the entries C3 binned once (the distinct
    count on the sparse route, 4^k on the dense one); no spectrum entry
    is pulled; `finalize/histo` and `finalize/assemble` nest in
    `finalize`."""
    t0 = time.perf_counter()
    with prof.collecting(prof.PhaseTimers()):
        assert torch_cli.main(
            ["histo", "-i", reads, "-k", str(k), "--canonical",
             "-o", str(tmp_path / "h.txt"), "--device", "cpu"]
            + GEOM.split()) == 0
    recs = prof.snapshot().records
    spans = [r for r in recs if isinstance(r, prof.SpanRecord)
             and r.t0 >= t0]
    counts = [r for r in recs if isinstance(r, prof.CountRecord)
              and r.t >= t0]
    want = (len(count_fasta_file(reads, k, canonical=True)) if k > 10
            else 4 ** k)
    assert [c.value for c in counts if c.name == "histo_on_card"] == [want]
    assert not any(c.name == "entries_pulled" for c in counts)
    (fin,) = [s for s in spans if s.name == "finalize"]
    for name in ("finalize/histo", "finalize/assemble"):
        (inner,) = [s for s in spans if s.name == name]
        assert inner.thread == fin.thread
        assert fin.t0 <= inner.t0 and inner.t1 <= fin.t1
    assert not any(s.name in ("finalize/d2h", "finalize/table")
                   for s in spans)


def test_finalize_histo_refuses_a_spilling_counter(reads, tmp_path):
    """A counter with a spill directory has no device spectrum to bin:
    `finalize(histo_max=)` says so, and `histo` takes the host route for
    it."""
    from findkmer_torch import Config

    cfg = Config(k=21, canonical=True, spill_dir=str(tmp_path / "spill"),
                 sparse_capacity=1024, chunk_len=64, batch_rows=2,
                 sparse_compact_entries=256)
    counter, state = pipeline.run_count(reads, cfg, torch.device("cpu"))
    assert not pipeline.histo_on_device(cfg, torch.device("cpu"), 10000)
    with pytest.raises(ValueError, match="unspilled"):
        counter.finalize(state, histo_max=10000)

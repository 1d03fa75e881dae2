"""The dense route above the histogram kernels' k (`cli.SPARSE_CEILING`).

`count` of one combined spectrum, in auto mode, takes the dense 4^k
table instead of the sparse store where both the input's bytes and 4^k
pass the store's ceiling and k <= 15: at the ceiling 2^28 = 4^14 that is
k = 15 over inputs of more than 2^28 bytes, the deployment whose distinct
15-mers would overflow the store.  Its finalize compacts the table to its
nonzero bins on the device, slice by slice, and streams them to the
writer as the sparse finalize streams its chunks.  Here:

  * the route rule at the real ceiling, over sparse files of the sizes
    around it (nothing is counted), and the flags that keep the store;
  * with the ceiling lowered, the commands that keep the store: a
    spectrum a sample or a record (`count --per-input`, `--per-record`,
    `matrix -k`), `histo` and `stream`;
  * with the ceiling lowered, the dense route at k = 11 and 12 on the CPU
    (tables of 16 and 64 MiB), on a seeded genome with repeats, N runs,
    lowercase and several records: byte for byte the sparse route's
    output and the oracle's (`oracle/scalar.py`), canonical and not,
    under --min-count and --max-count, and with the table's slices and
    the pulled chunks made small, so that there are many of each;
  * the spans and counters the route adds, under the tracer:
    `finalize/table` (the compaction and pull of each slice),
    `write/threshold`, and the counters `entries_pulled` (the nonzero
    bins, as many as the sparse route's distinct entries) and
    `entries_written`.

The card's step (C1 and one `index_add_`) is held to the plain chain in
`tests/test_torch_dense_scatter_cuda.py`.
"""

import os
import time

import numpy as np
import pytest
import torch

from findkmer_torch import cli
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.utils import prof
from oracle.scalar import count_fasta_file, spectrum_lines

torch.set_num_threads(1)  # six test workers share the cores

LOW = 1 << 16  # the lowered ceiling: the genome below passes it
GENOME_BYTES = 120_000


def _genome(path, seed=11):
    """Random records (GC 42%) with a diverged 300-base repeat in 60
    copies on either strand, a 50-copy tandem array, N runs and
    soft-masked letters: about GENOME_BYTES bytes."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    p = [0.29, 0.21, 0.21, 0.29]
    seq = acgt[rng.choice(4, GENOME_BYTES - 4000, p=p)]
    unit = acgt[rng.choice(4, 300, p=p)]
    for at in rng.integers(0, seq.size - 300, 60):
        copy = unit.copy()
        hit = rng.random(300) < 0.02
        copy[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
        if rng.random() < 0.5:
            copy = np.frombuffer(bytes(copy[::-1]).translate(
                bytes.maketrans(b"ACGT", b"TGCA")), np.uint8)
        seq[at : at + 300] = copy | 0x20
    mono = acgt[rng.choice(4, 60, p=p)]
    at = int(rng.integers(0, seq.size - 3000))
    seq[at : at + 3000] = np.tile(mono, 50)
    for at in rng.integers(0, seq.size - 500, 6):
        seq[at : at + int(rng.integers(1, 500))] = ord("N")
    cuts = np.sort(rng.integers(0, seq.size, 3))
    with open(path, "wb") as f:
        for i, rec in enumerate(np.split(seq, cuts)):
            f.write(f">rec{i}\n".encode())
            for s in range(0, rec.size, 70):
                f.write(rec[s : s + 70].tobytes() + b"\n")


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k15dense") / "genome.fa")
    _genome(path)
    assert os.path.getsize(path) > LOW
    return path


def _cfg(argv, path):
    """The Config `count` of one combined spectrum makes."""
    args = cli.build_parser().parse_args(["count", "-i", path] + argv)
    return cli._cfg_from_args(args, dense_past_ceiling=True)


@pytest.fixture(scope="module")
def sized(tmp_path_factory):
    """Sparse files of the sizes around the ceiling: no disk is used."""
    d = tmp_path_factory.mktemp("sized")

    def make(n):
        path = str(d / f"{n}.fa")
        with open(path, "wb") as f:
            f.truncate(n)
        return path

    return make


OVER, AT = cli.SPARSE_CEILING + 1, cli.SPARSE_CEILING
ROUTES = [
    ("k15_over", ["-k", "15", "--canonical"], OVER, "direct"),
    ("k15_at", ["-k", "15", "--canonical"], AT, "sparse"),
    ("k15_small", ["-k", "15"], 1000, "sparse"),
    ("k14_over", ["-k", "14"], OVER, "sparse"),
    ("k13_over", ["-k", "13", "--canonical"], OVER, "sparse"),
    ("k16_over", ["-k", "16"], OVER, "sparse"),
    ("k21_over", ["-k", "21", "--canonical"], OVER, "sparse"),
    ("k10_over", ["-k", "10"], OVER, "direct"),
    ("k15_over_table_mode_sparse", ["-k", "15", "--table-mode", "sparse"],
     OVER, "sparse"),
    ("k15_over_sparse_capacity", ["-k", "15", "--sparse-capacity",
                                  str(1 << 29)], OVER, "sparse"),
    ("k15_over_spill", ["-k", "15", "--spill", "runs"], OVER, "sparse"),
    ("k15_small_table_mode_direct", ["-k", "15", "--table-mode", "direct"],
     1000, "direct"),
]


@pytest.mark.parametrize("argv,size,want", [r[1:] for r in ROUTES],
                         ids=[r[0] for r in ROUTES])
def test_the_route_rule(sized, argv, size, want):
    cfg = _cfg(argv, sized(size))
    assert cfg.resolved_table_mode == want
    if want == "sparse" and "--sparse-capacity" not in argv:
        assert cfg.sparse_capacity <= cli.SPARSE_CEILING


@pytest.mark.parametrize("k,size,want", [
    (11, LOW + 1, "direct"), (11, LOW, "sparse"), (12, LOW + 1, "direct"),
    (7, LOW + 1, "direct"), (16, LOW + 1, "sparse"),
])
def test_the_route_follows_the_ceiling(sized, monkeypatch, k, size, want):
    monkeypatch.setattr(cli, "SPARSE_CEILING", LOW)
    assert _cfg(["-k", str(k)], sized(size)).resolved_table_mode == want


def _table_modes(monkeypatch):
    """The table mode of every single-device counter made from now on."""
    modes = []
    init = counter_mod.KmerCounter.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        modes.append(self.mode)

    monkeypatch.setattr(counter_mod.KmerCounter, "__init__", spy)
    return modes


KEEP_STORE = {
    "count": (["count"], "direct"),
    "count_per_input": (["count", "--per-input"], "sparse"),
    "count_per_record": (["count", "--per-record"], "sparse"),
    "matrix": (["matrix"], "sparse"),
    "histo": (["histo"], "sparse"),
    "stream": (["stream"], "sparse"),
}


@pytest.mark.parametrize("case", sorted(KEEP_STORE))
def test_only_one_combined_count_takes_the_table(genome, tmp_path,
                                                 monkeypatch, case):
    """A spectrum a sample or a record keeps a store sized for it, and
    `histo` / `stream` keep the store, whatever the bytes of the call."""
    head, want = KEEP_STORE[case]
    monkeypatch.setattr(cli, "SPARSE_CEILING", LOW)
    modes = _table_modes(monkeypatch)
    out = tmp_path / ("out" if case == "count_per_input" else "out.tsv")
    assert cli.main(head + ["-i", genome, genome, "-k", "11", "-o", str(out),
                            "--device", "cpu"]) == 0
    assert modes and set(modes) == {want}


def _count(path, out, argv):
    assert cli.main(["count", "-i", path, "-o", str(out), "--device", "cpu"]
                    + argv) == 0
    return out.read_bytes()


_ORACLE = {}


def _oracle(path, k, canonical, lo, hi):
    key = (k, canonical)
    if key not in _ORACLE:
        _ORACLE[key] = count_fasta_file(path, k, canonical=canonical)
    counts = {m: c for m, c in _ORACLE[key].items()
              if c >= lo and (not hi or c <= hi)}
    lines = spectrum_lines(counts, k)
    return ("\n".join(lines) + "\n" if lines else "").encode()


THRESHOLDS = {
    "min1": (["--min-count", "1"], 1, 0),
    "min2": (["--min-count", "2"], 2, 0),
    "min_high": (["--min-count", "20"], 20, 0),
    "max3": (["--max-count", "3"], 0, 3),
    "min2_max40": (["--min-count", "2", "--max-count", "40"], 2, 40),
}


@pytest.mark.parametrize("thr", sorted(THRESHOLDS))
@pytest.mark.parametrize("canonical", [False, True],
                         ids=["forward", "canonical"])
@pytest.mark.parametrize("k", [11, 12])
def test_dense_route_equals_sparse_route_and_oracle(genome, tmp_path,
                                                    monkeypatch, k,
                                                    canonical, thr):
    flags, lo, hi = THRESHOLDS[thr]
    argv = ["-k", str(k)] + (["--canonical"] if canonical else []) + flags
    monkeypatch.setattr(cli, "SPARSE_CEILING", LOW)
    assert _cfg(argv, genome).resolved_table_mode == "direct"
    dense = _count(genome, tmp_path / "dense.tsv", argv)
    sparse = _count(genome, tmp_path / "sparse.tsv",
                    argv + ["--table-mode", "sparse"])
    assert dense == sparse == _oracle(genome, k, canonical, lo, hi)
    if thr == "min_high":
        assert 0 < dense.count(b"\n") < 1000  # the repeats' k-mers alone


def test_dense_finalize_over_many_slices_and_chunks(genome, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(cli, "SPARSE_CEILING", LOW)
    monkeypatch.setattr(counter_mod, "TABLE_SLICE", 1 << 12)
    monkeypatch.setattr(counter_mod, "FINALIZE_CHUNK", 97)
    argv = ["-k", "12", "--canonical", "--min-count", "2"]
    assert _count(genome, tmp_path / "o.tsv", argv) == _oracle(
        genome, 12, True, 2, 0)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k, zeros", [(10, False), (11, False), (11, True)])
def test_zeros_and_small_k_keep_the_whole_table(genome, monkeypatch, k,
                                                zeros, canonical):
    """A dense table's finalize_chunks, at the histogram kernels' k and
    above it: the nonzero bins of finalize in code order, or with --zeros
    every bin of the table; small slices and chunks, so that there are
    many of each."""
    from findkmer_torch import pipeline
    from findkmer_torch.config import Config

    monkeypatch.setattr(counter_mod, "TABLE_SLICE", 1 << 12)
    monkeypatch.setattr(counter_mod, "FINALIZE_CHUNK", 97)
    cfg = Config(k=k, canonical=canonical, zeros=zeros, table_mode="direct",
                 chunk_len=4096, batch_rows=8)
    counter, state = pipeline.run_count(genome, cfg, torch.device("cpu"))
    table = counter.finalize(state)
    chunks = [(c.copy(), n.copy()) for c, n in counter.finalize_chunks(state)]
    assert len(chunks) > 1
    codes = np.concatenate([c for c, _ in chunks])
    counts = np.concatenate([n for _, n in chunks])
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    want = (np.arange(table.size) if zeros else np.flatnonzero(table))
    np.testing.assert_array_equal(codes, want.astype(np.uint64))
    np.testing.assert_array_equal(counts, table[want])
    assert zeros or counts.min() > 0


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_the_spans_and_counters_of_the_route(genome, tmp_path, monkeypatch,
                                             route):
    monkeypatch.setattr(cli, "SPARSE_CEILING", LOW)
    argv = ["-k", "11", "--canonical", "--min-count", "2"]
    if route == "sparse":
        argv += ["--table-mode", "sparse"]
    t0 = time.perf_counter()
    with prof.collecting(prof.PhaseTimers()):
        out = _count(genome, tmp_path / "o.tsv", argv)
    recs = [r for r in prof.snapshot().records
            if (r.t0 if isinstance(r, prof.SpanRecord) else r.t) >= t0]
    spans = [r for r in recs if isinstance(r, prof.SpanRecord)]
    counts = {}
    for r in recs:
        if isinstance(r, prof.CountRecord):
            counts[r.name] = counts.get(r.name, 0) + r.value
    names = [s.name for s in spans]
    assert counts["entries_written"] == out.count(b"\n") > 0
    distinct = len(_ORACLE.get((11, True)) or count_fasta_file(
        genome, 11, canonical=True))
    assert counts["entries_pulled"] == distinct
    assert names.count("write/threshold") >= 1
    tables = [s for s in spans if s.name == "finalize/table"]
    if route == "dense":
        assert len(tables) >= 2  # the slice's compaction, its chunk's pull
        for table in tables:
            assert any(s.name == "finalize" and s.t0 <= table.t0
                       and table.t1 <= s.t1 for s in spans)
    else:
        assert not tables
    for t in (s for s in spans if s.name == "write/threshold"):
        assert any(s.name == "write" and s.t0 <= t.t0 and t.t1 <= s.t1
                   for s in spans)

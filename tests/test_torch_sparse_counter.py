"""The sparse counter of the PyTorch port vs the JAX sparse counter.

`findkmer_torch.pipeline.count_file` on the CPU against
`findkmer_tpu.pipeline.count_file` on the same numpy-seeded FASTA, at a
multi-batch geometry with compactions forced by a small
sparse_compact_entries, at every k of the sparse list, forward and
canonical.  Spectra are (codes, counts) integers: equality is exact.
int64 counts are held to the oracle, not to a JAX int64 counter (that
would switch jax into x64 mode for the whole test process).
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_tpu.ops.window import str_to_code
from findkmer_torch import Config
from findkmer_torch import pipeline
from findkmer_torch.models.counter import KmerCounter, make_counter
from findkmer_torch.table import SparseTable
from oracle.scalar import count_fasta_file

torch.set_num_threads(1)  # six test workers share the cores


def _jax(cfg):
    """The JAX package's Config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))
CPU = torch.device("cpu")
SPARSE_KS = [11, 15, 16, 21, 23, 24, 28, 29, 31]
# 4 x 128 windows a batch; the raw buffer holds 4096 slots (the ladder
# floor), so a compaction runs about every eight batches
GEOM = dict(chunk_len=128, batch_rows=4, sparse_compact_entries=1024,
            sparse_capacity=1 << 16)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three records with N runs, lowercase and IUPAC codes, a poly-T
    run of 45 (codes whose low 32 bits are all ones at k >= 16), ~11
    kbase: two compactions or more before the finalize's at GEOM."""
    rng = np.random.default_rng(11)
    recs = [
        random_dna(rng, n, n_prob=0.02, lower_prob=0.1, iupac_prob=0.01)
        for n in (6000, 37, 5000)
    ]
    recs[0] = recs[0][:700] + "T" * 45 + recs[0][700:]
    path = tmp_path_factory.mktemp("fa") / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(path)


@pytest.fixture(scope="module")
def repeats(tmp_path_factory):
    """Repeat-heavy input: a 57-base motif 60 times, so most codes land
    in several store rows."""
    rng = np.random.default_rng(3)
    motif = random_dna(rng, 57)
    path = tmp_path_factory.mktemp("fa") / "rep.fa"
    path.write_text(">rep\n" + motif * 60 + "\n>tail\n" + motif[:40] + "\n")
    return str(path)


def _oracle(path, k, canonical=False):
    items = sorted(count_fasta_file(path, k, canonical=canonical).items())
    return (np.array([str_to_code(m) for m, _ in items], np.uint64),
            np.array([n for _, n in items], np.int64))


def _assert_spectrum(got, want):
    codes, counts = got
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    np.testing.assert_array_equal(codes, np.asarray(want[0], np.uint64))
    np.testing.assert_array_equal(counts, np.asarray(want[1], np.int64))


@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", SPARSE_KS)
def test_sparse_count_file_vs_jax(fasta, k, canonical):
    cfg = Config(k=k, canonical=canonical, **GEOM)
    assert cfg.resolved_table_mode == "sparse"
    want = jax_pipeline.count_file(fasta, _jax(cfg))
    counter, state = pipeline.run_count(fasta, cfg, CPU)
    # a count-carrying compaction ran before the finalize: its store has
    # more columns than the raw buffer's share of a row
    assert state.store_len > state.raw.shape[0] // counter._rows
    got = counter.finalize(state)
    _assert_spectrum(got, want)
    _assert_spectrum(got, _oracle(fasta, k, canonical))


@pytest.mark.parametrize("row_sort", ["auto", "kernel", "plain"])
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_sparse_counter_steps_vs_jax(fasta, packed, row_sort):
    """Counter interface by hand: raw and packed batches, every row-sort
    choice (on the CPU all of them run the plain sort), finalize_chunks
    concatenating to finalize, table_state restoring into a new counter."""
    cfg = Config(k=21, canonical=True, packed_h2d=packed, **GEOM)
    want = jax_pipeline.count_file(fasta, _jax(cfg))
    counter = KmerCounter(cfg, CPU, row_sort=row_sort)
    assert counter._plain_sort == (row_sort != "kernel")
    state = counter.init_state()
    batches = list(pipeline.batches_from_file(fasta, cfg))
    for b in batches[:3]:
        state = counter.step(state, counter.put_batch(b))
    state, table = counter.table_state(state)
    assert isinstance(table, SparseTable)
    resumed = KmerCounter(cfg, CPU, row_sort=row_sort)
    rstate = resumed.restore_state(table)
    for b in batches[3:]:
        state = counter.step(state, counter.put_batch(b))
        rstate = resumed.step(rstate, resumed.put_batch(b))
    full = counter.finalize(state)
    _assert_spectrum(full, want)
    _assert_spectrum(resumed.finalize(rstate), want)
    chunks = [(c.copy(), n.copy()) for c, n in counter.finalize_chunks(state)]
    _assert_spectrum((np.concatenate([c for c, _ in chunks]),
                      np.concatenate([n for _, n in chunks])), want)


def test_finalize_chunks_split(fasta, monkeypatch):
    cfg = Config(k=17, **GEOM)
    counter, state = pipeline.run_count(fasta, cfg, CPU)
    want = counter.finalize(state)
    monkeypatch.setenv("FINDKMER_FINALIZE_CHUNKS", "5")
    chunks = [(c.copy(), n.copy()) for c, n in counter.finalize_chunks(state)]
    assert len(chunks) == 5
    _assert_spectrum((np.concatenate([c for c, _ in chunks]),
                      np.concatenate([n for _, n in chunks])), want)


@pytest.mark.parametrize("k", [13, 21])
def test_dedup_path_vs_jax(repeats, k):
    """The row sum of distinct counts passes sparse_capacity on repeat-
    heavy input while the true distinct count does not: the cross-row
    dedup folds the duplicates and the count goes on, as in JAX."""
    n_distinct = len(count_fasta_file(repeats, k))
    cfg = Config(k=k, chunk_len=64, batch_rows=2, sparse_compact_entries=256,
                 sparse_capacity=n_distinct + 3)
    want = jax_pipeline.count_file(repeats, _jax(cfg))
    counter = make_counter(cfg, CPU)
    calls = []
    dedup = counter._dedup_state
    counter._dedup_state = lambda st: calls.append(1) or dedup(st)
    state = counter.init_state()
    for b in pipeline.batches_from_file(repeats, cfg):
        state = counter.step(state, counter.put_batch(b))
    got = counter.finalize(state)
    assert calls, "the dedup path did not run"
    _assert_spectrum(got, want)
    _assert_spectrum(got, _oracle(repeats, k))


def test_capacity_error_text_matches_jax(fasta):
    cfg = Config(k=19, **dict(GEOM, sparse_capacity=300))
    with pytest.raises(RuntimeError) as jerr:
        jax_pipeline.count_file(fasta, _jax(cfg))
    with pytest.raises(RuntimeError) as terr:
        pipeline.count_file(fasta, cfg, CPU)
    assert "sparse_capacity" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


def test_int64_counts_vs_oracle(fasta):
    """int64 counts past 2^33, carried in through restore_state."""
    k = 21
    cfg = Config(k=k, count_dtype="int64", **GEOM)
    want_codes, want_counts = _oracle(fasta, k)
    base = (1 << 33) + 5
    table = SparseTable(
        codes=torch.from_numpy(want_codes[::2].astype(np.int64)),
        counts=torch.full((want_codes[::2].size,), base, dtype=torch.int64),
        k=k)
    counter = make_counter(cfg, CPU)
    state = counter.restore_state(table)
    assert state.store[1].dtype == torch.int64
    for b in pipeline.batches_from_file(fasta, cfg):
        state = counter.step(state, counter.put_batch(b))
    expect = want_counts.copy()
    expect[::2] += base
    _assert_spectrum(counter.finalize(state), (want_codes, expect))
    fresh = pipeline.count_file(fasta, cfg, CPU)
    _assert_spectrum(fresh, (want_codes, want_counts))


@pytest.mark.parametrize("k", [16, 21, 31])
def test_poly_t_record(tmp_path, k):
    """A record of 50 T's: one k-mer, all ones (the JAX lo = 0xFFFFFFFF
    trap), counted, never taken for an empty slot."""
    path = tmp_path / "t.fa"
    path.write_text(">t\n" + "T" * 50 + "\n>a\nACGT\n")
    cfg = Config(k=k, **GEOM)
    got = pipeline.count_file(str(path), cfg, CPU)
    _assert_spectrum(got, (np.array([4 ** k - 1]), np.array([50 - k + 1])))
    _assert_spectrum(got, jax_pipeline.count_file(str(path), _jax(cfg)))


@pytest.mark.parametrize("k, canonical", [(13, False), (21, True),
                                          (24, False)])
def test_jax_table_carried_into_the_port(fasta, k, canonical):
    """Count the first half of the batches with the JAX counter, carry its
    sparse table into the port with restore_state, finish there."""
    cfg = Config(k=k, canonical=canonical, **GEOM)
    batches = list(jax_pipeline.batches_from_file(fasta, _jax(cfg)))
    half = len(batches) // 2
    jc = JaxCounter(_jax(cfg))
    jstate = jc.init_state()
    for b in batches[:half]:
        jstate = jc.step(jstate, jc.put_batch(b))
    _, jtable = jc.table_state(jstate)

    tc = KmerCounter(cfg, CPU)
    state = tc.restore_state(jtable)
    assert state.store[0].dtype == (torch.int32 if k <= 15 else torch.int64)
    for b in batches[half:]:
        state = tc.step(state, tc.put_batch(b))
    _assert_spectrum(tc.finalize(state), jax_pipeline.count_file(fasta, _jax(cfg)))


def test_restore_state_checks_k(fasta):
    counter = KmerCounter(Config(k=21, **GEOM), CPU)
    table = SparseTable(codes=torch.zeros(4, dtype=torch.int64),
                        counts=torch.ones(4, dtype=torch.int32), k=20)
    with pytest.raises(ValueError, match="k=20"):
        counter.restore_state(table)


def test_sparse_table_to_host_merges_rows():
    codes = torch.tensor([[3, 7, 9, 2 ** 63 - 1], [1, 3, 9, 9]])
    counts = torch.tensor([[2, 1, 0, 0], [4, 5, 6, 0]], dtype=torch.int32)
    c, n = SparseTable(codes=codes, counts=counts, k=21).to_host()
    assert c.tolist() == [1, 3, 7, 9] and n.tolist() == [4, 7, 1, 6]
    assert SparseTable(codes=codes, counts=counts, k=21).total() == 18


@pytest.mark.parametrize("cfg, err", [
    (Config(k=21, spill_dir="unused"), None),
    (Config(k=21, devices=0), NotImplementedError),
])
def test_sparse_unported_configs_raise(cfg, err, fasta, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if err is not None:
        with pytest.raises(err, match="not yet ported"):
            make_counter(cfg, CPU)
        return
    # the disk spill: under a roomy sparse_capacity nothing spills, the
    # dir holds the stream's token alone, and the count is the oracle's
    cfg = cfg.replace(**GEOM)
    got = pipeline.count_file(fasta, cfg, CPU)
    _assert_spectrum(got, _oracle(fasta, 21))
    assert [p.name for p in (tmp_path / "unused").iterdir()] == \
        ["stream.token"]


def test_row_sort_choice_checked():
    with pytest.raises(ValueError, match="row_sort"):
        KmerCounter(Config(k=21), CPU, row_sort="bitonic")


@pytest.mark.cuda
@pytest.mark.parametrize("k, canonical", [(13, False), (21, True)])
def test_sparse_count_on_card_vs_cpu(fasta, k, canonical):
    """The CUDA path end to end: every compaction's row sort is a kernel
    launch, and the spectrum equals the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows_cuda

    cfg = Config(k=k, canonical=canonical, **GEOM)
    want = pipeline.count_file(fasta, cfg, CPU)
    before = sort_rows_cuda.launches
    got = pipeline.count_file(fasta, cfg, torch.device("cuda"))
    assert sort_rows_cuda.launches - before >= 3  # two mid-run + finalize
    _assert_spectrum(got, want)
    plain = pipeline.count_file(fasta, cfg, torch.device("cuda"),
                                row_sort="plain")
    _assert_spectrum(plain, want)

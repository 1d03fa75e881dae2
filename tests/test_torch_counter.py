"""The dense counter and pipeline of the PyTorch port vs the JAX package.

`findkmer_torch.pipeline.count_file` on the CPU runs against
`findkmer_tpu.pipeline.count_file` with hist="pallas" (the Pallas kernel
in interpret mode) on the same numpy-seeded FASTA, at a multi-batch
geometry.  Counts are integers: equality is exact.  int64 counts are
held to the oracle, not to a JAX int64 counter (that would switch jax
into x64 mode for the whole test process).
"""

import threading

import jax.numpy as jnp
import dataclasses

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_torch import Config
from findkmer_torch import pipeline
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.models.counter import KmerCounter, make_counter
from findkmer_torch.table import DenseTable
from oracle.scalar import count_fasta_file

torch.set_num_threads(1)  # six test workers share the cores


def _jax(cfg):
    """The JAX package's Config with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))
CPU = torch.device("cpu")
GEOM = dict(chunk_len=128, batch_rows=4)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three records with N runs, lowercase and IUPAC codes, ~2.6 kbase:
    several batches at GEOM."""
    rng = np.random.default_rng(7)
    recs = [
        random_dna(rng, n, n_prob=0.02, lower_prob=0.1, iupac_prob=0.01)
        for n in (1500, 37, 1100)
    ]
    path = tmp_path_factory.mktemp("fa") / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(path)


@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [1, 4, 8, 10])
def test_count_file_vs_jax_pallas(fasta, k, canonical):
    cfg = Config(k=k, canonical=canonical, hist="pallas", **GEOM)
    want = np.asarray(jax_pipeline.count_file(fasta, _jax(cfg)))
    stats = pipeline.StreamStats()
    got = pipeline.count_file(fasta, cfg, CPU, stats=stats)
    assert stats.batches > 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # hist=auto on a CPU device takes scatter, and agrees too
    auto = pipeline.count_file(fasta, cfg.replace(hist="auto"), CPU)
    np.testing.assert_array_equal(auto, want)


@pytest.mark.parametrize("hist", ["scatter", "sort", "onehot", "pallas"])
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_counter_methods_vs_jax(fasta, hist, packed):
    cfg = Config(k=5, hist=hist, packed_h2d=packed, **GEOM)
    want = np.asarray(jax_pipeline.count_file(fasta, _jax(cfg).replace(
        hist="scatter")))
    counter = KmerCounter(cfg, CPU)
    state = counter.init_state()
    for b in pipeline.batches_from_file(fasta, cfg):
        state = counter.step(state, counter.put_batch(b))
    state = counter.flush(counter.compact(state))
    np.testing.assert_array_equal(counter.finalize(state), want)


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_jax_table_carried_into_the_port(fasta, packed):
    """Count the first half of the batches with the JAX counter, carry its
    dense table into the port with restore_state, finish there."""
    cfg = Config(k=6, canonical=True, packed_h2d=packed, **GEOM)
    batches = list(jax_pipeline.batches_from_file(fasta, _jax(cfg)))
    half = len(batches) // 2
    assert 0 < half < len(batches)
    jc = JaxCounter(_jax(cfg))
    jstate = jc.init_state()
    for b in batches[:half]:
        jstate = jc.step(jstate, jc.put_batch(b))
    jtable, _ = jc.table_state(jstate)

    tc = KmerCounter(cfg, CPU)
    state = tc.restore_state(jtable)
    assert isinstance(state.counts, torch.Tensor)
    for b in batches[half:]:
        state = tc.step(state, tc.put_batch(b))

    full = jc.init_state()
    for b in batches:
        full = jc.step(full, jc.put_batch(b))
    np.testing.assert_array_equal(tc.finalize(state), jc.finalize(full))


def test_int64_counts_vs_oracle(fasta):
    k = 5
    cfg = Config(k=k, count_dtype="int64", **GEOM)
    counter = make_counter(cfg, CPU)
    want = np.zeros(4 ** k, np.int64)
    for kmer, n in count_fasta_file(fasta, k).items():
        want[int(kmer.translate(str.maketrans("ACGT", "0123")), 4)] = n
    # start past 2^32 so a wrapped or narrowed count would show
    base = np.full(4 ** k, (1 << 33) + 5, np.int64)
    state = counter.restore_state(DenseTable(counts=base.copy(), k=k))
    assert state.counts.dtype == torch.int64
    for b in pipeline.prefetch_to_device(
        pipeline.batches_from_file(fasta, cfg), cfg.prefetch, CPU
    ):
        state = counter.step(state, b)
    np.testing.assert_array_equal(counter.finalize(state), base + want)
    fresh = pipeline.count_file(fasta, cfg, CPU)
    assert fresh.dtype == np.int64
    np.testing.assert_array_equal(fresh, want)


def test_dense_table_from_host_copies_and_checks():
    host = np.arange(16, dtype=np.int32)
    t = DenseTable.from_host(host, 2, CPU)
    t.counts += 1  # the steps update in place
    np.testing.assert_array_equal(host, np.arange(16))
    np.testing.assert_array_equal(t.to_host(), np.arange(1, 17))
    assert t.total() == sum(range(1, 17))
    snap = t.to_host()
    t.counts += 1
    np.testing.assert_array_equal(snap, np.arange(1, 17))  # a copy
    with pytest.raises(ValueError):
        DenseTable.from_host(np.zeros(15, np.int32), 2, CPU)
    with pytest.raises(ValueError):
        DenseTable.from_host(np.zeros(16, np.float32), 2, CPU)


def test_restore_state_checks_k_and_moves_tensors():
    counter = KmerCounter(Config(k=3), CPU)
    with pytest.raises(ValueError):
        counter.restore_state(DenseTable(counts=np.zeros(16, np.int32), k=2))
    t = torch.arange(64, dtype=torch.int32)
    state = counter.restore_state(DenseTable(counts=t, k=3))
    assert state.counts.device == CPU
    assert counter.table_state(state) == (state, state)
    jstate = DenseTable(counts=jnp.arange(64, dtype=jnp.int32), k=3)
    np.testing.assert_array_equal(
        counter.restore_state(jstate).to_host(), np.arange(64)
    )


@pytest.mark.parametrize("cfg, err", [
    (Config(k=12, devices=2), NotImplementedError),
    (Config(k=6, table_mode="sparse", spill_dir="unused"), None),
    (Config(k=6, devices=2), NotImplementedError),
    (Config(k=6, spill_dir="unused"), ValueError),
    (Config(k=11, table_mode="direct", hist="pallas"), ValueError),
])
def test_unported_or_invalid_configs_raise(cfg, err, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if err is not None:
        with pytest.raises(err):
            make_counter(cfg, CPU)
        assert not (tmp_path / "unused").exists()
        return
    # the disk spill on a forced sparse table: the counter takes the
    # config, makes the spill dir and stamps it at the first state
    counter = make_counter(cfg, CPU)
    assert counter.mode == "sparse" and counter._spill_n == 0
    counter.init_state()
    assert (tmp_path / "unused" / "stream.token").exists()


@pytest.fixture(scope="module")
def jax_dense(fasta):
    """(k, canonical) -> the JAX counter's dense spectrum of `fasta`."""
    cache = {}

    def get(k, canonical):
        if (k, canonical) not in cache:
            cfg = Config(k=k, canonical=canonical, hist="scatter", **GEOM)
            cache[k, canonical] = np.asarray(
                jax_pipeline.count_file(fasta, _jax(cfg)))
        return cache[k, canonical]

    return get


@pytest.mark.parametrize("dense_kernel", ["fused", "two_stage"])
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [4, 8, 10])
def test_dense_kernels_vs_jax_counter(fasta, jax_dense, monkeypatch, k,
                                      canonical, packed, dense_kernel):
    """hist="pallas" through K2 (fused) or extraction + K1 (two_stage),
    each wrapper on the CPU running its plain version, against the JAX
    counter; the step takes the route dense_kernel names, once a batch."""
    calls = {"fused": 0, "two_stage": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(counter_mod, "add_window_counts_cuda",
                        spy("fused", counter_mod.add_window_counts_cuda))
    monkeypatch.setattr(counter_mod, "add_counts_cuda",
                        spy("two_stage", counter_mod.add_counts_cuda))
    cfg = Config(k=k, canonical=canonical, hist="pallas", packed_h2d=packed,
                 **GEOM)
    stats = pipeline.StreamStats()
    got = pipeline.count_file(fasta, cfg, CPU, stats=stats,
                              dense_kernel=dense_kernel)
    np.testing.assert_array_equal(got, jax_dense(k, canonical))
    other = "two_stage" if dense_kernel == "fused" else "fused"
    assert calls[dense_kernel] == stats.batches and calls[other] == 0


def test_dense_kernel_name_is_checked():
    with pytest.raises(ValueError, match="dense_kernel"):
        KmerCounter(Config(k=4), CPU, dense_kernel="k1")
    assert make_counter(Config(k=4), CPU).dense_kernel == "fused"


def test_hist_auto_picks_by_device():
    assert KmerCounter(Config(k=8), CPU)._method == "scatter"
    assert KmerCounter(Config(k=8, hist="pallas"), CPU)._method == "pallas"
    big = Config(k=11, table_mode="direct")
    assert KmerCounter(big, CPU)._method == "scatter"


@pytest.mark.cuda
@pytest.mark.parametrize("k, count_dtype", [(4, "int32"), (8, "int64"),
                                            (10, "int32")])
def test_count_file_on_card_vs_cpu(fasta, k, count_dtype):
    """The CUDA path end to end (pinned staging ring reused over many
    batches; K2 once per batch, or with dense_kernel="two_stage" K1 once
    per batch) against the CPU path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from findkmer_torch.ops.cuda.histogram_kernel import histogram_cuda
    from findkmer_torch.ops.cuda.window_histogram_kernel import (
        fused_window_histogram_cuda as k2,
    )

    cfg = Config(k=k, count_dtype=count_dtype, chunk_len=64, batch_rows=2)
    want = pipeline.count_file(fasta, cfg, CPU)
    for dense_kernel, used, unused in (("fused", k2, histogram_cuda),
                                       ("two_stage", histogram_cuda, k2)):
        before, idle = used.launches, unused.launches
        stats = pipeline.StreamStats()
        got = pipeline.count_file(fasta, cfg, torch.device("cuda"),
                                  stats=stats, dense_kernel=dense_kernel)
        assert stats.batches > 2 * (cfg.prefetch + 1)
        assert used.launches - before == stats.batches
        assert unused.launches == idle
        np.testing.assert_array_equal(got, want)


def _stream(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise OSError("reader failed")
        yield np.full((2, 3), i, np.uint8), np.full((2, 1), i, np.uint8)


def test_prefetch_to_device_cpu_order_and_errors():
    got = [b for b in pipeline.prefetch_to_device(_stream(7), 2, CPU)]
    assert [int(p[0, 0]) for p, _ in got] == list(range(7))
    assert all(isinstance(t, torch.Tensor) for pair in got for t in pair)
    with pytest.raises(OSError, match="reader failed"):
        list(pipeline.prefetch_to_device(_stream(7, fail_at=3), 2, CPU))


def test_prefetch_to_device_stops_its_producer_on_early_exit():
    before = threading.active_count()
    it = pipeline.prefetch_to_device(_stream(1000), 2, CPU)
    next(it)
    it.close()  # consumer leaves early (a step raised)
    assert threading.active_count() == before

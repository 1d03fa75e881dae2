"""`findkmer-torch bench` (`findkmer_torch/bench/`) against the JAX
package's `findkmer bench` (the repository's root `bench` package over
`findkmer_tpu`), on the CPU.

The staged steps count the reference's seeded rows at the reference's
geometry: the port's final dense table equals a JAX `KmerCounter` stepped
as often over the same rows, and its finalized sparse store equals the JAX
counter's after the same ingest and compaction (at k = 13 also the
oracle's count).  Both CLIs run `bench` and `bench --phases` in this
process; their JSON lines are compared by keys, `k`, `bases` and each
phase's `calls` (the times differ by nature).  Counts are integers and
files are bytes: equality is exact.
"""

import dataclasses
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import quick as jax_quick
from findkmer_tpu import cli as jax_cli
from findkmer_tpu import output as jax_output
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_torch import Config
from findkmer_torch import cli as torch_cli
from findkmer_torch import output, pipeline
from findkmer_torch.bench import quick, steps
from oracle.scalar import count_kmers_in_text

torch.set_num_threads(1)  # six test workers share the cores

CPU = torch.device("cpu")
DENSE = dict(batch_rows=256, chunk_len=65536)   # the reference's k <= 15
SPARSE = dict(batch_rows=32, chunk_len=16384)   # and its k > 15


def _reference_rows(batch_rows, row_len):
    """The reference's dense draw (bench/steps.py bench_dense_step)."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4, (batch_rows, row_len), dtype=np.uint8)
    rows[rng.random(rows.shape) < 0.01] = 4
    return rows


def _reference_work(cfg):
    """The reference's sparse draw: the bases its wire packs."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 4, (cfg.batch_rows - 1) * cfg.chunk_len
                        + cfg.row_len, dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_tables():
    """(k, canonical) -> the JAX counter's table after two steps of the
    reference's rows at 256 x 65536 (computed once a key)."""
    done = {}

    def table(k, canonical):
        if (k, canonical) not in done:
            cfg = JaxConfig(k=k, canonical=canonical, **DENSE)
            counter = JaxCounter(cfg)
            rows = jnp.asarray(_reference_rows(cfg.batch_rows, cfg.row_len))
            state = counter.init_state()
            for _ in range(2):
                state = counter.step(state, rows)
            done[k, canonical] = np.asarray(state.counts)
        return done[k, canonical]

    return table


def test_inputs_are_the_reference_draws():
    cfg = Config(k=21, **SPARSE)
    np.testing.assert_array_equal(steps.dense_rows(4, 1003),
                                  _reference_rows(4, 1003))
    want = jax_pipeline._numpy_pack_rows(
        _reference_work(cfg), cfg.batch_rows, cfg.chunk_len, cfg.row_len,
        (cfg.row_len + 7) // 8 * 8)
    for got, w in zip(steps.sparse_wire(cfg), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("hist", ["auto", "pallas"])
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [4, 8, 10])
def test_dense_step_table_equals_jax(jax_tables, k, canonical, hist):
    """One warm-up and one timed step (steps=1) of the 256 x 65536 batch:
    the table is the JAX counter's after two steps.  hist="pallas" runs
    the kernel's plain version (on the card: the uint8-row entry of the
    fused window histogram kernel); "auto" is the CPU's scatter."""
    counter, state, dt = steps._dense_run(CPU, k=k, steps=1, hist=hist,
                                          canonical=canonical, **DENSE)
    assert counter._method == ("scatter" if hist == "auto" else "pallas")
    assert dt > 0
    got = state.counts.numpy()
    np.testing.assert_array_equal(got, jax_tables(k, canonical))
    assert int(got.sum()) > 0


def _jax_sparse(k, canonical, batch_rows, chunk_len, steps_=1):
    cfg = JaxConfig(k=k, canonical=canonical, batch_rows=batch_rows,
                    chunk_len=chunk_len, sparse_capacity=1 << 28,
                    sparse_expected_entries=batch_rows * chunk_len * steps_)
    counter = JaxCounter(cfg)
    wire = tuple(jnp.asarray(a) for a in jax_pipeline._numpy_pack_rows(
        _reference_work(cfg), batch_rows, chunk_len, cfg.row_len,
        (cfg.row_len + 7) // 8 * 8))
    state = counter.init_state()
    for _ in range(steps_):
        state = counter.step(state, wire)
    return counter.finalize(counter.compact(state))


@pytest.mark.parametrize("k, canonical", [(16, False), (21, True),
                                          (31, False)],
                         ids=["k16", "k21_canonical", "k31"])
def test_sparse_step_store_equals_jax(k, canonical):
    counter, state, dt = steps._sparse_run(CPU, k=k, steps=1,
                                           canonical=canonical, **SPARSE)
    assert counter.mode == "sparse" and dt > 0
    codes, counts = counter.finalize(state)
    want_codes, want_counts = _jax_sparse(k, canonical, **SPARSE)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(counts, want_counts)
    assert int(counts.sum()) == SPARSE["batch_rows"] * SPARSE["chunk_len"]


def test_sparse_step_k13_equals_jax_and_oracle(monkeypatch):
    """k=13 at the reference's 256 x 65536 (D12: the port's sparse step
    where the reference's bench fails): the store is the JAX counter's,
    and the oracle's count of the bases the rows hold (the rows' windows
    are exactly the windows of that one sequence).  The JAX counter
    finalizes by its heap-merge route (FINDKMER_ORDERED_FINALIZE=0, the
    same output): its ordered route takes ~40 s and ~6 GB on the CPU at
    this size."""
    counter, state, _ = steps._sparse_run(CPU, k=13, steps=1, **DENSE)
    codes, counts = counter.finalize(state)
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    want_codes, want_counts = _jax_sparse(13, False, **DENSE)
    monkeypatch.delenv("FINDKMER_ORDERED_FINALIZE")
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(counts, want_counts)
    work = _reference_work(counter.cfg)
    oracle = count_kmers_in_text(
        np.frombuffer(b"ACGT", np.uint8)[work].tobytes().decode(), 13)
    keys = np.frombuffer("".join(oracle).encode(), np.uint8).reshape(-1, 13)
    lut = np.zeros(256, np.uint64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint64)
    o_codes = lut[keys] @ (np.uint64(4) ** np.arange(12, -1, -1,
                                                     dtype=np.uint64))
    o_counts = np.fromiter(oracle.values(), np.int64, len(oracle))
    del oracle, keys
    order = np.argsort(o_codes)
    np.testing.assert_array_equal(codes, o_codes[order])
    np.testing.assert_array_equal(counts, o_counts[order])


def test_reference_bench_fails_at_k13():
    """D12: the reference sends every k <= 15 to its dense step, whose
    sync reads `counts` of the sparse state that k = 11..15 get."""
    with pytest.raises(AttributeError, match="'SparseState' object has no "
                                             "attribute 'counts'"):
        jax_cli.main(["bench", "-k", "13", "--gbases", "0.0001"])


def test_bench_phases_store_past_the_reference_capacity(capsys):
    """D12: `bench --phases` at k=21 over more than 2^22 distinct k-mers
    (4.5 Mbase): the reference's store keeps its 2^22 default and exits 2;
    the port's holds 2^28, as its staged step's, and counts."""
    argv = ["bench", "--phases", "-k", "21", "--gbases", "0.0045"]
    assert jax_cli.main(argv) == 2
    assert "exceeded sparse_capacity" in capsys.readouterr().err
    ours, _ = _bench(torch_cli.main, argv[1:] + ["--device", "cpu"],
                     capsys, gbases=None)
    assert ours["bases"] == 4_500_000 and ours["bases_per_s"] > 0
    assert [ours["phases"][p]["calls"] for p in
            ("dispatch", "finalize", "write")] == [1, 1, 1]


@pytest.mark.parametrize("bases", [1, 80, 81, 8_000_001])
def test_synth_fasta_equals_reference(tmp_path, bases):
    ours, theirs = tmp_path / "t.fa", tmp_path / "j.fa"
    quick._synth_fasta(str(ours), bases)
    jax_quick._synth_fasta(str(theirs), bases)
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (ours, theirs)]
    assert digest[0] == digest[1]
    # the header, then full 80-base lines ('A'-padded) of each 8 M block
    lines = sum(-(-min(8_000_000, bases - s) // 80)
                for s in range(0, bases, 8_000_000))
    assert ours.stat().st_size == 17 + 81 * lines


def _bench(main, argv, capsys, gbases="0.0001"):
    """One CLI `bench` run in this process -> (its JSON line, stderr)."""
    assert main(["bench", *argv]
                + (["--gbases", gbases] if gbases else [])) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), err


@pytest.mark.parametrize("argv", [["-k", "4"], ["-k", "8"],
                                  ["-k", "21", "--canonical"]],
                         ids=["k4", "k8", "k21_canonical"])
def test_bench_phases_equal_reference(argv, capsys):
    theirs, theirs_err = _bench(jax_cli.main, ["--phases", *argv], capsys)
    ours, ours_err = _bench(torch_cli.main,
                            ["--phases", *argv, "--device", "cpu"], capsys)
    assert list(ours) == list(theirs) == ["k", "bases", "wall_s",
                                          "bases_per_s", "phases"]
    assert ours["k"] == theirs["k"] and ours["bases"] == theirs["bases"]
    assert sorted(ours["phases"]) == sorted(theirs["phases"]) == [
        "dispatch", "finalize", "host_batches", "write"]
    for name, d in theirs["phases"].items():
        assert ours["phases"][name]["calls"] == d["calls"], name
        assert list(ours["phases"][name]) == list(d)
    assert ours["bases_per_s"] > 0 and ours["wall_s"] > 0
    # the stderr table: its header lines and one row a phase, in order
    rows = [[ln.split()[1], ln.split()[3]] for ln in ours_err.splitlines()
            [2:]]
    assert rows == [[ln.split()[1], ln.split()[3]]
                    for ln in theirs_err.splitlines()[2:]]
    assert ours_err.splitlines()[:2] == theirs_err.splitlines()[:2]


@pytest.mark.parametrize("argv", [["-k", "8"], ["-k", "21"]],
                         ids=["k8", "k21"])
def test_bench_keys_equal_reference(argv, capsys):
    theirs, _ = _bench(jax_cli.main, argv, capsys)
    ours, _ = _bench(torch_cli.main, [*argv, "--device", "cpu"], capsys)
    assert list(ours) == list(theirs) == ["k", "bases_per_s", "wall_s",
                                          "device", "hist"]
    assert (ours["k"], ours["hist"]) == (theirs["k"], theirs["hist"])
    assert ours["device"] == "cpu" and ours["bases_per_s"] > 0


def test_bench_k13_runs_the_sparse_step(capsys, monkeypatch):
    """D12 through the CLI: the port answers where the reference raises,
    by the sparse step (its table mode at k = 13)."""
    calls = []
    orig = steps._sparse_run

    def tapped(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)

    monkeypatch.setattr(steps, "_sparse_run", tapped)
    ours, _ = _bench(torch_cli.main, ["-k", "13", "--device", "cpu"],
                     capsys)
    assert ours["k"] == 13 and ours["bases_per_s"] > 0
    assert [(c["k"], c["batch_rows"], c["chunk_len"], c["steps"])
            for c in calls] == [(13, 256, 65536, 1)]


def test_bench_device_cuda_without_cuda_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for argv in (["bench"], ["bench", "-k", "21", "--phases"]):
        assert torch_cli.main(argv + ["--gbases", "0.0001"]) == 2
        out, err = capsys.readouterr()
        assert out == ""  # no result, nothing counted on the CPU instead
        assert "torch.cuda.is_available() is False" in err


@pytest.mark.parametrize("k", [4, 21], ids=["k4_dense", "k21_sparse"])
def test_spectrum_to_text_equals_reference(fixtures_dir, k):
    cfg = Config(k=k, canonical=k == 21, chunk_len=4096, batch_rows=8)
    spectrum = pipeline.count_file(f"{fixtures_dir}/ecoli_frag.fa", cfg,
                                   CPU)
    got = output.spectrum_to_text(spectrum, cfg)
    assert got == jax_output.spectrum_to_text(
        spectrum, JaxConfig(**dataclasses.asdict(cfg)))
    assert got.count("\n") > 100


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["-k", "8"], ["-k", "21", "--canonical"]],
                         ids=["k8", "k21_canonical"])
def test_bench_on_card(argv, capsys):
    """`bench` on the card: its JSON line names the device, and the
    staged step's result equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ours, _ = _bench(torch_cli.main, argv, capsys)
    assert ours["device"].startswith("cuda") and ours["bases_per_s"] > 0
    k = int(argv[1])
    if k <= 10:
        runs = [steps._dense_run(dev, k=k, steps=1, **DENSE)
                for dev in (torch.device("cuda"), CPU)]
        np.testing.assert_array_equal(runs[0][1].counts.cpu().numpy(),
                                      runs[1][1].counts.numpy())
    else:
        runs = [steps._sparse_run(dev, k=k, steps=1, canonical=True,
                                  **SPARSE)
                for dev in (torch.device("cuda"), CPU)]
        for got, want in zip(runs[0][0].finalize(runs[0][1]),
                             runs[1][0].finalize(runs[1][1])):
            np.testing.assert_array_equal(got, want)

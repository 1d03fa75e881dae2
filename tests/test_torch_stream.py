"""`findkmer-torch stream` against `findkmer stream` and `findkmer-torch count`.

The restartable streaming count of the port on the CPU (`--device cpu`:
the plain versions of the kernels) against the JAX package's on the same
numpy-seeded inputs, at small multi-batch geometries.  Everything
compared is exit codes, integers and bytes: the tolerance is none.  Then
resume: from every crash point, after completion, under a changed config,
input or host topology.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import cli as jax_cli
from findkmer_tpu import streaming as jax_streaming
from findkmer_tpu.config import Config as JaxConfig
from findkmer_torch import Config
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline, streaming
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.ops.sparse import merge_host_runs
from findkmer_torch.parallel import multihost
from findkmer_torch.utils import checkpoint as ckpt_mod
from oracle.scalar import count_fasta_file, spectrum_lines

torch.set_num_threads(1)  # six test workers share the cores
CPU = torch.device("cpu")
GEOM = ["--chunk-len", "128", "--batch-rows", "4",
        "--sparse-compact-entries", "1024"]
# k, extra flags: dense, dense at the kernels' limit, sparse narrow, sparse
# wide canonical, the widest code
RUNS = {
    "k4": ["-k", "4"],
    "k8-canonical": ["-k", "8", "--canonical"],
    "k12": ["-k", "12"],
    "k21-canonical": ["-k", "21", "--canonical"],
    "k31": ["-k", "31"],
    "k12-min-max": ["-k", "12", "--min-count", "2", "--max-count", "5"],
    "k6-min-count": ["-k", "6", "--min-count", "3"],
}


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two FASTA files (N runs, lowercase, IUPAC codes, a repeated motif
    so that --min-count keeps something) and one FASTQ file of the same
    kind of reads."""
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("stream_in")
    motif = random_dna(rng, 90)
    paths = []
    for name, lens in (("a.fa", (2500, 40, 1800)), ("b.fa", (1500,))):
        recs = [random_dna(rng, n, n_prob=0.02, lower_prob=0.1,
                           iupac_prob=0.01) + motif for n in lens]
        (d / name).write_text(
            "".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
        paths.append(str(d / name))
    reads = [random_dna(rng, int(n), n_prob=0.02) + motif[:30]
             for n in rng.integers(40, 400, 25)]
    (d / "reads.fq").write_text(
        "".join(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n"
                for i, s in enumerate(reads)))
    return paths, str(d / "reads.fq")


def _run(main, argv, out):
    rc = main(argv + ["-o", str(out)])
    return rc, (out.read_bytes() if out.exists() else None)


@pytest.mark.parametrize("source", ["fasta", "fastq"])
@pytest.mark.parametrize("run", list(RUNS))
def test_stream_matches_jax_stream_and_count(inputs, tmp_path, run, source):
    """The slice as a whole: same exit code and same bytes as the JAX
    package's `stream`, and as the port's own `count`."""
    fastas, fastq = inputs
    files = fastas if source == "fasta" else [fastq]
    args = ["-i", *files] + RUNS[run] + GEOM
    ck = ["--checkpoint-every", "3", "--checkpoint"]
    want_rc, want = _run(
        jax_cli.main, ["stream"] + args + ck + [str(tmp_path / "jck")],
        tmp_path / "jax.tsv")
    rc, got = _run(
        torch_cli.main,
        ["stream", "--device", "cpu"] + args + ck + [str(tmp_path / "tck")],
        tmp_path / "torch.tsv")
    assert rc == want_rc == 0
    assert got == want and got
    rc, counted = _run(torch_cli.main, ["count", "--device", "cpu"] + args,
                       tmp_path / "count.tsv")
    assert rc == 0 and counted == got
    assert (tmp_path / "tck" / "latest.json").exists()


def test_stream_without_checkpoint_and_stats(inputs, tmp_path, capsys):
    """No --checkpoint: a plain stream; --stats json prints the
    reference's keys, and the port's `device`, `host_encoder` and `phases`
    (as its `count` prints them)."""
    fastas, _ = inputs
    args = ["stream", "-i", *fastas, "-k", "9", "--stats", "json"] + GEOM
    assert jax_cli.main(args + ["-o", str(tmp_path / "j.tsv")]) == 0
    want = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert torch_cli.main(args + ["--device", "cpu", "-o",
                                  str(tmp_path / "t.tsv")]) == 0
    got = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(got) - set(want) == {"device", "host_encoder", "phases"}
    assert got["device"] == "cpu"
    assert set(got["phases"]) == {"host_batches", "dispatch", "finalize",
                                  "write"}
    for key in set(want) - {"wall_s"}:
        assert got[key] == want[key]
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


@pytest.mark.parametrize("k", ["6", "12"])
def test_stats_time_each_checkpoint(inputs, tmp_path, capsys, k):
    """--stats json of a checkpointed stream: every checkpoint's
    compaction, copy to the host and compressed write are phases."""
    fastas, _ = inputs
    ck = tmp_path / "ck"
    assert torch_cli.main(
        ["stream", "-i", fastas[0], "-k", k, "--device", "cpu", "-o",
         str(tmp_path / "o.tsv"), "--checkpoint", str(ck),
         "--checkpoint-every", "2", "--stats", "json"] + GEOM) == 0
    got = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    saves = got["batches"] // 2 + got["batches"] % 2
    assert saves >= 2 and len(list(ck.glob("ckpt_*.npz"))) == saves
    for name in ("checkpoint/compact", "checkpoint/d2h", "checkpoint/zlib"):
        assert got["phases"][name]["calls"] == saves
        assert got["phases"][name]["total_s"] >= 0.0


def test_log_level_reaches_the_stream_logger(inputs, tmp_path, caplog,
                                             capsys):
    """--log INFO: the stream logs each checkpoint and a resume; a level
    that is none is one error line and exit 2."""
    import logging

    fastas, _ = inputs
    args = ["stream", "-i", fastas[0], "-k", "6", "--device", "cpu", "-o",
            str(tmp_path / "o.tsv"), "--checkpoint", str(tmp_path / "ck"),
            "--checkpoint-every", "2"] + GEOM
    root = logging.getLogger("findkmer")
    before = root.level
    try:
        assert torch_cli.main(args) == 0  # default level: nothing at INFO
        assert not [r for r in caplog.records if r.name == "findkmer.stream"]
        assert torch_cli.main(args + ["--log", "info"]) == 0
        said = [r.getMessage() for r in caplog.records
                if r.name == "findkmer.stream"]
        assert any("resuming from checkpoint at batch" in m for m in said)
        assert os.environ["FINDKMER_LOGLEVEL"] == "info"
        capsys.readouterr()
        assert torch_cli.main(args + ["--log", "LOUD"]) == 2
        assert "LOUD" in capsys.readouterr().err
    finally:
        root.setLevel(before)
        os.environ.pop("FINDKMER_LOGLEVEL", None)


@pytest.mark.parametrize("argv, msg", [
    (["--coordinator", "host:1234", "--num-processes", "2",
      "--process-id", "0"], "ROADMAP.md Queue 1 item 13"),
    (["--num-processes", "2", "--process-id", "2"], "out of range"),
    (["--devices", "2"], "ROADMAP.md Queue 1 item 13"),
    (["--profile", "x"], "ROADMAP.md Queue 1 item 12"),
    (["-k", "8", "--spill", "x"], "--spill requires a sparse table"),
])
def test_stream_refusals_exit_2(inputs, tmp_path, capsys, argv, msg):
    fastas, _ = inputs
    out = tmp_path / "o.tsv"
    rc = torch_cli.main(["stream", "-i", fastas[0], "-k", "12", "--device",
                         "cpu", "-o", str(out)] + GEOM + argv)
    assert rc == 2
    err = capsys.readouterr().err
    assert msg in err and len(err.strip().splitlines()) == 1
    assert not out.exists()


def test_coordinator_from_the_environment(monkeypatch):
    monkeypatch.setenv("FINDKMER_NUM_PROCESSES", "3")
    monkeypatch.setenv("FINDKMER_PROCESS_ID", "2")
    assert multihost.initialize() == (3, 2)
    assert multihost.initialize(None, 1, 0) == (1, 0)
    monkeypatch.setenv("FINDKMER_COORDINATOR", "host:1")
    with pytest.raises(NotImplementedError, match="item 13"):
        multihost.initialize()
    assert multihost.initialize(None, 1, None) == (1, 0)  # one process
    assert list(multihost.shard_batches_round_robin(iter(range(7)), 3, 1)) \
        == [1, 4]


# ---- resume -----------------------------------------------------------------

@pytest.fixture(scope="module")
def fasta_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    recs = [random_dna(rng, n, n_prob=0.02) for n in (3000, 1500, 2200)]
    p = tmp_path_factory.mktemp("resume") / "in.fa"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(p)


def _crash_after(path, cfg, ckpt, n_batches):
    """Count the first n_batches by hand, a checkpoint after each, and
    abandon the run."""
    counter = KmerCounter(cfg, CPU)
    state = counter.init_state()
    for i, rows in enumerate(pipeline.batches_from_file(path, cfg)):
        if i >= n_batches:
            break
        state = counter.step(state, counter.put_batch(rows))
        state, table = counter.table_state(state)
        ckpt_mod.save(ckpt, cfg, i + 1, table, {})


def _same(a, b):
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    return np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("k", [6, 17])
def test_resume_every_crash_point(fasta_file, tmp_path, k):
    """For EVERY batch index i, a run checkpointed through batch i and
    abandoned resumes to the same spectrum, dense and sparse."""
    cfg = Config(k=k, chunk_len=256, batch_rows=2,
                 sparse_compact_entries=1024, sparse_capacity=1 << 15)
    want = pipeline.count_file(fasta_file, cfg, CPU)
    n_batches = sum(1 for _ in pipeline.batches_from_file(fasta_file, cfg))
    assert n_batches >= 3
    for crash_at in range(1, n_batches + 1):
        ckpt = str(tmp_path / f"ck{crash_at}")
        _crash_after(fasta_file, cfg, ckpt, crash_at)
        got = streaming.stream_count(
            [fasta_file], cfg, checkpoint_dir=ckpt, checkpoint_every=3,
            device="cpu")
        assert _same(got, want), crash_at
    assert _same(want, jax_streaming.stream_count([fasta_file], _jax(cfg)))


def test_resume_after_complete_is_stable(fasta_file, tmp_path):
    cfg = Config(k=5, chunk_len=256, batch_rows=2)
    ckpt = tmp_path / "ckpt"
    runs = [streaming.stream_count([fasta_file], cfg, checkpoint_dir=str(ckpt),
                                   checkpoint_every=1, device="cpu")
            for _ in range(2)]
    assert _same(*runs)
    # the second run counted nothing and wrote no new checkpoint
    n = sum(1 for _ in pipeline.batches_from_file(fasta_file, cfg))
    assert sorted(p.name for p in ckpt.glob("ckpt_*.npz")) == \
        [f"ckpt_{i:010d}.npz" for i in range(1, n + 1)]


@pytest.mark.parametrize("change", [
    dict(k=6), dict(canonical=True), dict(chunk_len=128), dict(batch_rows=4),
    dict(sparse_capacity=1 << 20), dict(count_dtype="int64"),
    dict(table_mode="sparse"),
], ids=lambda c: next(iter(c)))
def test_config_mismatch_rejected(fasta_file, tmp_path, change):
    """Each of the six checked fields, and the resolved table mode, with
    the reference's message."""
    cfg = Config(k=5, chunk_len=256, batch_rows=2)
    ckpt = str(tmp_path / "ckpt")
    streaming.stream_count([fasta_file], cfg, checkpoint_dir=ckpt,
                           checkpoint_every=1, device="cpu")
    with pytest.raises(ValueError, match="mismatch") as got:
        streaming.stream_count([fasta_file], cfg.replace(**change),
                               checkpoint_dir=ckpt, device="cpu")
    with pytest.raises(ValueError, match="mismatch") as want:
        jax_streaming.stream_count([fasta_file], _jax(cfg.replace(**change)),
                                   checkpoint_dir=ckpt)
    assert str(got.value) == str(want.value)
    # an explicit spelling of the same table mode is compatible
    streaming.stream_count([fasta_file], cfg.replace(table_mode="direct"),
                           checkpoint_dir=ckpt, device="cpu")


def test_resume_rejects_truncated_input(fasta_file, tmp_path):
    cfg = Config(k=6, chunk_len=256, batch_rows=2)
    ckpt = str(tmp_path / "ck")
    streaming.stream_count([fasta_file], cfg, checkpoint_dir=ckpt,
                           checkpoint_every=1, device="cpu")
    short = tmp_path / "short.fa"
    text = open(fasta_file).read()
    short.write_text(text[: len(text) // 3])
    with pytest.raises(ValueError, match="input changed") as got:
        streaming.stream_count([str(short)], cfg, checkpoint_dir=ckpt,
                               device="cpu")
    with pytest.raises(ValueError, match="input changed") as want:
        jax_streaming.stream_count([str(short)], _jax(cfg),
                                   checkpoint_dir=ckpt)
    assert str(got.value) == str(want.value)


def test_resume_stats_match_fresh_run(fixtures_dir, tmp_path):
    src = os.path.join(fixtures_dir, "ecoli_frag.fa")
    cfg = Config(k=6, chunk_len=512, batch_rows=2)
    fresh = pipeline.StreamStats()
    spec_fresh = streaming.stream_count([src], cfg, stats=fresh,
                                        device="cpu")
    ck = str(tmp_path / "ck")
    _crash_after(src, cfg, ck, 5)
    resumed = pipeline.StreamStats()
    spec_resumed = streaming.stream_count(
        [src], cfg, checkpoint_dir=ck, checkpoint_every=4, stats=resumed,
        device="cpu")
    assert resumed.as_dict() == fresh.as_dict()
    assert resumed.batches > 5
    assert _same(spec_fresh, spec_resumed)


def test_topology_mismatch_rejected_and_proc_subdirs(fasta_file, tmp_path):
    """Two simulated hosts: each checkpoints into its own proc subdir and
    returns a partial spectrum; the partials sum to the whole.  A resume
    under another topology is refused with the reference's message."""
    cfg = Config(k=13, chunk_len=256, batch_rows=2,
                 sparse_compact_entries=1024)
    ck = tmp_path / "ck"
    parts = [streaming.stream_count(
        [fasta_file], cfg, checkpoint_dir=str(ck), checkpoint_every=2,
        num_processes=2, process_id=i, device="cpu") for i in range(2)]
    assert (ck / "proc000" / "latest.json").exists()
    assert (ck / "proc001" / "latest.json").exists()
    assert _same(merge_host_runs(parts),
                 pipeline.count_file(fasta_file, cfg, CPU))
    jparts = [jax_streaming.stream_count(
        [fasta_file], _jax(cfg), num_processes=2, process_id=i)
        for i in range(2)]
    for a, b in zip(parts, jparts):
        assert _same(a, (np.asarray(b[0], np.uint64),
                         np.asarray(b[1], np.int64)))
    meta = json.loads((ck / "proc001" / "latest.json").read_text())
    assert meta["extra"] == {"num_processes": 2, "process_id": 1}
    for mod, c, kw in ((streaming, cfg, dict(device="cpu")),
                       (jax_streaming, _jax(cfg), {})):
        with pytest.raises(ValueError, match="original topology") as e:
            mod.stream_count([fasta_file], c,
                             checkpoint_dir=str(ck / "proc001"),
                             num_processes=1, process_id=0, **kw)
        assert "num_processes=2" in str(e.value)


def test_failed_step_closes_the_producer(fasta_file, tmp_path, monkeypatch):
    """A step that raises mid-stream leaves no producer thread behind, and
    the checkpoints written before it stay usable."""
    cfg = Config(k=6, chunk_len=256, batch_rows=2)
    ck = str(tmp_path / "ck")
    calls = []
    step = KmerCounter.step

    def failing(self, state, batch):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("injected step failure")
        return step(self, state, batch)

    monkeypatch.setattr(KmerCounter, "step", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="injected"):
        streaming.stream_count([fasta_file], cfg, checkpoint_dir=ck,
                               checkpoint_every=1, device="cpu")
    assert threading.active_count() == before
    monkeypatch.setattr(KmerCounter, "step", step)
    got = streaming.stream_count([fasta_file], cfg, checkpoint_dir=ck,
                                 device="cpu")
    assert len(calls) < 4 + sum(
        1 for _ in pipeline.batches_from_file(fasta_file, cfg))  # resumed at 3
    assert _same(got, pipeline.count_file(fasta_file, cfg, CPU))


def test_dense_checkpoint_is_a_copy_not_the_live_table(fasta_file, tmp_path):
    """The dense step adds into its table in place: a loaded checkpoint
    restored into a counter must not alias the loaded array, and a saved
    one holds the counts of its own batch index."""
    cfg = Config(k=6, chunk_len=256, batch_rows=2)
    ck = str(tmp_path / "ck")
    _crash_after(fasta_file, cfg, ck, 2)
    index, table, _, _ = ckpt_mod.load_latest(ck, cfg)
    assert index == 2
    loaded = np.array(table.counts, copy=True)
    counter = KmerCounter(cfg, CPU)
    state = counter.restore_state(table)
    for rows in list(pipeline.batches_from_file(fasta_file, cfg))[2:]:
        state = counter.step(state, counter.put_batch(rows))
    np.testing.assert_array_equal(table.counts, loaded)
    assert counter.finalize(state).sum() > loaded.sum()
    lines = spectrum_lines(count_fasta_file(fasta_file, 6), 6)
    assert int(counter.finalize(state).sum()) == sum(
        int(ln.split("\t")[1]) for ln in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("k, canonical", [(8, False), (21, True)])
def test_stream_on_card_vs_cpu(fasta_file, tmp_path, k, canonical):
    """The CUDA path: a stream with checkpoints on the card, abandoned and
    resumed there, equals the CPU's spectrum; its steps and checkpoints
    went through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows_cuda
    from findkmer_torch.ops.cuda.window_histogram_kernel import (
        fused_window_histogram_cuda,
    )

    cfg = Config(k=k, canonical=canonical, chunk_len=256, batch_rows=2,
                 sparse_compact_entries=1024, sparse_capacity=1 << 15)
    want = pipeline.count_file(fasta_file, cfg, CPU)
    fn = fused_window_histogram_cuda if k <= 10 else sort_rows_cuda
    before = fn.launches
    ck = str(tmp_path / "ck")
    got = streaming.stream_count([fasta_file], cfg, checkpoint_dir=ck,
                                 checkpoint_every=3, device="cuda")
    assert _same(got, want)
    n = sum(1 for _ in pipeline.batches_from_file(fasta_file, cfg))
    assert fn.launches - before >= (n if k <= 10 else n // 3)
    # a checkpoint written on the card resumes on the card and on the CPU
    index, table, _, _ = ckpt_mod.load_latest(ck, cfg)
    assert index == n
    for device in ("cuda", "cpu"):
        counter = KmerCounter(cfg, torch.device(device))
        assert _same(counter.finalize(counter.restore_state(table)), want)

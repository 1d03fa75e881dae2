"""The disk spill of the port, its C merge and the heap-merge finalize.

`findkmer_torch/spill.py`, `io/native.merge_runs`,
`ops/sparse.merge_host_runs` / `store_to_host_2d` and the spill engine of
`models/counter.py` on the CPU, against the JAX package's on the same
numpy-seeded inputs and against `oracle/scalar.py`.  A tiny
sparse_capacity forces the spills.  All integers and bytes: the tolerance
is none.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import cli as jax_cli
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu import spill as jax_spill
from findkmer_tpu import streaming as jax_streaming
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.io import native as jax_native
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_tpu.ops import sparse as jax_sparse
from findkmer_torch import Config
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline, spill, streaming
from findkmer_torch.io import native
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops.window import str_to_code
from findkmer_torch.utils import checkpoint as ckpt_mod
from oracle.scalar import count_fasta_file

torch.set_num_threads(1)  # six test workers share the cores
CPU = torch.device("cpu")
SPILL = dict(chunk_len=64, batch_rows=8, table_mode="sparse",
             sparse_capacity=512, sparse_compact_entries=1024)


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def _need_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler: the native library did not build")


def _oracle(path, k, canonical=False):
    items = sorted(count_fasta_file(path, k, canonical=canonical).items())
    return (np.array([str_to_code(m) for m, _ in items], np.uint64),
            np.array([n for _, n in items], np.int64))


def _assert_spectrum(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], np.asarray(want[0], np.uint64))
    np.testing.assert_array_equal(got[1], np.asarray(want[1], np.int64))


def _count(path, cfg, counter=None):
    counter = counter or KmerCounter(cfg, CPU)
    state = counter.init_state()
    for rows in pipeline.batches_from_file(path, cfg):
        state = counter.step(state, counter.put_batch(rows))
    return counter, state


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(23)
    recs = [random_dna(rng, n, n_prob=0.02) for n in (13000, 9000)]
    path = tmp_path_factory.mktemp("spill") / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(path)


# ---- the merges -------------------------------------------------------------

def _runs(seed, n_runs, dtypes, span=500):
    rng = np.random.default_rng(seed)
    runs = []
    for i in range(n_runs):
        codes = np.unique(rng.integers(0, span, rng.integers(0, 400))
                          .astype(np.uint64))
        dt = dtypes[i % len(dtypes)]
        counts = rng.integers(1, 100, codes.size).astype(dt)
        if dt == np.int64 and codes.size:
            counts[0] = (1 << 40) + i  # lost by a merge that narrows
        runs.append((codes, counts))
    return runs


def _dict_merge(runs):
    d = {}
    for c, n in runs:
        for ci, ni in zip(c.tolist(), n.tolist()):
            d[ci] = d.get(ci, 0) + ni
    return d


@pytest.mark.parametrize("dtypes", [(np.int32,), (np.int64,),
                                    (np.int32, np.int64)],
                         ids=["32", "64", "mixed"])
def test_merge_runs_equals_the_reference_and_numpy(dtypes):
    """The C merge widens to 64-bit when ANY run is 64-bit."""
    _need_native()
    runs = _runs(1, 9, dtypes)
    codes, counts = native.merge_runs(runs)
    want = jax_native.merge_runs(runs)
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    np.testing.assert_array_equal(codes, want[0])
    np.testing.assert_array_equal(counts, want[1])
    assert dict(zip(codes.tolist(), counts.tolist())) == _dict_merge(runs)
    assert native.merge_runs([])[0].size == 0
    with pytest.raises(ValueError, match="up to 256"):
        native.merge_runs(_runs(2, 300, dtypes, span=10 ** 6))


@pytest.mark.parametrize("native_merge", [True, False], ids=["c", "numpy"])
@pytest.mark.parametrize("n_runs", [0, 1, 2, 256, 257, 700])
def test_merge_host_runs(n_runs, native_merge, monkeypatch):
    """Empty runs dropped, one run passed through, the C merge, and its
    hierarchy above 256 runs; the same without the C library."""
    if native_merge:
        _need_native()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    runs = _runs(n_runs, n_runs, (np.int32, np.int64), span=3000)
    runs.insert(0, (np.empty(0, np.uint64), np.empty(0, np.int32)))
    codes, counts = sparse_ops.merge_host_runs(runs)
    want = jax_sparse.merge_host_runs(runs)
    assert codes.dtype == np.uint64 and counts.dtype == np.int64
    np.testing.assert_array_equal(codes, want[0])
    np.testing.assert_array_equal(counts, want[1])
    assert dict(zip(codes.tolist(), counts.tolist())) == _dict_merge(runs)


@pytest.mark.parametrize("k", [12, 21])
def test_store_to_host_2d_strips_by_count(k):
    """Holes keep their code and padding holds the sentinel: only the
    count tells a live slot.  Against the reference on its own planes."""
    rng = np.random.default_rng(k)
    dt = np.int32 if k <= 15 else np.int64
    G, C = 5, 40
    codes = np.sort(rng.integers(0, 4 ** k, (G, C)), axis=1).astype(dt)
    cnt = rng.integers(0, 4, (G, C)).astype(np.int32)  # zeros: holes
    cnt[:, 1:][codes[:, 1:] == codes[:, :-1]] = 0  # rows stay distinct
    codes[:, -3:] = np.iinfo(dt).max
    cnt[:, -3:] = 0
    if k > 15:
        codes[0, 5] = (codes[0, 5] | 0xFFFFFFFF)  # a live all-ones low word
        codes[0] = np.sort(codes[0])
    got = sparse_ops.store_to_host_2d(codes, cnt)
    hi = None if k <= 15 else (codes >> 32).astype(np.uint32)
    want = jax_sparse.store_to_host_2d(hi, codes.astype(np.uint32), cnt)
    _assert_spectrum(got, want)
    flat = {}
    for c, n in zip(codes.ravel().tolist(), cnt.ravel().tolist()):
        if n:
            flat[c] = flat.get(c, 0) + n
    assert dict(zip(got[0].tolist(), got[1].tolist())) == flat
    empty = sparse_ops.store_to_host_2d(codes, np.zeros_like(cnt))
    assert empty[0].size == 0 and empty[1].dtype == np.int64


# ---- spill.py ---------------------------------------------------------------

@pytest.mark.parametrize("native_merge", [True, False], ids=["c", "numpy"])
@pytest.mark.parametrize("block", [7, 64, 1 << 20])
def test_iter_merged_matches_dict(block, native_merge, monkeypatch):
    """Block merge == dict merge for overlapping runs at adversarial block
    sizes (the bound straddles duplicates across runs), and == the
    reference's blocks."""
    if native_merge:
        _need_native()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    runs = _runs(block, 5, (np.int64,))
    got = list(spill.iter_merged(runs, block=block))
    want = list(jax_spill.iter_merged(runs, block=block))
    assert len(got) == len(want)
    for (c, n), (wc, wn) in zip(got, want):
        assert np.all(np.diff(c.astype(np.int64)) > 0)  # sorted distinct
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_array_equal(n, wn)
    allc = np.concatenate([c for c, _ in got])
    alln = np.concatenate([n for _, n in got])
    assert np.all(np.diff(allc.astype(np.int64)) > 0)
    assert dict(zip(allc.tolist(), alln.tolist())) == _dict_merge(runs)


def test_iter_merged_empty_runs():
    assert list(spill.iter_merged([])) == []
    e = np.empty(0, np.uint64)
    assert list(spill.iter_merged([(e, e.astype(np.int64))])) == []


@pytest.mark.parametrize("writer, reader", [(spill, jax_spill),
                                            (jax_spill, spill),
                                            (spill, spill)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_run_files_cross_load(tmp_path, writer, reader):
    """One run-file format: names, dtypes, no temporary file left."""
    rng = np.random.default_rng(4)
    want = []
    for i in range(3):
        codes = np.unique(rng.integers(0, 1 << 40, 100).astype(np.uint64))
        counts = rng.integers(1, 9, codes.size).astype(np.int32)
        writer.write_run(str(tmp_path), i, codes, counts)
        want.append((codes, counts))
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"run{i:05d}.{part}.npy" for i in range(3)
        for part in ("codes", "counts"))
    runs = reader.load_runs(str(tmp_path))
    assert len(runs) == 3
    for (c, n), (wc, wn) in zip(runs, want):
        assert c.dtype == np.uint64 and n.dtype == np.int64
        np.testing.assert_array_equal(np.asarray(c), wc)
        np.testing.assert_array_equal(np.asarray(n), wn)
    token = writer.write_token(str(tmp_path))
    assert reader.read_token(str(tmp_path)) == token
    reader.remove_runs_from(str(tmp_path), 1)
    assert len(writer.load_runs(str(tmp_path))) == 1
    reader.remove_runs(str(tmp_path))
    assert os.listdir(tmp_path) == ["stream.token"]


def test_init_dir_refuses_stale_runs(tmp_path):
    """A dir with another count's runs is refused, also a non-contiguous
    tail that load_runs' walk from 0 would miss."""
    d = str(tmp_path / "sp")
    for i in (5, 6):  # a stale tail, no run00000
        spill.write_run(d, i, np.array([i], np.uint64),
                        np.array([1], np.int64))
    assert spill.load_runs(d) == []
    with pytest.raises(ValueError, match="already contains run files") as got:
        spill.init_dir(d)
    with pytest.raises(ValueError) as want:
        jax_spill.init_dir(d)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="already contains"):
        KmerCounter(Config(k=21, spill_dir=d), CPU).init_state()
    spill.remove_runs(d)
    assert spill.read_token(d) is None
    spill.init_dir(d)  # accepted once it is empty
    assert len(spill.read_token(d)) == 32


# ---- the engine -------------------------------------------------------------

@pytest.mark.parametrize("k, canonical", [(12, False), (21, False),
                                          (21, True)])
def test_spill_count_matches_oracle_and_jax(fasta, tmp_path, k, canonical):
    """A tiny sparse_capacity forces several spills: the spectrum stays
    exact, as many runs are written as the JAX engine writes, and the
    consumed run files are deleted."""
    cfg = Config(k=k, canonical=canonical, spill_dir=str(tmp_path / "sp"),
                 **SPILL)
    counter, state = _count(fasta, cfg)
    n_runs = counter._spill_n
    assert n_runs >= 2
    assert len(spill.load_runs(cfg.spill_dir)) == n_runs
    got = counter.finalize(state)
    assert spill.load_runs(cfg.spill_dir) == []  # consumed and removed
    _assert_spectrum(got, _oracle(fasta, k, canonical))
    jcfg = _jax(cfg.replace(spill_dir=str(tmp_path / "jsp")))
    jc = JaxCounter(jcfg)
    js = jc.init_state()
    for rows in jax_pipeline.batches_from_file(fasta, jcfg):
        js = jc.step(js, rows)
    assert jc._spill_n == n_runs
    _assert_spectrum(got, jc.finalize(js))
    # a second finalize of a spilled state is a clean error, and so is
    # a second state from the same counter
    with pytest.raises(RuntimeError, match="spill runs missing"):
        counter.finalize(state)
    with pytest.raises(RuntimeError, match="spill runs missing"):
        next(counter.finalize_chunks(state))
    with pytest.raises(RuntimeError, match="fresh counter"):
        counter.init_state()


@pytest.mark.parametrize("chunks", ["0", "1", "7"])
def test_finalize_chunking_does_not_change_the_merge(fasta, tmp_path,
                                                     monkeypatch, chunks):
    """The residual pull may be chunked any way (the merge reads it long
    after a pinned chunk buffer would be reused)."""
    monkeypatch.setenv("FINDKMER_FINALIZE_CHUNKS", chunks)
    cfg = Config(k=17, spill_dir=str(tmp_path / "sp"), **SPILL)
    counter, state = _count(fasta, cfg)
    assert counter._spill_n >= 2
    parts = list(counter.finalize_chunks(state))
    got = (np.concatenate([c for c, _ in parts]),
           np.concatenate([n for _, n in parts]))
    _assert_spectrum(got, _oracle(fasta, 17))


def test_exact_distinct_count_decides_the_spill(tmp_path):
    """Repeat-heavy input: a motif's codes land in many store rows, so the
    entry sum passes sparse_capacity long before the distinct count does.
    With the capacity just above the true distinct count the cross-row
    dedup runs and nothing spills; just below it, a run is written."""
    rng = np.random.default_rng(3)
    motif = random_dna(rng, 57)
    path = tmp_path / "rep.fa"
    path.write_text(">rep\n" + motif * 300 + "\n>tail\n" + motif[:40] + "\n")
    k = 13
    n_distinct = len(count_fasta_file(str(path), k))
    base = dict(k=k, chunk_len=64, batch_rows=2, sparse_compact_entries=256)
    for capacity, spills in ((n_distinct + 3, False), (n_distinct - 9, True)):
        cfg = Config(sparse_capacity=capacity,
                     spill_dir=str(tmp_path / f"sp{capacity}"), **base)
        counter = KmerCounter(cfg, CPU)
        dedups = []
        dedup = counter._dedup_state
        counter._dedup_state = lambda st: dedups.append(1) or dedup(st)
        counter, state = _count(str(path), cfg, counter)
        assert dedups, "the dedup path did not run"
        assert bool(counter._spill_n) == spills
        _assert_spectrum(counter.finalize(state), _oracle(str(path), k))


def test_spill_requires_sparse(tmp_path):
    with pytest.raises(ValueError, match="requires a sparse table"):
        KmerCounter(Config(k=4, spill_dir=str(tmp_path / "sp")), CPU)
    assert not (tmp_path / "sp").exists()


def test_adopt_spill_runs_truncates_and_validates(tmp_path):
    """Runs past the checkpoint's manifest are deleted (their batches
    replay); a truncated dir is unrecoverable."""
    sp = tmp_path / "sp"
    for i in range(3):
        spill.write_run(str(sp), i, np.array([i + 1], np.uint64),
                        np.array([1], np.int64))
    tok = spill.write_token(str(sp))
    cfg = Config(k=21, spill_dir=str(sp))
    c = KmerCounter(cfg, CPU)
    c.adopt_spill_runs(2, token=tok)
    assert c._spill_n == 2
    assert len(spill.load_runs(str(sp))) == 2  # run 2 deleted
    with pytest.raises(RuntimeError, match="expects 5 spill runs"):
        KmerCounter(cfg, CPU).adopt_spill_runs(5, token=tok)
    with pytest.raises(ValueError, match="--spill is off"):
        KmerCounter(Config(k=21), CPU).adopt_spill_runs(1)
    KmerCounter(Config(k=21), CPU).adopt_spill_runs(0)  # nothing to adopt


def test_adopt_spill_runs_refuses_foreign_runs(tmp_path):
    """Runs stamped by a DIFFERENT stream are neither adopted nor
    deleted; state from before the tokens resumes on an exact match."""
    sp = tmp_path / "sp"
    spill.write_run(str(sp), 0, np.array([7], np.uint64),
                    np.array([3], np.int64))
    spill.write_token(str(sp))  # the other stream's identity
    cfg = Config(k=21, spill_dir=str(sp))
    with pytest.raises(RuntimeError, match="different stream") as got:
        KmerCounter(cfg, CPU).adopt_spill_runs(0, token="someone-else")
    with pytest.raises(RuntimeError) as want:
        JaxCounter(_jax(cfg)).adopt_spill_runs(0, token="someone-else")
    assert str(got.value) == str(want.value)
    assert len(spill.load_runs(str(sp))) == 1  # nothing deleted
    with pytest.raises(RuntimeError, match="different stream"):
        KmerCounter(cfg, CPU).adopt_spill_runs(1, token=None)
    sp2 = tmp_path / "sp2"
    c = KmerCounter(Config(k=21, spill_dir=str(sp2)), CPU)
    c.adopt_spill_runs(0, token="restamped")  # a fresh dir is re-stamped
    assert spill.read_token(str(sp2)) == "restamped"
    sp3 = tmp_path / "sp3"
    spill.write_run(str(sp3), 0, np.array([9], np.uint64),
                    np.array([2], np.int64))
    c = KmerCounter(Config(k=21, spill_dir=str(sp3)), CPU)
    c.adopt_spill_runs(1, token=None)  # legacy-exact
    assert c._spill_n == 1 and len(spill.load_runs(str(sp3))) == 1


@pytest.mark.parametrize("resume_in", ["port", "jax"])
@pytest.mark.parametrize("k", [12, 21])
def test_spill_and_checkpoint_compose(fasta, tmp_path, k, resume_in):
    """A stream that spills and checkpoints, abandoned after a checkpoint
    that follows a spill and after one more spill: the resume adopts the
    checkpoint's runs, deletes the later one, replays its batches and
    ends at the same spectrum, in either package."""
    cfg = Config(k=k, spill_dir=str(tmp_path / "sp"), **SPILL)
    ck = str(tmp_path / "ck")
    counter = KmerCounter(cfg, CPU)
    state = counter.init_state()
    saved_runs = None
    for i, rows in enumerate(pipeline.batches_from_file(fasta, cfg)):
        state = counter.step(state, counter.put_batch(rows))
        if saved_runs is None and counter._spill_n >= 2:
            state = streaming._save(counter, ck, cfg, i + 1, state, None)
            saved_runs = counter._spill_n
        elif saved_runs is not None and counter._spill_n > saved_runs:
            break  # "crash" with a run that no checkpoint covers
    assert saved_runs and counter._spill_n > saved_runs
    if resume_in == "port":
        got = streaming.stream_count([fasta], cfg, checkpoint_dir=ck,
                                     checkpoint_every=4, device="cpu")
    else:
        got = jax_streaming.stream_count([fasta], _jax(cfg),
                                         checkpoint_dir=ck,
                                         checkpoint_every=4)
        got = (np.asarray(got[0], np.uint64), np.asarray(got[1], np.int64))
    _assert_spectrum(got, _oracle(fasta, k))
    assert spill.load_runs(cfg.spill_dir) == []


def test_jax_spill_and_checkpoint_resume_in_the_port(fasta, tmp_path):
    """The other direction: the JAX package spills and checkpoints, the
    port adopts its runs and finishes."""
    cfg = Config(k=21, spill_dir=str(tmp_path / "sp"), **SPILL)
    jcfg = _jax(cfg)
    ck = str(tmp_path / "ck")
    jc = JaxCounter(jcfg)
    js = jc.init_state()
    for i, rows in enumerate(jax_pipeline.batches_from_file(fasta, jcfg)):
        js = jc.step(js, rows)
        if jc._spill_n >= 2:
            jax_streaming._save(jc, ck, jcfg, i + 1, js, None)
            break
    got = streaming.stream_count([fasta], cfg, checkpoint_dir=ck,
                                 checkpoint_every=4, device="cpu")
    _assert_spectrum(got, _oracle(fasta, 21))


def test_two_simulated_hosts_spill_into_proc_subdirs(fasta, tmp_path):
    spd, ck = tmp_path / "sp", tmp_path / "ck"
    cfg = Config(k=17, spill_dir=str(spd), **SPILL)
    parts = [streaming.stream_count([fasta], cfg, num_processes=2,
                                    process_id=i, checkpoint_dir=str(ck),
                                    checkpoint_every=3, device="cpu")
             for i in range(2)]
    for sub in ("proc000", "proc001"):
        assert (spd / sub / "stream.token").exists()
        meta = ckpt_mod.load_latest(ck / sub, cfg)[3]
        assert meta["spill_runs"] >= 1
        assert meta["spill_token"] == spill.read_token(str(spd / sub))
    _assert_spectrum(sparse_ops.merge_host_runs(parts), _oracle(fasta, 17))


# ---- the heap-merge finalize ------------------------------------------------

@pytest.mark.parametrize("k, canonical", [(12, False), (21, True), (31, False)])
def test_heap_merge_finalize_equals_the_ordered_one(fasta, monkeypatch, k,
                                                    canonical):
    """FINDKMER_ORDERED_FINALIZE=0: another route to the same spectrum,
    which leaves the state as it was."""
    cfg = Config(k=k, canonical=canonical, chunk_len=64, batch_rows=8,
                 sparse_compact_entries=1024, sparse_capacity=1 << 16)
    counter, state = _count(fasta, cfg)
    ordered = counter.finalize(state)
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    merges = []
    store_to_host = counter._store_to_host
    counter._store_to_host = lambda *a: merges.append(1) or store_to_host(*a)
    _assert_spectrum(counter.finalize(state), ordered)
    assert merges == [1]
    _assert_spectrum(counter.finalize(state), ordered)  # state untouched
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "1")
    _assert_spectrum(counter.finalize(state), ordered)
    assert merges == [1, 1]
    _assert_spectrum(ordered, _oracle(fasta, k, canonical))


@pytest.mark.parametrize("ordered", ["0", "1"])
@pytest.mark.parametrize("k, canonical", [(12, False), (21, True)])
def test_first_spill_in_the_finalize_compaction(fasta, tmp_path, monkeypatch,
                                                k, canonical, ordered):
    """The raw buffer holds all but one compaction's worth, so the FIRST
    run is written by the finalize's own compaction.  Whatever
    FINDKMER_ORDERED_FINALIZE says, the route is chosen after that
    compaction: the spectrum holds the spilled k-mers and the run files
    are consumed."""
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", ordered)
    cfg = Config(k=k, canonical=canonical, spill_dir=str(tmp_path / "sp"),
                 **{**SPILL, "sparse_compact_entries": 16384})
    counter, state = _count(fasta, cfg)
    assert counter._spill_n == 0 and state.store is not None and state.fill
    got = counter.finalize(state)
    assert counter._spill_n == 1
    assert spill.load_runs(cfg.spill_dir) == []  # consumed and removed
    _assert_spectrum(got, _oracle(fasta, k, canonical))
    jcfg = _jax(cfg.replace(spill_dir=str(tmp_path / "jsp")))
    jc = JaxCounter(jcfg)
    js = jc.init_state()
    for rows in jax_pipeline.batches_from_file(fasta, jcfg):
        js = jc.step(js, rows)
    assert jc._spill_n == 0
    _assert_spectrum(got, jc.finalize(js))
    assert jc._spill_n == 1


@pytest.mark.parametrize("sub", ["count", "stream"])
def test_cli_heap_merge_setting_with_spill_bytes_equal(fasta, tmp_path,
                                                       monkeypatch, sub):
    """FINDKMER_ORDERED_FINALIZE=0 with --spill, the first run written at
    finalize: the bytes of the unspilled run, and no run file left."""
    base = ["-i", fasta, "-k", "21", "--canonical", "--chunk-len", "64",
            "--batch-rows", "8", "--sparse-compact-entries", "16384"]
    plain = tmp_path / "plain.tsv"
    assert torch_cli.main(["count", "--device", "cpu", "-o", str(plain)]
                          + base) == 0
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    out = tmp_path / "spilled.tsv"
    assert torch_cli.main([sub, "--device", "cpu", "-o", str(out), "--spill",
                           str(tmp_path / "sp"), "--sparse-capacity", "512"]
                          + base) == 0
    assert out.read_bytes() == plain.read_bytes() != b""
    assert os.listdir(tmp_path / "sp") == ["stream.token"]


# ---- the CLI ----------------------------------------------------------------

CLI_GEOM = ["--chunk-len", "256", "--batch-rows", "4",
            "--sparse-compact-entries", "2048"]


@pytest.mark.parametrize("sub", ["count", "stream"])
@pytest.mark.parametrize("k", ["12", "21"])
def test_cli_spill_bytes_equal(fasta, tmp_path, sub, k):
    """--spill with a tiny capacity == the unspilled run == the JAX CLI
    with --spill, byte for byte; the run files are gone afterwards."""
    base = ["-i", fasta, "-k", k, "--table-mode", "sparse"] + CLI_GEOM
    plain = tmp_path / "plain.tsv"
    assert torch_cli.main(["count", "--device", "cpu", "-o", str(plain)]
                          + base) == 0
    tiny = ["--sparse-capacity", "1024"]
    out = tmp_path / "spilled.tsv"
    assert torch_cli.main([sub, "--device", "cpu", "-o", str(out), "--spill",
                           str(tmp_path / "sp")] + base + tiny) == 0
    assert out.read_bytes() == plain.read_bytes() != b""
    assert os.listdir(tmp_path / "sp") == ["stream.token"]
    jout = tmp_path / "jax.tsv"
    assert jax_cli.main([sub, "-o", str(jout), "--spill",
                         str(tmp_path / "jsp")] + base + tiny) == 0
    assert jout.read_bytes() == out.read_bytes()


def test_cli_capacity_error_names_spill(fasta, tmp_path, capsys):
    rc = torch_cli.main(["count", "-i", fasta, "-k", "21", "--device", "cpu",
                         "-o", str(tmp_path / "o.tsv"), "--sparse-capacity",
                         "1024"] + CLI_GEOM)
    assert rc == 2
    err = capsys.readouterr().err
    assert "set --spill" in err and len(err.strip().splitlines()) == 1


@pytest.mark.parametrize("sub", ["count", "stream"])
def test_cli_heap_merge_finalize_bytes_equal(fasta, tmp_path, monkeypatch,
                                             sub):
    """FINDKMER_ORDERED_FINALIZE=0 from the CLI: written through
    write_spectrum, the same bytes as the streamed writer's and as the
    JAX CLI's under the same setting."""
    base = ["-i", fasta, "-k", "21", "--canonical"] + CLI_GEOM
    ordered = tmp_path / "ordered.tsv"
    assert torch_cli.main([sub, "--device", "cpu", "-o", str(ordered)]
                          + base) == 0
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    merged, jmerged = tmp_path / "merged.tsv", tmp_path / "jax.tsv"
    assert torch_cli.main([sub, "--device", "cpu", "-o", str(merged)]
                          + base) == 0
    assert jax_cli.main([sub, "-o", str(jmerged)] + base) == 0
    assert merged.read_bytes() == ordered.read_bytes() != b""
    assert jmerged.read_bytes() == merged.read_bytes()

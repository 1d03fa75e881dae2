"""The port's checkpoints against the JAX package's: one format.

`findkmer_torch/utils/checkpoint.py` writes the files that
`findkmer_tpu/utils/checkpoint.py` writes, so a stream that one package
began resumes in the other.  Shown here on numpy-seeded inputs on the CPU,
dense and sparse, narrow (k <= 15) and wide codes: the files' names, keys
and dtypes, the live entries they hold, and a resume across the packages
in both directions to the same final bytes.  All integers and bytes: the
tolerance is none.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu import streaming as jax_streaming
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_tpu.ops import sparse as jax_sparse
from findkmer_tpu.utils import checkpoint as jax_ckpt
from findkmer_torch import Config
from findkmer_torch import output, pipeline, streaming
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.table import SparseTable
from findkmer_torch.utils import checkpoint as ckpt_mod
from oracle.scalar import count_fasta_file, spectrum_lines

torch.set_num_threads(1)  # six test workers share the cores
CPU = torch.device("cpu")
GEOM = dict(chunk_len=128, batch_rows=4, sparse_compact_entries=1024,
            sparse_capacity=1 << 16)
# dense, sparse narrow, sparse wide with the uint16 hi plane, and with the
# uint32 one
CASES = [(6, False), (12, False), (21, True), (25, False)]


def _jax(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three records with N runs and a poly-T run of 45 (codes whose low
    word is all ones at k >= 16), ~9 kbase: some twenty batches."""
    rng = np.random.default_rng(17)
    recs = [random_dna(rng, n, n_prob=0.02, lower_prob=0.1)
            for n in (5000, 37, 4000)]
    recs[0] = recs[0][:700] + "T" * 45 + recs[0][700:]
    path = tmp_path_factory.mktemp("ck") / "in.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    return str(path)


def _port_prefix(path, cfg, ckpt, n):
    """The port counts the first n batches and checkpoints."""
    counter = KmerCounter(cfg, CPU)
    state = counter.init_state()
    for i, rows in enumerate(pipeline.batches_from_file(path, cfg)):
        if i >= n:
            break
        state = counter.step(state, counter.put_batch(rows))
    state, table = counter.table_state(state)
    return ckpt_mod.save(ckpt, cfg, n, table, {"batches": n},
                         extra={"num_processes": 1, "process_id": 0})


def _jax_prefix(path, cfg, ckpt, n):
    """The JAX package counts the first n batches and checkpoints."""
    jcfg = _jax(cfg)
    counter = JaxCounter(jcfg)
    state = counter.init_state()
    for i, rows in enumerate(jax_pipeline.batches_from_file(path, jcfg)):
        if i >= n:
            break
        state = counter.step(state, counter.put_batch(rows))
    state, table = counter.table_state(state)
    return jax_ckpt.save(ckpt, jcfg, n, table, {"batches": n},
                         extra={"num_processes": 1, "process_id": 0})


def _bytes(spectrum, cfg):
    import io

    f = io.BytesIO()
    output.write_spectrum(f, spectrum, cfg)
    return f.getvalue()


def _oracle_bytes(path, cfg):
    lines = spectrum_lines(
        count_fasta_file(path, cfg.k, canonical=cfg.canonical), cfg.k,
        canonical=cfg.canonical)
    return "".join(ln + "\n" for ln in lines).encode()


def _live(data, k):
    """A sparse checkpoint's live entries as a sorted (code, count) list,
    by the reference's own reading (`store_to_host_2d`)."""
    hi = data["hi"] if k > 15 else None
    codes, counts = jax_sparse.store_to_host_2d(hi, data["lo"], data["cnt"])
    return codes.tolist(), counts.tolist()


@pytest.mark.parametrize("k, canonical", CASES)
def test_checkpoint_files_equal_in_form_and_content(fasta, tmp_path, k,
                                                    canonical):
    cfg = Config(k=k, canonical=canonical, **GEOM)
    ours = _port_prefix(fasta, cfg, tmp_path / "t", 9)
    theirs = _jax_prefix(fasta, cfg, tmp_path / "j", 9)
    assert ours.name == theirs.name == "ckpt_0000000009.npz"
    assert json.loads((tmp_path / "t" / "latest.json").read_text()) == \
        json.loads((tmp_path / "j" / "latest.json").read_text())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["ckpt_0000000009.npz", "latest.json"]  # no temporary file stays
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].ndim == b[key].ndim, key
    if k <= 10:
        np.testing.assert_array_equal(a["counts"], b["counts"])
        return
    assert a["hi"].dtype == (ckpt_mod.hi_dtype(k) if k > 15 else np.uint32)
    assert _live(a, k) == _live(b, k)
    assert not a["overflow"]
    # dead slots carry the planes' own sentinels, live slots of narrow
    # codes a zero hi word
    dead = a["cnt"] == 0
    assert dead.any() and (a["lo"][dead] == 0xFFFFFFFF).all()
    assert (a["hi"][dead] == np.iinfo(a["hi"].dtype).max).all()
    if k <= 15:
        assert not a["hi"][~dead].any()


@pytest.mark.parametrize("crash_at", [4, 13])
@pytest.mark.parametrize("k, canonical", CASES)
def test_jax_checkpoint_resumes_in_the_port(fasta, tmp_path, k, canonical,
                                            crash_at):
    cfg = Config(k=k, canonical=canonical, **GEOM)
    ck = tmp_path / "ck"
    _jax_prefix(fasta, cfg, ck, crash_at)
    got = streaming.stream_count([fasta], cfg, checkpoint_dir=str(ck),
                                 checkpoint_every=5, device="cpu")
    assert _bytes(got, cfg) == _oracle_bytes(fasta, cfg)
    meta = json.loads((ck / "latest.json").read_text())
    assert meta["batch_index"] > crash_at  # the port went on checkpointing


@pytest.mark.parametrize("crash_at", [4, 13])
@pytest.mark.parametrize("k, canonical", CASES)
def test_port_checkpoint_resumes_in_jax(fasta, tmp_path, k, canonical,
                                        crash_at):
    cfg = Config(k=k, canonical=canonical, **GEOM)
    ck = tmp_path / "ck"
    _port_prefix(fasta, cfg, ck, crash_at)
    got = jax_streaming.stream_count([fasta], _jax(cfg),
                                     checkpoint_dir=str(ck),
                                     checkpoint_every=5)
    if isinstance(got, tuple):
        got = (np.asarray(got[0], np.uint64), np.asarray(got[1], np.int64))
    else:
        got = np.asarray(got)
    assert _bytes(got, cfg) == _oracle_bytes(fasta, cfg)


def test_a_stream_handed_back_and_forth(fasta, tmp_path):
    """JAX counts 4 batches, the port the next 5, JAX the rest."""
    cfg = Config(k=21, canonical=True, **GEOM)
    ck = str(tmp_path / "ck")
    _jax_prefix(fasta, cfg, ck, 4)
    index, table, _, _ = ckpt_mod.load_latest(ck, cfg)
    counter = KmerCounter(cfg, CPU)
    state = counter.restore_state(table)
    for rows in list(pipeline.batches_from_file(fasta, cfg))[index:9]:
        state = counter.step(state, counter.put_batch(rows))
    state, table = counter.table_state(state)
    ckpt_mod.save(ck, cfg, 9, table, {})
    got = jax_streaming.stream_count([fasta], _jax(cfg), checkpoint_dir=ck)
    got = (np.asarray(got[0], np.uint64), np.asarray(got[1], np.int64))
    assert _bytes(got, cfg) == _oracle_bytes(fasta, cfg)


def test_split_planes_strips_by_count_never_by_code():
    """A live code whose low word is all ones (a k-mer ending in 16 T's)
    survives the round trip; a hole that keeps a real code does not."""
    k = 21
    poly_t = 4 ** k - 1
    codes = torch.tensor([[5, poly_t, 77, 2 ** 63 - 1]])
    cnt = torch.tensor([[2, 3, 0, 0]], dtype=torch.int32)
    arrays = ckpt_mod.split_planes(codes, cnt, k)
    assert arrays["hi"].tolist() == [[0, poly_t >> 32, 0xFFFF, 0xFFFF]]
    assert arrays["lo"].dtype == np.uint32 and arrays["hi"].dtype == np.uint16
    assert arrays["lo"][0, 1] == 0xFFFFFFFF and arrays["hi"][0, 1] != 0xFFFF
    planes = ckpt_mod.SparsePlanes(k=k, **arrays)
    counter = KmerCounter(Config(k=k, **GEOM), CPU)
    got = counter.finalize(counter.restore_state(planes))
    assert got[0].tolist() == [5, poly_t] and got[1].tolist() == [2, 3]
    narrow = ckpt_mod.split_planes(
        torch.tensor([[9, 2 ** 31 - 1]], dtype=torch.int32),
        torch.tensor([[1, 0]], dtype=torch.int32), 12)
    assert narrow["hi"].tolist() == [[0, 0xFFFFFFFF]]
    assert narrow["lo"].tolist() == [[9, 0xFFFFFFFF]]


def test_int64_counts_round_trip(tmp_path):
    cfg = Config(k=21, count_dtype="int64", **GEOM)
    big = (1 << 40) + 7
    table = SparseTable(codes=torch.tensor([[3, 9, 2 ** 63 - 1]]),
                        counts=torch.tensor([[big, 1, 0]]), k=21)
    ckpt_mod.save(tmp_path, cfg, 1, table, {})
    assert np.load(tmp_path / "ckpt_0000000001.npz")["cnt"].dtype == np.int64
    _, loaded, _, _ = ckpt_mod.load_latest(tmp_path, cfg)
    counter = KmerCounter(cfg, CPU)
    got = counter.finalize(counter.restore_state(loaded))
    assert got[0].tolist() == [3, 9] and got[1].tolist() == [big, 1]


def test_load_latest_without_a_checkpoint(tmp_path):
    assert ckpt_mod.load_latest(tmp_path / "none", Config(k=5)) is None


def test_failed_save_leaves_no_temporary_file(tmp_path, monkeypatch):
    cfg = Config(k=4)
    counter = KmerCounter(cfg, CPU)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(OSError, match="disk full"):
        ckpt_mod.save(tmp_path, cfg, 1, counter.init_state(), {})
    assert list(tmp_path.iterdir()) == []

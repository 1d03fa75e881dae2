"""Counting over a mesh: the port's DistributedCounter against the JAX one.

The JAX counter runs in this process on the 8-virtual-device CPU mesh that
conftest.py sets up; the port's on a mesh of n CPU shards
(`findkmer_torch/parallel/mesh.py`).  The same numpy-seeded input goes
through each package's own batcher; the spectra must be equal to each
other and to oracle/scalar.py, the overflow flags and error messages
identical.  The tolerance is none: everything compared is integers, bytes
and strings.
"""

import io
import os

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import cli as jax_cli
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.io.fasta import FastaReader as JaxFastaReader
from findkmer_tpu.parallel import DistributedCounter as JaxDC
from findkmer_tpu.parallel import make_mesh as jax_mesh
from findkmer_torch import Config, api, pipeline
from findkmer_torch import cli as torch_cli
from findkmer_torch.io.fasta import FastaReader
from findkmer_torch.models.counter import KmerCounter, make_counter
from findkmer_torch.parallel import dryrun
from findkmer_torch.parallel.dist import DistributedCounter, ShardedBatch
from findkmer_torch.parallel.mesh import make_mesh
from test_vs_oracle import oracle_dict, spectrum_to_dict

torch.set_num_threads(1)  # six test workers share the cores
CPU = torch.device("cpu")
MESHES = (2, 4, 8)
GEOM = dict(chunk_len=64, batch_rows=8)


@pytest.fixture(scope="module")
def text():
    """Two records: random bases with N runs, lowercase and IUPAC codes,
    and a repeated motif (counts above 1, codes in several store rows)."""
    rng = np.random.default_rng(9)
    motif = random_dna(rng, 50)
    a = random_dna(rng, 2600, n_prob=0.02, lower_prob=0.1, iupac_prob=0.01)
    b = random_dna(rng, 700, n_prob=0.01) + motif * 12
    return f">a\n{a}\n>b\n{b}\n"


def _jax_count(text, kw, n, **dc_kw):
    cfg = JaxConfig(**kw)
    dc = JaxDC(cfg, jax_mesh(n), **dc_kw)
    state = dc.init_state()
    reader = JaxFastaReader(io.BytesIO(text.encode()))
    for rows in jax_pipeline.batches_from_codes(
            jax_pipeline.code_stream(reader), cfg):
        state = dc.step(state, rows)
    return dc.finalize(state), dc


def _torch_count(text, kw, n, **dc_kw):
    cfg = Config(**kw)
    dc = DistributedCounter(cfg, make_mesh(n, device="cpu"), **dc_kw)
    state = dc.init_state()
    reader = FastaReader(io.BytesIO(text.encode()))
    for rows in pipeline.batches_from_codes(pipeline.code_stream(reader),
                                            cfg):
        state = dc.step(state, rows)
    return dc.finalize(state), dc


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


def _both(text, kw, n, **dc_kw):
    """-> (port spectrum, JAX spectrum, port counter, JAX counter), the
    spectra asserted equal."""
    got, tdc = _torch_count(text, kw, n, **dc_kw)
    want, jdc = _jax_count(text, kw, n, **dc_kw)
    _equal(got, want)
    assert tdc.merge == jdc.merge
    return got, want, tdc, jdc


def _raises_alike(fn_torch, fn_jax, exc):
    with pytest.raises(exc) as got:
        fn_torch()
    with pytest.raises(exc) as want:
        fn_jax()
    assert str(got.value) == str(want.value)
    return str(got.value)


# ---- every merge mode against the JAX mesh and the oracle -------------------

@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("k", [1, 4, 8, 10])
@pytest.mark.parametrize("merge", ["psum", "psum_scatter"])
def test_replicated_merges(text, merge, k, n, canonical):
    kw = dict(k=k, canonical=canonical, merge=merge, **GEOM)
    if merge == "psum_scatter" and 4 ** k % n:
        # a table of fewer entries than shards: refused alike
        msg = _raises_alike(lambda: _torch_count(text, kw, n),
                            lambda: _jax_count(text, kw, n), ValueError)
        assert "psum_scatter needs table size" in msg
        return
    got, _, tdc, _ = _both(text, kw, n)
    assert tdc.merge == merge and got.shape == (4 ** k,)
    assert spectrum_to_dict(got, k) == oracle_dict(text, k, canonical)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("k", [8, 12])
def test_all_to_all_full_table(text, k, n, canonical):
    kw = dict(k=k, canonical=canonical, merge="all_to_all",
              table_mode="direct", **GEOM)
    got, _, tdc, jdc = _both(text, kw, n)
    assert tdc._route_cap == jdc._route_cap
    assert spectrum_to_dict(got, k) == oracle_dict(text, k, canonical)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("n", MESHES)
def test_all_to_all_scaled_table_partial_counts(n, canonical):
    """k=15 codes routed with the production geometry into a table of 4^8
    entries: the counts are exactly the full spectrum's first 4^8.  The
    bases are 90% A, so that low codes exist, and nearly every window
    routes to shard 0: the buckets are sized for it (the reference's dry
    run does the same)."""
    rng = np.random.default_rng(15)
    seq = np.where(rng.random(3000) < 0.9, "A",
                   np.array(list("ACGTN"))[rng.integers(0, 5, 3000)])
    text = ">r\n" + "".join(seq) + "\n"
    kw = dict(k=15, canonical=canonical, merge="all_to_all",
              table_mode="direct", route_capacity_factor=float(n), **GEOM)
    got, _, _, _ = _both(text, kw, n, table_entries=4 ** 8)
    assert got.shape == (4 ** 8,)
    want = np.zeros(4 ** 8, np.int64)
    for code, c in _oracle_codes(text, 15, canonical).items():
        if code < 4 ** 8:
            want[code] = c
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _oracle_codes(text, k, canonical):
    from findkmer_torch.ops.window import str_to_code

    return {str_to_code(m): c
            for m, c in oracle_dict(text, k, canonical).items()}


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("k", [11, 15, 16, 17, 21, 28, 29, 31])
def test_dp_sparse(text, k, n, canonical):
    """A small compaction threshold forces raw-only and store-carrying
    compactions, and squeezes, on every shard."""
    kw = dict(k=k, canonical=canonical, sparse_capacity=1 << 16,
              sparse_compact_entries=2048, **GEOM)
    got, _, tdc, jdc = _both(text, kw, n)
    assert tdc.merge == "dp_sparse"
    assert (tdc._sub, tdc._raw_cap0(), tdc._target_cap()) == \
        (jdc._sub, jdc._raw_cap0(), jdc._target_cap())
    assert spectrum_to_dict(got, k) == oracle_dict(text, k, canonical)


@pytest.mark.parametrize("n", [2, 8])
def test_dp_sparse_heap_merge_finalize(text, n, monkeypatch):
    """FINDKMER_ORDERED_FINALIZE=0: the row stores merged on the host, in
    both packages; the same spectrum as the ordered finalize."""
    kw = dict(k=21, sparse_compact_entries=2048, **GEOM)
    ordered, _ = _torch_count(text, kw, n)
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    got, _, _, _ = _both(text, kw, n)
    _equal(got, ordered)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("merge", ["dp_sparse", "psum", "psum_scatter",
                                   "all_to_all"])
def test_dp_sparse_finalize_chunks(text, merge, n):
    """finalize_chunks of every merge, in code order: the dp_sparse
    spectrum of finalize, or a dense merge's nonzero bins (its partials
    summed, or its shards from their code offsets)."""
    kw = dict(k=17, canonical=True, sparse_compact_entries=2048, **GEOM)
    if merge != "dp_sparse":
        kw = dict(k=8, canonical=True, merge=merge, **GEOM)
    want, _ = _torch_count(text, kw, n)
    cfg = Config(**kw)
    dc = DistributedCounter(cfg, make_mesh(n, device="cpu"))
    assert dc.merge == merge
    state = dc.init_state()
    for rows in pipeline.batches_from_codes(
            pipeline.code_stream(FastaReader(io.BytesIO(text.encode()))),
            cfg):
        state = dc.step(state, rows)
    parts = [(c.copy(), m.copy()) for c, m in dc.finalize_chunks(state)]
    got = (np.concatenate([c for c, _ in parts]),
           np.concatenate([m for _, m in parts]))
    if merge != "dp_sparse":
        nz = np.flatnonzero(want)
        want = (nz.astype(np.uint64), want[nz].astype(np.int64))
    _equal(got, want)


def test_dp_sparse_capacity_error_and_dedup(text):
    """The exact distinct count decides (cross-row dedup first); past the
    capacity both packages raise the same error."""
    kw = dict(k=21, sparse_capacity=16, sparse_compact_entries=256, **GEOM)
    _raises_alike(lambda: _torch_count(text, kw, 8),
                  lambda: _jax_count(text, kw, 8), RuntimeError)
    # repeat-heavy: the entry sum passes the capacity, the exact count not
    rep = ">r\n" + "ACGTTGCAAGGCTTAC" * 200 + "\n"
    kw = dict(k=21, sparse_capacity=40, sparse_compact_entries=256, **GEOM)
    got, _, _, _ = _both(rep, kw, 4)
    assert spectrum_to_dict(got, 21) == oracle_dict(rep, 21)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spill_run_count(tmp_path, n):
    """Every spill writes one run per shard that holds entries: the same
    number of runs as the reference, and the same spectrum.  The input
    passes the shards' 4096-slot compaction floor several times."""
    rng = np.random.default_rng(21)
    text = ">r\n" + random_dna(rng, 40000, n_prob=0.01) + "\n"
    kw = dict(k=21, canonical=True, sparse_capacity=64,
              sparse_compact_entries=1024, **GEOM)
    got, tdc = _torch_count(text, dict(kw, spill_dir=str(tmp_path / "t")),
                            n)
    want, jdc = _jax_count(text, dict(kw, spill_dir=str(tmp_path / "j")), n)
    _equal(got, want)
    assert tdc._spill_n == jdc._spill_n >= n
    plain, _ = _torch_count(text, kw | dict(sparse_capacity=1 << 16), n)
    _equal(got, plain)
    assert sorted(os.listdir(tmp_path / "t")) == ["stream.token"]


# ---- overflow and refusals -------------------------------------------------

@pytest.mark.parametrize("factor", [0.01, 0.3, 2.5, 8.0])
@pytest.mark.parametrize("n", [2, 8])
def test_route_overflow_parity(text, n, factor):
    """The same inputs overflow a bucket in both packages, with the same
    error; a skewed input (poly-A: one hot shard) at a small capacity."""
    skewed = ">r\n" + "A" * 3000 + text[3:]
    kw = dict(k=8, merge="all_to_all", route_capacity_factor=factor,
              **GEOM)
    try:
        want, jdc = _jax_count(skewed, kw, n)
    except RuntimeError as e:
        msg = _raises_alike(lambda: _torch_count(skewed, kw, n),
                            lambda: _jax_count(skewed, kw, n), RuntimeError)
        assert msg == str(e) and "overflow" in msg
        assert factor < 8.0  # a bucket of w_local slots never overflows
        return
    got, tdc = _torch_count(skewed, kw, n)
    _equal(got, want)
    assert factor > 0.01


def test_route_overflow_fails_fast():
    text = ">r\n" + "A" * 40000 + "\n"
    cfg = Config(k=8, merge="all_to_all", route_capacity_factor=0.01,
                 **GEOM)
    dc = DistributedCounter(cfg, make_mesh(8, device="cpu"))
    dc.overflow_check_every = 2
    state = dc.init_state()
    with pytest.raises(RuntimeError, match="overflow"):
        for i, rows in enumerate(pipeline.batches_from_codes(
                pipeline.code_stream(FastaReader(io.BytesIO(text.encode()))),
                cfg)):
            state = dc.step(state, rows)
            assert i < 3, "overflow not raised fast"


REFUSALS = {
    "table_entries_power_of_two": (
        dict(k=8, merge="all_to_all"), 4, dict(table_entries=1000)),
    "batch_rows_divisible": (dict(k=8, batch_rows=6, chunk_len=64), 4, {}),
    "spill_needs_sparse": (dict(k=8, spill_dir="SPILL"), 2, {}),
    "all_to_all_table_divisible": (
        dict(k=8, merge="all_to_all", batch_rows=6, chunk_len=64), 3, {}),
    "table_entries_all_to_all_only": (
        dict(k=8, merge="psum"), 2, dict(table_entries=1024)),
    "psum_scatter_table_divisible": (
        dict(k=8, merge="psum_scatter", batch_rows=6, chunk_len=64), 3, {}),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals(tmp_path, case):
    kw, n, dc_kw = REFUSALS[case]
    if kw.get("spill_dir"):
        kw = dict(kw, spill_dir=str(tmp_path / "sp"))
    msg = _raises_alike(
        lambda: DistributedCounter(Config(**kw), make_mesh(n, device="cpu"),
                                   **dc_kw),
        lambda: JaxDC(JaxConfig(**kw), jax_mesh(n), **dc_kw), ValueError)
    assert msg


def test_refusal_of_a_batch_the_mesh_cannot_split():
    cfg = dict(k=8, packed_h2d=False, **GEOM)
    rows = np.zeros((3, Config(**cfg).row_len), np.uint8)
    tdc = DistributedCounter(Config(**cfg), make_mesh(2, device="cpu"))
    jdc = JaxDC(JaxConfig(**cfg), jax_mesh(2))
    _raises_alike(lambda: tdc.step(tdc.init_state(), rows),
                  lambda: jdc.step(jdc.init_state(), rows), ValueError)


def test_mesh_and_make_counter():
    """make_mesh: the reference's "need N devices, have M"; a device may
    repeat.  make_counter: devices 1 and 0 (one CPU) take the single
    engine, N > 1 a mesh of N CPU shards; on cuda without cards the mesh
    cannot be built."""
    _raises_alike(lambda: make_mesh(16, devices=[CPU] * 8),
                  lambda: jax_mesh(16), ValueError)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        make_mesh(3, devices=[CPU, CPU])
    assert make_mesh(3, device="cpu") == [CPU] * 3
    assert isinstance(make_counter(Config(k=4), CPU), KmerCounter)
    assert isinstance(make_counter(Config(k=4, devices=0), CPU),
                      KmerCounter)
    dc = make_counter(Config(k=4, devices=8), CPU)
    assert isinstance(dc, DistributedCounter) and dc.n_dev == 8
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices, have"):
            make_counter(Config(k=4, devices=2), torch.device("cuda"))


def test_put_batch_and_prefetch_place_row_blocks():
    """put_batch sends rows [i*B/n, (i+1)*B/n) to shard i; the pipeline's
    prefetch takes it as its put= (the reference's keyword)."""
    cfg = Config(k=8, devices=4, **GEOM)
    dc = DistributedCounter(cfg, make_mesh(4, device="cpu"))
    packed = np.arange(8 * 3, dtype=np.uint8).reshape(8, 3)
    bits = np.arange(8 * 2, dtype=np.uint8).reshape(8, 2)
    got = dc.put_batch((packed, bits))
    assert isinstance(got, ShardedBatch) and len(got) == 4
    for i, (p, v) in enumerate(got):
        np.testing.assert_array_equal(p.numpy(), packed[2 * i : 2 * i + 2])
        np.testing.assert_array_equal(v.numpy(), bits[2 * i : 2 * i + 2])
    staged = list(pipeline.prefetch_to_device(iter([packed, packed]), 2,
                                              put=dc.put_batch))
    assert all(isinstance(b, ShardedBatch) for b in staged)


# ---- the CLI, selftest and the API over a mesh ------------------------------

CLI_MERGES = {
    "psum": ["-k", "8", "--merge", "psum"],
    "psum_scatter": ["-k", "8", "--canonical", "--merge", "psum_scatter"],
    "all_to_all": ["-k", "12", "--table-mode", "direct", "--merge",
                   "all_to_all"],
    "auto_dense": ["-k", "10", "--merge", "auto"],
    "dp_sparse": ["-k", "21", "--canonical", "--merge", "all_to_all"],
}


@pytest.mark.parametrize("case", list(CLI_MERGES))
def test_cli_count_devices_8(fixtures_dir, tmp_path, case):
    """`findkmer_torch count --device cpu --devices 8 --merge X`: the bytes
    of `findkmer count --devices 8 --merge X`."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    args = ["count", "-i", path, "--chunk-len", "1024", "--batch-rows",
            "8", "--devices", "8"] + CLI_MERGES[case]
    assert jax_cli.main(args + ["-o", str(tmp_path / "j.tsv")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "t.tsv"),
                                  "--device", "cpu"]) == 0
    want = (tmp_path / "j.tsv").read_bytes()
    assert (tmp_path / "t.tsv").read_bytes() == want and want


@pytest.mark.parametrize("flag", ["--per-record", "--per-input"])
def test_cli_per_record_and_per_input_on_a_mesh(fixtures_dir, tmp_path,
                                                 flag):
    paths = [os.path.join(fixtures_dir, f"{n}.fa") for n in ("tiny", "multi")]
    args = ["count", "-i", *paths, "-k", "5", flag, "--devices", "4",
            "--chunk-len", "256", "--batch-rows", "4"]
    assert jax_cli.main(args + ["-o", str(tmp_path / "j")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "t"),
                                  "--device", "cpu"]) == 0
    if flag == "--per-record":
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    else:
        names = sorted(os.listdir(tmp_path / "j"))
        assert sorted(os.listdir(tmp_path / "t")) == names
        for name in names:
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("k", ["8", "21"])
def test_cli_histo_devices_4(fixtures_dir, tmp_path, k):
    """`histo` recounts over the mesh too: the reference's bytes."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    args = ["histo", "-i", path, "-k", k, "--canonical", "--devices", "4",
            "--chunk-len", "1024", "--batch-rows", "8"]
    assert jax_cli.main(args + ["-o", str(tmp_path / "j")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "t"),
                                  "--device", "cpu"]) == 0
    want = (tmp_path / "j").read_bytes()
    assert (tmp_path / "t").read_bytes() == want and want


def test_selftest_devices_4(capsys):
    assert torch_cli.main(["selftest", "--device", "cpu", "--devices",
                           "4"]) == 0
    out = capsys.readouterr().out
    assert "counting with devices=4" in out
    assert "selftest OK (3/3 cases bit-exact)" in out


def test_api_count_on_a_mesh(fixtures_dir):
    path = os.path.join(fixtures_dir, "multi.fa")
    geom = dict(chunk_len=128, batch_rows=4)
    single = api.count(path, 13, canonical=True, device="cpu", **geom)
    mesh = api.count(path, 13, canonical=True, device="cpu", devices=4,
                     **geom)
    assert mesh.to_dict() == single.to_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(k=8, merge="psum"), dict(k=8, canonical=True,
                                  merge="psum_scatter"),
    dict(k=12, merge="all_to_all", table_mode="direct"),
    dict(k=21, canonical=True, sparse_compact_entries=2048)],
    ids=["psum", "psum_scatter", "all_to_all", "dp_sparse"])
def test_mesh_on_card_equals_cpu(text, kw):
    """Two shards of one card (the pinned stager, K2 in the psum steps, K3
    in every dp_sparse row sort) count what two CPU shards count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows_cuda
    from findkmer_torch.ops.cuda.window_histogram_kernel import (
        fused_window_histogram_cuda,
    )

    cfg = Config(devices=2, **GEOM, **kw)
    want, _ = _torch_count(text, dict(GEOM, **kw), 2)
    card = torch.device("cuda", 0)
    dc = DistributedCounter(cfg, [card, card])
    k2, k3 = fused_window_histogram_cuda.launches, sort_rows_cuda.launches
    state = dc.init_state()
    for rows in pipeline.prefetch_to_device(
            pipeline.batches_from_codes(pipeline.code_stream(
                FastaReader(io.BytesIO(text.encode()))), cfg),
            2, put=dc.put_batch):
        state = dc.step(state, rows)
    _equal(dc.finalize(state), want)
    if dc.merge.startswith("psum"):
        assert fused_window_histogram_cuda.launches > k2
    if dc.merge == "dp_sparse":
        assert sort_rows_cuda.launches > k3


# ---- the dry run -----------------------------------------------------------

@pytest.mark.parametrize("reference", ["host", "engine"])
def test_dryrun_every_leg(fixtures_dir, reference):
    """parallel/dryrun.py over 2 and 4 CPU shards: every leg equal to the
    numpy host count, or to the single-device counter; the checkpoint
    written at 4 shards is restored at 2, and at 1."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    # k <= 12: the engine reference's dense tables stay small here
    run = dryrun.DryRun(path, Config(batch_rows=8, chunk_len=1024),
                        reference=reference, k_route=12, k_scaled=12)
    for n, restore, width in ((4, None, 2), (2, [CPU], 1)):
        recs = run.run(make_mesh(n, device="cpu"), restore_mesh=restore)
        assert list(recs) == list(dryrun.LEGS)
        assert all(r["equal"] for r in recs.values())
        assert recs["checkpoint"]["restored_at"] == width
        assert recs["spill"]["spill_runs"] >= n


def test_mesh_count_never_imports_jax(fixtures_dir, tmp_path):
    from test_torch_guard import _without_jax

    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    _without_jax(
        "from findkmer_torch.cli import main\n"
        f"assert main(['count', '-i', {path!r}, '-k', '21', '--devices',"
        " '4', '--device', 'cpu', '--batch-rows', '8', '--chunk-len',"
        " '1024', '-o', 'o.tsv']) == 0\n"
        "from findkmer_torch.parallel import dryrun\n"
        f"assert dryrun.main(['-i', {path!r}, '--shards', '2',"
        " '--device', 'cpu', '--batch-rows', '8']) == 0\n",
        tmp_path)
    from oracle.scalar import count_fasta_file, spectrum_lines

    assert (tmp_path / "o.tsv").read_text().splitlines() == \
        spectrum_lines(count_fasta_file(path, 21), 21)

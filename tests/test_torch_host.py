"""The port's own host layer against the JAX package's originals.

`findkmer_torch` keeps its own copy of every host module it needs
(`config`, `io/*`, `output`, `utils/*`, the CLI's argument helpers, the
API's `Spectrum`, the selftest's case builders, the FASTQ block reader).
A copy can drift, so each one is held here to its original in
`findkmer_tpu` on the same numpy-seeded inputs.  Everything compared is
integers and bytes: the tolerance is none.
"""

import dataclasses
import gzip
import io
import os

import numpy as np
import pytest

import findkmer_tpu.api as jax_api
import findkmer_tpu.cli as jax_cli
import findkmer_tpu.config as jax_config
import findkmer_tpu.filter as jax_filter
import findkmer_tpu.io.encode as jax_encode
import findkmer_tpu.io.fasta as jax_fasta
import findkmer_tpu.io.fastq as jax_fastq
import findkmer_tpu.io.native as jax_native
import findkmer_tpu.io.sam as jax_sam
import findkmer_tpu.output as jax_output
import findkmer_tpu.pipeline as jax_pipeline
import findkmer_tpu.parallel.multihost as jax_multihost
import findkmer_tpu.selftest as jax_selftest
import findkmer_tpu.spill as jax_spill
import findkmer_tpu.utils.logging as jax_logging
import findkmer_tpu.spectra as jax_spectra
import findkmer_tpu.version as jax_version
import findkmer_torch
import findkmer_torch.api as api
import findkmer_torch.cli as cli
import findkmer_torch.config as config
import findkmer_torch.io as port_io
import findkmer_torch.io.encode as encode
import findkmer_torch.io.fasta as fasta
import findkmer_torch.io.fastq as fastq
import findkmer_torch.io.native as native
import findkmer_torch.io.sam as sam
import findkmer_torch.output as output
import findkmer_torch.pipeline as pipeline
import findkmer_torch.parallel.multihost as multihost
import findkmer_torch.selftest as selftest
import findkmer_torch.spill as spill
import findkmer_torch.utils.logging as port_logging
import findkmer_torch.version as version
from findkmer_torch.utils import directio, malloc_tuning, prof, shmalloc
from test_sam import make_bam, make_sam

FASTAS = ["tiny.fa", "multi.fa", "ecoli_frag.fa", "debruijn4.fa"]


def _jax(cfg):
    """The JAX package's Config with the same fields."""
    return jax_config.Config(**dataclasses.asdict(cfg))


def _dna_bytes(seed, n):
    """Random sequence bytes: ACGT in both cases, N, IUPAC codes, and a
    few bytes that are no letter at all."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtNnRYSWKMBDHVryswkmbdhv-*.0 \xff",
                             np.uint8)
    p = np.full(alphabet.size, 0.2 / (alphabet.size - 8))
    p[:8] = 0.1
    return alphabet[rng.choice(alphabet.size, n, p=p)]


# ---- config, version --------------------------------------------------------

def test_config_fields_and_defaults_equal():
    ours = dataclasses.fields(config.Config)
    theirs = dataclasses.fields(jax_config.Config)
    assert [(f.name, f.type, f.default) for f in ours] == \
        [(f.name, f.type, f.default) for f in theirs]
    assert findkmer_torch.Config is config.Config
    consts = [n for n in dir(jax_config) if n.isupper()]
    assert consts and all(
        getattr(config, n) == getattr(jax_config, n) for n in consts)
    assert version.__version__ == jax_version.__version__


@pytest.mark.parametrize("table_mode", ["auto", "direct", "sparse"])
@pytest.mark.parametrize("k", range(4, 32))
def test_config_resolved_table_mode(k, table_mode):
    cfg = config.Config(k=k, table_mode=table_mode)
    ref = _jax(cfg)
    try:
        want = ref.resolved_table_mode
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cfg.resolved_table_mode
        assert str(got.value) == str(e)
        return
    assert cfg.resolved_table_mode == want
    for prop in ("table_size", "window_len", "row_len"):
        assert getattr(cfg, prop) == getattr(ref, prop)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.replace(k=5, canonical=True)) == \
        dataclasses.asdict(ref.replace(k=5, canonical=True))


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=32), dict(table_mode="dense"), dict(k=9, chunk_len=8),
    dict(input_format="gff"), dict(count_dtype="int16"), dict(min_qual=95),
    dict(min_qual=3, input_format="fasta"),
])
def test_config_rejects_what_the_original_rejects(bad):
    with pytest.raises(ValueError) as want:
        jax_config.Config(**bad)
    with pytest.raises(ValueError) as got:
        config.Config(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    {}, dict(k=21, canonical=True, spill_dir="runs/x", sparse_capacity=77),
    dict(k=12, table_mode="sparse", count_dtype="int64", sep=" : ",
         route_capacity_factor=1.25, min_count=2, input_format="fastq",
         min_qual=20),
], ids=["defaults", "spill", "mixed"])
def test_config_json_equal(fields):
    """to_json is what a checkpoint's manifest stores: the same string as
    the reference's, so that each package rebuilds the other's Config."""
    cfg = config.Config(**fields)
    ref = jax_config.Config(**fields)
    assert cfg.to_json() == ref.to_json()
    assert config.Config.from_json(ref.to_json()) == cfg
    assert dataclasses.asdict(jax_config.Config.from_json(cfg.to_json())) \
        == dataclasses.asdict(cfg)
    for k in (15, 16):
        assert config.Config(k=k).needs_wide_codes == \
            jax_config.Config(k=k).needs_wide_codes == (k > 15)


@pytest.mark.parametrize("level", [None, "DEBUG", "info", "ERROR"])
def test_get_logger_reads_the_level(monkeypatch, level):
    """--log sets FINDKMER_LOGLEVEL; the first get_logger reads it, as the
    original's does (both configure the one "findkmer" logger)."""
    import logging

    if level is None:
        monkeypatch.delenv("FINDKMER_LOGLEVEL", raising=False)
    else:
        monkeypatch.setenv("FINDKMER_LOGLEVEL", level)
    root = logging.getLogger("findkmer")
    before = (root.level, list(root.handlers))
    try:
        levels = []
        for mod in (jax_logging, port_logging):
            monkeypatch.setattr(mod, "_CONFIGURED", False)
            root.handlers.clear()
            log = mod.get_logger("findkmer.stream")
            assert log.name == "findkmer.stream" and log.parent is root
            assert len(root.handlers) == 1
            assert mod.get_logger() is root and len(root.handlers) == 1
            levels.append((root.level, root.handlers[0].formatter._fmt))
        assert levels[0] == levels[1]
        assert levels[1][0] == getattr(logging, (level or "WARNING").upper())
    finally:
        root.setLevel(before[0])
        root.handlers[:] = before[1]


# ---- spill, multihost -------------------------------------------------------

def test_spill_functions_equal(tmp_path):
    """spill.py function by function: the two packages write the same
    bytes under the same names and read each other's state."""
    rng = np.random.default_rng(9)
    dirs = {}
    for name, mod in (("ours", spill), ("theirs", jax_spill)):
        d = str(tmp_path / name)
        dirs[name] = d
        mod.init_dir(d)
        assert len(mod.read_token(d)) == 32
        assert mod.write_token(d, "tok") == "tok" == mod.read_token(d)
        assert not mod._any_run_files(d)
        gen = np.random.default_rng(9)
        for i in (0, 1, 2, 4):
            codes = np.unique(gen.integers(0, 1 << 50, 300).astype(np.uint64))
            counts = gen.integers(1, 1 << 33, codes.size)
            mod.write_run(d, i, codes, counts.astype(np.int32 if i else
                                                     np.int64))
        assert mod._any_run_files(d)
        assert mod._run_paths(d, 7) == (
            os.path.join(d, "run00007.codes.npy"),
            os.path.join(d, "run00007.counts.npy"))
    names = sorted(os.listdir(dirs["ours"]))
    assert names == sorted(os.listdir(dirs["theirs"]))
    for n in names:
        assert open(os.path.join(dirs["ours"], n), "rb").read() == \
            open(os.path.join(dirs["theirs"], n), "rb").read()
    ours, theirs = spill.load_runs(dirs["theirs"]), \
        jax_spill.load_runs(dirs["ours"])
    assert len(ours) == len(theirs) == 3  # the walk stops at the gap
    for block in (50, 1 << 22):
        for (a, b), (c, d) in zip(spill.iter_merged(ours, block),
                                  jax_spill.iter_merged(theirs, block)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    parts = [np.asarray(c[:40]) for c, _ in ours], \
        [np.asarray(n[:40]) for _, n in ours]
    for a, b in zip(spill._merge_block(*parts), jax_spill._merge_block(*parts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for mod, d in ((spill, dirs["theirs"]), (jax_spill, dirs["ours"])):
        with pytest.raises(ValueError, match="already contains run files"):
            mod.init_dir(d)
        mod.remove_runs_from(d, 2)
        assert sorted(os.listdir(d)) == [
            "run00000.codes.npy", "run00000.counts.npy",
            "run00001.codes.npy", "run00001.counts.npy", "stream.token"]
        mod.remove_runs(d)
        assert os.listdir(d) == ["stream.token"]
        assert mod.read_token(str(tmp_path / "nowhere")) is None
    del rng


@pytest.mark.parametrize("args, env", [
    ((None, None, None), {}),
    ((None, 4, 3), {}),
    ((None, None, None), {"FINDKMER_NUM_PROCESSES": "3",
                          "FINDKMER_PROCESS_ID": "1"}),
    ((None, 2, None), {"FINDKMER_PROCESS_ID": "1"}),
    ((None, 1, 5), {}),
    ((None, 2, 2), {}),
    ((None, 2, -1), {}),
])
def test_multihost_without_a_coordinator_equal(monkeypatch, args, env):
    for name in ("FINDKMER_COORDINATOR", "FINDKMER_NUM_PROCESSES",
                 "FINDKMER_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        want = jax_multihost.initialize(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            multihost.initialize(*args)
        assert str(got.value) == str(e)
        return
    assert multihost.initialize(*args) == want
    for p in range(1, 4):
        for h in range(p):
            assert list(multihost.shard_batches_round_robin(
                iter(range(11)), p, h)) == list(
                jax_multihost.shard_batches_round_robin(
                    iter(range(11)), p, h))


# ---- encode, native ---------------------------------------------------------

def test_encode_tables_equal():
    np.testing.assert_array_equal(encode.LUT, jax_encode.LUT)
    assert encode.INVALID == jax_encode.INVALID
    import findkmer_tpu.io as jax_io

    assert set(port_io.__all__) - {"FastqReader"} <= set(jax_io.__all__)
    assert all(hasattr(port_io, n) for n in port_io.__all__)


@pytest.mark.parametrize("prefer_native", [False, True],
                         ids=["numpy", "native"])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1000, 65537])
def test_encode_bytes_equal(n, prefer_native):
    buf = _dna_bytes(n, n)
    want = jax_encode.encode_bytes(buf, prefer_native=prefer_native)
    got = encode.encode_bytes(buf, prefer_native=prefer_native)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        encode.encode_bytes(buf.tobytes(), prefer_native=prefer_native), want)


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy", "native"])
@pytest.mark.parametrize("B,L,R", [(1, 8, 8), (5, 64, 70), (3, 100, 107),
                                   (4, 33, 63), (2, 4099, 4129)])
def test_pack_rows_equal(B, L, R, use_native):
    """The 2-bit wire of a batch (packed codes and validity bits, rows
    padded to a multiple of 8 slots): both packers against the originals,
    and against the reference's one-stream `pack_2bit` row by row."""
    if use_native:
        _need_native()
    work = jax_encode.encode_bytes(_dna_bytes(B * L + R, (B - 1) * L + R + 5),
                                   prefer_native=False)
    R8 = (R + 7) // 8 * 8
    if use_native:
        got = native.pack_rows(work, B, L, R)
        want = jax_native.pack_rows(work, B, L, R)
    else:
        got = pipeline._numpy_pack_rows(work, B, L, R, R8)
        want = jax_pipeline._numpy_pack_rows(work, B, L, R, R8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for i in range(B):
        row = np.full(R8, encode.INVALID, np.uint8)
        row[:R] = work[i * L : i * L + R]
        packed, validmask, _ = jax_encode.pack_2bit(row)
        np.testing.assert_array_equal(got[0][i], packed)
        np.testing.assert_array_equal(got[1][i], validmask)


def _need_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler: the native encoder did not build")


def test_native_entry_points_equal():
    _need_native()
    assert native.lib_path().parent.name == "torch_native"
    raw = _dna_bytes(5, 5000)
    raw[::61] = ord("\n")  # whitespace, which the compacting encoder strips
    np.testing.assert_array_equal(native.encode(raw), jax_native.encode(raw))
    out_a = np.full(6000, 9, np.uint8)
    out_b = out_a.copy()
    m = native.encode_compact_into(raw, out_a, 17)
    assert m == jax_native.encode_compact_into(raw, out_b, 17)
    np.testing.assert_array_equal(out_a, out_b)
    assert native.count_acgt(out_a, 17, m) == \
        jax_native.count_acgt(out_b, 17, m)
    B, L, R = 6, 100, 107
    work = jax_native.encode(_dna_bytes(6, (B - 1) * L + R + 3))
    for a, b in zip(native.pack_rows(work, B, L, R),
                    jax_native.pack_rows(work, B, L, R)):
        np.testing.assert_array_equal(a, b)
    codes = np.sort(np.random.default_rng(7).integers(
        0, 4 ** 21, 500).astype(np.uint64))
    counts = np.random.default_rng(8).integers(1, 10 ** 12, 500)
    assert bytes(native.format_spectrum(codes, counts, 21, b"\t")) == \
        bytes(jax_native.format_spectrum(codes, counts, 21, b"\t"))
    with pytest.raises(ValueError):
        native.encode_compact_into(raw, out_a, 2000)  # does not fit
    with pytest.raises(ValueError):
        native.format_spectrum(codes, counts, 21, b"::")


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 9, 4097, 1 << 17])
def test_native_packed_compact_and_valid_equal(n):
    """encode_packed, encode_compact (from an array and from bytes) and
    count_valid against the originals, on fuzzed bytes of every class
    (lengths at the 2-bit and bitmask seams, and past the C loops'
    multithreading threshold), with whitespace for the compactor."""
    _need_native()
    raw = _dna_bytes(n + 11, n)
    raw[::53] = ord("\n")
    for a, b in zip(native.encode_packed(raw), jax_native.encode_packed(raw)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.encode_compact(raw),
                                  jax_native.encode_compact(raw))
    np.testing.assert_array_equal(native.encode_compact(raw.tobytes()),
                                  jax_native.encode_compact(raw.tobytes()))
    assert native.count_valid(raw) == jax_native.count_valid(raw) == \
        int((jax_native.encode(raw) < 4).sum())


def _fuzzed_reads(seed, n=300):
    """(joined bytes with one N between reads, starts, lens) of fuzzed
    reads: every byte class of _dna_bytes, empty and all-N reads."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 200, n)
    lens[::37] = 0
    lens[3] = 50
    reads = [bytes(_dna_bytes(seed + i, int(ln))) for i, ln in
             enumerate(lens)]
    reads[3] = b"N" * 50
    assert sum(map(len, reads)) == lens.sum()
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])
    return reads, starts, lens.astype(np.int64)


@pytest.mark.parametrize("k, canonical", [(1, False), (7, True),
                                          (16, True), (21, False),
                                          (31, True)])
def test_filter_native_functions_equal(k, canonical):
    """fk_filter_hits, fk_filter_prepare, fk_filter_bitmap_hits(2) through
    the port's wrappers and the originals, on fuzzed reads."""
    _need_native()
    reads, starts, lens = _fuzzed_reads(k)
    buf = np.frombuffer(b"N".join(reads), np.uint8)
    rng = np.random.default_rng(k)
    codes, valid = jax_filter.window_codes_host(bytes(buf), k)
    table = np.unique(np.concatenate([
        codes[valid][rng.random(int(valid.sum())) < 0.3],
        rng.integers(0, 4 ** k, 50, dtype=np.uint64)]))
    if canonical:
        table = np.unique(np.minimum(
            table, jax_spectra.revcomp_codes_u64(table, k)))
    spec = jax_filter.FilterSpec(k=k, codes=table, canonical=canonical)
    args = (buf, starts, lens, k, canonical, spec.codes, spec._bloom,
            spec._shift)
    got, want = native.filter_hits(*args), jax_native.filter_hits(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].sum() > 0
    out_a, out_b = (np.full(buf.size + 9, 7, np.uint8) for _ in range(2))
    native.filter_prepare(buf, out_a)
    jax_native.filter_prepare(buf, out_b)
    np.testing.assert_array_equal(out_a, out_b)
    words = rng.integers(0, 2 ** 32, (buf.size + 64) // 32 + 1,
                         dtype=np.uint64).astype(np.uint32)
    halo = k - 1
    got = native.filter_bitmap_hits(buf, starts, lens, k, words, halo)
    want = jax_native.filter_bitmap_hits(buf, starts, lens, k, words, halo)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the block form: reads at other byte offsets of a block buffer
    block = np.frombuffer(b"@x\n".join(reads), np.uint8)
    byte_starts = np.zeros(len(reads), np.int64)
    np.cumsum(lens[:-1] + 3, out=byte_starts[1:])
    got = native.filter_bitmap_hits2(block, byte_starts, starts, lens, k,
                                     words, halo)
    want = jax_native.filter_bitmap_hits2(block, byte_starts, starts, lens,
                                          k, words, halo)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.filter_bitmap_hits(buf, starts, lens, k,
                                  words.astype(np.int64), halo)
    with pytest.raises(ValueError):
        native.filter_prepare(buf, out_a[:10])


@pytest.mark.parametrize("k", [1, 5, 21, 31])
def test_spectrum_parsing_equal(tmp_path, k):
    """parse_spectrum, _infer_k, _parse_binary, read_spectrum and
    canonize_runs of the port's spectra.py against the originals: a clean
    sorted spectrum, an unsorted one (the C parser declines), gzipped,
    and a multi-byte separator."""
    _need_native()
    from findkmer_torch import spectra

    rng = np.random.default_rng(k)
    codes = np.unique(rng.integers(0, 4 ** k, 400, dtype=np.uint64))
    counts = rng.integers(1, 10 ** 9, codes.size)
    text = bytes(jax_native.format_spectrum(codes, counts, k, b"\t"))
    for a, b in zip(native.parse_spectrum(text, k, b"\t"),
                    jax_native.parse_spectrum(text, k, b"\t")):
        np.testing.assert_array_equal(a, b)
    lines = text.splitlines(keepends=True)
    shuffled = b"".join(lines[::-1])
    assert native.parse_spectrum(shuffled, k, b"\t") is None
    assert jax_native.parse_spectrum(shuffled, k, b"\t") is None
    with pytest.raises(ValueError):
        native.parse_spectrum(text, k, b"::")
    paths = {"sorted.tsv": text, "unsorted.tsv": shuffled,
             "sep.tsv": text.replace(b"\t", b"::"),
             "empty.tsv": b"", "long.tsv": b"A" * 40 + b"\t3\n"}
    for name, body in paths.items():
        (tmp_path / name).write_bytes(body)
    with gzip.open(tmp_path / "gz.tsv", "wb") as f:
        f.write(text)
    for name in list(paths) + ["gz.tsv"]:
        p = str(tmp_path / name)
        sep = b"::" if name == "sep.tsv" else b"\t"
        assert spectra._infer_k(p, sep) == jax_spectra._infer_k(p, sep)
        kk = jax_spectra._infer_k(p, sep)
        if kk is not None and len(sep) == 1:
            got = spectra._parse_binary(p, kk, sep)
            want = jax_spectra._parse_binary(p, kk, sep)
            assert (got is None) == (want is None), name
            for a, b in zip(got or (), want or ()):
                np.testing.assert_array_equal(a, b)
        if name != "empty.tsv":
            assert spectra.read_spectrum(p, sep.decode()) == \
                jax_spectra.read_spectrum(p, sep.decode())
    for a, b in zip(spectra.canonize_runs(codes, counts, k),
                    jax_spectra.canonize_runs(codes, counts, k)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(spectra.canonize_runs(codes[:0], counts[:0], k),
                    jax_spectra.canonize_runs(codes[:0], counts[:0], k)):
        np.testing.assert_array_equal(a, b)


def test_spectrum_dict_cap_equal(tmp_path, monkeypatch):
    from findkmer_torch import spectra

    p = tmp_path / "s.tsv"
    p.write_text("".join(f"{c}\t1\n" for c in ("AC", "AG", "AT", "CA")))
    monkeypatch.setenv("FINDKMER_DICT_MAX", "2")
    assert spectra._dict_max() == jax_spectra._dict_max() == 2
    errs = []
    for mod in (spectra, jax_spectra):
        with pytest.raises(ValueError) as e:
            mod.read_spectrum(str(p))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    p.write_text("AC\tx\n")
    monkeypatch.setenv("FINDKMER_DICT_MAX", "nan")
    assert spectra._dict_max() == jax_spectra._dict_max()
    for mod in (spectra, jax_spectra):
        with pytest.raises(ValueError) as e:
            mod.read_spectrum(str(p))
        errs.append(str(e.value))
    assert errs[2] == errs[3]


# ---- readers ----------------------------------------------------------------

def _chunks(reader):
    with reader:
        return [(c.record_id, c.header, bytes(c.data), c.final)
                for c in reader.chunks()]


@pytest.mark.parametrize("strip_ws", [True, False], ids=["strip", "raw"])
@pytest.mark.parametrize("block", [7, 64, 1 << 22])
@pytest.mark.parametrize("name", FASTAS)
def test_fasta_reader_equal(fixtures_dir, name, block, strip_ws):
    path = os.path.join(fixtures_dir, name)
    want = _chunks(jax_fasta.FastaReader(path, block, strip_ws))
    assert want
    assert _chunks(fasta.FastaReader(path, block, strip_ws)) == want
    with fasta.FastaReader(path) as r:
        assert list(r.records()) == jax_fasta.read_records(path)


def test_fasta_reader_gzip_crlf_and_pushback(fixtures_dir, tmp_path):
    raw = open(os.path.join(fixtures_dir, "multi.fa"), "rb").read()
    gz = tmp_path / "multi.fa.gz"
    gz.write_bytes(gzip.compress(raw))
    crlf = tmp_path / "crlf.fa"
    crlf.write_bytes(raw.replace(b"\n", b"\r\n"))
    for path in (gz, crlf):
        assert _chunks(fasta.FastaReader(str(path), 50)) == \
            _chunks(jax_fasta.FastaReader(str(path), 50))
    for mod in (fasta, jax_fasta):
        s = mod.pushback_stream(raw[:10], io.BytesIO(raw[10:]))
        assert s.read() == raw
    f, own = fasta.open_maybe_gzip(io.BytesIO(gzip.compress(raw)))
    assert not own and f.read() == raw


@pytest.mark.parametrize("block", [5, 64, 1 << 22])
def test_fasta_reader_line_endings_equal(tmp_path, block):
    """Headers ended by LF, CRLF or a lone CR, mixed in one file of many
    short records, and an unterminated last header: the same chunks."""
    rng = np.random.default_rng(block)
    ends = [b"\n", b"\r\n", b"\r"]
    body = b"".join(
        b">r%d x%s%s%s" % (i, ends[i % 3], bytes(_dna_bytes(i, int(n))),
                            ends[(i // 3) % 3])
        for i, n in enumerate(rng.integers(0, 90, 300)))
    path = tmp_path / "mixed.fa"
    path.write_bytes(body + b">last header")
    for strip_ws in (True, False):
        assert _chunks(fasta.FastaReader(str(path), block, strip_ws)) == \
            _chunks(jax_fasta.FastaReader(str(path), block, strip_ws))


def _reads(fixtures_dir, seed=3):
    """(name, sequence, quality) reads cut from the FASTA fixtures, with
    seeded phred+33 qualities."""
    rng = np.random.default_rng(seed)
    reads = []
    for name in ("multi.fa", "ecoli_frag.fa"):
        for header, seq in jax_fasta.read_records(
                os.path.join(fixtures_dir, name)):
            for s in range(0, min(len(seq), 3000), 150):
                part = seq[s : s + int(rng.integers(30, 150))].decode()
                if part:
                    qual = "".join(chr(33 + int(q))
                                   for q in rng.integers(0, 42, len(part)))
                    reads.append((f"{name}.{len(reads)} x", part, qual))
    return reads


@pytest.fixture(scope="module")
def fastq_path(fixtures_dir, tmp_path_factory):
    path = tmp_path_factory.mktemp("fq") / "reads.fq"
    path.write_text("".join(f"@{n}\n{s}\n+\n{q}\n"
                            for n, s, q in _reads(fixtures_dir)))
    return str(path)


@pytest.mark.parametrize("min_qual", [0, 20])
@pytest.mark.parametrize("block", [33, 1 << 22])
def test_fastq_reader_equal(fastq_path, block, min_qual):
    want = _chunks(jax_fastq.FastqReader(fastq_path, block, min_qual))
    assert len(want) > 50
    assert _chunks(fastq.FastqReader(fastq_path, block, min_qual)) == want
    assert fastq.sniff_format(fastq_path) == "fastq"


@pytest.mark.parametrize("head", [
    b"", b">r\nACGT\n", b"@r\nACGT\n+\nIIII\n", b"@HD\tVN:1.6\n", b"BAM\x01",
    b"\n\n>r\n", b"r1\t0\tchr1\t1\t60\t4M\t*\t0\t0\tACGT\tIIII\n", b"ACGT\n",
])
def test_sniff_head_equal(head):
    assert fastq.sniff_head(head) == jax_fastq.sniff_head(head)


@pytest.mark.parametrize("bad", [
    "@r\nACGT\n+\n", "@r\n", "r\nACGT\n+\nIIII\n", "@r\nAC\nGT\n+\nIIII\n",
    "@r\nACGT\n+\nIII\n",
])
def test_fastq_reader_rejects_what_the_original_rejects(tmp_path, bad):
    path = tmp_path / "bad.fq"
    path.write_text(bad)
    with pytest.raises(ValueError) as want:
        _chunks(jax_fastq.FastqReader(str(path), min_qual=5))
    with pytest.raises(ValueError) as got:
        _chunks(fastq.FastqReader(str(path), min_qual=5))
    assert str(got.value) == str(want.value)


def _alignments(fixtures_dir):
    flags = [0, 16, 4, 256, 2048, 16 | 1, 0]
    recs = [(n.split()[0], flags[i % len(flags)], s.upper(), q)
            for i, (n, s, q) in enumerate(_reads(fixtures_dir))]
    recs.insert(5, ("nosq", 0, "*"))
    return recs


@pytest.mark.parametrize("min_qual", [0, 20])
def test_sam_and_bam_readers_equal(fixtures_dir, tmp_path, min_qual):
    recs = _alignments(fixtures_dir)
    sam_path = tmp_path / "a.sam"
    sam_path.write_bytes(make_sam(recs))
    want = _chunks(jax_sam.SamReader(str(sam_path), 500, min_qual))
    assert len(want) > 30
    assert _chunks(sam.SamReader(str(sam_path), 500, min_qual)) == want
    assert fastq.sniff_format(str(sam_path)) == "sam"
    raw = [(n, f, s) + ((bytes(ord(c) - 33 for c in q[0]),) if q else ())
           for n, f, s, *q in recs]
    bam_path = tmp_path / "a.bam"
    bam_path.write_bytes(make_bam(raw, bgzf_chunks=3))
    want = _chunks(jax_sam.BamReader(str(bam_path), min_qual))
    assert len(want) > 30
    assert _chunks(sam.BamReader(str(bam_path), min_qual)) == want
    assert fastq.sniff_format(str(bam_path)) == "bam"
    with pytest.raises(ValueError):
        sam.BamReader(str(sam_path))


# ---- host batches -----------------------------------------------------------

def _assert_batches_equal(got, want):
    assert len(got) == len(want) and want
    for a, b in zip(got, want):
        if isinstance(b, tuple):
            assert isinstance(a, tuple) and len(a) == len(b)
        else:
            a, b = (a,), (b,)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "raw"])
@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("name,k", [("multi.fa", 4), ("ecoli_frag.fa", 21),
                                    ("tiny.fa", 8)])
def test_host_batches_equal(fixtures_dir, name, k, use_native, packed):
    """Both batchers (the fused C strip+encode one, and code_stream +
    batches_from_codes on the numpy encoder), packed and raw, with their
    stream statistics."""
    if use_native:
        _need_native()
    path = os.path.join(fixtures_dir, name)
    cfg = config.Config(k=k, chunk_len=96, batch_rows=5, packed_h2d=packed,
                        use_native_encode=use_native)
    want_stats = jax_pipeline.StreamStats()
    want = list(jax_pipeline.batches_from_file(path, _jax(cfg),
                                               stats=want_stats))
    stats = pipeline.StreamStats()
    got = list(pipeline.batches_from_file(path, cfg, stats=stats))
    _assert_batches_equal(got, want)
    assert stats.as_dict() == want_stats.as_dict()
    assert pipeline.host_encoder(use_native) == (
        "native" if use_native else "numpy")


@pytest.mark.parametrize("fast", ["1", "0"], ids=["offsets", "reader"])
def test_host_batches_fastq_equal(fastq_path, monkeypatch, fast):
    """The offsets-based FASTQ flow (C scanner, `_fastq_blocks`) and the
    line reader, both against the original's."""
    _need_native()
    monkeypatch.setenv("FINDKMER_FASTQ_FAST", fast)
    cfg = config.Config(k=11, chunk_len=200, batch_rows=4)
    want = list(jax_pipeline.batches_from_file(fastq_path, _jax(cfg)))
    _assert_batches_equal(
        list(pipeline.batches_from_file(fastq_path, cfg)), want)
    blocks = list(pipeline._fastq_blocks(fastq_path, block_bytes=4096))
    ref = list(jax_filter._fastq_blocks(fastq_path, block_bytes=4096))
    assert len(blocks) == len(ref) > 1
    for a, b in zip(blocks, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---- output -----------------------------------------------------------------

def _dense(k, seed=1):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 4 ** k).astype(np.int32)
    counts[rng.random(4 ** k) < 0.4] = 0
    counts[3] = 2_000_000_000
    return counts


def _sparse(k, seed=2, n=3000):
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, 4 ** k, n, dtype=np.int64))
    counts = rng.integers(1, 9, codes.size).astype(np.int64)
    counts[::97] = 1 << 40
    return codes.astype(np.uint64), counts


OUT_CASES = {
    "plain": {},
    "zeros": dict(zeros=True),
    "canonical": dict(canonical=True),
    "zeros-canonical": dict(zeros=True, canonical=True),
    "min-count": dict(min_count=3),
    "max-count": dict(max_count=2),
    "min-max-zeros": dict(min_count=2, max_count=4, zeros=True),
    "counts-only": dict(out_counts_only=True),
    "sep": dict(sep=","),
    "wide-sep": dict(sep=" : "),
}


@pytest.mark.parametrize("case", OUT_CASES)
@pytest.mark.parametrize("k", [1, 4, 6])
def test_output_dense_bytes_equal(k, case):
    cfg = config.Config(k=k, **OUT_CASES[case])
    counts = _dense(k)
    want = b"".join(bytes(b) for b in
                    jax_output.spectrum_chunks(counts, _jax(cfg), chunk=1000))
    got = b"".join(bytes(b) for b in
                   output.spectrum_chunks(counts, cfg, chunk=1000))
    assert got == want and (want or case == "max-count")
    f = io.BytesIO()
    assert output.write_spectrum(f, counts, cfg) == len(f.getvalue())
    assert f.getvalue() == want


@pytest.mark.parametrize("case", [c for c in OUT_CASES if "zeros" not in c])
@pytest.mark.parametrize("k", [11, 21, 31])
def test_output_sparse_bytes_equal(k, case):
    cfg = config.Config(k=k, **OUT_CASES[case])
    spectrum = _sparse(k)
    want = io.BytesIO()
    jax_output.write_spectrum(want, spectrum, _jax(cfg))
    got = io.BytesIO()
    output.write_spectrum(got, spectrum, cfg)
    assert got.getvalue() == want.getvalue() != b""
    codes, counts = spectrum
    cuts = [0, 1, 700, 701, codes.size]
    chunks = [(codes[a:b], counts[a:b]) for a, b in zip(cuts, cuts[1:])]
    streamed = io.BytesIO()
    n = output.write_spectrum_streaming(streamed, iter(chunks), cfg)
    assert streamed.getvalue() == want.getvalue() and n == len(want.getvalue())
    with pytest.raises(ValueError):
        output.write_spectrum(io.BytesIO(), spectrum, cfg.replace(zeros=True))


@pytest.mark.parametrize("k", [1, 5, 16, 21, 31, 32])
def test_output_code_helpers_equal(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4 ** min(k, 31), 200).astype(np.uint64)
    np.testing.assert_array_equal(output.revcomp_codes_u64(codes, k),
                                  jax_spectra.revcomp_codes_u64(codes, k))
    if k <= 31:
        np.testing.assert_array_equal(
            output.codes_to_kmer_bytes(codes, k),
            jax_output.codes_to_kmer_bytes(codes, k))


# ---- CLI helpers ------------------------------------------------------------

ARGVS = [
    ["-k", "4"],
    ["-k", "21", "--canonical"],
    ["-k", "8", "-z", "--sep", ",", "--counts-only"],
    ["-k", "15", "--table-mode", "direct", "--hist", "scatter"],
    ["-k", "12", "--table-mode", "sparse", "--sparse-capacity", "4096",
     "--sparse-compact-entries", "8192"],
    ["-k", "31", "--batch-rows", "8", "--chunk-len", "16"],
    ["-k", "9", "--min-count", "2", "--max-count", "9"],
    ["-k", "6", "--count-dtype", "int64", "--no-native-encode"],
    ["-k", "5", "--format", "fastq", "--min-qual", "20", "--qual-offset",
     "64"],
    ["-k", "7", "--devices", "2", "--merge", "psum_scatter", "--spill",
     "runs"],
    ["-k", "13", "--per-record", "--stats", "json", "--log", "INFO"],
    ["-k", "11", "--per-input", "-o", "outdir"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_cli_parsers_give_equal_configs(fixtures_dir, argv):
    inputs = [os.path.join(fixtures_dir, n) for n in ("multi.fa", "tiny.fa")]
    argv = ["count", "-i", *inputs] + argv
    ours = cli.build_parser().parse_args(argv)
    theirs = jax_cli.build_parser().parse_args(argv)
    shared = {k: v for k, v in vars(ours).items()
              if k not in ("fn", "device")}
    assert shared == {k: vars(theirs)[k] for k in shared}
    got = cli._cfg_from_args(ours)
    want = jax_cli._cfg_from_args(theirs)
    assert isinstance(got, config.Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


STREAM_ARGVS = [
    ["-k", "8"],
    ["-k", "21", "--canonical", "--checkpoint", "ck", "--checkpoint-every",
     "2", "--spill", "runs"],
    ["-k", "12", "--min-count", "2", "--max-count", "7", "--num-processes",
     "2", "--process-id", "1"],
    ["-k", "17", "--coordinator", "host:1", "--stats", "json", "--log",
     "INFO"],
]


@pytest.mark.parametrize("argv", STREAM_ARGVS,
                         ids=[" ".join(a) for a in STREAM_ARGVS])
def test_stream_parsers_give_equal_configs(fixtures_dir, argv):
    """`stream` takes the reference's flags (and --device)."""
    inputs = [os.path.join(fixtures_dir, n) for n in ("multi.fa", "tiny.fa")]
    argv = ["stream", "-i", *inputs] + argv
    ours = cli.build_parser().parse_args(argv)
    theirs = jax_cli.build_parser().parse_args(argv)
    shared = {k: v for k, v in vars(ours).items()
              if k not in ("fn", "device")}
    assert shared == {k: v for k, v in vars(theirs).items() if k != "fn"}
    assert dataclasses.asdict(cli._cfg_from_args(ours)) == \
        dataclasses.asdict(jax_cli._cfg_from_args(theirs))


@pytest.mark.parametrize("argv,exc", [
    (["-k", "12", "-z"], ValueError),
    (["-k", "16", "--table-mode", "direct"], ValueError),
    (["-k", "4", "-i", "no/such/file.fa"], FileNotFoundError),
    (["-k", "33"], ValueError),
])
def test_cli_cfg_errors_equal(fixtures_dir, argv, exc):
    argv = ["count", "-i", os.path.join(fixtures_dir, "tiny.fa")] + argv
    with pytest.raises(exc) as want:
        jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(argv))
    with pytest.raises(exc) as got:
        cli._cfg_from_args(cli.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value)


def test_cli_help_and_names_equal(tmp_path, monkeypatch):
    def common_help(build):
        p = build()
        sub = next(a for a in p._actions if hasattr(a, "choices")
                   and a.choices and "count" in a.choices)
        return {tuple(a.option_strings): (a.help, a.default, a.choices,
                                          a.metavar, a.nargs, a.required)
                for a in sub.choices["count"]._actions}

    ours, theirs = common_help(cli.build_parser), common_help(
        jax_cli.build_parser)
    ours.pop(("--device",))
    assert ours == {k: theirs[k] for k in ours}
    paths = ["a/x.fa", "b/x.fasta.gz", "x.FQ", "y.tsv", "x", "z.fa.gz"]
    seen_a, seen_b = {}, {}
    assert [cli._per_input_name(p, seen_a) for p in paths] == \
        [jax_cli._per_input_name(p, seen_b) for p in paths]
    monkeypatch.chdir(tmp_path)
    for name, env in (("o.tsv", "1"), ("o2.tsv", "0"), ("o.tsv.gz", "1")):
        monkeypatch.setenv("FINDKMER_DIRECT_OUT", env)
        for mod, out in ((cli, "ours_" + name), (jax_cli, "theirs_" + name)):
            f, close = mod._open_out(out)
            f.write(b"ACGT\t1\n" * 1000)
            assert close
            f.close()
        read = gzip.open if name.endswith(".gz") else open
        assert read("ours_" + name, "rb").read() == \
            read("theirs_" + name, "rb").read() == b"ACGT\t1\n" * 1000
    assert cli._open_out("-")[1] is False


# ---- API, selftest, utils ---------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_spectrum_equal(tmp_path, sparse):
    k = 12 if sparse else 5
    engine = _sparse(k, n=400) if sparse else _dense(k)
    cfg = config.Config(k=k, canonical=True)
    ours = api.Spectrum.from_engine(engine, cfg)
    theirs = jax_api.Spectrum.from_engine(engine, _jax(cfg))
    assert [f.name for f in dataclasses.fields(api.Spectrum)] == \
        [f.name for f in dataclasses.fields(jax_api.Spectrum)]
    assert (ours.k, ours.canonical) == (theirs.k, theirs.canonical)
    assert ours.total() == theirs.total()
    assert ours.distinct() == theirs.distinct()
    assert list(ours.items()) == list(theirs.items())
    assert ours.to_dict() == theirs.to_dict()
    np.testing.assert_array_equal(ours.histo(50), theirs.histo(50))
    for kmer, _ in list(theirs.items())[:40] + [("A" * k, 0), ("T" * k, 0)]:
        assert ours[kmer] == theirs[kmer]
    assert ours[3] == theirs[3]
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    assert ours.write(str(a), sep=",") == theirs.write(str(b), sep=",")
    assert a.read_bytes() == b.read_bytes() != b""
    f = io.BytesIO()
    ours.write(f, zeros=not sparse)
    g = io.BytesIO()
    theirs.write(g, zeros=not sparse)
    assert f.getvalue() == g.getvalue()


def test_selftest_case_builders_equal():
    assert selftest.CASES == jax_selftest.CASES
    text, recs = selftest._make_input(np.random.default_rng(5))
    want_text, want_recs = jax_selftest._make_input(np.random.default_rng(5))
    assert (text, recs) == (want_text, want_recs)
    for case in selftest.CASES:
        assert selftest._scalar_count(recs, **case) == \
            jax_selftest._scalar_count(recs, **case)
    for spectrum, k in ((_dense(4), 4), (_sparse(13, n=50), 13)):
        assert selftest._spectrum_dict(spectrum, k) == \
            jax_selftest._spectrum_dict(spectrum, k)


def test_utils_behave_as_the_originals(tmp_path):
    timers = prof.PhaseTimers()
    with timers.phase("a"):
        pass
    with timers.phase("a"):
        pass
    d = timers.as_dict()
    assert list(d) == ["a"] and d["a"]["calls"] == 2
    assert d["a"]["total_s"] >= 0
    assert malloc_tuning.tune_for_streaming() in (True, False)
    assert shmalloc.ensure_shared_alloc() in (True, False)
    assert shmalloc.BUILD_DIR.name == "torch_native"
    data = np.random.default_rng(0).integers(0, 255, 3 * directio.BLOCK + 77,
                                             dtype=np.uint8)
    path = tmp_path / "direct.bin"
    with directio.DirectWriter(str(path)) as w:
        assert w.write(data[:100]) == 100
        w.write(memoryview(data[100:]))
    assert path.read_bytes() == data.tobytes()

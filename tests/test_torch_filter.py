"""Read filtering in the port (`findkmer_torch/filter.py`,
`filter_device.py`, `findkmer-torch filter`, API `filter_reads`) against
the JAX package's `findkmer filter`, on the CPU.

The same seeded reads and spectra go through both packages: the spectrum
sets, the device step's hit bitmaps word for word, the per-read (hits,
windows) of both engines, and the CLI's output bytes, kept/seen line and
exit code.  Everything compared is integers and bytes: the tolerance is
none.  The JAX device engine runs on the CPU backend, as its own
tests/test_filter.py runs it; the JAX CLI is run with its host engine,
which that file holds byte-identical to its device engine.
"""

import functools
import gzip
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import findkmer_tpu.api as jax_api
import findkmer_tpu.cli as jax_cli
import findkmer_tpu.filter as jax_filter
import findkmer_tpu.filter_device as jax_fd
import findkmer_tpu.spectra as jax_spectra
import findkmer_torch
from findkmer_torch import cli, filter as port_filter
from findkmer_torch import filter_device, pipeline
from findkmer_torch.io import native

CPU = torch.device("cpu")
SMALL = dict(batch_rows=2, chunk_len=2048)  # 4096 windows a device batch


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _reads(rng, ref, n, max_len=150):
    """Reads: half drawn from `ref` with 2% substitutions (N, lowercase
    and other bases), half random; some empty, some shorter than k, some
    all N."""
    out = []
    for i in range(n):
        ln = int(rng.integers(0, max_len + 1))
        if rng.random() < 0.5 and ln:
            p = int(rng.integers(0, len(ref) - ln))
            s = list(ref[p : p + ln])
        else:
            s = list(rng.choice(list("ACGT"), ln))
        for j in np.flatnonzero(rng.random(ln) < 0.02):
            s[j] = str(rng.choice(list("ACGTNnacgt")))
        if i % 97 == 5:
            s = ["N"] * ln
        out.append("".join(s))
    return out


def _write_fastq(path, reads, tag=""):
    with open(path, "w") as f:
        for i, s in enumerate(reads):
            f.write(f"@r{i}{tag} x\n{s}\n+\n{'I' * len(s)}\n")


def _write_spectrum(path, seqs, k, canonical=False):
    """KMER\\tCOUNT of every valid window of `seqs` (the oracle's count)."""
    from oracle.scalar import count_kmers_in_text, spectrum_lines

    counts = {}
    for s in seqs:
        for km, n in count_kmers_in_text(s, k, canonical=canonical).items():
            counts[km] = counts.get(km, 0) + n
    with open(path, "w") as f:
        f.write("".join(ln + "\n" for ln in spectrum_lines(counts, k)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("filter")
    rng = np.random.default_rng(11)
    ref = _genome(rng, 3000)
    reads = _reads(rng, ref, 500)
    mates = _reads(rng, ref, 500)
    _write_fastq(d / "r.fq", reads)
    _write_fastq(d / "r2.fq", mates, "/2")
    _write_fastq(d / "short.fq", mates[:-1], "/2")
    with open(d / "r.fa", "w") as f:
        f.write("".join(f">r{i} seeded\n{s}\n" for i, s in enumerate(reads)))
    for k in (7, 21):
        _write_spectrum(d / f"spec{k}.tsv", [ref[:1500]], k)
    _write_spectrum(d / "spec21c.tsv", [ref[1500:]], 21, canonical=True)
    # a spectrum with counts 1..3 (a repeat), for --min-count/--max-count
    _write_spectrum(d / "spec7rep.tsv", [ref[:900], ref[:300], ref[:100]], 7)
    (d / "empty.tsv").write_text("")
    (d / "foreign.tsv").write_text("ACGTACGTACGTACGTACGTA\t1\n")
    from test_sam import make_sam

    (d / "r.sam").write_bytes(make_sam([("q1", 0, "ACGTACGTAC")]))
    return d


# ---- FilterSpec.load --------------------------------------------------------

@pytest.mark.parametrize("spec, sep, canonical, lo, hi", [
    ("spec21.tsv", "\t", False, 0, 0),
    ("spec21.tsv", "\t", True, 0, 0),
    ("spec7rep.tsv", "\t", False, 2, 0),
    ("spec7rep.tsv", "\t", True, 2, 3),
    ("spec7rep.tsv", "\t", False, 0, 1),
    ("spec7rep.tsv", "::", False, 0, 0),
    ("spec7rep.tsv", "::", True, 3, 0),
], ids=["plain", "canonical", "min", "canonical-min-max", "max",
        "multibyte-sep", "multibyte-sep-canonical-min"])
def test_filter_spec_load_equal(data, tmp_path, spec, sep, canonical, lo,
                                hi):
    path = str(data / spec)
    if sep != "\t":  # a multi-byte separator takes read_spectrum's route
        text = (data / spec).read_text().replace("\t", sep)
        path = str(tmp_path / "sep.tsv")
        open(path, "w").write(text)
    got = port_filter.FilterSpec.load(path, sep=sep, canonical=canonical,
                                      min_count=lo, max_count=hi)
    want = jax_filter.FilterSpec.load(path, sep=sep, canonical=canonical,
                                      min_count=lo, max_count=hi)
    assert got._bloom is None  # built at the host engine's first lookup
    bloom, shift = got.prefilter()
    assert (got.k, got.canonical, shift) == \
        (want.k, want.canonical, want._shift)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(bloom, want._bloom)
    assert got.prefilter()[0] is bloom
    assert got.codes.dtype == np.uint64 and got.codes.size


def test_filter_spec_load_errors_equal(data, tmp_path):
    bad = tmp_path / "bad.tsv"
    bad.write_text("ACGNA\t1\n")
    for path in (data / "empty.tsv", bad):
        with pytest.raises(ValueError) as want:
            jax_filter.FilterSpec.load(str(path))
        with pytest.raises(ValueError) as got:
            port_filter.FilterSpec.load(str(path))
        assert str(got.value) == str(want.value)


# ---- the device step --------------------------------------------------------

def _members(rng, work, k, canonical):
    """Sorted distinct codes: ~half of the windows of `work`, all-A,
    all-T and random codes, folded canonical where asked."""
    seq = bytes(np.frombuffer(b"ACGTN", np.uint8)[work])
    codes, valid = jax_filter.window_codes_host(seq, k)
    codes = codes[valid][rng.random(int(valid.sum())) < 0.5]
    extra = rng.integers(0, 4 ** k, 64, dtype=np.uint64)
    codes = np.concatenate([codes, extra, np.array([0, 4 ** k - 1],
                                                   np.uint64)])
    if canonical:
        codes = np.minimum(codes, jax_spectra.revcomp_codes_u64(codes, k))
    return np.unique(codes)


STEP_CASES = [(4, 256, k, c) for k in (4, 15, 16, 21, 29, 31)
              for c in (False, True)] + [(2, 400, k, c) for k in (16, 29)
                                         for c in (False, True)]


@pytest.mark.parametrize("B, L, k, canonical", STEP_CASES, ids=[
    f"{B}x{L}-k{k}{'-canonical' * c}" for B, L, k, c in STEP_CASES])
def test_filter_step_bitmap_equals_jax(k, canonical, B, L):
    """The port's `_filter_step` gives the JAX one's uint32 words, word for
    word, from the same packed batch (2x400: rows whose length is no
    multiple of 16, so the extraction has padding slots)."""
    rng = np.random.default_rng(100 * k + canonical + B)
    R = L + k - 1
    work = rng.integers(0, 4, (B - 1) * L + R).astype(np.uint8)
    work[rng.random(work.size) < 0.03] = 4
    work[50:50 + 3 * k] = 0  # poly-A
    work[-2 * k:] = 3  # poly-T at the end of the last row
    packed, validbits = pipeline._numpy_pack_rows(work, B, L, R,
                                                  (R + 7) // 8 * 8)
    codes = _members(rng, work, k, canonical)
    jdev = jax_fd.DeviceFilter(
        jax_filter.FilterSpec(k=k, codes=codes, canonical=canonical),
        batch_rows=B, chunk_len=L)
    want = np.asarray(jax_fd._filter_step(
        jdev.members, jnp.asarray(packed), jnp.asarray(validbits), k,
        canonical, R, L))
    tdev = filter_device.DeviceFilter(
        port_filter.FilterSpec(k=k, codes=codes, canonical=canonical),
        batch_rows=B, chunk_len=L, device="cpu")
    got = filter_device._filter_step(
        tdev.members, torch.from_numpy(packed), torch.from_numpy(validbits),
        k, canonical, R, L)
    assert got.dtype == torch.int32 and got.shape == (B * L // 32,)
    got = got.numpy().view(np.uint32)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert 0 < int(np.unpackbits(got.view(np.uint8)).sum()) < B * L


def test_member_table_dtype_and_empty():
    for k, dt in ((15, torch.int32), (16, torch.int64), (31, torch.int64)):
        codes = np.array([0, 4 ** k - 1], np.uint64)
        d = filter_device.DeviceFilter(port_filter.FilterSpec(k=k,
                                                              codes=codes),
                                       device="cpu", **SMALL)
        assert d.members.dtype == dt and d.members.tolist() == [0, 4 ** k - 1]
        assert d.member_bytes == 2 * d.members.element_size()
    empty = filter_device.DeviceFilter(
        port_filter.FilterSpec(k=8, codes=np.empty(0, np.uint64)),
        device="cpu", **SMALL)
    h, w = empty.hits_batch([b"ACGTACGTACGT", b"", b"ACG"])
    assert h.tolist() == [0, 0, 0] and w.tolist() == [5, 0, 0]
    for bad in (dict(batch_rows=3, chunk_len=10),
                dict(batch_rows=1 << 15, chunk_len=1 << 16)):
        with pytest.raises(ValueError) as got:
            filter_device.DeviceFilter(empty.spec, device="cpu", **bad)
        with pytest.raises(ValueError) as want:
            jax_fd.DeviceFilter(jax_filter.FilterSpec(
                k=8, codes=np.empty(0, np.uint64)), **bad)
        assert str(got.value) == str(want.value)


# ---- DeviceFilter against the JAX engine and the host engine ---------------

def _fastq_seqs(path):
    return open(path, "rb").read().split(b"\n")[1::4]


def _specs(data, name, canonical):
    path = str(data / name)
    return (port_filter.FilterSpec.load(path, canonical=canonical),
            jax_filter.FilterSpec.load(path, canonical=canonical))


@pytest.mark.parametrize("name, canonical", [("spec7.tsv", False),
                                             ("spec21c.tsv", True)])
@pytest.mark.parametrize("attribution", ["native", "numpy"])
def test_device_filter_hits_batch_equal(data, monkeypatch, name, canonical,
                                        attribution):
    """hits_batch over several device batches == the JAX device engine ==
    both hosts' engines, by the C attribution and by numpy's."""
    ours, theirs = _specs(data, name, canonical)
    reads = [b"", b"ACG", b"N" * 40] + _fastq_seqs(data / "r.fq")[:300]
    want_h, want_w = theirs.hits_batch(reads)
    jh, jw = jax_fd.DeviceFilter(theirs, **SMALL).hits_batch(reads)
    np.testing.assert_array_equal(jh, want_h)
    np.testing.assert_array_equal(jw, want_w)
    if attribution == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    dev = filter_device.DeviceFilter(ours, device="cpu", **SMALL)
    begun = dev.begin(reads)
    assert len(begun[2][0]) > 3 * (SMALL["chunk_len"] * 2 // 32)  # batches
    for h, w in (dev.finish(begun), ours.hits_batch(reads)):
        np.testing.assert_array_equal(h, want_h)
        np.testing.assert_array_equal(w, want_w)
    assert want_h.sum() > 0


@pytest.mark.parametrize("name, canonical", [("spec7.tsv", False),
                                             ("spec21c.tsv", True)])
def test_device_filter_begin_offsets_equal(data, name, canonical):
    """begin_offsets / finish on block segments, as the offsets flow
    builds them (blocks of 4096 bytes, several device batches a flush):
    the same (hits, windows) as the JAX engine and the host scan."""
    ours, theirs = _specs(data, name, canonical)
    segs, nbases, nreads = [], 0, 0
    for blk, ss, se, rs, re_ in pipeline._fastq_blocks(str(data / "r.fq"),
                                                       block_bytes=4096):
        lens = se - ss
        js = np.empty(ss.size, np.int64)
        js[0] = nbases + nreads
        np.cumsum(lens[:-1] + 1, out=js[1:])
        js[1:] += js[0]
        segs.append((blk, ss, js, lens, rs, re_))
        nbases += int(lens.sum())
        nreads += int(ss.size)
    assert len(segs) > 3
    dev = filter_device.DeviceFilter(ours, device="cpu", **SMALL)
    got = dev.finish(dev.begin_offsets(segs, nbases, nreads))
    jdev = jax_fd.DeviceFilter(theirs, **SMALL)
    want = jdev.finish(jdev.begin_offsets(segs, nbases, nreads))
    host = [np.concatenate(x) for x in zip(*(
        native.filter_hits(b, ss, ln, ours.k, canonical, ours.codes,
                           *ours.prefilter())
        for b, ss, _, ln, _, _ in segs))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, host):
        np.testing.assert_array_equal(a, b)
    assert got[0].size == nreads == 500 and got[0].sum() > 0
    empty = dev.finish(dev.begin_offsets([], 0, 0))
    assert empty[0].size == 0


# ---- the CLI ----------------------------------------------------------------

def _run(main, argv, capsys):
    """-> (exit code, the stderr's last line without the program name)."""
    rc = main(argv)
    err = capsys.readouterr().err.strip().splitlines()
    last = err[-1] if err else ""
    return rc, last.split("error: ", 1)[-1]


def _outputs(paths):
    out = []
    for p in paths:
        if not os.path.exists(p):
            out.append(None)
            continue
        read = gzip.open if p.endswith(".gz") else open
        with read(p, "rb") as f:
            out.append(f.read())
    return out


CLI_CASES = {
    "fastq": ([], {}),
    "fastq-canonical-k21": (["--canonical"], {"spec": "spec21c.tsv"}),
    "list-flow": ([], {"FINDKMER_FILTER_FAST": "0"}),
    "list-flow-depth0": (["--invert"], {"FINDKMER_FILTER_FAST": "0",
                                        "FINDKMER_FILTER_DEPTH": "0"}),
    "block-8192": ([], {"FINDKMER_FILTER_BLOCK": "8192"}),
    "depth0": ([], {"FINDKMER_FILTER_DEPTH": "0"}),
    "depth2": (["--min-hits", "3"], {"FINDKMER_FILTER_DEPTH": "2"}),
    "fasta": (["--format", "fasta"], {"input": "r.fa"}),
    "fasta-auto-canonical": (["--canonical", "--min-frac", "0.2"],
                             {"input": "r.fa", "spec": "spec21c.tsv"}),
    "gz-output": ([], {"out": "o.fq.gz"}),
    "invert": (["--invert"], {}),
    "min-frac": (["--min-frac", "0.5"], {}),
    "min-count": (["--min-count", "2", "--max-count", "2"],
                  {"spec": "spec7rep.tsv"}),
    "two-inputs": ([], {"input": "r.fq r.fa"}),
    "nothing-kept": ([], {"spec": "foreign.tsv"}),
    "spectrum-thresholded-empty": (["--min-count", "9"],
                                   {"spec": "spec7rep.tsv"}),
    "paired-any": (["--paired"], {"paired": True}),
    "paired-both-invert": (["--paired", "--pair-mode", "both", "--invert"],
                           {"paired": True}),
    "paired-list-flow": (["--paired", "--min-frac", "0.3"],
                         {"paired": True, "FINDKMER_FILTER_FAST": "0"}),
    "paired-block-depth0": (["--paired", "--canonical"],
                            {"paired": True, "spec": "spec21c.tsv",
                             "FINDKMER_FILTER_BLOCK": "8192",
                             "FINDKMER_FILTER_DEPTH": "0"}),
    "paired-count-mismatch": (["--paired"], {"paired": "short.fq"}),
    "paired-one-input": (["--paired"], {"input": "r.fq", "out": "a,b"}),
    "missing-input": ([], {"input": "nope.fq"}),
    "empty-spectrum": ([], {"spec": "empty.tsv"}),
}


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_filter_equals_jax_cli(data, tmp_path, monkeypatch, capsys,
                                   case):
    """`findkmer-torch filter` by both engines (--device cpu; the device
    engine at 4096 windows a batch, so several batches a flush) against
    `findkmer filter`: the same output bytes, stderr line and exit code."""
    extra, opt = CLI_CASES[case]
    for key, val in opt.items():
        if key.startswith("FINDKMER_"):
            monkeypatch.setenv(key, val)
    monkeypatch.setattr(filter_device, "DeviceFilter", functools.partial(
        filter_device.DeviceFilter, **SMALL))
    monkeypatch.chdir(data)
    inputs = opt.get("input", "r.fq").split()
    if opt.get("paired"):
        mate = opt["paired"] if isinstance(opt["paired"], str) else "r2.fq"
        inputs = ["r.fq", mate]

    def argv(tag):
        if "out" in opt and "," in opt["out"]:
            outs = [str(tmp_path / f"{tag}_{o}") for o in
                    opt["out"].split(",")]
            return outs, [",".join(outs)]
        ext = opt.get("out", "o.fq")
        outs = ([str(tmp_path / f"{tag}_1.fq"), str(tmp_path / f"{tag}_2.fq")]
                if "--paired" in extra else [str(tmp_path / f"{tag}_{ext}")])
        return outs, [",".join(outs)]

    outs, o = argv("jax")
    base = ["filter", "-i", *inputs, "--spectrum",
            opt.get("spec", "spec7.tsv")] + extra
    want = _run(jax_cli.main, base + ["-o", *o, "--engine", "host"], capsys)
    want_bytes = _outputs(outs)
    assert want[0] in (0, 1, 2)
    for engine in ("host", "device"):
        outs, o = argv(engine)
        got = _run(cli.main, base + ["-o", *o, "--engine", engine,
                                     "--device", "cpu"], capsys)
        assert got == want, engine
        assert _outputs(outs) == want_bytes, engine
    if case in ("fastq", "paired-any", "fasta"):
        assert want[0] == 0 and want_bytes[0]
    if case in ("nothing-kept", "spectrum-thresholded-empty"):
        assert want[0] == 1 and want_bytes == [b""]
    if case in ("paired-count-mismatch", "missing-input", "empty-spectrum",
                "paired-one-input"):
        assert want[0] == 2


def test_cli_filter_default_geometry(data, tmp_path, capsys, monkeypatch):
    """The device engine at its own geometry (256 x 65536 windows a batch,
    one batch for the whole input), list and offsets flows."""
    want = jax_cli.main(["filter", "-i", str(data / "r.fq"), "--spectrum",
                         str(data / "spec7.tsv"), "-o",
                         str(tmp_path / "h.fq"), "--engine", "host"])
    for fast in ("1", "0"):
        monkeypatch.setenv("FINDKMER_FILTER_FAST", fast)
        rc = cli.main(["filter", "-i", str(data / "r.fq"), "--spectrum",
                       str(data / "spec7.tsv"), "-o", str(tmp_path / "d.fq"),
                       "--engine", "device", "--device", "cpu"])
        assert rc == want == 0
        assert (tmp_path / "d.fq").read_bytes() == \
            (tmp_path / "h.fq").read_bytes()
    capsys.readouterr()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_filter_sam_input_exits_2(data, tmp_path, capsys, engine):
    """SAM/BAM records cannot be re-emitted verbatim: both CLIs refuse
    with the same reason; the port exits 2 (trouble), where the JAX CLI
    raises SystemExit with the message (exit 1 as a process)."""
    argv = ["filter", "-i", str(data / "r.sam"), "--spectrum",
            str(data / "spec7.tsv"), "-o", str(tmp_path / "o.fq"),
            "--engine", engine]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    rc, msg = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 2
    assert msg.startswith("filter reads FASTA/FASTQ only")
    assert msg in str(want.value.code)


def test_cli_filter_help_equal():
    """Flags, defaults and choices of `filter` are the JAX CLI's, plus
    --device; the help texts are the same apart from --engine's, which
    names the port's auto rule (device on --device cuda)."""
    def actions(build):
        p = build()
        sub = next(a for a in p._actions if hasattr(a, "choices")
                   and a.choices and "filter" in a.choices)
        pf = sub.choices["filter"]
        return pf.epilog, {tuple(a.option_strings): (
            a.help or "", a.default, a.choices, a.metavar, a.nargs,
            a.required) for a in pf._actions}

    (ours_epi, ours), (theirs_epi, theirs) = (actions(cli.build_parser),
                                              actions(jax_cli.build_parser))
    assert ours.pop(("--device",))[1:3] == ("cuda", ["cuda", "cpu"])
    engine, theirs_engine = ours.pop(("--engine",)), theirs.pop(("--engine",))
    assert engine[1:] == theirs_engine[1:] == (
        "auto", ["auto", "host", "device"], None, None, False)
    assert "auto picks device on --device cuda, host on --device cpu" in \
        engine[0]
    assert ours == theirs and ours_epi == theirs_epi


# ---- the API ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["host", "device"])
def test_filter_reads_equal(data, tmp_path, monkeypatch, engine):
    monkeypatch.setattr(filter_device, "DeviceFilter", functools.partial(
        filter_device.DeviceFilter, **SMALL))
    ins = [str(data / "r.fq"), str(data / "r.fa")]
    kw = dict(min_frac=0.1, canonical=True)
    want = jax_api.filter_reads(ins, str(data / "spec21c.tsv"),
                                str(tmp_path / "j.fq"), engine="host", **kw)
    got = findkmer_torch.filter_reads(ins, str(data / "spec21c.tsv"),
                                      str(tmp_path / "t.fq.gz"),
                                      engine=engine, device="cpu", **kw)
    assert got == want and want[0] > 0
    assert gzip.open(tmp_path / "t.fq.gz").read() == \
        (tmp_path / "j.fq").read_bytes()
    pair = [str(data / "r.fq"), str(data / "r2.fq")]
    outs = lambda tag: [str(tmp_path / f"{tag}{i}.fq") for i in (1, 2)]
    want = jax_api.filter_reads(pair, str(data / "spec7.tsv"), outs("j"),
                                paired=True, pair_mode="both",
                                engine="host")
    got = findkmer_torch.filter_reads(pair, str(data / "spec7.tsv"),
                                      outs("t"), paired=True,
                                      pair_mode="both", engine=engine,
                                      device="cpu")
    assert got == want and 0 < want[0] < want[1]
    for a, b in zip(outs("t"), outs("j")):
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="paired filtering takes"):
        findkmer_torch.filter_reads(pair, str(data / "spec7.tsv"),
                                    outs("x")[:1], paired=True,
                                    device="cpu")


def test_resolve_engine(monkeypatch):
    assert port_filter._resolve_engine("host") == "host"
    assert port_filter._resolve_engine("device", "cpu") == "device"
    # auto follows the requested device alone: neither the C library nor
    # a card that is there or not changes the pick (a missing card raises
    # later, where the device is resolved)
    for built in (True, False):
        monkeypatch.setattr(native, "available", lambda: built)
        for card in (True, False):
            monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
            assert port_filter._resolve_engine("auto", "cuda") == "device"
            assert port_filter._resolve_engine("auto") == "device"
            assert port_filter._resolve_engine(
                "auto", torch.device("cuda", 0)) == "device"
            assert port_filter._resolve_engine("auto", "cpu") == "host"
            assert port_filter._resolve_engine("auto", CPU) == "host"
            assert port_filter._resolve_engine("host", "cuda") == "host"


def test_numpy_host_engine_equal(data, monkeypatch):
    """Without the C library the host engine scores with numpy: the same
    (hits, windows)."""
    ours, theirs = _specs(data, "spec21c.tsv", True)
    reads = _fastq_seqs(data / "r.fq")
    want = theirs.hits_batch(reads)
    monkeypatch.setattr(native, "available", lambda: False)
    for a, b in zip(ours.hits_batch(reads), want):
        np.testing.assert_array_equal(a, b)
    assert want[0].sum() > 0
    assert ours.hits(b"ACGT" * 10) == theirs.hits(b"ACGT" * 10)


@pytest.mark.parametrize("fast", ["1", "0"])
def test_device_engine_never_builds_prefilter(data, monkeypatch, fast):
    """The bit-table prefilter is the host engine's: a device-engine run
    (either flow) leaves it unbuilt, a host-engine run builds it."""
    monkeypatch.setenv("FINDKMER_FILTER_FAST", fast)
    monkeypatch.setattr(filter_device, "DeviceFilter", functools.partial(
        filter_device.DeviceFilter, **SMALL))
    kept = []
    for engine in ("device", "host"):
        spec = port_filter.FilterSpec.load(str(data / "spec21c.tsv"),
                                           canonical=True)
        out = io.BytesIO()
        kept.append(port_filter.filter_file(str(data / "r.fq"), out, spec,
                                            engine=engine, device=CPU))
        assert (spec._bloom is None) == (engine == "device"), engine
    assert kept[0] == kept[1] and kept[0][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["small", "default"])
def test_device_engine_on_card_equals_host(data, tmp_path, monkeypatch,
                                           capsys, geometry):
    """On a CUDA card: `filter --engine device --device cuda` and the
    auto pick (offsets and list flows, single-end and paired, depth 0 and
    2) write the host engine's bytes; the step's bitmap on the card equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if geometry == "small":
        monkeypatch.setattr(filter_device, "DeviceFilter", functools.partial(
            filter_device.DeviceFilter, **SMALL))
    monkeypatch.chdir(data)
    for env in ({}, {"FINDKMER_FILTER_FAST": "0"},
                {"FINDKMER_FILTER_DEPTH": "0"}):
        for key in ("FINDKMER_FILTER_FAST", "FINDKMER_FILTER_DEPTH"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        for extra in ([], ["--canonical", "--spectrum", "spec21c.tsv"],
                      ["--paired"]):
            ins = ["r.fq", "r2.fq"] if "--paired" in extra else ["r.fq"]
            outs = {}
            for engine in ("host", "device", "auto"):
                o = [str(tmp_path / f"{engine}{i}.fq") for i in range(
                    len(ins))]
                rc = cli.main(["filter", "-i", *ins, "--spectrum",
                               "spec7.tsv", "-o", ",".join(o), "--engine",
                               engine, "--device", "cuda"] + extra)
                outs[engine] = (rc, [open(p, "rb").read() for p in o],
                                capsys.readouterr().err)
            assert outs["device"] == outs["host"], (env, extra)
            assert outs["auto"] == outs["host"], (env, extra)
            assert outs["host"][0] == 0
    rng = np.random.default_rng(1)
    for k, canonical in ((4, False), (15, True), (16, True), (31, True)):
        B, L = 4, 256
        R = L + k - 1
        work = rng.integers(0, 5, (B - 1) * L + R).astype(np.uint8)
        packed, validbits = pipeline._numpy_pack_rows(work, B, L, R,
                                                      (R + 7) // 8 * 8)
        spec = port_filter.FilterSpec(k=k, codes=_members(rng, work, k,
                                                          canonical),
                                      canonical=canonical)
        words = {}
        for dev in ("cpu", "cuda"):
            d = filter_device.DeviceFilter(spec, batch_rows=B, chunk_len=L,
                                           device=dev)
            words[dev] = filter_device._filter_step(
                d.members, torch.from_numpy(packed).to(dev),
                torch.from_numpy(validbits).to(dev), k, canonical, R,
                L).cpu()
        assert torch.equal(words["cuda"], words["cpu"]), k

"""The port's MinHash sketches (`findkmer_torch.sketch`, and the API's
`sketch_sample` / `similarity`) against the JAX package's.

The same numpy-seeded codes and spectrum files go through both packages:
hashes are compared word for word, sketch dicts and the JSON bytes of
`write_sketch` whole, comparisons (Jaccard, Mash distance, floats from
the same integer counts) exactly, and errors by their message.  The
sequence inputs are the fixtures in tests/data, counted by the port on
the CPU (`device="cpu"`) and by the reference on its CPU backend.  The
tolerance is none.
"""

import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

import findkmer_tpu.api as jax_api
import findkmer_tpu.io.native as jax_native
import findkmer_tpu.sketch as jax_sketch
import findkmer_torch
import findkmer_torch.api as port_api
import findkmer_torch.io.native as port_native
import findkmer_torch.sketch as port_sketch
from oracle.scalar import count_fasta_file, spectrum_lines


def _u64(seed, n, hi):
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64)


@pytest.fixture(scope="module")
def specs(tmp_path_factory, fixtures_dir):
    """Spectrum files of the fixtures (k=5, 8, 21 plain and canonical),
    a gzip copy, a lowercase unsorted copy (the line path), a mixed-k
    file, a k=33 file and a file with a non-ACGT k-mer."""
    d = tmp_path_factory.mktemp("sketch")
    p = {}
    for name, fa, k, canonical in (
            ("tiny5", "tiny.fa", 5, False), ("multi8", "multi.fa", 8, False),
            ("ecoli21", "ecoli_frag.fa", 21, False),
            ("ecoli21c", "ecoli_frag.fa", 21, True)):
        fa = os.path.join(fixtures_dir, fa)
        lines = spectrum_lines(count_fasta_file(fa, k, canonical=canonical),
                               k)
        p[name] = d / f"{name}.tsv"
        p[name].write_text("\n".join(lines) + "\n")
    text = p["ecoli21"].read_text()
    with gzip.open(d / "ecoli21.tsv.gz", "wt") as f:
        f.write(text)
    p["gz"] = d / "ecoli21.tsv.gz"
    rows = text.splitlines()
    rng = np.random.default_rng(3)
    p["lower"] = d / "lower.tsv"
    p["lower"].write_text("\n".join(rows[i].lower() for i in
                                    rng.permutation(len(rows))) + "\n")
    p["colon"] = d / "colon.tsv"
    p["colon"].write_text(p["multi8"].read_text().replace("\t", " :: "))
    p["mixed"] = d / "mixed.tsv"
    p["mixed"].write_text("ACGT\t1\nACG\t2\n")
    p["k33"] = d / "k33.tsv"
    p["k33"].write_text("A" * 33 + "\t1\n")
    p["nonacgt"] = d / "nonacgt.tsv"
    p["nonacgt"].write_text("ACGT\t1\nACNT\t2\n")
    p["empty"] = d / "empty.tsv"
    p["empty"].write_text("")
    return {k: str(v) for k, v in p.items()}


@pytest.mark.parametrize("hi", [1 << 10, 4 ** 21, 1 << 64])
def test_hash_codes_equal(hi):
    codes = _u64(hi % 1000, 20000, hi)
    np.testing.assert_array_equal(port_sketch.hash_codes_u64(codes),
                                  jax_sketch.hash_codes_u64(codes))
    assert port_sketch.hash_codes_u64(codes).dtype == np.uint64


@pytest.mark.parametrize("s", [1, 7, 1000, 50000, 0, -3])
def test_sketch_codes_equal(s):
    codes = np.concatenate([_u64(s + 10, 3000, 4 ** 15)] * 2)  # duplicates
    outs = []
    for mod in (port_sketch, jax_sketch):
        try:
            outs.append(mod.sketch_codes(codes, s).tolist())
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("native_lib", ["built", "unavailable"])
@pytest.mark.parametrize("name", ["tiny5", "multi8", "ecoli21", "ecoli21c",
                                  "gz", "lower", "mixed", "k33", "nonacgt",
                                  "empty"])
def test_codes_of_spectrum_file_equal(specs, monkeypatch, name, native_lib):
    """The C parse and the line fallback (gzip, unsorted lowercase, and
    every file with the library made unavailable) give the reference's
    (k, codes), or its error."""
    if native_lib == "unavailable":
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    elif not port_native.available():
        pytest.skip("no C compiler: the native library did not build")
    outs = []
    for mod in (port_sketch, jax_sketch):
        try:
            k, codes = mod._codes_of_spectrum_file(specs[name], "\t")
            outs.append((k, np.sort(codes).tolist()))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("s", [1, 64, 1000])
@pytest.mark.parametrize("name", ["multi8", "ecoli21", "gz", "lower",
                                  "empty"])
def test_sketch_spectrum_file_equal(specs, name, s, canonical):
    kw = dict(s=s, canonical=canonical, name=None if s == 64 else "x")
    a = port_sketch.sketch_spectrum_file(specs[name], **kw)
    b = jax_sketch.sketch_spectrum_file(specs[name], **kw)
    assert a == b
    fa, fb = io.BytesIO(), io.BytesIO()
    port_sketch.write_sketch(a, fa)
    jax_sketch.write_sketch(b, fb)
    assert fa.getvalue() == fb.getvalue()


def test_sketch_multibyte_separator(specs):
    """With a multi-byte separator and the C library built, the reference
    stops at the C parser's 1-byte assert; the port takes the line path
    and gives the reference's sketch without its C library
    (ROADMAP.md D10)."""
    if not (port_native.available() and jax_native.available()):
        pytest.skip("no C compiler: the native library did not build")
    with pytest.raises(AssertionError):
        jax_sketch.sketch_spectrum_file(specs["colon"], s=50, sep=" :: ")
    got = port_sketch.sketch_spectrum_file(specs["colon"], s=50, sep=" :: ")
    jax_native_available = jax_native.available
    try:
        jax_native.available = lambda: False
        want = jax_sketch.sketch_spectrum_file(specs["colon"], s=50,
                                               sep=" :: ")
    finally:
        jax_native.available = jax_native_available
    assert got == want == port_sketch.sketch_spectrum_file(specs["multi8"],
                                                           s=50, name=specs[
                                                               "colon"])


def test_read_write_and_detect_equal(specs, tmp_path):
    """Each package reads the other's sketch files (plain and gzip) and
    agrees on what is a sketch file."""
    sk = port_sketch.sketch_spectrum_file(specs["ecoli21"], s=300,
                                          canonical=True)
    paths = {}
    for mod, tag in ((port_sketch, "port"), (jax_sketch, "jax")):
        for gz in (False, True):
            path = tmp_path / f"{tag}{'.json.gz' if gz else '.json'}"
            with (gzip.open if gz else open)(path, "wb") as f:
                mod.write_sketch(sk, f)
            paths[(tag, gz)] = str(path)
    for path in paths.values():
        assert port_sketch.read_sketch(path) == jax_sketch.read_sketch(path) \
            == sk
    not_sketches = [specs["ecoli21"], specs["gz"], specs["empty"],
                    str(tmp_path / "missing.json")]
    (tmp_path / "other.json").write_text('{"format": "other/v1"}')
    not_sketches.append(str(tmp_path / "other.json"))
    for path in list(paths.values()) + not_sketches:
        assert port_sketch.is_sketch_file(path) == \
            jax_sketch.is_sketch_file(path)
    for path in not_sketches[:3] + not_sketches[4:]:
        errs = []
        for mod in (port_sketch, jax_sketch):
            with pytest.raises(ValueError) as e:
                mod.read_sketch(path)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _sk(mod, k, s, canonical, hashes, name):
    return mod._make(k, s, canonical, np.asarray(hashes, np.uint64), name)


@pytest.mark.parametrize("case", ["overlap", "identical", "disjoint",
                                  "empty_both", "empty_one", "small_s",
                                  "k_mismatch", "canonical_mismatch"])
def test_compare_sketches_equal(case):
    rng = np.random.default_rng(len(case))
    pool = np.sort(rng.choice(1 << 40, 6000, replace=False)).astype(np.uint64)
    a_h, b_h = np.sort(pool[:4000]), np.sort(pool[2000:])
    args = {
        "overlap": ((21, 1000, False, a_h[:1000]), (21, 1000, False,
                                                    b_h[:1000])),
        "identical": ((21, 500, True, a_h[:500]), (21, 500, True,
                                                   a_h[:500])),
        "disjoint": ((8, 300, False, a_h[:300]), (8, 300, False,
                                                  pool[-300:])),
        "empty_both": ((5, 10, False, []), (5, 10, False, [])),
        "empty_one": ((5, 10, False, a_h[:10]), (5, 10, False, [])),
        "small_s": ((15, 50, False, a_h[:50]), (15, 2000, False,
                                                b_h[:2000])),
        "k_mismatch": ((5, 10, False, a_h[:10]), (6, 10, False, a_h[:10])),
        "canonical_mismatch": ((5, 10, False, a_h[:10]), (5, 10, True,
                                                          a_h[:10])),
    }[case]
    outs = []
    for mod in (port_sketch, jax_sketch):
        a = _sk(mod, *args[0], "a")
        b = _sk(mod, *args[1], "b")
        try:
            outs.append(mod.compare_sketches(a, b))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name, k, canonical", [
    ("tiny.fa", 5, False), ("multi.fa", 8, True),
    ("ecoli_frag.fa", 21, True)])
def test_sketch_sequences_equal(fixtures_dir, name, k, canonical):
    """Sequence input counted by the port on the CPU and by the
    reference: the same sketch, equal to the sketch of the oracle's
    spectrum of that input."""
    fa = os.path.join(fixtures_dir, name)
    # a small geometry (Config fields through **config_overrides): the
    # reference's default raw buffer takes minutes to compile on the CPU
    small = dict(chunk_len=4096, batch_rows=8, sparse_capacity=1 << 17,
                 sparse_compact_entries=1 << 16)
    got = port_sketch.sketch_sequences([fa], k, s=400, canonical=canonical,
                                       device="cpu", **small)
    want = jax_sketch.sketch_sequences([fa], k, s=400, canonical=canonical,
                                       **small)
    assert got == want
    api = port_api.sketch_sample(fa, k, s=400, canonical=canonical,
                                 device="cpu", **small)
    assert api == want
    codes = count_fasta_file(fa, k, canonical=canonical)
    oracle = jax_sketch.sketch_codes(np.array(
        [int(km.translate(str.maketrans("ACGT", "0123")), 4) for km in codes],
        np.uint64), 400)
    assert got["hashes"] == [format(int(h), "016x") for h in oracle]


def test_sketch_sample_and_similarity_api_equal(specs, tmp_path):
    """The API's `sketch_sample` without k and `similarity` over
    spectrum files, sketch dicts, sketch files and mixed pairs."""
    got = port_api.sketch_sample(specs["ecoli21c"], s=200, canonical=True)
    want = jax_api.sketch_sample(specs["ecoli21c"], s=200, canonical=True)
    assert got == want
    with pytest.raises(ValueError) as e1:
        port_api.sketch_sample([specs["ecoli21"]])
    with pytest.raises(ValueError) as e2:
        jax_api.sketch_sample([specs["ecoli21"]])
    assert str(e1.value) == str(e2.value)
    skf = tmp_path / "a.json"
    with open(skf, "wb") as f:
        port_sketch.write_sketch(got, f)
    plain = port_api.sketch_sample(specs["ecoli21"], s=200)
    pairs = [(specs["ecoli21"], specs["ecoli21c"], {}),
             (specs["ecoli21"], specs["lower"], {"canonical": True}),
             (got, specs["ecoli21"], {}),
             (str(skf), specs["gz"], {"canonical": True}),
             (specs["ecoli21"], str(skf), {}),
             (plain, specs["ecoli21c"], {"canonical": True}),
             (got, plain, {})]
    for a, b, kw in pairs:
        outs = []
        for api in (port_api, jax_api):
            try:
                outs.append(api.similarity(a, b, **kw))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], (a if isinstance(a, str) else "dict", kw)


def test_sketch_sample_on_cuda_without_a_card_raises(fixtures_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    fa = os.path.join(fixtures_dir, "tiny.fa")
    with pytest.raises(RuntimeError, match="is_available"):
        findkmer_torch.sketch_sample(fa, 5)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="is_available"):
        port_sketch.sketch_sequences([fa], 5)


def test_sketch_json_round_trip_is_the_reference_format(specs):
    sk = port_sketch.sketch_spectrum_file(specs["tiny5"], s=10)
    f = io.BytesIO()
    port_sketch.write_sketch(sk, f)
    d = json.loads(f.getvalue())
    assert d["format"] == jax_sketch.SKETCH_FORMAT == port_sketch.SKETCH_FORMAT
    assert port_sketch.DEFAULT_S == jax_sketch.DEFAULT_S
    assert [int(h, 16) for h in d["hashes"]] == sorted(
        int(h, 16) for h in d["hashes"])

"""The port's spectrum tools (`findkmer_torch.spectra`) against the JAX
package's (`findkmer_tpu.spectra`).

Every function of the module gets the same seeded spectrum files (numpy
`default_rng`) through both packages: the bytes each writes, what it
returns and the message of what it raises must be equal.  Each case runs
twice, with the C library of `io/native.py` built and with it made
unavailable (both packages' `native.available` patched to False), so the
C fast paths (`merge_binary_fast`, `_setop_binary_fast`,
`_similarity_binary`, `sort_spectrum_file`'s coded branch, the C parse
of `canonize`, `histo`, `info`) and their Python fallbacks are each held
to the reference; multi-byte separators, gzip inputs, lowercase and
unsorted files and k > 31 take the fallbacks with the library built.
Everything compared is integers, bytes, and floats computed from the same
integers in the same order: the tolerance is none.
"""

import gzip
import io

import numpy as np
import pytest

import findkmer_tpu.io.native as jax_native
import findkmer_tpu.spectra as jax_spectra
import findkmer_torch.io.native as port_native
import findkmer_torch.spectra as port_spectra

K = 8


def _kmers(codes, k):
    codes = np.asarray(codes, dtype=np.uint64)
    return ["".join("ACGT"[(int(c) >> (2 * (k - 1 - j))) & 3]
                    for j in range(k)) for c in codes]


def _rc(kmer):
    return kmer.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _write(path, kmers, counts, sep="\t"):
    path.write_text("".join(f"{km}{sep}{c}\n" for km, c in zip(kmers,
                                                                  counts)))
    return str(path)


@pytest.fixture(scope="module")
def P(tmp_path_factory):
    """Seeded spectrum files: three related k=8 samples (a shared pool of
    codes, counts 1-200 with many singletons), k=4 plain and canonical
    pairs for the -z interleave, a k=21 file, k=33 and mixed-length
    files, an unsorted mixed-case file with duplicate keys, an empty
    file, and lowercase, gzip and ' :: '-separated copies."""
    d = tmp_path_factory.mktemp("spectra")
    rng = np.random.default_rng(8)
    pool = np.unique(rng.integers(0, 4 ** K, 5000).astype(np.uint64))
    p = {}
    for name, n in (("a", 3000), ("b", 2500), ("c", 1200)):
        codes = np.sort(rng.choice(pool, n, replace=False))
        counts = np.where(rng.random(codes.size) < 0.3, 1,
                          rng.integers(1, 200, codes.size))
        p[name] = _write(d / f"{name}.tsv", _kmers(codes, K), counts)
    for name in ("a4", "b4"):
        codes = np.unique(rng.integers(0, 256, 120))
        kms = _kmers(codes, 4)
        p[name] = _write(d / f"{name}.tsv", kms, rng.integers(1, 9, len(kms)))
        canon = sorted({min(km, _rc(km)) for km in kms})
        p["c" + name] = _write(d / f"c{name}.tsv", canon,
                               rng.integers(1, 9, len(canon)))
    codes = np.unique(rng.integers(0, 4 ** 21, 2000).astype(np.uint64))
    p["a21"] = _write(d / "a21.tsv", _kmers(codes, 21),
                      rng.integers(1, 40, codes.size))
    k33 = sorted({"".join(rng.choice(list("ACGT"), 33)) for _ in range(300)})
    p["k33"] = _write(d / "k33.tsv", k33, rng.integers(1, 5, len(k33)))
    p["mixed"] = _write(d / "mixed.tsv", ["ACGT", "AC", "A", "acgt"],
                        [1, 2, 3, 4])
    a = open(p["a"]).read().splitlines()
    order = rng.permutation(len(a))
    shuffled = [a[i].lower() if i % 3 == 0 else a[i] for i in order]
    shuffled += a[:50]  # duplicate keys: summed by the dict paths
    (d / "unsorted.tsv").write_text("\n".join(shuffled) + "\n")
    p["unsorted"] = str(d / "unsorted.tsv")
    (d / "empty.tsv").write_text("")
    p["empty"] = str(d / "empty.tsv")
    for name in ("a", "b", "c"):
        text = open(p[name]).read()
        (d / f"{name}_low.tsv").write_text(text.lower())
        p[name + "_low"] = str(d / f"{name}_low.tsv")
        (d / f"{name}_colon.tsv").write_text(text.replace("\t", " :: "))
        p[name + "_colon"] = str(d / f"{name}_colon.tsv")
        with gzip.open(d / f"{name}.tsv.gz", "wt") as f:
            f.write(text)
        p[name + "_gz"] = str(d / f"{name}.tsv.gz")
    (d / "bad.tsv").write_text("AAAAAAAA\t1\nAAAAAAAC 2\n")
    p["bad"] = str(d / "bad.tsv")
    return p


def _norm(x):
    """Results made comparable: arrays and generators to lists."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if hasattr(x, "__next__"):
        return [_norm(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _outcome(mod, case, p):
    out = io.BytesIO()
    try:
        res = _norm(case(mod, out, p))
    except (ValueError, KeyError) as e:
        return ("raised", type(e).__name__, str(e), out.getvalue())
    return ("ok", res, out.getvalue())


def _abc(p, suffix=""):
    return [p["a" + suffix], p["b" + suffix], p["c" + suffix]]


# (id, case(module, out, paths) -> result); `out` is a BytesIO the case
# may write to
CASES = [
    ("merge_streaming", lambda m, o, p: m.merge_sorted_streaming(_abc(p), o)),
    ("merge_streaming_min", lambda m, o, p: m.merge_sorted_streaming(
        _abc(p), o, op="min")),
    ("merge_streaming_max", lambda m, o, p: m.merge_sorted_streaming(
        _abc(p), o, op="max")),
    ("merge_streaming_zeros", lambda m, o, p: m.merge_sorted_streaming(
        [p["a4"], p["b4"]], o, zeros_k=4)),
    ("merge_streaming_zeros_canonical", lambda m, o, p:
        m.merge_sorted_streaming([p["ca4"], p["cb4"]], o, zeros_k=4,
                                 canonical=True)),
    ("merge_streaming_zeros_noncanonical_input", lambda m, o, p:
        m.merge_sorted_streaming([p["a4"]], o, zeros_k=4, canonical=True)),
    ("merge_streaming_zeros_wrong_k", lambda m, o, p:
        m.merge_sorted_streaming([p["a"]], o, zeros_k=4)),
    ("merge_streaming_colon", lambda m, o, p: m.merge_sorted_streaming(
        [p["a_colon"], p["b_colon"]], o, sep=" :: ")),
    ("merge_streaming_gz", lambda m, o, p: m.merge_sorted_streaming(
        [p["a_gz"], p["b"]], o)),
    ("merge_streaming_unsorted", lambda m, o, p: m.merge_sorted_streaming(
        [p["unsorted"]], o)),
    ("merge_binary_fast", lambda m, o, p: m.merge_binary_fast(_abc(p), o)),
    ("merge_binary_fast_declines", lambda m, o, p: [
        m.merge_binary_fast(x, o) for x in ([p["a_low"]], [p["k33"]],
                                            [p["a_gz"]], [p["unsorted"]])]
        + [m.merge_binary_fast([p["a_colon"]], o, sep=" :: ")]),
    ("merge_dict", lambda m, o, p: m.merge_spectra(
        [p["a"], p["unsorted"], p["b_gz"]])),
    ("merge_dict_min_max", lambda m, o, p: [
        m.merge_spectra([p["a"], p["b"]], op=op) for op in ("min", "max")]),
    ("spectrum_lines_zeros", lambda m, o, p: list(m.spectrum_lines(
        m.merge_spectra([p["ca4"], p["cb4"]]), zeros_k=4, canonical=True))
        + list(m.spectrum_lines(m.read_spectrum(p["a4"]), sep=",",
                                zeros_k=4))),
    ("spectrum_lines_zeros_bad", lambda m, o, p: list(m.spectrum_lines(
        {"GT": 1}, zeros_k=2, canonical=True))),
    ("matrix", lambda m, o, p: m.matrix_sorted_streaming(
        _abc(p), o, ["x", "y", "z"])),
    ("matrix_filters", lambda m, o, p: m.matrix_sorted_streaming(
        [p["a"], p["b_gz"], p["c"]], o, ["x", "y", "z"], sep=",",
        min_total=20, min_samples=2)),
    ("matrix_names_mismatch", lambda m, o, p: m.matrix_sorted_streaming(
        _abc(p), o, ["x"])),
    ("canonize", lambda m, o, p: [m.canonize_spectrum_file(p[x], o) for x in
                                  ("a", "a21", "k33", "a_low", "a_gz",
                                   "empty")]),
    ("canonize_colon", lambda m, o, p: m.canonize_spectrum_file(
        p["a_colon"], o, sep=" :: ")),
    ("sort", lambda m, o, p: [m.sort_spectrum_file(p[x], o) for x in
                              ("unsorted", "mixed", "k33", "a21", "empty")]),
    ("sort_knobs", lambda m, o, p: [
        m.sort_spectrum_file(p["unsorted"], o, min_count=3, max_count=100),
        m.sort_spectrum_file(p["unsorted"], o, set_count=7),
        m.sort_spectrum_file(p["unsorted"], o, kmers_only=True),
        m.sort_spectrum_file(p["k33"], o, kmers_only=True),
        m.sort_spectrum_file(p["a_colon"], o, sep=" :: ", min_count=2)]),
    ("histo", lambda m, o, p: [m.histo_spectrum_file(p[x], max_count=mc)
                               for x in ("a", "k33", "a_gz", "empty")
                               for mc in (1, 50, 10000)]),
    ("histo_colon", lambda m, o, p: m.histo_spectrum_file(
        p["a_colon"], max_count=30, sep=" :: ")),
    ("histo_malformed", lambda m, o, p: m.histo_spectrum_file(p["bad"])),
    ("diff_dict", lambda m, o, p: m.diff_spectra(
        m.read_spectrum(p["a"]), m.read_spectrum(p["unsorted"]))),
    ("diff_streaming", lambda m, o, p: list(m.diff_sorted_streaming(
        p["a"], p["b_gz"]))),
    ("diff_streaming_unsorted", lambda m, o, p: list(m.diff_sorted_streaming(
        p["a"], p["unsorted"]))),
    ("grouped", lambda m, o, p: list(m._grouped(_abc(p), b"\t"))),
    ("lines", lambda m, o, p: [list(m._spectrum_lines(p["unsorted"], b"\t")),
                               list(m._sorted_lines(p["a_gz"], b"\t"))]),
    ("malformed", lambda m, o, p: list(m._spectrum_lines(p["bad"], b"\t"))),
    ("intersect", lambda m, o, p: m.intersect_sorted_streaming(_abc(p), o)),
    ("intersect_canonical", lambda m, o, p: m.intersect_sorted_streaming(
        [p["a"], p["b"]], o, canonical=True)),
    ("intersect_lower", lambda m, o, p: m.intersect_sorted_streaming(
        _abc(p, "_low"), o)),
    ("intersect_colon", lambda m, o, p: m.intersect_sorted_streaming(
        _abc(p, "_colon"), o, sep=" :: ")),
    ("subtract_counters", lambda m, o, p: m.subtract_sorted_streaming(
        _abc(p), o)),
    ("subtract_kmers", lambda m, o, p: m.subtract_sorted_streaming(
        _abc(p), o, mode="kmers")),
    ("subtract_canonical_kmers", lambda m, o, p: m.subtract_sorted_streaming(
        [p["a"], p["c_gz"]], o, canonical=True, mode="kmers")),
    ("subtract_lower", lambda m, o, p: [m.subtract_sorted_streaming(
        _abc(p, "_low"), o, mode=mode) for mode in ("counters", "kmers")]),
    ("setop_binary_fast", lambda m, o, p: [
        m._setop_binary_fast(_abc(p), o, op, "\t", mode=mode)
        for op, mode in (("intersect", "counters"), ("subtract", "counters"),
                         ("subtract", "kmers"))]
        + [m._setop_binary_fast([p["a"], p["empty"]], o, "intersect", "\t"),
           m._setop_binary_fast([p["a_low"], p["b"]], o, "intersect", "\t")]),
    ("expr", lambda m, o, p: m.expr_sorted_streaming(
        "(A + B) * C ~ A - (B * C)", dict(zip("ABC", _abc(p))), o)),
    ("expr_canonical", lambda m, o, p: m.expr_sorted_streaming(
        "A ~ B + C", dict(zip("ABC", _abc(p, "_gz"))), o, canonical=True)),
    ("expr_errors", lambda m, o, p: [_raises(lambda: list(m.eval_expression(
        t, {"A": p["a"], "B": p["b"]}))) for t in (
        "A +", "(A", "A $ B", "D", "A B", ")", "", "A * (B ~ 1)")]),
    ("query", lambda m, o, p: m.query_spectrum(
        p["a"], _kmers([0, 1, 4 ** K - 1], K)
        + [km.lower() for km in _kmers([5], K)]
        + open(p["b"]).read().split()[:40:2])),
    ("query_canonical", lambda m, o, p: m.query_spectrum(
        p["cb4"], ["AAAA", "TTTT", "acgt", "GGGG"], canonical=True)),
    ("query_unsorted", lambda m, o, p: m.query_spectrum(
        p["unsorted"], ["TTTTTTTT"])),
    ("top_n", lambda m, o, p: [m.top_n(p[x], n) for x in ("a", "k33")
                               for n in (0, 1, 10, 10 ** 6)]),
    ("info", lambda m, o, p: [m.info_spectrum_file(p[x]) for x in (
        "a", "ca4", "a4", "unsorted", "empty", "k33", "a_gz", "a_low",
        "mixed")]),
    ("info_colon", lambda m, o, p: m.info_spectrum_file(p["a_colon"],
                                                        sep=" :: ")),
    ("similarity", lambda m, o, p: [m.similarity_spectra(p[x], p[y]) for x, y
                                    in (("a", "b"), ("a", "a"), ("a", "c_gz"),
                                        ("a_low", "b_low"), ("a", "empty"),
                                        ("empty", "empty"), ("a", "a21"),
                                        ("k33", "k33"))]),
    ("similarity_canonical", lambda m, o, p: m.similarity_spectra(
        p["a"], p["b_low"], canonical=True)),
    ("similarity_colon", lambda m, o, p: m.similarity_spectra(
        p["a_colon"], p["b_colon"], sep=" :: ")),
    ("similarity_binary", lambda m, o, p: [m._similarity_binary(
        p[x], p[y], b"\t") for x, y in (("a", "b"), ("a", "a21"),
                                        ("a_gz", "b"))]),
    ("is_canonical_kmer", lambda m, o, p: [
        m._is_canonical_kmer(km.encode()) for km in _kmers(range(256), 4)]),
    ("write_codes", lambda m, o, p: [
        m._write_codes(o, np.arange(0, 4 ** 6, 7, dtype=np.uint64),
                       np.arange(586, dtype=np.int64) + 1, 6, b"\t"),
        m._write_codes(o, np.arange(9, dtype=np.uint64), np.ones(9), 3,
                       b",", kmers_only=True),
        m._write_batched(o, ((b"AC", 1), (b"GT", 20)), b" :: ")]),
]


# a separator longer than one byte reaches the reference's C parser from
# these cases and stops at its 1-byte assert; the port declines such a
# separator in `_parse_binary` (ROADMAP.md D10), so it is held to the
# reference's result without the C library
REFERENCE_WITHOUT_C = {"info_colon", "similarity_colon"}


def _raises(fn):
    try:
        return ("ok", _norm(fn()))
    except ValueError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("native_lib", ["built", "unavailable"])
@pytest.mark.parametrize("name, case", CASES, ids=[n for n, _ in CASES])
def test_spectra_function_equal(P, monkeypatch, name, case, native_lib):
    if native_lib == "built":
        if not (port_native.available() and jax_native.available()):
            pytest.skip("no C compiler: the native library did not build")
    else:
        monkeypatch.setattr(port_native, "available", lambda: False)
    got = _outcome(port_spectra, case, P)
    if native_lib == "unavailable" or name in REFERENCE_WITHOUT_C:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    assert got == _outcome(jax_spectra, case, P)


@pytest.mark.parametrize("name", sorted(REFERENCE_WITHOUT_C))
def test_reference_stops_at_a_multibyte_separator(P, name):
    """What REFERENCE_WITHOUT_C stands for: with its C library built the
    reference stops at the C parser's assert; the port answers."""
    if not (port_native.available() and jax_native.available()):
        pytest.skip("no C compiler: the native library did not build")
    case = dict(CASES)[name]
    with pytest.raises(AssertionError):
        case(jax_spectra, io.BytesIO(), P)
    assert _outcome(port_spectra, case, P)[0] == "ok"


def test_cases_reach_both_branches(P):
    """The fixtures do reach what the cases claim: the C paths accept the
    clean files, and decline the lowercase, gzip and k > 31 ones."""
    if not port_native.available():
        pytest.skip("no C compiler: the native library did not build")
    assert port_spectra.merge_binary_fast(_abc(P), io.BytesIO())
    assert port_spectra._similarity_binary(P["a"], P["b"], b"\t")
    assert port_spectra._setop_binary_fast(_abc(P), io.BytesIO(),
                                           "intersect", "\t") > 0
    for name in ("a_low", "a_gz", "k33", "unsorted"):
        assert not port_spectra.merge_binary_fast([P[name]], io.BytesIO())
    assert port_spectra._infer_k(P["k33"], b"\t") is None
    out = io.BytesIO()
    assert port_spectra.merge_sorted_streaming(_abc(P), out) > 3000


@pytest.mark.parametrize("seed", range(6))
def test_expr_random_trees_equal(P, seed):
    """Random expression trees over four inputs (the reference's
    `test_expr_random_trees_match_bruteforce`, held here to the
    reference itself): the same bytes and line count."""
    rng = np.random.default_rng(100 + seed)
    names = list("ABCD")
    inputs = dict(zip(names, _abc(P) + [P["a_gz"]]))

    def tree(depth):
        if depth == 0 or rng.random() < 0.3:
            return str(rng.choice(names))
        op = str(rng.choice(list("+-*~")))
        return f"({tree(depth - 1)} {op} {tree(depth - 1)})"

    for _ in range(4):
        text = tree(3)
        canonical = bool(rng.integers(0, 2))
        outs = []
        for mod in (jax_spectra, port_spectra):
            f = io.BytesIO()
            n = mod.expr_sorted_streaming(text, inputs, f,
                                          canonical=canonical)
            outs.append((n, f.getvalue()))
        assert outs[0] == outs[1], text


@pytest.mark.parametrize("cap", ["1000", "2999", "3000"])
def test_dict_cap_equal(P, monkeypatch, cap):
    """FINDKMER_DICT_MAX bounds `read_spectrum` and the --in-memory merge
    and diff with the same message (the line the user sees)."""
    monkeypatch.setenv("FINDKMER_DICT_MAX", cap)
    for fn in (lambda m: m.read_spectrum(P["unsorted"]),
               lambda m: m.merge_spectra([P["a"], P["b"]]),
               lambda m: m.sort_spectrum_file(P["a"], io.BytesIO())):
        assert _raises(lambda: fn(port_spectra)) == \
            _raises(lambda: fn(jax_spectra))


def test_revbytes_order_equal():
    words = [b"AC", b"AG", b"AC", b"T", b""]
    for x in words:
        for y in words:
            a, b = port_spectra._RevBytes(x), port_spectra._RevBytes(y)
            c, d = jax_spectra._RevBytes(x), jax_spectra._RevBytes(y)
            assert (a < b, a > b, a == b) == (c < d, c > d, c == d)

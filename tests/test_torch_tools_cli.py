"""The port's spectrum subcommands (`findkmer_torch.cli`) against the JAX
package's (`findkmer_tpu.cli`), run in this process on the same files.

Each case runs one argv through both CLIs (the port's counting
subcommands, `matrix -k`, `sketch -k` and `histo` without
`--from-spectrum`, with `--device cpu` added) and compares the exit
code, stdout, stderr (with the program name of the error line made the
same) and every file the run wrote (gzip outputs decompressed: their
headers carry a time stamp).  The inputs are seeded spectrum files
(numpy `default_rng`), their lowercase, gzip, unsorted, ' :: '-separated
and k = 33 variants, sketches written by the reference, and the FASTA
fixtures in tests/data.  Everything compared is bytes: the tolerance is
none.
"""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from findkmer_tpu import cli as jax_cli
from findkmer_tpu import sketch as jax_sketch
from findkmer_torch import cli as torch_cli
from oracle.scalar import count_fasta_file, spectrum_lines

torch.set_num_threads(1)  # six test workers share the cores


def _kmers(codes, k):
    return ["".join("ACGT"[(int(c) >> (2 * (k - 1 - j))) & 3]
                    for j in range(k)) for c in codes]


def _write(path, kmers, counts, sep="\t"):
    path.write_text("".join(f"{km}{sep}{c}\n" for km, c in zip(kmers,
                                                                  counts)))


@pytest.fixture(scope="module")
def data(tmp_path_factory, fixtures_dir):
    """The input directory of every case (argv paths are relative to
    it)."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(21)
    pool = np.unique(rng.integers(0, 4 ** 8, 4000))
    for i, n in ((1, 2000), (2, 1600), (3, 800)):
        codes = np.sort(rng.choice(pool, n, replace=False))
        counts = np.where(rng.random(n) < 0.3, 1, rng.integers(1, 300, n))
        _write(d / f"s{i}.tsv", _kmers(codes, 8), counts)
        text = (d / f"s{i}.tsv").read_text()
        (d / f"low{i}.tsv").write_text(text.lower())
        (d / f"colon{i}.tsv").write_text(text.replace("\t", " :: "))
        with gzip.open(d / f"s{i}.tsv.gz", "wt") as f:
            f.write(text)
    for i in (1, 2):
        kms = _kmers(np.unique(rng.integers(0, 256, 100)), 4)
        _write(d / f"p{i}.tsv", kms, rng.integers(1, 9, len(kms)))
        rc = {km: km.translate(str.maketrans("ACGT", "TGCA"))[::-1]
              for km in kms}
        canon = sorted({min(km, rc[km]) for km in kms})
        _write(d / f"c{i}.tsv", canon, rng.integers(1, 9, len(canon)))
    rows = (d / "s1.tsv").read_text().splitlines()
    mixed = [rows[i].lower() if i % 4 == 0 else rows[i]
             for i in rng.permutation(len(rows))] + rows[:30]
    (d / "unsorted.tsv").write_text("\n".join(mixed) + "\n")
    k33 = sorted({"".join(rng.choice(list("ACGT"), 33)) for _ in range(200)})
    _write(d / "k33.tsv", k33, rng.integers(1, 6, len(k33)))
    _write(d / "mixed.tsv", ["ACGT", "AC", "A", "acgt"], [1, 2, 3, 4])
    (d / "empty.tsv").write_text("")
    for name in ("tiny", "multi", "ecoli_frag"):
        shutil.copy(os.path.join(fixtures_dir, f"{name}.fa"), d)
    for sub, src in (("a", "tiny"), ("b", "multi")):  # colliding stems
        (d / sub).mkdir()
        shutil.copy(d / f"{src}.fa", d / sub / "x.fa")
    for name, k, canonical in (("e21", 21, False), ("e21c", 21, True)):
        _write(d / f"{name}.tsv", *zip(*(ln.split("\t") for ln in
                                          spectrum_lines(count_fasta_file(
                                              d / "ecoli_frag.fa", k,
                                              canonical=canonical), k))))
    (d / "kmers.txt").write_text(" ".join(rows[5].split("\t")[:1] + [
        "acgtacgt", "TTTTTTTT"]) + "\n" + rows[900].split("\t")[0] + "\n")
    for name, src, s, canonical in (("sk1", "s1", 100, False),
                                    ("sk2", "s2", 100, False),
                                    ("sk3", "s3", 60, False),
                                    ("skc", "s1", 100, True),
                                    ("sk21", "e21", 100, False)):
        sk = jax_sketch.sketch_spectrum_file(str(d / f"{src}.tsv"), s=s,
                                             canonical=canonical)
        with open(d / f"{name}.json", "wb") as f:
            jax_sketch.write_sketch(sk, f)
    return d


# (id, argv; "{o}/" names the output directory; COUNTING adds --device cpu
# for the port)
CASES = [
    ("merge", "merge -i s1.tsv s2.tsv s3.tsv -o {o}/m.tsv"),
    ("merge_stdout", "merge -i s1.tsv s2.tsv"),
    ("merge_in_memory", "merge -i unsorted.tsv s2.tsv --in-memory -o {o}/m.tsv"),
    ("merge_min", "merge -i s1.tsv s2.tsv s3.tsv --op min"),
    ("merge_max", "merge -i s1.tsv s2.tsv --op max -o {o}/m.tsv"),
    ("merge_zeros", "merge -i p1.tsv p2.tsv -z -k 4"),
    ("merge_zeros_canonical", "merge -i c1.tsv c2.tsv -z -k 4 --canonical"),
    ("merge_zeros_canonical_in_memory",
     "merge -i c1.tsv c2.tsv -z -k 4 --canonical --in-memory"),
    ("merge_zeros_noncanonical_input", "merge -i p1.tsv -z -k 4 --canonical"),
    ("merge_gz", "merge -i s1.tsv.gz s2.tsv -o {o}/m.tsv.gz"),
    ("merge_colon", "merge -i colon1.tsv colon2.tsv --sep ' :: '"),
    ("merge_lower", "merge -i low1.tsv low2.tsv"),
    ("merge_unsorted", "merge -i unsorted.tsv -o {o}/m.tsv"),
    ("merge_zeros_without_k", "merge -i s1.tsv -z"),
    ("merge_canonical_without_zeros", "merge -i s1.tsv --canonical"),
    ("merge_missing_input", "merge -i missing.tsv"),
    ("matrix", "matrix -i s1.tsv s2.tsv s3.tsv"),
    ("matrix_names_filters", "matrix -i s1.tsv s2.tsv.gz s3.tsv --names "
     "A,B,C --min-total 20 --min-samples 2 -o {o}/x.tsv"),
    ("matrix_names_mismatch", "matrix -i s1.tsv s2.tsv --names A -o {o}/x"),
    ("matrix_canonical_without_k", "matrix -i s1.tsv --canonical"),
    ("matrix_k8", "matrix -i tiny.fa multi.fa ecoli_frag.fa -k 8"),
    ("matrix_k21_canonical", "matrix -i ecoli_frag.fa multi.fa a/x.fa b/x.fa "
     "-k 21 --canonical --min-samples 2 -o {o}/x.tsv"),
    ("matrix_k5_sep", "matrix -i tiny.fa multi.fa -k 5 --sep ,"),
    ("expr_union", "expr 'A + B' -i A=s1.tsv B=s2.tsv"),
    ("expr_tree", "expr '(A + B) * C ~ A - B' -i A=s1.tsv B=s2.tsv C=s3.tsv "
     "-o {o}/e.tsv"),
    ("expr_canonical", "expr 'A * B' --canonical -i A=s1.tsv B=s2.tsv.gz"),
    ("expr_parse_error", "expr 'A +' -i A=s1.tsv -o {o}/e.tsv"),
    ("expr_undefined_name", "expr 'A + Z' -i A=s1.tsv"),
    ("expr_bad_input", "expr A -i s1.tsv"),
    ("expr_duplicate_name", "expr A -i A=s1.tsv A=s2.tsv"),
    ("expr_missing_file", "expr A -i A=missing.tsv"),
    ("intersect", "intersect -i s1.tsv s2.tsv s3.tsv"),
    ("intersect_canonical", "intersect -i s1.tsv s2.tsv --canonical "
     "-o {o}/i.tsv"),
    ("intersect_lower", "intersect -i low1.tsv low2.tsv"),
    ("intersect_colon", "intersect -i colon1.tsv colon2.tsv --sep ' :: '"),
    ("subtract", "subtract -i s1.tsv s2.tsv s3.tsv"),
    ("subtract_kmers", "subtract -i s1.tsv s2.tsv s3.tsv --mode kmers"),
    ("subtract_canonical", "subtract -i s1.tsv s3.tsv.gz --canonical --mode "
     "kmers -o {o}/s.tsv.gz"),
    ("subtract_unsorted", "subtract -i unsorted.tsv s2.tsv"),
    ("sort", "sort unsorted.tsv"),
    ("sort_min_max", "sort unsorted.tsv --min-count 3 --max-count 100"),
    ("sort_set_count", "sort unsorted.tsv --set-count 7 -o {o}/s.tsv"),
    ("sort_kmers_only", "sort unsorted.tsv --kmers-only"),
    ("sort_k33", "sort k33.tsv"),
    ("sort_mixed", "sort mixed.tsv"),
    ("sort_colon", "sort colon1.tsv --sep ' :: '"),
    ("canonize", "canonize s1.tsv"),
    ("canonize_k33", "canonize k33.tsv"),
    ("canonize_gz", "canonize s1.tsv.gz -o {o}/c.tsv.gz"),
    ("canonize_colon", "canonize colon1.tsv --sep ' :: '"),
    ("query", "query s1.tsv AAAAAAAA acgtacgt TTTTTTTT"),
    ("query_kmers_file", "query s1.tsv --kmers-file kmers.txt GGGGGGGG"),
    ("query_canonical", "query c1.tsv AAAA TTTT acgt --canonical"),
    ("query_nothing", "query s1.tsv"),
    ("query_unsorted", "query unsorted.tsv TTTTTTTT"),
    ("topn", "topn s1.tsv"),
    ("topn_0", "topn s1.tsv -n 0"),
    ("topn_all", "topn s1.tsv -n 100000"),
    ("topn_k33", "topn k33.tsv -n 7"),
    ("histo_from_spectrum", "histo -i s1.tsv s2.tsv -k 1 --from-spectrum"),
    ("histo_from_spectrum_opts", "histo -i s1.tsv -k 1 --from-spectrum "
     "--max-count 20 --nonzero-only -o {o}/h.tsv"),
    ("histo_from_spectrum_k33", "histo -i k33.tsv -k 1 --from-spectrum"),
    ("histo_from_spectrum_colon", "histo -i colon1.tsv -k 1 --from-spectrum "
     "--sep ' :: ' --nonzero-only"),
    ("histo_k8", "histo -i multi.fa ecoli_frag.fa -k 8 --nonzero-only"),
    ("histo_k21_canonical", "histo -i ecoli_frag.fa -k 21 --canonical "
     "--max-count 5 -o {o}/h.tsv"),
    ("histo_zeros_sparse", "histo -i tiny.fa -k 21 -z"),
    ("info", "info s1.tsv"),
    ("info_json", "info s1.tsv --json"),
    ("info_canonical", "info c1.tsv"),
    ("info_unsorted", "info unsorted.tsv --json"),
    ("info_empty", "info empty.tsv"),
    ("info_k33", "info k33.tsv"),
    ("info_gz", "info s1.tsv.gz"),
    ("info_sketch", "info sk1.json"),
    ("info_sketch_json", "info skc.json --json"),
    ("similarity", "similarity -i s1.tsv s2.tsv"),
    ("similarity_json", "similarity -i s1.tsv s3.tsv --json"),
    ("similarity_canonical", "similarity -i s1.tsv low2.tsv --canonical"),
    ("similarity_lower", "similarity -i low1.tsv s2.tsv.gz"),
    ("similarity_three", "similarity -i s1.tsv s2.tsv s3.tsv"),
    ("similarity_three_json", "similarity -i s1.tsv s2.tsv s3.tsv --json"),
    ("similarity_sketches", "similarity -i sk1.json sk2.json"),
    ("similarity_mixed", "similarity -i sk1.json s2.tsv"),
    ("similarity_mixed_three", "similarity -i sk1.json s2.tsv sk3.json"),
    ("similarity_canonical_sketches", "similarity -i skc.json s2.tsv "
     "--canonical"),
    ("similarity_canonical_mismatch", "similarity -i sk1.json s2.tsv "
     "--canonical"),
    ("similarity_one_input", "similarity -i s1.tsv"),
    ("similarity_k_mismatch", "similarity -i sk1.json sk21.json"),
    ("sketch", "sketch -i s1.tsv -s 50"),
    ("sketch_canonical_named", "sketch -i e21.tsv --canonical -s 200 "
     "--name e -o {o}/e.json"),
    ("sketch_gz", "sketch -i s2.tsv.gz -o {o}/e.json.gz"),
    ("sketch_k8", "sketch -i tiny.fa multi.fa -k 8 -s 100"),
    ("sketch_per_input", "sketch -i a/x.fa b/x.fa tiny.fa -k 6 --per-input "
     "--canonical -s 80 -o {o}/sk"),
    ("sketch_s0", "sketch -i s1.tsv -s 0"),
    ("sketch_per_input_without_k", "sketch -i s1.tsv --per-input -o {o}/sk"),
    ("sketch_per_input_without_dir", "sketch -i tiny.fa -k 5 --per-input"),
    ("sketch_two_spectra", "sketch -i s1.tsv s2.tsv"),
    ("diff_equal", "diff -i s1.tsv s1.tsv.gz"),
    ("diff_limit", "diff -i s1.tsv s2.tsv --limit 3"),
    ("diff_default_limit", "diff -i s1.tsv s3.tsv"),
    ("diff_in_memory", "diff -i unsorted.tsv s1.tsv --in-memory"),
    ("diff_unsorted", "diff -i unsorted.tsv s1.tsv"),
    ("stats", "stats -i multi.fa ecoli_frag.fa -k 8"),
    ("stats_fasta_k21", "stats -i tiny.fa -k 21 --format fasta"),
]
COUNTING = ("matrix_k", "histo_k", "histo_zeros", "sketch_k8",
            "sketch_per_input", "sketch_per_input_without_dir")


def _argv(text, out):
    import shlex

    return [a.replace("{o}", str(out)) for a in shlex.split(text)]


def _files(out):
    """{relative path: bytes} of everything under out (gzip decoded)."""
    got = {}
    for root, _, names in os.walk(out):
        for name in names:
            path = os.path.join(root, name)
            opener = gzip.open if name.endswith(".gz") else open
            with opener(path, "rb") as f:
                got[os.path.relpath(path, out)] = f.read()
    return got


def _run(main, argv, out, capsysbinary):
    out.mkdir()
    rc = main(argv)
    cap = capsysbinary.readouterr()
    err = cap.err.replace(b"findkmer-torch: error:", b"findkmer: error:")
    return (rc, cap.out.replace(str(out).encode(), b"{o}"),
            err.replace(str(out).encode(), b"{o}"), _files(out))


@pytest.mark.parametrize("name, text", CASES, ids=[n for n, _ in CASES])
def test_tool_cli_equal(data, tmp_path, monkeypatch, capsysbinary, name,
                        text):
    monkeypatch.chdir(data)
    want = _run(jax_cli.main, _argv(text, tmp_path / "jax"),
                tmp_path / "jax", capsysbinary)
    port_argv = _argv(text, tmp_path / "port")
    if name.startswith(COUNTING):
        port_argv += ["--device", "cpu"]
    got = _run(torch_cli.main, port_argv, tmp_path / "port", capsysbinary)
    assert got == want
    # each case does what its name says: errors exit 2, `diff` of
    # different spectra 1, the rest write something
    rc, out, err, files = got
    if name.startswith("diff_") and name not in ("diff_equal",
                                                 "diff_unsorted"):
        assert rc == 1 and out
    elif rc == 0:
        assert out or files or name in ("topn_0", "diff_equal")
    else:
        assert rc == 2 and err.startswith(b"findkmer: error:"), err


def test_subcommands_are_the_reference_less_bench():
    def subparsers(build):
        p = build()
        return next(a for a in p._actions if hasattr(a, "choices")
                    and a.choices and "count" in a.choices).choices

    ours, theirs = subparsers(torch_cli.build_parser), subparsers(
        jax_cli.build_parser)
    assert list(ours) == [c for c in theirs if c != "bench"]


@pytest.mark.parametrize("cmd", [
    "stats", "merge", "matrix", "expr", "intersect", "subtract", "sort",
    "canonize", "query", "topn", "histo", "info", "similarity", "sketch",
    "diff"])
def test_subcommand_flags_equal(cmd):
    """Flags, defaults, choices and help texts as the reference's; the
    counting subcommands add --device (default cuda)."""
    def flags(build):
        p = build()
        sub = next(a for a in p._actions if hasattr(a, "choices")
                   and a.choices and "count" in a.choices).choices[cmd]
        return {tuple(a.option_strings) or a.dest: (
            a.help, a.default, a.choices, a.metavar, a.nargs, a.required)
            for a in sub._actions}, (sub.description, sub.epilog)

    (ours, ours_text), (theirs, theirs_text) = flags(
        torch_cli.build_parser), flags(jax_cli.build_parser)
    device = ours.pop(("--device",), None)
    assert (device is not None) == (cmd in ("matrix", "histo", "sketch"))
    if device is not None:
        assert device[1:3] == ("cuda", ["cuda", "cpu"])
    assert ours == theirs
    assert ours_text == theirs_text


def test_input_stems_equal():
    paths = ["a/x.fa", "b/x.fa", "x.FQ.gz", "y.tsv", "z.sam", "w.bam",
             "x", "s.fasta.gz", "y.tsv"]
    assert torch_cli._input_stems(paths) == jax_cli._input_stems(paths)


@pytest.mark.cuda
def test_counting_tools_on_card_equal_cpu(data, tmp_path, monkeypatch,
                                          capsysbinary):
    """On a CUDA card: `matrix -k 21 --canonical` and `sketch -k 21`
    (one sample and --per-input) on cuda write the bytes of their
    --device cpu runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.chdir(data)
    for text in ("matrix -i ecoli_frag.fa multi.fa a/x.fa b/x.fa -k 21 "
                 "--canonical --min-samples 2 -o {o}/x.tsv",
                 "sketch -i ecoli_frag.fa multi.fa -k 21 -o {o}/s.json",
                 "sketch -i ecoli_frag.fa a/x.fa b/x.fa -k 21 --canonical "
                 "--per-input -o {o}/sk",
                 "histo -i ecoli_frag.fa -k 21 --canonical -o {o}/h.tsv",
                 "histo -i ecoli_frag.fa -k 8 -o {o}/h.tsv"):
        runs = [_run(torch_cli.main, _argv(text, tmp_path / dev) + [
            "--device", dev], tmp_path / dev, capsysbinary)
            for dev in ("cuda", "cpu")]
        assert runs[0] == runs[1], text
        assert runs[0][0] == 0 and runs[0][3], text
        shutil.rmtree(tmp_path / "cuda")
        shutil.rmtree(tmp_path / "cpu")

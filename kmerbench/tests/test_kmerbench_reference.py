"""The plain reference against `oracle/scalar.py` (the repository's
byte-at-a-time counter) at k=8 and k=21 canonical, on FASTA and FASTQ
with N, lowercase, IUPAC codes and record boundaries; its text formats;
its controls."""

import numpy as np
import pytest
import torch

from kmerbench.reference import histogram, kmers, per_input, tsv_spectrum
from oracle.scalar import (count_kmers_in_records, parse_fasta_text,
                           spectrum_lines)

LETTERS = np.frombuffer(b"ACGTacgtNRYKn", np.uint8)
P = np.array([20, 20, 20, 20, 5, 5, 5, 5, 2, 1, 1, 1, 1], float)


def _records(rng, n, longest):
    return [rng.choice(LETTERS, int(rng.integers(0, longest)), p=P / P.sum())
            .tobytes().decode() for _ in range(n)]


def _write_fasta(path, recs, width):
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            f.write(f">rec{i} a header line\n")
            for s in range(0, len(r), width):
                f.write(r[s : s + width] + "\n")


def _write_fastq(path, recs):
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            f.write(f"@read{i}/1 x\n{r}\n+\n{'I' * len(r)}\n")


def _text(codes, counts, k):
    return b"".join(p.tobytes() for p in kmers.tsv_pieces(codes, counts, k))


def _want(recs, k, canonical):
    lines = spectrum_lines(count_kmers_in_records(recs, k,
                                                  canonical=canonical), k)
    return ("\n".join(lines) + "\n" if lines else "").encode()


@pytest.mark.parametrize("k,canonical", [(8, False), (21, True), (8, True),
                                         (21, False), (1, False), (31, True)])
@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_spectrum_equals_the_oracle(tmp_path, k, canonical, fmt):
    rng = np.random.default_rng(k * 7 + canonical)
    recs = _records(rng, 12, 400)
    path = str(tmp_path / f"in.{fmt}")
    if fmt == "fasta":
        _write_fasta(path, recs, 61)
    else:
        _write_fastq(path, recs)
    codes, counts = kmers.spectrum([path], k, canonical, "cpu")
    assert _text(codes, counts, k) == _want(recs, k, canonical)


def test_fasta_parse_matches_the_oracle(tmp_path):
    rng = np.random.default_rng(3)
    recs = _records(rng, 7, 300)
    path = str(tmp_path / "in.fa")
    _write_fasta(path, recs, 50)
    seqs = [s for _, s in parse_fasta_text(open(path).read())]
    assert seqs == recs
    got = kmers.read_sequences(path).tobytes().split(b">")[1:]
    assert [g.decode() for g in got] == recs


def test_inputs_count_as_one_and_per_input_apart(tmp_path):
    rng = np.random.default_rng(5)
    a, b = _records(rng, 4, 300), _records(rng, 4, 300)
    pa, pb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    _write_fasta(pa, a, 70)
    _write_fasta(pb, b, 70)
    (one,) = tsv_spectrum.streams([pa, pb], 21, True, "cpu")
    assert b"".join(bytes(p) for p in one) == _want(a + b, 21, True)
    sa, sb = per_input.streams([pa, pb], 21, True, "cpu")
    assert b"".join(bytes(p) for p in sa) == _want(a, 21, True)
    assert b"".join(bytes(p) for p in sb) == _want(b, 21, True)


def test_histogram_lines(tmp_path):
    rng = np.random.default_rng(9)
    recs = [r.replace("N", "A") for r in _records(rng, 30, 200)]
    recs += ["A" * 60]  # one 8-mer 53 times
    path = str(tmp_path / "in.fa")
    _write_fasta(path, recs, 60)
    counts = count_kmers_in_records(recs, 8, canonical=True)
    (h,) = histogram.streams([path], 8, True, "cpu", max_count=20)
    got = b"".join(h).decode().splitlines()
    assert len(got) == 20
    want = np.bincount(np.minimum(list(counts.values()), 20), minlength=21)
    assert got == [f"{m}\t{want[m]}" for m in range(1, 21)]


def test_digits_of_large_counts():
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    counts = torch.tensor([1, 9, 10, 1234567890123], dtype=torch.int64)
    assert _text(codes, counts, 2) == (b"AA\t1\nAC\t9\nAG\t10\n"
                                       b"AT\t1234567890123\n")


def test_fingerprint32_control_shares_counts_of_colliding_codes():
    gen = torch.Generator().manual_seed(0)
    codes = torch.unique(torch.randint(0, 1 << 42, (400_000,), generator=gen))
    fp = kmers.fingerprint32(codes)
    assert int(fp.min()) >= 0 and int(fp.max()) < 1 << 32
    counts = torch.randint(1, 50, codes.shape, generator=gen)
    shared = kmers._shared_counts(codes, counts)
    _, inv, per = torch.unique(fp, return_inverse=True, return_counts=True)
    collide = per[inv] > 1
    assert int(collide.sum()) > 0  # 400 k keys of 32 bits: ~19 pairs
    assert torch.equal(shared[~collide], counts[~collide])
    totals = torch.zeros(per.numel(), dtype=counts.dtype).index_add_(
        0, inv, counts)
    assert torch.equal(shared, totals[inv])


def test_count16_control_saturates(tmp_path):
    path = str(tmp_path / "in.fa")
    _write_fasta(path, ["A" * 40_000], 80)
    _, exact = kmers.spectrum([path], 8, False, "cpu")
    _, narrow = kmers.spectrum([path], 8, False, "cpu", "count16")
    assert int(exact[0]) == 40_000 - 7 and int(narrow[0]) == 32767


def test_unknown_variant_is_refused(tmp_path):
    path = str(tmp_path / "in.fa")
    _write_fasta(path, ["ACGT" * 10], 80)
    with pytest.raises(ValueError):
        kmers.spectrum([path], 4, False, "cpu", "int4")


def test_window_chunks_join_without_seams(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    recs = _records(rng, 3, 3000)
    path = str(tmp_path / "in.fa")
    _write_fasta(path, recs, 80)
    whole = kmers.spectrum([path], 21, True, "cpu")
    monkeypatch.setattr(kmers, "WINDOW_CHUNK", 257)
    monkeypatch.setattr(kmers, "LINE_CHUNK", 100)
    parts = kmers.spectrum([path], 21, True, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(whole, parts))
    assert _text(*parts, 21) == _want(recs, 21, True)

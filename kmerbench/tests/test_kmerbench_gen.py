"""The traffic generators at a small scale: the same seed gives the same
bytes, and GC, N, repeat share, heterozygosity, error rate and sizes land
where the parameters put them."""

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

from kmerbench import gen
from kmerbench.gen.common import ACGT
from kmerbench.reference.kmers import read_sequences

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _traffic(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    return gen.load(t["generator"]), t["params"]


def _make(tmp_path, name, seed, params=None, tag="run"):
    mod, p = _traffic(name)
    out = tmp_path / f"{tag}{seed}"
    out.mkdir()
    return mod.generate(str(out), seed, params or mod.tiny(p))


def _bytes(made):
    return [Path(p).read_bytes() for p in made["inputs"]]


@pytest.mark.parametrize("name", ["chr1", "reads_histo", "isolates"])
def test_same_seed_same_bytes(tmp_path, name):
    seed = 2**31 + 5  # the driver's seeds pass 32 signed bits
    a = _make(tmp_path, name, seed, tag="a")
    b = _make(tmp_path, name, seed, tag="b")
    c = _make(tmp_path, name, seed + 1)
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(c)
    letters = sum(int((read_sequences(p) != ord(">")).sum())
                  for p in a["inputs"])
    assert a["bases"] == letters


def test_chr1_like_shares(tmp_path):
    mod, p = _traffic("chr1")
    p = {**mod.tiny(p), "length": 2_000_000}
    made = _make(tmp_path, "chr1", 7, p)
    seq = read_sequences(made["inputs"][0])[1:]
    assert seq.size == p["length"] == made["bases"]
    n = seq == ord("N")
    assert int(n.sum()) == p["gaps"]["n_total"]
    assert np.all(n[: p["gaps"]["telomere"]]) and np.all(
        n[-p["gaps"]["telomere"]:])
    acgt = ~n
    up = seq[acgt] & 0xDF
    gc = np.isin(up, np.frombuffer(b"GC", np.uint8)).mean()
    assert abs(gc - p["gc"]) < 0.02
    masked = (seq >= ord("a")).mean()
    sat = p["satellite"]
    want = sum(f["share"] for f in p["families"]) + p["microsat"]["share"] \
        + sat["arrays"] * np.mean(sat["array_len"]) / p["length"]
    assert abs(masked - want) < 0.03
    assert set(np.unique(up).tolist()) <= set(b"ACGT")


def test_diploid_reads_heterozygosity_errors_and_qualities(tmp_path):
    mod, p = _traffic("reads_histo")
    p = {**mod.tiny(p), "genome": 200_000, "coverage": 20, "chunk": 5000}
    seed = 3
    made = _make(tmp_path, "reads_histo", seed, p)
    # haplotypes as the generator draws them first from the seed
    rng = np.random.default_rng(seed)
    from kmerbench.gen.common import random_codes, substitute
    a = random_codes(rng, p["genome"], p["gc"])
    b = a.copy()
    substitute(b, p["het"], rng)
    assert abs((a != b).mean() - p["het"]) < 0.0015
    haps = np.stack([ACGT[a], ACGT[b]])
    R = p["read_len"]
    mism = np.zeros(R)
    n_reads, ns = 0, 0
    head = re.compile(rb"@r\d{9}/[12] ([01]):(\d{9}):([+-])")
    for path in made["inputs"]:
        lines = Path(path).read_bytes().split(b"\n")
        for h, s, q in zip(lines[0::4], lines[1::4], lines[3::4]):
            hap, pos, strand = head.match(h).groups()
            true = haps[int(hap), int(pos) : int(pos) + R]
            if strand == b"-":
                true = np.frombuffer(bytes(true)[::-1].translate(
                    bytes.maketrans(b"ACGT", b"TGCA")), np.uint8)
            got = np.frombuffer(s, np.uint8)
            ok = got != ord("N")
            ns += int((~ok).sum())
            mism += (got != true) & ok
            n_reads += 1
            assert len(q) == R
    assert n_reads == 2 * round(p["coverage"] * p["genome"] / (2 * R))
    rate = mism / n_reads
    want = np.linspace(p["err"][0], p["err"][1], R)
    assert abs(rate[:50].mean() - want[:50].mean()) < 0.001
    assert abs(rate[-50:].mean() - want[-50:].mean()) < 0.002
    assert abs(rate.mean() * 3 / 3 - want.mean()) < 0.001
    assert ns / (n_reads * R) < 5 * p["n_rate"]


def test_isolate_cohort_sizes_gc_and_records(tmp_path):
    mod, p = _traffic("isolates")
    p = {**mod.tiny(p), "samples": 5}
    made = _make(tmp_path, "isolates", 4, p)
    assert len(made["inputs"]) == 5
    total = 0
    for path in made["inputs"]:
        text = Path(path).read_bytes()
        heads = [ln for ln in text.split(b"\n") if ln.startswith(b">")]
        assert heads[0].endswith(b"chromosome")
        assert p["plasmids"][0] <= len(heads) - 1 <= p["plasmids"][1]
        seqs = read_sequences(path).tobytes().split(b">")[1:]
        lo, hi = p["size"]
        assert lo - p["block"] <= len(seqs[0]) <= hi
        for s in seqs[1:]:
            assert p["plasmid_len"][0] <= len(s) <= p["plasmid_len"][1]
        arr = np.frombuffer(b"".join(seqs), np.uint8)
        assert abs(np.isin(arr, np.frombuffer(b"GC", np.uint8)).mean()
                   - p["gc"]) < 0.02
        total += arr.size
    assert total == made["bases"]
    assert os.path.basename(made["inputs"][0]) == "isolate01.fa"

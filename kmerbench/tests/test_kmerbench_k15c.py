"""The thresholded cells, `k15c.repeats` and `k21c.chr1_min2`: their
reference `tsv_spectrum_min` against `oracle/scalar.py`; a threshold one
off in the program comes out not correct in both; the control of `k15c`
(int16 counts) comes out not correct on three seeds.

`k15c.repeats`' --min-count N is meryl's `distinct=0.9998` threshold of
the full-size input, where the satellite monomer's and the Alu family's
15-mers lie; at the generator's tiny size the same rule gives a smaller
N, which the off-by-one run takes instead, so that k-mers sit at the
threshold."""

import dataclasses

import numpy as np
import pytest
import torch

from kmerbench import control, gen, harness
from kmerbench.reference import kmers, tsv_spectrum_min
from kmerbench.spans import _patch
from oracle.scalar import count_kmers_in_records, spectrum_lines

NEW = ["k15c.repeats", "k21c.chr1_min2"]
SEED = 2**31 + 29
LETTERS = np.frombuffer(b"ACGTacgtNRn", np.uint8)
P = np.array([20, 20, 20, 20, 5, 5, 5, 5, 2, 1, 1], float)


def _fasta(path, rng):
    """Records of random letters, a repeated stretch in each so that
    counts pass 1."""
    unit = rng.choice(LETTERS[:4], 40).tobytes().decode()
    recs = []
    for _ in range(9):
        r = rng.choice(LETTERS, int(rng.integers(0, 500)), p=P / P.sum())
        recs.append(r.tobytes().decode() + unit * int(rng.integers(0, 4)))
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            f.write(f">r{i}\n")
            for s in range(0, len(r), 60):
                f.write(r[s : s + 60] + "\n")
    return recs


@pytest.mark.parametrize("lo,hi", [(0, 0), (1, 0), (2, 0), (3, 0), (2, 3),
                                   (0, 1), (50, 0)])
@pytest.mark.parametrize("k,canonical", [(15, True), (15, False),
                                         (21, True)])
def test_tsv_spectrum_min_equals_the_oracle(tmp_path, k, canonical, lo, hi):
    rng = np.random.default_rng(k + 3 * canonical)
    path = str(tmp_path / "in.fa")
    recs = _fasta(path, rng)
    counts = {m: c for m, c in count_kmers_in_records(
        recs, k, canonical=canonical).items()
        if c >= lo and (not hi or c <= hi)}
    lines = spectrum_lines(counts, k)
    want = ("\n".join(lines) + "\n" if lines else "").encode()
    (stream,) = tsv_spectrum_min.streams([path], k, canonical, "cpu",
                                         min_count=lo, max_count=hi)
    assert b"".join(p.tobytes() for p in stream) == want
    assert want or lo == 50


def test_meryl_min_count():
    ones = [1] * 9997
    assert tsv_spectrum_min.meryl_min_count(torch.tensor(ones + [1, 5, 5])) \
        == 2
    assert tsv_spectrum_min.meryl_min_count(torch.tensor(ones + [3, 5, 5])) \
        == 4


def _tiny(cell):
    return gen.load(cell.traffic["generator"]).tiny(cell.traffic["params"])


def _at_tiny_threshold(cell, params):
    """The cell with --min-count set by meryl's rule on the tiny input of
    SEED, where the cell's own N is a full-size count."""
    if "min_count" not in cell.traffic["reference_params"] \
            or cell.traffic["reference_params"]["min_count"] <= 2:
        return cell
    import tempfile

    tmp = tempfile.mkdtemp()
    try:
        made = gen.load(cell.traffic["generator"]).generate(
            tmp, SEED, params)
        _, counts = kmers.spectrum(made["inputs"], cell.config["k"],
                                   cell.config["canonical"], "cpu")
    finally:
        gen.common.release()
    n = tsv_spectrum_min.meryl_min_count(counts)
    assert int((counts == n - 1).sum()) > 0
    command = list(cell.traffic["command"])
    command[command.index("--min-count") + 1] = str(n)
    traffic = {**cell.traffic, "command": command,
               "reference_params": {**cell.traffic["reference_params"],
                                    "min_count": n}}
    return dataclasses.replace(cell, traffic=traffic)


def threshold_one_low():
    from findkmer_torch import output

    def low(fn):
        return lambda spectrum, cfg: fn(
            spectrum, cfg.replace(min_count=cfg.min_count - 1))

    return [_patch(output, "_apply_count_thresholds", low)]


@pytest.mark.parametrize("fault", [None, threshold_one_low],
                         ids=["as_is", "threshold_one_low"])
@pytest.mark.parametrize("cell_name", NEW)
def test_a_threshold_one_off_is_not_correct(cell_name, fault):
    cell = harness.load_cell(cell_name)
    params = _tiny(cell)
    cell = _at_tiny_threshold(cell, params)
    r = harness.run(cell, SEED, 0.3, False, 0.0,
                    harness.Options(device="cpu", params=params,
                                    fault=fault))
    if fault is None:
        assert r["correct"], r["compared"]
    else:
        assert not r["correct"]
        assert r["compared"]["blocks_differing"]["value"] > 0


@pytest.mark.parametrize("seed", [2**31 + 3, 2**32 + 5, 977])
def test_the_k15c_control_is_not_correct(seed):
    """int16 counts: a tiny input of poly-A runs (the interspersed
    families left out to make room) puts a 15-mer past 32767, as the
    full-size input's satellite and Alu 15-mers are."""
    cell = harness.load_cell("k15c.repeats")
    params = {**_tiny(cell), "families": [], "microsat": {
        "share": 0.2, "motifs": ["A"], "run": [20, 120], "div": 0.02}}
    r = control.readings(cell, seed, "cpu", params)
    assert not r["correct"], r
    assert r["compared"]["blocks_differing"] > 0

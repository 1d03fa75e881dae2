"""`findkmer_torch.cli count --device cpu` vs `findkmer_tpu.cli count`.

Both CLIs run in this process on the same fixture and arguments; their
output files must be identical byte for byte.  A multi-batch geometry
(--chunk-len 256 --batch-rows 4) exercises the chunk joints.
"""

import json
import os

import pytest
import torch

from findkmer_tpu import cli as jax_cli
from findkmer_torch import cli as torch_cli
from oracle.scalar import count_fasta_file, spectrum_lines

torch.set_num_threads(1)  # six test workers share the cores
FIXTURES = ["tiny", "multi", "ecoli_frag", "debruijn4"]
VARIANTS = {
    "plain": [],
    "zeros": ["-z"],
    "canonical": ["--canonical"],
    "min_count": ["--min-count", "2"],
}
GEOM = ["--chunk-len", "256", "--batch-rows", "4"]


def _count(main, path, k, extra, out):
    rc = main(["count", "-i", path, "-k", str(k), "-o", str(out)]
              + GEOM + extra)
    assert rc == 0
    return out.read_bytes()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", FIXTURES)
def test_cli_matches_jax_cli(fixtures_dir, tmp_path, name, k, variant):
    path = os.path.join(fixtures_dir, f"{name}.fa")
    extra = VARIANTS[variant]
    want = _count(jax_cli.main, path, k, extra, tmp_path / "jax.tsv")
    got = _count(torch_cli.main, path, k, extra + ["--device", "cpu"],
                 tmp_path / "torch.tsv")
    assert got == want
    # every fixture has k-mers at k=4 and k=8 (debruijn4 holds each 4-mer
    # once, so --min-count 2 empties it)
    assert got or variant == "min_count"


def test_cli_int64_and_max_count_vs_oracle(fixtures_dir, tmp_path, capsys):
    path = os.path.join(fixtures_dir, "multi.fa")
    out = tmp_path / "o.tsv"
    rc = torch_cli.main(["count", "-i", path, "-k", "5", "-o", str(out),
                         "--count-dtype", "int64", "--max-count", "3",
                         "--device", "cpu", "--stats", "json"] + GEOM)
    assert rc == 0
    counts = {m: n for m, n in count_fasta_file(path, 5).items() if n <= 3}
    want = "".join(ln + "\n" for ln in spectrum_lines(counts, 5))
    assert out.read_text() == want
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["device"] == "cpu"
    assert stats["batches"] > 1 and stats["bases"] > 0


def test_cli_stdout_and_multiple_inputs(fixtures_dir, tmp_path, capsysbinary):
    paths = [os.path.join(fixtures_dir, f"{n}.fa") for n in ("tiny", "multi")]
    args = ["count", "-i", *paths, "-k", "4"] + GEOM
    assert jax_cli.main(args) == 0
    want = capsysbinary.readouterr().out
    assert torch_cli.main(args + ["--device", "cpu"]) == 0
    assert capsysbinary.readouterr().out == want


@pytest.mark.parametrize("flag", [
    ["--per-input"], ["--per-record"], ["--spill", "x"], ["--devices", "2"],
    ["--profile", "x"], ["-k", "21", "--spill", "x"],
    ["--table-mode", "sparse", "--devices", "0"],
])
def test_cli_unported_options_exit_2(fixtures_dir, tmp_path, capsys, flag):
    path = os.path.join(fixtures_dir, "tiny.fa")
    out = tmp_path / "o.tsv"
    args = ["count", "-i", path, "-k", "4", "-o", str(out), "--device", "cpu"]
    assert torch_cli.main(args + flag) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and len(err.strip().splitlines()) == 1
    assert not out.exists()

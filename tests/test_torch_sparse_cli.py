"""`findkmer_torch.cli count --device cpu` vs `findkmer_tpu.cli count` on
the sparse path (k >= 11): the streamed finalize, the reused sparse
autosize and output helpers.

Both CLIs run in this process on the same fixture and arguments; their
output files must be identical byte for byte.  A multi-batch geometry
(--chunk-len 256 --batch-rows 4) exercises the chunk joints, and a small
--sparse-compact-entries the count-carrying compaction.
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
RUNS = {
    "k15": ["-k", "15"],
    "k21_canonical": ["-k", "21", "--canonical"],
    "k31": ["-k", "31"],
}
GEOM = ["--chunk-len", "256", "--batch-rows", "4",
        "--sparse-compact-entries", "4096"]


def _count(main, path, extra, out):
    rc = main(["count", "-i", path, "-o", str(out)] + GEOM + extra)
    assert rc == 0
    return out.read_bytes()


@pytest.mark.parametrize("min_count", [[], ["--min-count", "2"]],
                         ids=["all", "min_count"])
@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name", FIXTURES)
def test_sparse_cli_matches_jax_cli(fixtures_dir, tmp_path, name, run,
                                    min_count):
    path = os.path.join(fixtures_dir, f"{name}.fa")
    extra = RUNS[run] + min_count
    want = _count(jax_cli.main, path, extra, tmp_path / "jax.tsv")
    got = _count(torch_cli.main, path, extra + ["--device", "cpu"],
                 tmp_path / "torch.tsv")
    assert got == want
    assert got or min_count or name == "tiny"


def test_sparse_cli_vs_oracle_and_stats(fixtures_dir, tmp_path, capsys):
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    out = tmp_path / "o.tsv"
    rc = torch_cli.main(["count", "-i", path, "-k", "21", "--canonical",
                         "-o", str(out), "--device", "cpu", "--stats",
                         "json"] + GEOM)
    assert rc == 0
    counts = count_fasta_file(path, 21, canonical=True)
    want = "".join(ln + "\n" for ln in spectrum_lines(counts, 21))
    assert out.read_text() == want
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["device"] == "cpu"
    assert stats["host_encoder"] in ("native", "numpy")
    phases = stats["phases"]
    for name in ("host_batches", "dispatch", "finalize", "write",
                 "finalize/compact", "finalize/global_sort",
                 "finalize/d2h"):
        assert name in phases, name


def test_sparse_zeros_error_matches_jax(fixtures_dir, tmp_path, capsys):
    path = os.path.join(fixtures_dir, "tiny.fa")
    args = ["count", "-i", path, "-k", "21", "-z", "-o",
            str(tmp_path / "o.tsv")]
    assert jax_cli.main(args) == 2
    jerr = capsys.readouterr().err
    assert torch_cli.main(args + ["--device", "cpu"]) == 2
    terr = capsys.readouterr().err
    assert "-z/--zeros requires a direct" in terr
    assert terr.split("error: ", 1)[1] == jerr.split("error: ", 1)[1]
    assert not (tmp_path / "o.tsv").exists()


def test_legacy_finalize_is_refused(fixtures_dir, tmp_path, capsys,
                                    monkeypatch):
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    path = os.path.join(fixtures_dir, "tiny.fa")
    out = tmp_path / "o.tsv"
    rc = torch_cli.main(["count", "-i", path, "-k", "21", "-o", str(out),
                         "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and len(err.strip().splitlines()) == 1
    assert not out.exists()

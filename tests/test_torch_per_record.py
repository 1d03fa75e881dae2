"""`count --per-input` and `count --per-record` of the port vs the JAX CLI.

Both CLIs run in this process on the same inputs and arguments; their
outputs must be identical byte for byte: tests/data fixtures (multi.fa
has N runs, IUPAC codes and empty records) and a seeded FASTQ, at dense
k=4 and 8 and sparse k=11 and 21 --canonical, at a multi-batch geometry.
Error cases exit 2 with the JAX package's message.
"""

import os

import numpy as np
import pytest
import torch

from conftest import random_dna
from findkmer_tpu import cli as jax_cli
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline
from findkmer_torch.ops.cuda import _build

torch.set_num_threads(1)  # six test workers share the cores
GEOM = ["--chunk-len", "256", "--batch-rows", "4",
        "--sparse-compact-entries", "4096"]
RUNS = {
    "k4": ["-k", "4"],
    "k8": ["-k", "8"],
    "k11": ["-k", "11"],
    "k21_canonical": ["-k", "21", "--canonical"],
}
INPUTS = ["tiny", "multi", "ecoli_frag", "reads_fq"]


@pytest.fixture(scope="module")
def inputs(fixtures_dir, tmp_path_factory):
    """name -> path: the fixtures and a seeded FASTQ of 40 reads of 30 to
    300 bases with N calls and lowercase."""
    rng = np.random.default_rng(11)
    fq = tmp_path_factory.mktemp("fq") / "reads.fastq"
    with open(fq, "w") as f:
        for i in range(40):
            seq = random_dna(rng, int(rng.integers(30, 300)), n_prob=0.02,
                             lower_prob=0.05)
            f.write(f"@read{i} sample\n{seq}\n+\n{'I' * len(seq)}\n")
    paths = {n: os.path.join(fixtures_dir, f"{n}.fa") for n in INPUTS[:3]}
    paths["reads_fq"] = str(fq)
    return paths


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name", INPUTS)
def test_per_record_matches_jax_cli(inputs, tmp_path, name, run):
    args = ["count", "-i", inputs[name], "--per-record"] + GEOM + RUNS[run]
    jout, tout = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_cli.main(args + ["-o", str(jout)]) == 0
    assert torch_cli.main(args + ["-o", str(tout), "--device", "cpu"]) == 0
    got = tout.read_bytes()
    assert got == jout.read_bytes()
    assert got.count(b">") >= (40 if name == "reads_fq" else 1)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name", INPUTS)
def test_per_input_matches_jax_cli(inputs, tmp_path, name, run):
    """Each input given twice, beside tiny.fa: the repeated stem is named
    <stem>.2.tsv; every file is the JAX CLI's."""
    paths = [inputs[name], inputs["tiny"], inputs[name]]
    args = ["count", "-i", *paths, "--per-input"] + GEOM + RUNS[run]
    assert jax_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert torch_cli.main(args + ["-o", str(tmp_path / "torch"),
                                  "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    stem = os.path.splitext(os.path.basename(inputs[name]))[0]
    want_names = {f"{stem}.tsv", f"{stem}.2.tsv", "tiny.tsv"}
    if name == "tiny":
        want_names = {"tiny.tsv", "tiny.2.tsv", "tiny.3.tsv"}
    assert set(names) == want_names
    assert sorted(os.listdir(tmp_path / "torch")) == names
    for n in names:
        got = (tmp_path / "torch" / n).read_bytes()
        assert got == (tmp_path / "jax" / n).read_bytes(), n
    # the same input twice: the same spectrum under both names
    assert (tmp_path / "torch" / f"{stem}.tsv").read_bytes() == \
        (tmp_path / "torch" / f"{stem}.2.tsv").read_bytes()


def test_per_input_files_equal_single_counts(inputs, tmp_path):
    paths = [inputs["multi"], inputs["ecoli_frag"], inputs["reads_fq"]]
    args = GEOM + ["-k", "8", "--device", "cpu"]
    assert torch_cli.main(["count", "-i", *paths, "--per-input", "-o",
                           str(tmp_path / "d")] + args) == 0
    for p in paths:
        one = tmp_path / "one.tsv"
        assert torch_cli.main(["count", "-i", p, "-o", str(one)] + args) == 0
        stem = os.path.splitext(os.path.basename(p))[0]
        assert (tmp_path / "d" / f"{stem}.tsv").read_bytes() == \
            one.read_bytes()


@pytest.mark.parametrize("case", ["o_file", "o_stdout", "both", "spill"])
def test_error_cases_exit_2_with_jax_message(inputs, tmp_path, capsys, case):
    path = inputs["tiny"]
    args = ["count", "-i", path, "-k", "4"]
    if case == "o_file":
        (tmp_path / "f").write_text("x")
        args += ["--per-input", "-o", str(tmp_path / "f")]
    elif case == "o_stdout":
        args += ["--per-input"]
    elif case == "both":
        args += ["--per-input", "--per-record", "-o", str(tmp_path / "d")]
    else:
        args += ["-k", "21", "--per-record", "--spill", str(tmp_path / "s")]
    assert jax_cli.main(args) == 2
    jerr = capsys.readouterr().err
    assert torch_cli.main(args + ["--device", "cpu"]) == 2
    terr = capsys.readouterr().err
    assert len(terr.strip().splitlines()) == 1
    assert terr.split("error: ", 1)[1] == jerr.split("error: ", 1)[1]
    assert not (tmp_path / "d").exists()


def test_per_record_starts_no_producer_thread(inputs, monkeypatch):
    """Every record of an input is batched in the caller's thread; the
    CPU path builds no kernel."""
    import threading

    def refuse(*a, **kw):
        raise AssertionError("the CPU path called the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = threading.active_count()
    seen = []
    orig = pipeline.prefetch_to_device

    def spy(batches, depth, device, **kw):
        seen.append(kw.get("threaded", True))
        assert threading.active_count() == before
        return orig(batches, depth, device, **kw)

    monkeypatch.setattr(pipeline, "prefetch_to_device", spy)
    from findkmer_torch import Config

    cfg = Config(k=8, chunk_len=256, batch_rows=4)
    out = list(pipeline.per_record_spectra(inputs["reads_fq"], cfg,
                                           torch.device("cpu")))
    assert len(out) == 40 and seen == [False] * 40
    assert all(s.shape == (4 ** 8,) for _, s in out)


def test_per_record_sizes_the_raw_buffer_per_record(inputs, monkeypatch):
    """The sparse counter of --per-record starts from one row of windows,
    not from the input's size, and grows for a longer record."""
    from findkmer_torch import Config
    from findkmer_torch.models import counter as counter_mod

    made = []
    orig = counter_mod.make_counter

    def spy(cfg, *a, **kw):
        made.append(cfg)
        return orig(cfg, *a, **kw)

    monkeypatch.setattr(counter_mod, "make_counter", spy)
    cfg = Config(k=21, chunk_len=256, batch_rows=4,
                 sparse_expected_entries=1 << 30)
    spectra = list(pipeline.per_record_spectra(inputs["ecoli_frag"], cfg,
                                               torch.device("cpu")))
    assert len(made) == 1 and made[0].sparse_expected_entries == 256
    codes, counts = spectra[0][1]
    assert int(counts.sum()) > 40000  # one 50 kb record, many batches

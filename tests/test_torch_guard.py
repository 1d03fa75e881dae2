"""Guards of the PyTorch port: no jax, no silent CPU fallback, no build
on the CPU path, a clear error without nvcc."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from findkmer_tpu.config import Config
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline
from findkmer_torch.device import resolve_device
from findkmer_torch.ops.cuda import _build
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "findkmer_torch"


def _cli_without_jax(path, out, extra, tmp_path):
    """Run the port's CLI in a fresh interpreter; fail if jax loaded."""
    code = (
        "import sys\n"
        "from findkmer_torch.cli import main\n"
        f"rc = main(['count', '-i', {path!r}, '--device', 'cpu',"
        f" '-o', {str(out)!r}] + {extra!r})\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'jaxlib' not in sys.modules, 'jaxlib was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr


def test_cli_count_never_imports_jax(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "multi.fa")
    out = tmp_path / "o.tsv"
    _cli_without_jax(path, out, ["-k", "4"], tmp_path)
    want = spectrum_lines(count_fasta_file(path, 4), 4)
    assert out.read_text().splitlines() == want


def test_cli_sparse_count_never_imports_jax(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    out = tmp_path / "o.tsv"
    _cli_without_jax(path, out, ["-k", "21", "--canonical",
                                 "--sparse-compact-entries", "20000"],
                     tmp_path)
    counts = count_fasta_file(path, 21, canonical=True)
    assert out.read_text().splitlines() == spectrum_lines(counts, 21)


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax\b)", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pat.search(p.read_text())]
    # the smoke script drives the port alone: nothing of the JAX package,
    # not even its jax-free modules, which the port reuses on its behalf
    tpu = re.compile(r"^\s*(import|from)\s+(jax|findkmer_tpu)\b", re.M)
    if tpu.search((REPO / "chip_smoke.py").read_text()):
        offenders.append("chip_smoke.py")
    assert offenders == []


def test_device_cuda_without_cuda_exits_2(fixtures_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = tmp_path / "o.tsv"
    path = os.path.join(fixtures_dir, "tiny.fa")
    rc = torch_cli.main(["count", "-i", path, "-k", "4", "-o", str(out)])
    assert rc == 2  # --device defaults to cuda
    err = capsys.readouterr().err
    assert "torch.cuda.is_available() is False" in err
    assert not out.exists()  # nothing was counted on the CPU instead


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")


def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
    if _build_env_has_no_nvcc():
        monkeypatch.delenv("CUDA_HOME")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()


def _build_env_has_no_nvcc() -> bool:
    try:
        _build.nvcc_path()
    except RuntimeError:
        return True
    return False


def test_library_name_tracks_sources_and_flags(monkeypatch):
    base = _build.library_path()
    assert base.parent == _build.BUILD_DIR
    assert base.name.startswith("libfindkmer_torch_")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != base


@pytest.mark.parametrize("hist", ["auto", "pallas"])
def test_cpu_slice_never_builds(fixtures_dir, monkeypatch, hist):
    def refuse():
        raise AssertionError("the CPU path called the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    path = os.path.join(fixtures_dir, "multi.fa")
    cfg = Config(k=6, hist=hist, chunk_len=256, batch_rows=4)
    got = pipeline.count_file(path, cfg, torch.device("cpu"))
    want = np.zeros(4 ** 6, np.int32)
    for kmer, n in count_fasta_file(path, 6).items():
        want[int(kmer.translate(str.maketrans("ACGT", "0123")), 4)] = n
    np.testing.assert_array_equal(got, want)


def test_cpu_sparse_slice_never_builds(fixtures_dir, monkeypatch):
    def refuse():
        raise AssertionError("the CPU path called the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    path = os.path.join(fixtures_dir, "multi.fa")
    cfg = Config(k=21, chunk_len=256, batch_rows=4,
                 sparse_compact_entries=1024)
    for row_sort in ("auto", "kernel", "plain"):
        codes, counts = pipeline.count_file(path, cfg, torch.device("cpu"),
                                            row_sort=row_sort)
        assert int(counts.sum()) == sum(count_fasta_file(path, 21).values())


def test_native_encoder_build_retries_with_cc(tmp_path, monkeypatch):
    """A $CC that cannot build the C host library (as a compiler without
    OpenMP cannot) gets one retry with CC=cc; $CC is left as it was."""
    if shutil.which("cc") is None:
        pytest.skip("no cc on this machine")
    from findkmer_tpu.io import native

    lib = tmp_path / "libfindkmer_encode.so"
    monkeypatch.setattr(native, "_lib_path", lambda: lib)
    monkeypatch.setenv("CC", "false")  # a compiler that always fails
    assert pipeline.build_native_encoder()
    assert lib.exists()
    assert os.environ["CC"] == "false"
    lib.unlink()
    monkeypatch.delenv("CC")
    monkeypatch.setattr(native, "build", lambda quiet=True: False)
    assert not pipeline.build_native_encoder()  # no compiler works
    assert "CC" not in os.environ


def test_host_encoder_warns_once_without_a_compiler(fixtures_dir, tmp_path,
                                                    monkeypatch, capsys):
    """Where no compiler works the CLI still counts (numpy host path) and
    says so in one warning line; --stats json names the encoder."""
    monkeypatch.setattr(pipeline, "host_encoder", lambda use_native=True:
                        "numpy")
    path = os.path.join(fixtures_dir, "tiny.fa")
    out = tmp_path / "o.tsv"
    rc = torch_cli.main(["count", "-i", path, "-k", "4", "-o", str(out),
                         "--device", "cpu", "--stats", "json"])
    assert rc == 0
    err = capsys.readouterr().err.strip().splitlines()
    warnings = [ln for ln in err if "warning" in ln]
    assert len(warnings) == 1 and "numpy fallback" in warnings[0]
    assert json.loads(err[-1])["host_encoder"] == "numpy"
    assert out.read_text().splitlines() == spectrum_lines(
        count_fasta_file(path, 4), 4)

"""Guards of the PyTorch port: no jax, no silent CPU fallback, no build
on the CPU path, a clear error without nvcc."""

import os
import pathlib
import re
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


def test_cli_count_never_imports_jax(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "multi.fa")
    out = tmp_path / "o.tsv"
    code = (
        "import sys\n"
        "from findkmer_torch.cli import main\n"
        f"rc = main(['count', '-i', {path!r}, '-k', '4', '--device', 'cpu',"
        f" '-o', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'jaxlib' not in sys.modules, 'jaxlib was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    want = spectrum_lines(count_fasta_file(path, 4), 4)
    assert out.read_text().splitlines() == want


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

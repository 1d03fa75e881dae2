"""Guards of the PyTorch port: no jax and nothing of the JAX package, no
silent CPU fallback, no build on the CPU path, a clear error without
nvcc, the C host encoder built into the port's own directory."""

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

from findkmer_torch import Config
from findkmer_torch import cli as torch_cli
from findkmer_torch import pipeline
from findkmer_torch.device import resolve_device
from findkmer_torch.ops.cuda import _build
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "findkmer_torch"


def _without_jax(code, tmp_path):
    """Run `code` in a fresh interpreter; fail if it fails, or if jax, any
    module of the JAX package or the repository's root `bench` package
    (which imports both) was loaded.  -> its stdout."""
    code += (
        "\nimport sys\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'jaxlib' not in sys.modules, 'jaxlib was imported'\n"
        "tpu = [m for m in sys.modules if m.split('.')[0] in"
        " ('findkmer_tpu', 'bench')]\n"
        "assert not tpu, f'the JAX package was imported: {tpu}'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _cli_without_jax(path, out, extra, tmp_path):
    """Run the port's CLI in a fresh interpreter; fail if jax or the JAX
    package loaded."""
    _without_jax(
        "from findkmer_torch.cli import main\n"
        f"rc = main(['count', '-i', {path!r}, '--device', 'cpu',"
        f" '-o', {str(out)!r}] + {extra!r})\n"
        "assert rc == 0, rc\n",
        tmp_path,
    )


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


def test_cli_per_record_never_imports_jax(fixtures_dir, tmp_path):
    from oracle.scalar import count_kmers_in_text, parse_fasta_text

    path = os.path.join(fixtures_dir, "multi.fa")
    out = tmp_path / "o.txt"
    _cli_without_jax(path, out, ["-k", "4", "--per-record"], tmp_path)
    want = []
    for header, seq in parse_fasta_text(open(path).read()):
        want.append(f">{header}")
        want.extend(spectrum_lines(count_kmers_in_text(seq, 4), 4))
    assert out.read_text().splitlines() == want


@pytest.mark.parametrize("extra", [
    ["-k", "8"],
    ["-k", "21", "--canonical", "--spill", "sp", "--sparse-capacity", "4096",
     "--sparse-compact-entries", "8192", "--chunk-len", "1024",
     "--batch-rows", "4"],
], ids=["dense", "sparse-spill"])
def test_cli_stream_never_imports_jax(fixtures_dir, tmp_path, extra):
    """`stream` with checkpoints, run and then resumed, in a fresh
    interpreter each; and once with the spill and its C merge (a finished
    spilled stream has consumed its runs and cannot resume)."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    out = tmp_path / "o.tsv"
    for _ in range(1 if "--spill" in extra else 2):
        _without_jax(
            "from findkmer_torch.cli import main\n"
            f"rc = main(['stream', '-i', {path!r}, '--device', 'cpu', '-o',"
            f" {str(out)!r}, '--checkpoint', 'ck', '--checkpoint-every', '3']"
            f" + {extra!r})\n"
            "assert rc == 0, rc\n"
            "import findkmer_torch.streaming, findkmer_torch.spill\n"
            "import findkmer_torch.utils.checkpoint\n"
            "import findkmer_torch.utils.logging\n"
            "import findkmer_torch.parallel.multihost\n",
            tmp_path,
        )
    k = int(extra[1])
    counts = count_fasta_file(path, k, canonical="--canonical" in extra)
    assert out.read_text().splitlines() == spectrum_lines(counts, k)
    assert (tmp_path / "ck" / "latest.json").exists()


def test_heap_merge_finalize_never_imports_jax(fixtures_dir, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("FINDKMER_ORDERED_FINALIZE", "0")
    path = os.path.join(fixtures_dir, "multi.fa")
    out = tmp_path / "o.tsv"
    _cli_without_jax(path, out, ["-k", "17"], tmp_path)
    assert out.read_text().splitlines() == spectrum_lines(
        count_fasta_file(path, 17), 17)


def test_selftest_never_imports_jax(tmp_path):
    out = _without_jax(
        "from findkmer_torch.cli import main\n"
        "assert main(['selftest', '--device', 'cpu']) == 0\n",
        tmp_path,
    )
    assert "selftest OK (3/3 cases bit-exact)" in out


def test_bench_never_imports_jax(tmp_path):
    """`bench` (the dense and the sparse staged step) and `bench
    --phases`, in a fresh interpreter: one JSON line each."""
    out = _without_jax(
        "from findkmer_torch.cli import main\n"
        "for argv in (['-k', '8'], ['-k', '21', '--canonical'],"
        " ['--phases', '-k', '21']):\n"
        "    assert main(['bench', '--device', 'cpu', '--gbases', '0.0001']"
        " + argv) == 0, argv\n"
        "import findkmer_torch.bench.steps, findkmer_torch.bench.quick\n",
        tmp_path,
    )
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert [d["k"] for d in lines] == [8, 21, 21]
    assert all(d["bases_per_s"] > 0 for d in lines)
    assert sorted(lines[2]["phases"]) == ["dispatch", "finalize",
                                          "host_batches", "write"]


def test_bench_driver_and_entry_never_import_jax(tmp_path):
    """The benchmark driver (its five calls cut to a small geometry),
    `entry()` and `dryrun_multichip` on the CPU, in a fresh interpreter:
    the driver's one stdout line, the step's table, every mesh leg."""
    out = _without_jax(
        "from findkmer_torch.bench import driver, steps\n"
        "from findkmer_torch.graft_entry import dryrun_multichip, entry\n"
        "def small(fn):\n"
        "    return lambda dev, **kw: fn(dev, **{**kw, 'chunk_len': 1024,"
        " 'steps': 1, 'batch_rows': kw.get('batch_rows', 1024) // 128})\n"
        "driver.bench_dense_step = small(steps.bench_dense_step)\n"
        "driver.bench_sparse_step = small(steps.bench_sparse_step)\n"
        "assert driver.main(['--device', 'cpu']) == 0\n"
        "fn, args = entry(device='cpu')\n"
        "assert int(fn(*args).sum()) == 0\n"
        "legs = dryrun_multichip(2, device='cpu')\n"
        "assert all(r['equal'] for r in legs.values()), legs\n",
        tmp_path,
    )
    (line,) = [json.loads(ln) for ln in out.splitlines()]
    assert line["metric"] == "bases_per_s_per_chip_k8" and line["value"] > 0


def test_bench_driver_and_entry_without_cuda_refuse(tmp_path, capsys):
    """Without a card and without device="cpu": the driver exits 2 with
    nothing on stdout (in this process and as `python -m`), `entry()` and
    `dryrun_multichip` raise; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from findkmer_torch.bench import driver
    from findkmer_torch.graft_entry import dryrun_multichip, entry

    assert driver.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "torch.cuda.is_available() is False" in err
    res = subprocess.run([sys.executable, "-m", "findkmer_torch.bench.driver"],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
    for call in (entry, lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_api_never_imports_jax(fixtures_dir, tmp_path):
    path = os.path.join(fixtures_dir, "tiny.fa")
    want = count_fasta_file(path, 4)
    out = _without_jax(
        "import findkmer_torch as fkt\n"
        f"spec = fkt.count({path!r}, 4, device='cpu')\n"
        "print(spec['ACGT'], len(list(spec.items())), spec.total())\n"
        f"for h, s in fkt.count_per_record({path!r}, 21, device='cpu'):\n"
        "    s['A' * 21], list(s.items())\n"
        "t = fkt.count_text('>r\\nACGTACGT\\n', 4, device='cpu')\n"
        "assert t['ACGT'] == 2 and dict(t.items())['CGTA'] == 1\n",
        tmp_path,
    )
    assert out.split() == [str(want.get("ACGT", 0)), str(len(want)),
                           str(sum(want.values()))]


def _filter_inputs(fixtures_dir, tmp_path):
    """A FASTQ of the records of multi.fa and a k=5 spectrum of tiny.fa."""
    from oracle.scalar import parse_fasta_text

    recs = parse_fasta_text(open(os.path.join(fixtures_dir,
                                              "multi.fa")).read())
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{h}\n{s}\n+\n{'I' * len(s)}\n"
                          for h, s in recs))
    spec = tmp_path / "spec.tsv"
    spec.write_text("\n".join(spectrum_lines(count_fasta_file(
        os.path.join(fixtures_dir, "tiny.fa"), 5), 5)) + "\n")
    return str(fq), str(spec)


def test_filter_never_imports_jax(fixtures_dir, tmp_path):
    """`filter` by both engines, single-end and paired, and the API's
    `filter_reads`, in a fresh interpreter: the same bytes each time."""
    fq, spec = _filter_inputs(fixtures_dir, tmp_path)
    out = _without_jax(
        "import findkmer_torch as fkt\n"
        "from findkmer_torch.cli import main\n"
        "for e in ('host', 'device'):\n"
        f"    rc = main(['filter', '-i', {fq!r}, '--spectrum', {spec!r},"
        " '-o', e + '.fq', '--engine', e, '--device', 'cpu'])\n"
        "    assert rc == 0, rc\n"
        f"    rc = main(['filter', '-i', {fq!r}, {fq!r}, '--paired',"
        f" '--spectrum', {spec!r}, '-o', e + '1.fq,' + e + '2.fq',"
        " '--engine', e, '--device', 'cpu'])\n"
        "    assert rc == 0, rc\n"
        f"print(*fkt.filter_reads({fq!r}, {spec!r}, 'api.fq',"
        " engine='device', device='cpu'))\n"
        "import findkmer_torch.filter, findkmer_torch.filter_device\n"
        "import findkmer_torch.spectra\n",
        tmp_path,
    )
    kept, seen = map(int, out.split())
    assert 0 < kept < seen
    want = (tmp_path / "host.fq").read_bytes()
    for name in ("device.fq", "api.fq", "host1.fq", "device1.fq",
                 "device2.fq"):
        assert (tmp_path / name).read_bytes() == want


TOOLS = {
    "matrix_k21": ["matrix", "-i", "{e}", "{m}", "-k", "21", "--canonical",
                   "--min-samples", "2", "-o", "x.tsv"],
    "sketch_k8": ["sketch", "-i", "{e}", "{m}", "-k", "8", "--per-input",
                  "-o", "sk"],
    "histo_k21": ["histo", "-i", "{e}", "-k", "21", "--canonical", "-o",
                  "h.tsv"],
    "host_tools": None,
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_spectrum_tools_never_import_jax(fixtures_dir, tmp_path, name):
    """The counting spectrum tools on --device cpu, and a chain of host
    tools (merge, canonize, expr, matrix, sketch, similarity, info,
    diff), each in a fresh interpreter with neither jax nor the JAX
    package loaded."""
    e = os.path.join(fixtures_dir, "ecoli_frag.fa")
    m = os.path.join(fixtures_dir, "multi.fa")
    if TOOLS[name] is not None:
        argv = [a.format(e=e, m=m) for a in TOOLS[name]]
        _without_jax(
            "from findkmer_torch.cli import main\n"
            f"assert main({argv!r} + ['--device', 'cpu']) == 0\n"
            "import findkmer_torch.spectra, findkmer_torch.sketch\n",
            tmp_path)
        assert any(p.is_file() and p.stat().st_size
                   for p in tmp_path.rglob("*"))
        return
    for path, k in ((e, 21), (m, 21)):
        name_ = os.path.basename(path) + ".tsv"
        (tmp_path / name_).write_text("\n".join(spectrum_lines(
            count_fasta_file(path, k), k)) + "\n")
    out = _without_jax(
        "from findkmer_torch.cli import main\n"
        "import findkmer_torch as fkt\n"
        "runs = [['merge', '-i', 'ecoli_frag.fa.tsv', 'multi.fa.tsv',"
        " '-o', 'm.tsv'], ['canonize', 'm.tsv', '-o', 'c.tsv'],"
        " ['expr', 'A ~ B', '-i', 'A=m.tsv', 'B=multi.fa.tsv', '-o',"
        " 'e.tsv'], ['sketch', '-i', 'c.tsv', '-o', 'c.json'],"
        " ['similarity', '-i', 'c.json', 'm.tsv'], ['info', 'c.tsv'],"
        " ['diff', '-i', 'e.tsv', 'ecoli_frag.fa.tsv']]\n"
        "for argv in runs:\n"
        "    assert main(argv) == 0, argv\n"
        "print(fkt.matrix(['m.tsv', 'e.tsv'], 'x.tsv'))\n"
        "print(len(fkt.expr('A * B', {'A': 'm.tsv', 'B': 'c.tsv'})))\n"
        "print(fkt.similarity('m.tsv', 'c.json')['k'])\n",
        tmp_path)
    lines = out.strip().splitlines()
    assert lines[-1] == "21" and int(lines[-3]) > 0


def test_filter_engine_device_without_cuda_exits_2(fixtures_dir, tmp_path,
                                                   capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    fq, spec = _filter_inputs(fixtures_dir, tmp_path)
    out = tmp_path / "o.fq"
    rc = torch_cli.main(["filter", "-i", fq, "--spectrum", spec, "-o",
                         str(out), "--engine", "device"])
    assert rc == 2  # --device defaults to cuda
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()  # no output opened, nothing scored on the CPU
    import findkmer_torch as fkt

    with pytest.raises(RuntimeError, match="is_available"):
        fkt.filter_reads(fq, spec, str(out), engine="device")
    assert not out.exists()
    # the default engine follows --device: on its default (cuda) it is the
    # device engine, so without a card it exits 2 before any output, and
    # the API raises; on --device cpu it is the host scan
    rc = torch_cli.main(["filter", "-i", fq, "--spectrum", spec, "-o",
                         str(out)])
    assert rc == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()
    with pytest.raises(RuntimeError, match="is_available"):
        fkt.filter_reads(fq, spec, str(out))
    assert not out.exists()
    assert torch_cli.main(["filter", "-i", fq, "--spectrum", spec, "-o",
                           str(out), "--device", "cpu"]) == 0
    assert out.stat().st_size


def test_port_sources_do_not_import_jax():
    # neither jax nor anything of the JAX package, at module level or
    # inside a function, not even its jax-free modules, nor the root
    # `bench` package: the port keeps its own copies, and the smoke
    # script drives the port alone
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|findkmer_tpu|bench)\b",
                     re.M)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    for new in ("streaming.py", "spill.py", "utils/checkpoint.py",
                "utils/logging.py", "parallel/multihost.py", "filter.py",
                "filter_device.py", "spectra.py", "sketch.py",
                "bench/steps.py", "bench/quick.py", "bench/driver.py",
                "graft_entry.py"):
        assert PORT / new in sources
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pat.search(p.read_text())]
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
    # the subcommands that count before their host work: the same, and
    # no output file or directory is made
    for argv in (["matrix", "-i", path, path, "-k", "21", "--canonical"],
                 ["sketch", "-i", path, "-k", "8"],
                 ["sketch", "-i", path, "-k", "8", "--per-input"],
                 ["histo", "-i", path, "-k", "21"],
                 ["histo", "-i", path, "-k", "4", "--nonzero-only"]):
        rc = torch_cli.main(argv + ["-o", str(out)])
        assert rc == 2, argv
        assert "torch.cuda.is_available() is False" in \
            capsys.readouterr().err, argv
        assert not out.exists(), argv


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
    OpenMP cannot) gets one retry with cc; $CC is left as it was.  The
    library lands in the port's own build directory (in a checkout,
    build/torch_native/), and the source's directory gains no file."""
    if shutil.which("cc") is None:
        pytest.skip("no cc on this machine")
    from findkmer_torch.io import native

    assert native.BUILD_DIR == REPO / "build" / "torch_native"
    assert native.SOURCE == PORT / "_native" / "encode.c"
    src_before = sorted(p.name for p in native.SOURCE.parent.iterdir())
    build_dir = tmp_path / "torch_native"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    lib = native.lib_path()
    assert lib.parent == build_dir
    assert lib.name.startswith("libfindkmer_encode_")
    monkeypatch.setenv("CC", "false")  # a compiler that always fails
    assert native.build()
    assert [p.name for p in build_dir.iterdir()] == [lib.name]
    assert os.environ["CC"] == "false"
    assert sorted(p.name for p in native.SOURCE.parent.iterdir()) == src_before
    lib.unlink()
    monkeypatch.delenv("CC")
    monkeypatch.setattr(native, "_compile", lambda cc, out, quiet: False)
    assert not native.build()  # no compiler works
    assert "CC" not in os.environ and not lib.exists()


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

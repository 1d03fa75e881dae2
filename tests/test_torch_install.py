"""The port as a user installs it: a wheel built from the tree, installed
into a target directory, run from there.

A copy of the tree builds the wheel (`pip wheel` writes `build/` and
`*.egg-info` into the directory it builds), `pip install --target`
installs it, and every check runs a `python -P` child from a directory
outside the checkout with `PYTHONPATH` set to the target alone, so the
child imports the installed copy.  The wheel holds the port's CUDA sources
and its copy of the C encoder (`MANIFEST.in`); installed, the port builds
them into `FINDKMER_TORCH_CACHE`, never into the package, and counts the
installed reference's bytes.  No network: `--no-index --no-deps
--no-build-isolation`.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest
import torch

from findkmer_torch import _native
from findkmer_torch.io import native
from findkmer_torch.ops.cuda import _build

REPO = Path(__file__).resolve().parents[1]
# top-level entries of the tree the wheel is not built from
NOT_COPIED = {".git", "build"}
NEVER_COPIED = {"__pycache__", ".pytest_cache", ".hypothesis"}
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-input"]
GEOM = ["--chunk-len", "1024", "--batch-rows", "4",
        "--sparse-compact-entries", "8192"]
RUNS = {"k4": ["-k", "4"], "k8": ["-k", "8"],
        "k21_canonical": ["-k", "21", "--canonical"]}
FIXTURES = ("multi", "ecoli_frag")


def _ignore(root: str, names: list) -> list:
    top = Path(root) == REPO
    return [n for n in names if n in NEVER_COPIED or n.endswith(".egg-info")
            or (top and n in NOT_COPIED)]


def _pip(args: list, cwd: Path) -> None:
    """pip with $CC, then, if that fails and $CC is another compiler, once
    more with cc (the rule of the port's own C build: a $CC without
    OpenMP cannot link the JAX package's encoder)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(PIP + args, cwd=cwd, env=env, capture_output=True,
                         text=True)
    if res.returncode and env.get("CC", "cc") != "cc":
        shutil.rmtree(cwd / "build", ignore_errors=True)
        res = subprocess.run(PIP + args, cwd=cwd, env={**env, "CC": "cc"},
                             capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """-> (wheel, target): the tree's wheel and where it is installed."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    shutil.copytree(REPO, src, ignore=_ignore, symlinks=True)
    _pip(["wheel", "--no-build-isolation", "--no-deps", "--no-index",
          "--no-cache-dir", "-q", "-w", str(tmp / "wheel"), str(src)], src)
    (wheel,) = (tmp / "wheel").glob("*.whl")
    target = tmp / "target"
    _pip(["install", "--no-deps", "--no-index", "--no-cache-dir", "-q",
          "--target", str(target), str(wheel)], tmp)
    return wheel, target


def _child(code: str, path: Path, cwd: Path, **env) -> dict:
    """Run `code` in `python -P` from `cwd` with PYTHONPATH=path alone and
    `env` over this process's environment (None removes a variable);
    -> the JSON object of its last stdout line."""
    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", _native.ENV, "XDG_CACHE_HOME")}
    full.update(PYTHONPATH=str(path), JAX_PLATFORMS="cpu")
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    res = subprocess.run([sys.executable, "-P", "-c", code], cwd=cwd,
                         env=full, capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


_WHERE = """
import json, sys
import findkmer_torch
from findkmer_torch import _native
from findkmer_torch.io import native
from findkmer_torch.ops.cuda import _build
print(json.dumps({
    "file": findkmer_torch.__file__, "in_checkout": _native.in_checkout(),
    "csrc": str(_build.CSRC),
    "sources": [p.name for p in _build.sources()],
    "library": str(_build.library_path()),
    "encode_c": str(native.SOURCE), "native_lib": str(native.lib_path()),
    "cache": {kind: str(_native.cache_dir(kind))
              for kind in ("kernels", "native")},
    "jax_package": "findkmer_tpu" in sys.modules}))
"""


def _under(path: str, root: Path) -> bool:
    return Path(path).resolve().is_relative_to(root.resolve())


def test_wheel_ships_the_sources(installed):
    """Every CUDA source of the port, byte-equal to the checkout's, and its
    copy of the C encoder."""
    wheel, target = installed
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        csrc = sorted(n for n in names
                      if n.startswith("findkmer_torch/csrc/"))
        want = sorted(f"findkmer_torch/csrc/{p.name}"
                      for p in _build.sources())
        assert csrc == want and len(want) == 5
        for n in want + ["findkmer_torch/_native/encode.c"]:
            assert z.read(n) == (REPO / n).read_bytes(), n
        assert "findkmer_torch/_native/__init__.py" in names
    assert (target / "findkmer_torch" / "_native" / "encode.c").read_bytes() \
        == (REPO / "src" / "native" / "encode.c").read_bytes()


def test_installed_tree_builds_from_its_own_sources(installed, tmp_path):
    """The child imports the installed copy; its kernel and encoder
    libraries lie in FINDKMER_TORCH_CACHE under the checkout's names (the
    same bytes hash alike), and nothing of the JAX package is imported."""
    _, target = installed
    cache = tmp_path / "cache"
    got = _child(_WHERE, target, tmp_path, FINDKMER_TORCH_CACHE=str(cache))
    assert _under(got["file"], target) and not got["in_checkout"]
    assert _under(got["csrc"], target) and _under(got["encode_c"], target)
    assert got["sources"] == [p.name for p in _build.sources()]
    assert got["cache"] == {kind: str(cache / kind)
                            for kind in ("kernels", "native")}
    assert Path(got["library"]) == cache / "kernels" / \
        _build.library_path().name
    assert Path(got["native_lib"]) == cache / "native" / \
        native.lib_path().name
    assert not got["jax_package"]
    assert not cache.exists()  # nothing is built at import


_COUNTS = """
import contextlib, io, json, sys
pkg, inputs, runs, geom, out = json.loads(sys.argv[1])
cli = __import__(pkg + ".cli", fromlist=["main"])
extra = ["--device", "cpu", "--stats", "json"] if pkg == "findkmer_torch" \\
    else []
report = {"stats": {}}
for run, flags in runs.items():
    for name in inputs:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["count", "-i", inputs[name], "-o",
                           f"{out}/{name}_{run}.tsv", *flags, *geom, *extra])
        assert rc == 0, err.getvalue()
        if extra:
            report["stats"][f"{name}_{run}"] = json.loads(
                err.getvalue().strip().splitlines()[-1])
native = __import__(pkg + ".io.native", fromlist=["available"])
report.update(native_available=native.available(), native=native.__file__,
              jax_package="findkmer_tpu" in sys.modules)
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def installed_counts(installed, tmp_path_factory):
    """Both installed CLIs over the fixtures at every run of RUNS: the port
    on --device cpu with --stats json, each in a child of its own."""
    _, target = installed
    tmp = tmp_path_factory.mktemp("counts")
    inputs = {n: str(REPO / "tests" / "data" / f"{n}.fa") for n in FIXTURES}
    reports = {}
    for pkg in ("findkmer_tpu", "findkmer_torch"):
        out = tmp / pkg
        out.mkdir()
        code = _COUNTS.replace("sys.argv[1]", repr(json.dumps(
            [pkg, inputs, RUNS, GEOM, str(out)])))
        reports[pkg] = _child(code, target, tmp,
                              FINDKMER_TORCH_CACHE=str(tmp / "cache"))
    return tmp, reports


@pytest.mark.parametrize("run", list(RUNS))
def test_installed_count_equals_installed_reference(installed, run,
                                                    installed_counts):
    """Bytes of the installed `findkmer-torch count --device cpu` equal the
    installed `findkmer count`'s, with the C host encoder on both sides."""
    _, target = installed
    tmp, reports = installed_counts
    port, ref = reports["findkmer_torch"], reports["findkmer_tpu"]
    for name in FIXTURES:
        got = (tmp / "findkmer_torch" / f"{name}_{run}.tsv").read_bytes()
        want = (tmp / "findkmer_tpu" / f"{name}_{run}.tsv").read_bytes()
        assert got == want and got, name
        stats = port["stats"][f"{name}_{run}"]
        assert stats["host_encoder"] == "native"
        assert stats["device"] == "cpu"
    assert port["native_available"] and ref["native_available"]
    assert _under(port["native"], target) and _under(ref["native"], target)
    assert not port["jax_package"]
    libs = list((tmp / "cache").rglob("libfindkmer_encode_*.so"))
    assert [p.name for p in libs] == [native.lib_path().name]


_CACHES = """
import json, os
from findkmer_torch import _native
got = {}
for xdg in (None, "{xdg}", "relative/cache"):
    if xdg is None:
        os.environ.pop("XDG_CACHE_HOME", None)
    else:
        os.environ["XDG_CACHE_HOME"] = xdg
    got[str(xdg)] = str(_native.cache_dir("kernels"))
os.environ["FINDKMER_TORCH_CACHE"] = "{env}"
got["env"] = str(_native.cache_dir("kernels"))
print(json.dumps(got))
"""


def test_cache_dir_rules(installed, tmp_path, monkeypatch):
    """$FINDKMER_TORCH_CACHE/<kind>; in a checkout build/torch_<kind>; else
    $XDG_CACHE_HOME/findkmer_torch/<kind> (an absolute one), by default
    ~/.cache/findkmer_torch/<kind>."""
    _, target = installed
    monkeypatch.delenv(_native.ENV, raising=False)
    assert _native.in_checkout()
    for kind in ("kernels", "native"):
        assert _native.cache_dir(kind) == REPO / "build" / f"torch_{kind}"
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    assert native.BUILD_DIR == REPO / "build" / "torch_native"
    monkeypatch.setenv(_native.ENV, str(tmp_path / "env"))
    assert _native.cache_dir("native") == tmp_path / "env" / "native"
    home, xdg = tmp_path / "home", tmp_path / "xdg"
    code = _CACHES.replace("{xdg}", str(xdg)).replace(
        "{env}", str(tmp_path / "env"))
    got = _child(code, target, tmp_path, HOME=str(home),
                 XDG_CACHE_HOME=None)
    assert got == {
        "None": str(home / ".cache" / "findkmer_torch" / "kernels"),
        str(xdg): str(xdg / "findkmer_torch" / "kernels"),
        "relative/cache": str(home / ".cache" / "findkmer_torch" / "kernels"),
        "env": str(tmp_path / "env" / "kernels"),
    }
    assert not home.exists() and not xdg.exists()


def test_unwritable_cache_is_an_error(installed, tmp_path):
    """A cache that cannot be created is an error naming the path and the
    variable, in this process and from the installed CLI (exit 2): no
    other place is tried, and no numpy fallback is taken."""
    _, target = installed
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(_native.CacheError) as e:
        _native.ensure_dir(blocker / "kernels")
    assert str(blocker / "kernels") in str(e.value)
    assert _native.ENV in str(e.value)
    assert _native.ensure_dir(tmp_path / "ok" / "native").is_dir()
    out = tmp_path / "o.tsv"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(target), FINDKMER_TORCH_CACHE=str(blocker))
    res = subprocess.run(
        [sys.executable, "-P", "-m", "findkmer_torch.cli", "count", "-i",
         str(REPO / "tests" / "data" / "tiny.fa"), "-k", "4", "-o",
         str(out), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert res.returncode == 2
    assert f"cannot write the build cache {blocker / 'native'}" in res.stderr
    assert _native.ENV in res.stderr and "numpy" not in res.stderr
    assert not out.exists()


_NO_CSRC = """
import json
from findkmer_torch.ops.cuda import _build
got = {}
for fn in (_build.sources, _build.library_path, _build.build, _build.load):
    try:
        fn()
        got[fn.__name__] = None
    except RuntimeError as e:
        got[fn.__name__] = str(e)
print(json.dumps(got))
"""


def test_installed_without_csrc_names_it(installed, tmp_path):
    """A package installed without csrc/ fails with its own message before
    nvcc is looked for, at every entry of the build."""
    _, target = installed
    bare = tmp_path / "bare"
    shutil.copytree(target / "findkmer_torch", bare / "findkmer_torch",
                    ignore=shutil.ignore_patterns("csrc"))
    got = _child(_NO_CSRC, bare, tmp_path,
                 FINDKMER_TORCH_CACHE=str(tmp_path / "cache"))
    csrc = bare / "findkmer_torch" / "csrc"
    want = (f"no CUDA sources under {csrc}; the package was installed "
            "without its csrc/")
    assert got == dict.fromkeys(
        ("sources", "library_path", "build", "load"), want)
    assert not (tmp_path / "cache").exists()


@pytest.mark.cuda
def test_installed_count_on_the_card(installed, tmp_path):
    """The installed tree builds its kernels into an empty cache and counts
    k=21 --canonical on the card: the bytes of its own --device cpu run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, target = installed
    cache = tmp_path / "cache"
    fasta = str(REPO / "tests" / "data" / "ecoli_frag.fa")
    code = """
import contextlib, io, json, sys
from findkmer_torch import cli
from findkmer_torch.ops.cuda import _build
from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows_cuda
stats = {}
for device in ("cuda", "cpu"):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["count", "-i", FASTA, "-k", "21", "--canonical",
                       "-o", OUT + device, "--device", device, "--stats",
                       "json", *GEOM])
    assert rc == 0, err.getvalue()
    stats[device] = json.loads(err.getvalue().strip().splitlines()[-1])
print(json.dumps({"stats": stats, "library": str(_build.library_path()),
                  "launches": sort_rows_cuda.launches,
                  "jax_package": "findkmer_tpu" in sys.modules}))
""".replace("FASTA", repr(fasta)).replace(
        "OUT", repr(str(tmp_path / "o_"))).replace("GEOM", repr(GEOM))
    got = _child(code, target, tmp_path, FINDKMER_TORCH_CACHE=str(cache))
    assert (tmp_path / "o_cuda").read_bytes() == \
        (tmp_path / "o_cpu").read_bytes() != b""
    assert got["stats"]["cuda"]["device"] != "cpu"
    assert got["stats"]["cuda"]["host_encoder"] == "native"
    assert Path(got["library"]).is_file() and _under(got["library"], cache)
    assert got["launches"] > 0 and not got["jax_package"]

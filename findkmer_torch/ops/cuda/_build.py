"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `*.cu` file under `findkmer_torch/csrc/` is compiled by nvcc into one
shared library with a plain C interface, each source in its own nvcc
process (all started together), then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <tmp>/<name>.o findkmer_torch/csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/torch_kernels/libfindkmer_torch_<key>.so <tmp>/*.o

The sources include no PyTorch header, so the build takes seconds.  The
library name carries a hash of the sources and flags: an edited source
builds anew, an unchanged one is loaded as built.  The build writes a
temporary file and renames it into place, so two processes building at
once cannot load a half-written library.

A missing nvcc or a failed build raises with nvcc's own message.  There is
no fallback: the kernels' plain twins run only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# the CUDA toolkit's default install prefix, tried after CUDA_HOME and PATH
_DEFAULT_CUDA_HOME = Path("/usr/local/cuda")


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME when set, else from PATH, else the toolkit's
    default prefix.  Raises RuntimeError when none has it."""
    home = os.environ.get("CUDA_HOME")
    if home:
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
        raise RuntimeError(
            f"nvcc not found: CUDA_HOME={home} has no bin/nvcc; the CUDA "
            "kernels of findkmer_torch are built with nvcc at first use"
        )
    found = shutil.which("nvcc")
    if found:
        return found
    cand = _DEFAULT_CUDA_HOME / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under the CUDA toolkit's default "
        "prefix; set CUDA_HOME.  The CUDA kernels of findkmer_torch are "
        "built with nvcc at first use"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfindkmer_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.{uuid.uuid4().hex}"
    tmp.mkdir()
    try:
        srcs = [s for s in sources() if s.suffix == ".cu"]
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for cmd in (
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)
            )
        ]
        errs = [p.communicate()[1] for _, p in procs]  # waits for each
        failed = [(cmd, p.returncode, e)
                  for (cmd, p), e in zip(procs, errs) if p.returncode]
        if not failed:
            lib = tmp / "lib.so"
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                   *map(str, objs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                failed = [(cmd, res.returncode, res.stderr)]
            else:
                os.replace(lib, out)
        if failed:
            cmd, rc, err = failed[0]
            raise RuntimeError(
                f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{err}"
            )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every symbol."""
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    lib.fk_histogram.argtypes = [
        ptr, ptr, ctypes.c_int64, ptr, ctypes.c_int, ctypes.c_int, ptr,
    ]
    lib.fk_histogram.restype = ctypes.c_int
    lib.fk_sort_rows.argtypes = [
        ptr, ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ptr,
    ]
    lib.fk_sort_rows.restype = ctypes.c_int
    i64 = ctypes.c_int64
    lib.fk_window_histogram.argtypes = [
        ptr, i64, i64, ptr, ctypes.c_int, ctypes.c_int, ptr,
    ]
    lib.fk_window_histogram.restype = ctypes.c_int
    lib.fk_window_histogram_packed.argtypes = [
        ptr, ptr, i64, i64, i64, i64, ptr, ctypes.c_int, ctypes.c_int, ptr,
    ]
    lib.fk_window_histogram_packed.restype = ctypes.c_int
    lib.fk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fk_cuda_error_string.restype = ctypes.c_char_p
    return lib

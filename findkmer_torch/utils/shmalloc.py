"""Shared-memory numpy allocator loader (src/native/shmalloc.c).

The port's copy of `findkmer_tpu/utils/shmalloc.py`.  On hosts whose
memory is backed lazily, private anonymous pages (normal malloc / numpy
memory) fault far slower than shared anonymous ones.  The C extension
installs a numpy PyDataMem handler that serves allocations >= 1 MiB from
MAP_SHARED|MAP_ANONYMOUS mmaps (with a small pooled free-list), which
covers every large host buffer of a run.

An installed tree imports the wheel's own `findkmer_shmalloc`.  In a
source checkout the extension is compiled from the repository's source at
first use into `_native.cache_dir("native")` (`build/torch_native/`
there).  Best-effort: it silently stays on the default allocator if
anything fails (correctness is unaffected).  Kill-switch:
FINDKMER_NO_SHMALLOC=1.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from findkmer_torch import _native

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "src" / "native" / "shmalloc.c"
BUILD_DIR = _native.cache_dir("native")
_installed = False
_attempted = False


def _build() -> bool:
    out = BUILD_DIR / "findkmer_shmalloc.so"
    if not SOURCE.exists():
        return False
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return True
    try:
        import sysconfig

        import numpy

        _native.ensure_dir(BUILD_DIR)
        tmp = out.with_name(f".{out.name}.{os.getpid()}")
        cc = os.environ.get("CC", "cc")
        cmd = [
            cc, "-O2", "-shared", "-fPIC", "-std=c11",
            f"-I{numpy.get_include()}",
            f"-I{sysconfig.get_paths()['include']}",
            str(SOURCE), "-o", str(tmp),
        ]
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError, ImportError, KeyError,
            _native.CacheError):
        return False


def ensure_shared_alloc() -> bool:
    """Install the shared-memory numpy allocator (idempotent).

    Call EARLY, before the big host buffers of a run are allocated;
    already-allocated arrays keep their original allocator (numpy
    frees through the handler recorded per array, so mixing is safe).
    """
    global _installed, _attempted
    if _installed or _attempted:
        return _installed
    _attempted = True
    if os.environ.get("FINDKMER_NO_SHMALLOC") == "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        # installed (setup.py-built) extension, if present
        import findkmer_shmalloc
    except ImportError:
        if not _build():
            return False
        sp = str(BUILD_DIR)
        if sp not in sys.path:
            sys.path.insert(0, sp)
        try:
            import findkmer_shmalloc
        except Exception:
            return False
    try:
        _installed = bool(findkmer_shmalloc.install())
    except Exception:
        _installed = False
    return _installed

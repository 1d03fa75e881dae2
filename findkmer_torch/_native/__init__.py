"""The port's native sources and where their build products go.

The counterpart of `findkmer_tpu/_native/`.  This directory ships inside
the package (`MANIFEST.in`): `encode.c` is a byte-equal copy of the
repository's `src/native/encode.c`, compiled at first use by
`findkmer_torch/io/native.py`; the CUDA kernels' sources ship beside it in
`findkmer_torch/csrc/` (`findkmer_torch/ops/cuda/_build.py`).  Nothing is
built into the package itself, which may be read-only once installed:
every loader of the port asks `cache_dir(kind)` where its products go,

  1. `$FINDKMER_TORCH_CACHE/<kind>` when that variable is set;
  2. else, when the package sits in a source checkout (its parent holds
     `pyproject.toml` and `src/native/encode.c`),
     `<checkout>/build/torch_<kind>`;
  3. else `$XDG_CACHE_HOME/findkmer_torch/<kind>`, by default
     `~/.cache/findkmer_torch/<kind>`.

and calls `ensure_dir` before it writes there.  A directory that cannot
be created or written is an error that names it; no other place is
tried.  Library names carry a hash of their sources and flags, so
packages of other versions can share one cache.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

ENV = "FINDKMER_TORCH_CACHE"
HERE = Path(__file__).resolve().parent
ENCODE_C = HERE / "encode.c"
_CHECKOUT = HERE.parents[1]


class CacheError(RuntimeError):
    """The build cache cannot be created or written."""


def in_checkout() -> bool:
    """Whether the package sits in a source checkout of the repository."""
    return ((_CHECKOUT / "pyproject.toml").is_file()
            and (_CHECKOUT / "src" / "native" / "encode.c").is_file())


def cache_dir(kind: str) -> Path:
    """Where build products of `kind` ("kernels", "native") go; no I/O
    beyond the checkout test."""
    root = os.environ.get(ENV)
    if root:
        return Path(root).expanduser().absolute() / kind
    if in_checkout():
        return _CHECKOUT / "build" / f"torch_{kind}"
    xdg = os.environ.get("XDG_CACHE_HOME", "")
    base = Path(xdg) if os.path.isabs(xdg) else Path.home() / ".cache"
    return base / "findkmer_torch" / kind


def ensure_dir(path: Path) -> Path:
    """Create `path` if need be and check that a file can be written
    there; raise CacheError naming it otherwise."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=path):
            pass
    except OSError as e:
        raise CacheError(
            f"cannot write the build cache {path} ({e.strerror or e}); "
            f"set {ENV} to a writable directory"
        ) from None
    return path

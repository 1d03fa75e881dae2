"""ctypes loader for the native C encoder (`_native/encode.c`).

The port's copy of `findkmer_tpu/io/native.py`, with every entry point
of the original.  It compiles the package's own copy of the C source,
`findkmer_torch/_native/encode.c` (byte-equal to the repository's
`src/native/encode.c`, and shipped in the wheel), at first use into
`_native.cache_dir("native")`: `build/torch_native/` in a source
checkout, a user cache once installed.  The name carries a hash of the
source and flags: the JAX package builds the same source into its own
directories (and ships its own library, which the port never loads), and
neither package can load a library the other built from another version
of the source.

The build runs `$CC` (default `cc`); if that fails and `$CC` names another
compiler, it runs once more with `cc` (a `$CC` that cannot link OpenMP
fails the first build).  The library is optional: where no compiler
works, `available()` is False and io/encode.py and the pipeline fall back
to numpy, with the same output; a cache that cannot be written is an
error (`_native.CacheError`).  FINDKMER_AUTOBUILD=0 turns building off.
`python -m findkmer_torch.io.native` builds and reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import uuid
from pathlib import Path
from typing import Optional

import numpy as np

from findkmer_torch import _native

SOURCE = _native.ENCODE_C
BUILD_DIR = _native.cache_dir("native")
CFLAGS = ("-O3", "-march=native", "-std=c17", "-fPIC", "-fopenmp", "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def lib_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    if SOURCE.exists():
        h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfindkmer_encode_{h.hexdigest()[:16]}.so"


def _compile(cc: str, out: Path, quiet: bool) -> bool:
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{uuid.uuid4().hex}")
    cmd = [cc, *CFLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120,
                             cwd=str(BUILD_DIR))
        if res.returncode != 0 or not tmp.exists():
            if not quiet:
                sys.stderr.write(res.stderr.decode("utf-8", "replace"))
            return False
        os.replace(tmp, out)  # never a half-written library under `out`
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def build(quiet: bool = True) -> bool:
    """Compile the shared library into BUILD_DIR: with $CC (default cc),
    then, if that fails and $CC is another compiler, once more with cc.
    Returns True on success; raises _native.CacheError where BUILD_DIR
    cannot be written."""
    if not SOURCE.exists():
        return False
    out = lib_path()
    _native.ensure_dir(BUILD_DIR)
    cc = os.environ.get("CC") or "cc"
    if _compile(cc, out, quiet):
        return True
    return cc != "cc" and _compile("cc", out, quiet)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    path = lib_path()
    if (not path.exists()
            and os.environ.get("FINDKMER_AUTOBUILD", "1") == "1"):
        build(quiet=True)  # an unwritable cache raises, every time
    _load_attempted = True
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    except (OSError, AttributeError):
        _lib = None
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    ptr, size, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_longlong
    lib.fk_encode.argtypes = [ptr, ptr, size]
    lib.fk_encode.restype = None
    lib.fk_encode_packed.argtypes = [ptr, ptr, ptr, size]
    lib.fk_encode_packed.restype = None
    lib.fk_count_valid.argtypes = [ptr, size]
    lib.fk_count_valid.restype = size
    lib.fk_count_acgt.argtypes = [ptr, size]
    lib.fk_count_acgt.restype = size
    lib.fk_encode_compact.argtypes = [ptr, ptr, size]
    lib.fk_encode_compact.restype = size
    lib.fk_pack_rows.argtypes = [ptr, size, size, size, size, ptr, ptr]
    lib.fk_pack_rows.restype = None
    lib.fk_format_spectrum.argtypes = [
        ptr, ptr, size, ctypes.c_uint32, ctypes.c_uint8, ptr,
    ]
    lib.fk_format_spectrum.restype = size
    lib.fk_parse_spectrum.argtypes = [
        ptr, size, ctypes.c_int, ctypes.c_uint8, ptr, ptr, size,
    ]
    lib.fk_parse_spectrum.restype = size
    lib.fk_filter_hits.argtypes = [
        ptr, ptr, ptr, i64, ctypes.c_int, ctypes.c_int, ptr, size, ptr,
        ctypes.c_int, ptr, ptr,
    ]
    lib.fk_filter_hits.restype = None
    lib.fk_filter_prepare.argtypes = [ptr, i64, ptr]
    lib.fk_filter_prepare.restype = None
    lib.fk_filter_bitmap_hits.argtypes = [
        ptr, ptr, ptr, i64, ctypes.c_int, ptr, i64, ptr, ptr,
    ]
    lib.fk_filter_bitmap_hits.restype = None
    lib.fk_filter_bitmap_hits2.argtypes = [
        ptr, ptr, ptr, ptr, i64, ctypes.c_int, ptr, i64, ptr, ptr,
    ]
    lib.fk_filter_bitmap_hits2.restype = None
    lib.fk_fastq_scan.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, i64, ptr, ptr]
    lib.fk_fastq_scan.restype = i64
    lib.fk_filter_gather_prepare.argtypes = [ptr, ptr, ptr, ptr, i64, ptr]
    lib.fk_filter_gather_prepare.restype = None
    for name in ("fk_merge_runs64", "fk_merge_runs32",
                 "fk_merge_runs64_mt", "fk_merge_runs32_mt"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.POINTER(ptr), ptr,
                       ctypes.c_int, ptr, ptr]
        fn.restype = size


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder not available")
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_u8(**arrays) -> None:
    _check(np.uint8, **arrays)


def _check(dtype, **arrays) -> None:
    for name, a in arrays.items():
        if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
            raise ValueError(
                f"{name} must be a contiguous {np.dtype(dtype).name} array")


def encode(buf: np.ndarray) -> np.ndarray:
    """bytes/uint8 array -> uint8 codes via the C LUT loop."""
    lib = _require()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty_like(buf)
    lib.fk_encode(_ptr(buf), _ptr(out), buf.size)
    return out


def encode_packed(buf: np.ndarray):
    """bytes -> (packed 2-bit codes, validity bitmask, n) in one C pass."""
    lib = _require()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = buf.size
    packed = np.empty((n + 3) // 4, dtype=np.uint8)
    validmask = np.zeros((n + 7) // 8, dtype=np.uint8)
    lib.fk_encode_packed(_ptr(buf), _ptr(packed), _ptr(validmask), n)
    return packed, validmask, n


def encode_compact(buf) -> np.ndarray:
    """Raw FASTA sequence bytes -> compacted codes (whitespace removed,
    non-ACGT -> INVALID) in one C pass."""
    lib = _require()
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty(buf.size, dtype=np.uint8)
    m = lib.fk_encode_compact(_ptr(buf), _ptr(out), buf.size)
    return out[: int(m)]


def encode_compact_into(buf: np.ndarray, out: np.ndarray,
                        offset: int) -> int:
    """Strip+encode raw sequence bytes DIRECTLY into out[offset:] (the
    pipeline's work buffer): no intermediate codes array, no extra copy.
    Returns the number of codes written (<= buf.size)."""
    lib = _require()
    _check_u8(buf=buf, out=out)
    if offset < 0 or offset + buf.size > out.size:
        raise ValueError("encode_compact_into: out is too small")
    return int(lib.fk_encode_compact(
        _ptr(buf), ctypes.c_void_p(out.ctypes.data + offset), buf.size))


def count_acgt(codes: np.ndarray, offset: int, m: int) -> int:
    """Valid (code < 4) count over codes[offset:offset+m], no numpy pass."""
    lib = _require()
    _check_u8(codes=codes)
    if offset < 0 or m < 0 or offset + m > codes.size:
        raise ValueError("count_acgt: range outside codes")
    return int(lib.fk_count_acgt(
        ctypes.c_void_p(codes.ctypes.data + offset), m))


def pack_rows(work: np.ndarray, B: int, L: int, R: int):
    """Flat work buffer -> ((B, R8/4) packed, (B, R8/8) validbits).

    Row i covers work[i*L : i*L+R] (overlapping halos), padded with
    invalid to R8 = R rounded up to 8.
    """
    lib = _require()
    work = np.ascontiguousarray(work, dtype=np.uint8)
    if work.size < (B - 1) * L + R:
        raise ValueError("pack_rows: work buffer shorter than B rows")
    R8 = (R + 7) // 8 * 8
    packed = np.empty((B, R8 // 4), dtype=np.uint8)
    validbits = np.empty((B, R8 // 8), dtype=np.uint8)
    lib.fk_pack_rows(_ptr(work), B, L, R, R8, _ptr(packed), _ptr(validbits))
    return packed, validbits


def format_spectrum(codes: np.ndarray, counts: np.ndarray, k: int,
                    sep: bytes) -> np.ndarray:
    """Format "KMER<sep>COUNT\\n" lines in one C pass.

    Returns a uint8 numpy view (NOT bytes): file.write() and
    bytes.join() accept it directly, and a .tobytes() here would copy
    the whole block once more."""
    lib = _require()
    if len(sep) != 1:
        raise ValueError("native formatter supports 1-byte separators")
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = codes.size
    out = np.empty(n * (k + 22), dtype=np.uint8)
    m = lib.fk_format_spectrum(_ptr(codes), _ptr(counts), n, k, sep[0],
                               _ptr(out))
    return out[: int(m)]


MERGE_MAX_RUNS = 256  # fk_merge_runs' own limit


def merge_runs(runs):
    """G-way merge of sorted (codes u64, counts) runs, summing counts of
    equal codes -> (codes u64, counts i64) sorted distinct arrays.

    `runs` is a list of (codes, counts) pairs, each sorted ascending by
    code with no duplicates within a run, at most MERGE_MAX_RUNS of them.
    One heap-merge C pass: the host-side tail of the row store (its rows
    are independent sorted runs) and of the disk spill's block merge."""
    lib = _require()
    runs = [
        (np.ascontiguousarray(c, dtype=np.uint64), np.ascontiguousarray(n))
        for c, n in runs
        if c.size
    ]
    G = len(runs)
    if G == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    if G > MERGE_MAX_RUNS:
        raise ValueError(
            f"merge_runs takes up to {MERGE_MAX_RUNS} runs, got {G}")
    # 64-bit when ANY run carries 64-bit counts: keying on runs[0] alone
    # would silently downcast a later run's > 2^31 count
    is64 = any(n.dtype.itemsize == 8 for _, n in runs)
    cdt = np.int64 if is64 else np.int32
    runs = [(c, n.astype(cdt, copy=False)) for c, n in runs]
    code_ptrs = (ctypes.c_void_p * G)(*[c.ctypes.data for c, _ in runs])
    cnt_ptrs = (ctypes.c_void_p * G)(*[n.ctypes.data for _, n in runs])
    lens = np.array([c.size for c, _ in runs], dtype=np.uintp)
    total = int(lens.sum())
    out_codes = np.empty(total, np.uint64)
    out_counts = np.empty(total, np.int64)
    fn = lib.fk_merge_runs64_mt if is64 else lib.fk_merge_runs32_mt
    m = int(fn(code_ptrs, cnt_ptrs, _ptr(lens), G, _ptr(out_codes),
               _ptr(out_counts)))
    if m == (1 << 64) - 1:  # (size_t)-1
        raise RuntimeError("fk_merge_runs failed (run count/size guard)")
    return out_codes[:m], out_counts[:m]


def fastq_scan(buf: np.ndarray, max_rec: int = 0):
    """Strict-4-line FASTQ block scan -> per-record offset arrays.

    Returns (seq_s, seq_e, rec_s, rec_e, consumed, err): offsets into
    `buf` of each complete record's sequence span and verbatim record
    span; `consumed` = bytes fully parsed (carry the tail); err != 0
    means a malformed/multi-line record starts at `consumed`.  Zero
    copies: the caller slices/encodes straight from the block."""
    lib = _require()
    _check_u8(buf=buf)
    n = int(buf.size)
    if max_rec <= 0:
        max_rec = n // 6 + 2  # "@\n\n+\n\n" = 6 B is the minimum record
    seq_s = np.empty(max_rec, np.int64)
    seq_e = np.empty(max_rec, np.int64)
    rec_s = np.empty(max_rec, np.int64)
    rec_e = np.empty(max_rec, np.int64)
    consumed = ctypes.c_longlong(0)
    err = ctypes.c_int(0)
    nrec = int(lib.fk_fastq_scan(
        _ptr(buf), n, _ptr(seq_s), _ptr(seq_e), _ptr(rec_s), _ptr(rec_e),
        max_rec, ctypes.byref(consumed), ctypes.byref(err)))
    return (
        seq_s[:nrec], seq_e[:nrec], rec_s[:nrec], rec_e[:nrec],
        int(consumed.value), int(err.value),
    )


def filter_gather_prepare(buf: np.ndarray, starts: np.ndarray,
                          joined: np.ndarray, lens: np.ndarray,
                          out: np.ndarray) -> None:
    """LUT-encode each read from the block buffer straight into its
    joined-stream slot of the (4-prefilled) work buffer."""
    lib = _require()
    _check_u8(buf=buf, out=out)
    lib.fk_filter_gather_prepare(
        _ptr(buf), _ptr(starts), _ptr(joined), _ptr(lens), int(starts.size),
        _ptr(out))


def _hits_out(n: int):
    return np.empty(n, np.int64), np.empty(n, np.int64)


def filter_hits(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                k: int, canonical: bool, table: np.ndarray,
                bloom: np.ndarray, bloom_shift: int):
    """Per-read (hits, valid windows) vs a sorted u64 code table.

    buf holds all reads' bytes; read r spans buf[starts[r]:+lens[r]].
    bloom is the bool one-probe prefilter (see filter.FilterSpec)."""
    lib = _require()
    _check_u8(buf=buf)
    _check(np.int64, starts=starts, lens=lens)
    _check(np.uint64, table=table)
    _check(np.bool_, bloom=bloom)
    n = int(starts.size)
    hits, wins = _hits_out(n)
    lib.fk_filter_hits(
        _ptr(buf), _ptr(starts), _ptr(lens), n, k, int(canonical),
        _ptr(table), table.size, _ptr(bloom), bloom_shift, _ptr(hits),
        _ptr(wins))
    return hits, wins


def filter_prepare(buf: np.ndarray, out: np.ndarray) -> None:
    """Joined read bytes -> device code stream into out (0..3, 4=N)."""
    lib = _require()
    _check_u8(buf=buf, out=out)
    if out.size < buf.size:
        raise ValueError("filter_prepare: out is shorter than buf")
    lib.fk_filter_prepare(_ptr(buf), buf.size, _ptr(out))


def filter_bitmap_hits(buf: np.ndarray, starts: np.ndarray,
                       lens: np.ndarray, k: int, words: np.ndarray,
                       halo: int):
    """Per-read (hits, valid windows) from the device hit bitmap.

    buf holds the reads' joined bytes; the window starting at joined
    position p is bit p + halo of `words` (uint32 little-endian, the
    filter_device._filter_step packing)."""
    lib = _require()
    _check_u8(buf=buf)
    _check(np.int64, starts=starts, lens=lens)
    _check(np.uint32, words=words)
    n = int(starts.size)
    hits, wins = _hits_out(n)
    lib.fk_filter_bitmap_hits(
        _ptr(buf), _ptr(starts), _ptr(lens), n, k, _ptr(words), halo,
        _ptr(hits), _ptr(wins))
    return hits, wins


def filter_bitmap_hits2(buf: np.ndarray, byte_starts: np.ndarray,
                        joined: np.ndarray, lens: np.ndarray, k: int,
                        words: np.ndarray, halo: int):
    """filter_bitmap_hits with separate byte (block) and bitmap
    (joined-stream) coordinates: the offsets-based zero-copy flow."""
    lib = _require()
    _check_u8(buf=buf)
    _check(np.int64, byte_starts=byte_starts, joined=joined, lens=lens)
    _check(np.uint32, words=words)
    n = int(byte_starts.size)
    hits, wins = _hits_out(n)
    lib.fk_filter_bitmap_hits2(
        _ptr(buf), _ptr(byte_starts), _ptr(joined), _ptr(lens), n, k,
        _ptr(words), halo, _ptr(hits), _ptr(wins))
    return hits, wins


def count_valid(buf: np.ndarray) -> int:
    """Number of A/C/G/T bytes (either case) in buf."""
    lib = _require()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    return int(lib.fk_count_valid(_ptr(buf), buf.size))


def parse_spectrum(buf, k: int, sep: bytes):
    """Parse a sorted KMER<sep>COUNT buffer -> (codes u64, counts i64).

    Returns None when the input is not a clean sorted uppercase
    spectrum (callers fall back to the Python parser).  One OpenMP C
    pass."""
    lib = _require()
    if len(sep) != 1:
        raise ValueError("parse_spectrum takes a 1-byte separator")
    src = np.frombuffer(memoryview(buf), dtype=np.uint8)
    n_max = src.size // (k + 2) + 2
    codes = np.empty(n_max, np.uint64)
    counts = np.empty(n_max, np.int64)
    m = int(lib.fk_parse_spectrum(_ptr(src), src.size, k, sep[0],
                                  _ptr(codes), _ptr(counts), n_max))
    if m == (1 << 64) - 1:  # (size_t)-1
        return None
    return codes[:m], counts[:m]


if __name__ == "__main__":
    ok = build(quiet=False)
    print(f"build: {'ok' if ok else 'FAILED'} -> {lib_path()}")
    if ok:
        print("encode:", encode(np.frombuffer(b"ACGTNacgtX", dtype=np.uint8)))

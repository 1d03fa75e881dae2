"""Vectorized byte -> 2-bit base encoding with validity masking.

The port's copy of `findkmer_tpu/io/encode.py`.  A 256-entry lookup table
maps a whole buffer in one numpy gather: A/C/G/T in either case become
0..3, every other byte (N, IUPAC codes, ...) becomes the sentinel
INVALID=4, which window extraction treats as a window reset
(ops/window.py).

Backends:
  * numpy:  a gather on the LUT.
  * native: src/native/encode.c via ctypes (io/native.py); used when it
    builds and Config.use_native_encode is set.

Base code order A=0, C=1, G=2, T=3 gives lexicographic == numeric code
order, which makes spectrum emission a linear scan.
"""

from __future__ import annotations

import numpy as np

INVALID = np.uint8(4)  # sentinel code for non-ACGT bytes (window reset)

# 256-entry LUT: ACGT/acgt -> 0..3, everything else -> INVALID
LUT = np.full(256, INVALID, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    LUT[b] = i
    LUT[b + 32] = i  # lowercase


def _numpy_encode(buf: np.ndarray) -> np.ndarray:
    return LUT[buf]


_native = None
_native_checked = False


def _get_native():
    """Lazily probe the C encoder; never fail (numpy is always available)."""
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from findkmer_torch.io import native as _n

            _native = _n if _n.available() else None
        except Exception:
            _native = None
    return _native


def encode_bytes(
    data: bytes | np.ndarray, *, prefer_native: bool = True
) -> np.ndarray:
    """Encode sequence bytes to uint8 codes in {0,1,2,3,INVALID}.

    Accepts bytes or a uint8 array; returns a fresh uint8 array of the same
    length.
    """
    buf = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    nat = _get_native() if prefer_native else None
    if nat is not None:
        return nat.encode(buf)
    return _numpy_encode(buf)

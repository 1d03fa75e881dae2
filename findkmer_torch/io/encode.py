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

from typing import Tuple

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


def encoder_backend(prefer_native: bool = True) -> str:
    """Name of the encode backend that encode_bytes will use."""
    return "native" if (prefer_native and _get_native()) else "numpy"


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


def decode_codes(codes: np.ndarray) -> bytes:
    """Codes (0..3) back to ACGT bytes.  INVALID becomes 'N'."""
    out_lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return out_lut[np.minimum(codes, 4)].tobytes()


# ----------------------------------------------------------------------
# 2-bit packing: 4 bases/byte for minimal H2D traffic, plus a separate
# validity bitmask (1 bit/base).  The device unpacks with shifts
# (ops/window.py unpack path).
# ----------------------------------------------------------------------

def pack_2bit(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack uint8 codes into (packed, validmask, n).

    MSB-first (one big-endian 2-bit stream, matching encode.c and the
    device unpack): base 4i+j of byte i sits at bits (6-2j)..(7-2j),
    so base 0 occupies the TOP two bits; INVALID packs as 0.
    validmask: uint8, ceil(n/8) bytes, base 8i+j at bit (7-j) of byte i
    (np.packbits bitorder='big').  n: original base count."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    valid = codes < 4
    safe = np.where(valid, codes, 0).astype(np.uint8)

    pad4 = (-n) % 4
    if pad4:
        safe = np.concatenate([safe, np.zeros(pad4, np.uint8)])
    q = safe.reshape(-1, 4)
    # MSB-first: the wire is one big-endian 2-bit stream (encode.c)
    packed = (
        (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    ).astype(np.uint8)

    validmask = np.packbits(valid, bitorder="big")
    return packed, validmask, n


def unpack_2bit(
    packed: np.ndarray, validmask: np.ndarray, n: int
) -> np.ndarray:
    """Inverse of pack_2bit: back to uint8 codes with INVALID sentinels."""
    packed = np.asarray(packed, dtype=np.uint8)
    b = packed.reshape(-1, 1)
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    codes = ((b >> shifts) & 3).reshape(-1)[:n].astype(np.uint8)
    valid = np.unpackbits(
        np.asarray(validmask, dtype=np.uint8), bitorder="big"
    )[:n].astype(bool)
    codes[~valid] = INVALID
    return codes

"""Rolling-window k-mer code extraction in PyTorch.

Counterpart of `findkmer_tpu/ops/window.py` (same layouts, same results):

  rows: (B, R) uint8 codes in {0..3, INVALID=4}; R = L + k - 1, the first
  k-1 slots being the halo carried from the previous chunk.
  Output: W = R - k + 1 window codes per row; window i ends at owned
  position i, so every window is counted in exactly one chunk.

`window_codes` builds each window's code from k shifted slices OR'd
together, and the canonical code min(code, revcomp) in the same pass.
`window_codes_packed` (the sparse path's extraction) reads the 2-bit
wire words directly instead.  Plain tensor ops on whatever device the
input lies on (the JAX package leaves the same work to XLA).
`window_codes_packed` is also the plain version of C1, the kernel that
extracts on CUDA (`ops/cuda/window_codes_kernel.py`): the counter and
the device filter call C1's wrapper, which runs this function for CPU
tensors.

A code is one signed integer: int32 for k <= 15, int64 for 16 <= k <= 31
(the JAX package splits the wide codes into a (hi, lo) uint32 pair).
Real codes are below 4^k <= 2^62, so the dtype's max is free to mark an
empty or invalid slot (`sentinel`): it sorts after every real code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INVALID = 4
MAX_K = 31


def code_dtype(k: int) -> torch.dtype:
    """The dtype of a k-mer code: int32 for k <= 15, else int64."""
    return torch.int32 if k <= 15 else torch.int64


def sentinel(dtype: torch.dtype) -> int:
    """The empty-slot marker of a code dtype: its max value."""
    return torch.iinfo(dtype).max


def window_codes(
    rows: torch.Tensor, k: int, canonical: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All window codes of each row.  1 <= k <= 31.

    Returns (codes (B, W) of `code_dtype(k)`, valid bool (B, W)).  Codes
    of invalid windows are arbitrary; mask them with `valid`.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"window_codes needs 1 <= k <= {MAX_K}, got {k}")
    dt = code_dtype(k)
    W = rows.shape[-1] - k + 1
    code = rc = valid = None
    for j in range(k):
        cj = rows[..., j : j + W]
        b = (cj & 3).to(dt)
        v = cj < INVALID
        if code is None:
            code, valid = b, v
        else:
            # in place: the (B, W) accumulators are reused across the k
            # slices instead of allocating two new ones per base
            code <<= 2
            code |= b
            valid &= v
        if canonical:
            r = (3 - b) << (2 * j)
            if rc is None:
                rc = r
            else:
                rc |= r
    if canonical:
        torch.minimum(code, rc, out=code)
    return code, valid


def unpack_rows(
    packed: torch.Tensor, validbits: torch.Tensor, R: int
) -> torch.Tensor:
    """Unpack 2-bit-packed rows back to uint8 code rows on their device.

    packed:    (B, R8/4) uint8, 4 bases per byte, MSB first.
    validbits: (B, R8/8) uint8, 1 bit per base, MSB first (the wire is one
    big-endian bitstream; see src/native/encode.c).
    Returns (B, R) uint8 codes with INVALID (4) at invalid positions.
    """
    B = packed.shape[0]
    dev = packed.device
    # arange, not torch.tensor: a list copied to a CUDA device would be a
    # pageable H2D copy that waits for the stream on every step
    shifts2 = torch.arange(6, -1, -2, dtype=torch.uint8, device=dev)
    codes = ((packed[:, :, None] >> shifts2) & 3).reshape(B, -1)
    shifts1 = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bits = ((validbits[:, :, None] >> shifts1) & 1).reshape(B, -1)
    # in place: `codes` is a fresh tensor, masking it saves a (B, R8) copy
    codes.masked_fill_(bits == 0, INVALID)
    return codes[:, :R]


_M32 = 0xFFFFFFFF


def _be_words(b: torch.Tensor, width: int, pad: int) -> torch.Tensor:
    """(B, NB) uint8 -> (B, ceil(NB / width) + pad) big-endian words of
    `width` bytes, held as non-negative int64; the padding is zeros."""
    B, NB = b.shape
    n = -(-NB // width) + pad
    buf = torch.zeros((B, n * width), dtype=torch.int64, device=b.device)
    buf[:, :NB] = b
    buf = buf.view(B, n, width)
    w = buf[..., 0].clone()
    for i in range(1, width):
        w <<= 8
        w |= buf[..., i]
    return w


def _rev32_2bit(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups of 32-bit values held in int64."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    return (
        ((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00) | (x >> 24)
    )


def packed_slots(B: int, NB: int, k: int, R: int = 0) -> int:
    """Code slots `window_codes_packed` emits for (B, NB) packed rows."""
    NW = -(-NB // 4)
    if R:
        NW = min(NW, (max(R - k + 1, 0) + 15) // 16)
    return 16 * B * NW


def window_codes_packed(
    packed: torch.Tensor, validbits: torch.Tensor, k: int,
    canonical: bool = False, R: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Window codes straight from the packed 2-bit wire format.

    Counterpart of the JAX `window_codes_packed`, same slots in the same
    order.  The wire is a big-endian 2-bit stream, so a 32-bit word
    holds 16 bases and the code of the window starting at base
    p = 16w + r is a combine of words w, w+1 (and w+2 for k > 16) at the
    constant shift 2r: 16 residue streams replace the k-slice chain of
    `window_codes`.  Validity rides the same scheme on 16-bit halfwords
    of the validity bitstream.

    Returns ONE flat tensor of `code_dtype(k)` in residue-interleaved
    order (residue, row, word), invalid slots set to the sentinel.  The
    sparse store does not depend on the order (it sorts); the device
    filter's hit bitmap does (`filter_device.hit_bitmap`), so C1 keeps
    it slot for slot.
    R, the true row length, trims the word streams to the row's windows
    (`packed_slots`).  `out`, when given, is filled in place (the raw
    store appends a batch without an intermediate copy).
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"window_codes_packed needs 1 <= k <= {MAX_K}, got {k}"
        )
    dt = code_dtype(k)
    B, NB = packed.shape
    n = packed_slots(B, NB, k, R)
    NW = n // (16 * B) if B else 0
    if out is None:
        out = torch.empty(n, dtype=dt, device=packed.device)
    elif out.shape != (n,) or out.dtype != dt:
        raise ValueError(
            f"out must be ({n},) {dt}, got {tuple(out.shape)} {out.dtype}"
        )
    if n == 0:
        return out
    W32 = _be_words(packed, 4, 2)
    V16 = _be_words(validbits, 2, 2)
    W0, W1, W2 = W32[:, :NW], W32[:, 1 : NW + 1], W32[:, 2 : NW + 2]
    C32 = (V16[:, :NW] << 16) | V16[:, 1 : NW + 1]
    V2 = V16[:, 2 : NW + 2]
    full = (1 << k) - 1
    sent = sentinel(dt)
    slots = out.view(16, B, NW)
    for r in range(16):
        s = 2 * r
        a = ((W0 << s) | (W1 >> (32 - s))) & _M32 if s else W0
        # validity: the top k bits of the bitstream from base 16w + r
        t = ((C32 << r) | (V2 >> (16 - r))) & _M32 if r else C32
        valid = (t >> (32 - k)) == full
        if k <= 16:
            code = a >> (32 - 2 * k)
            if canonical:
                rc = _rev32_2bit(code ^ _M32) >> (32 - 2 * k)
                code = torch.minimum(code, rc)
        else:
            b2 = ((W1 << s) | (W2 >> (32 - s))) & _M32 if s else W1
            code = (a << (2 * k - 32)) | (b2 >> (64 - 2 * k))
            if canonical:
                # rev64(~code) = (U << 32) | V; rc = rev64(~code) >> sh
                sh = 64 - 2 * k
                U = _rev32_2bit((code & _M32) ^ _M32)
                V = _rev32_2bit((code >> 32) ^ _M32)
                rc = (U << (32 - sh)) | (V >> sh)
                code = torch.minimum(code, rc)
        slots[r] = torch.where(valid, code, sent)
    return out


def rows_from_batch(batch, R: int) -> torch.Tensor:
    """Accept either raw (B, R) uint8 rows or a (packed, validbits) pair."""
    if isinstance(batch, (tuple, list)):
        packed, validbits = batch
        return unpack_rows(packed, validbits, R)
    return batch


def revcomp_code(code: int, k: int) -> int:
    """Host-side reverse complement of an integer k-mer code."""
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | (3 - (code & 3))
        code >>= 2
    return rc


def code_to_str(code: int, k: int) -> str:
    """Host-side code -> ACGT string (lexicographic order == numeric)."""
    bases = "ACGT"
    return "".join(bases[(code >> (2 * (k - 1 - j))) & 3] for j in range(k))


def str_to_code(kmer: str) -> int:
    m = {"A": 0, "C": 1, "G": 2, "T": 3}
    code = 0
    for ch in kmer.upper():
        code = (code << 2) | m[ch]
    return code

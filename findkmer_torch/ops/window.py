"""Rolling-window k-mer code extraction in PyTorch.

Counterpart of `findkmer_tpu/ops/window.py` (same layouts, same results):

  rows: (B, R) uint8 codes in {0..3, INVALID=4}; R = L + k - 1, the first
  k-1 slots being the halo carried from the previous chunk.
  Output: W = R - k + 1 window codes per row; window i ends at owned
  position i, so every window is counted in exactly one chunk.

`window_codes` builds each window's code from k shifted slices OR'd
together, and the canonical code min(code, revcomp) in the same pass.
Plain tensor ops on whatever device `rows` lies on; no kernel of its own
(the JAX package leaves the same work to XLA).

`window_codes_wide` (16 <= k <= 31) and `window_codes_packed` belong to
the sparse path and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

INVALID = 4


def window_codes(
    rows: torch.Tensor, k: int, canonical: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All window codes of each row.  k <= 15.

    Returns (codes int32 (B, W), valid bool (B, W)).  Codes of invalid
    windows are arbitrary; mask them with `valid`.
    """
    if not 1 <= k <= 15:
        raise ValueError(f"window_codes needs 1 <= k <= 15, got {k}")
    W = rows.shape[-1] - k + 1
    code = rc = valid = None
    for j in range(k):
        cj = rows[..., j : j + W]
        b = (cj & 3).to(torch.int32)
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

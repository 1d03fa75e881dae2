"""Device read-filtering engine: spectrum membership on a torch device.

The port's counterpart of `findkmer_tpu/filter_device.py`, with the same
contract (per-read hits and valid windows equal to the host engine's) and
the same hit bitmap:

  host   reads -> 'N'-joined stream -> packed 2-bit wire (0.375 B/base,
         native.pack_rows / pipeline._numpy_pack_rows), staged to the
         device through one reused `_PinnedStager`
  device window_codes_packed (the sparse counter's extraction, plain
         torch), then membership of every window code in the sorted
         member codes: torch.searchsorted, the index clamped, one gather,
         an equality test.  (The JAX package sorts members and queries
         together because gathers are slow on a TPU; on a GPU the binary
         search is the cheaper of the two.)  The hits, mapped from the
         extraction's residue-interleaved slots to window order, pack 32
         to a little-endian word: the D2H wire carries 1 bit a window.
  D2H    each flush's bitmap goes to a pinned buffer of its own by a
         non_blocking copy; `finish` waits on that copy's event alone
  host   per-read attribution from the bitmap (C fk_filter_bitmap_hits,
         or numpy), the same arithmetic as the host engine.

Validity never crosses the wire: a read's valid window count depends only
on its bases, so the host computes it; invalid windows extract as the
code dtype's max, which no member (< 4^k) equals, so their hit bits are 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from findkmer_torch.device import resolve_device
from findkmer_torch.filter import _CODE_LUT, _cumsum01, _read_spans
from findkmer_torch.io import native
from findkmer_torch.ops import window as window_ops
from findkmer_torch.pipeline import (
    _numpy_pack_rows,
    _PinnedStager,
    prefetch_to_device,
)

_PREFETCH = 2  # batches whose H2D copies are in flight ahead of the step


def member_hits(members: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes -> bool, True where the code is one of `members` (sorted,
    of the codes' dtype).  Sentinel codes (invalid windows) never hit."""
    if members.numel() == 0:
        return torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    idx = torch.searchsorted(members, codes, out_int32=True)
    idx.clamp_(max=members.numel() - 1)
    return members.index_select(0, idx.view(-1)).view(codes.shape) == codes


def hit_bitmap(hit: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """Slot-ordered hits of `window_codes_packed` -> (B*L//32,) int32
    words, bit j of word i = the window at b*L + s = 32i + j.

    Element (r, b, w) of the residue-interleaved layout is the window
    starting at row position s = 16w + r; only s < L are the row's
    windows, the rest are padding."""
    NW = hit.numel() // (16 * B)
    bits = hit.view(16, B, NW).permute(1, 2, 0).reshape(B, 16 * NW)[:, :L]
    bits = bits.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=hit.device)
    words = (bits << shifts).sum(dim=1)  # < 2^32: the uint32 word
    words -= (words >> 31) << 32  # the same 32 bits as an int32
    return words.to(torch.int32)


def _filter_step(members, packed, validbits, k: int, canonical: bool,
                 R: int, L: int) -> torch.Tensor:
    """One device batch -> (B*L//32,) int32 hit bitmap in window order
    (the uint32 words of the JAX package's `_filter_step`).

    members: the sorted member codes in `code_dtype(k)`.  Window slot s of
    row b covers the joined stream position b*L + s - (k-1) relative to
    this batch's first owned base."""
    codes = window_ops.window_codes_packed(packed, validbits, k, canonical,
                                           R=R)
    return hit_bitmap(member_hits(members, codes), packed.shape[0], L)


class DeviceFilter:
    """Device-resident membership scorer with FilterSpec.hits_batch's
    exact contract: per-read (hits, valid windows) over a batch of
    reads, reads isolated by 'N' separators.  `device`: 'cuda' or 'cpu'
    (resolved by `device.resolve_device`: cuda without a card raises) or
    a torch.device."""

    def __init__(self, spec, batch_rows: int = 256,
                 chunk_len: int = 65536, device="cuda"):
        self.spec = spec
        self.k = k = spec.k
        self.canonical = spec.canonical
        self.B, self.L = batch_rows, chunk_len
        self.R = chunk_len + k - 1
        self.R8 = (self.R + 7) // 8 * 8
        self.need = self.B * self.L  # owned bases per device batch
        # the JAX package packs (slot << 1 | hit) into int32 payloads and
        # both packings reshape (B*L,) -> (-1, 32): the port keeps both
        # guards, so the two engines accept the same geometries
        if self.need > 1 << 30:
            raise ValueError(
                f"batch_rows * chunk_len = {self.need} exceeds the "
                "2^30 slot limit of the int32 payload packing; use a "
                "smaller batch geometry"
            )
        if self.need % 32:
            raise ValueError(
                f"batch_rows * chunk_len = {self.need} must be a "
                "multiple of 32 (hit-bitmap word packing)"
            )
        self.device = (resolve_device(device) if isinstance(device, str)
                       else torch.device(device))
        # sorted codes < 4^k: int64 holds every k <= 31, int32 k <= 15
        self.members = torch.from_numpy(
            np.asarray(spec.codes, np.uint64).astype(np.int64)
        ).to(window_ops.code_dtype(k)).to(self.device)
        self._cuda = self.device.type == "cuda"
        self._stager = (_PinnedStager(_PREFETCH + 1, self.device)
                        if self._cuda else None)

    @property
    def member_bytes(self) -> int:
        """Bytes of the member table on the device."""
        return self.members.numel() * self.members.element_size()

    # ------------------------------------------------------------------
    def _dispatch_bitmaps(self, work: np.ndarray):
        """work: (k-1 halo ++ owned stream ++ INVALID pad) uint8 codes,
        length k-1 + n_batches*need.  Dispatches every device batch and
        starts the copy of its bitmap to the host; returns what finish()
        waits on, WITHOUT waiting for the device: on CUDA (pinned int32
        words, the event after their copy), on the CPU the words."""
        k, B, L, R, R8 = self.k, self.B, self.L, self.R, self.R8
        halo = k - 1
        n_batches = (work.size - halo) // self.need
        per = self.need // 32

        def host_batches():
            for i in range(n_batches):
                chunk = work[i * self.need : i * self.need + halo
                             + self.need]
                if native.available():
                    yield native.pack_rows(chunk, B, L, R)
                else:
                    yield _numpy_pack_rows(chunk, B, L, R, R8)

        # a pinned buffer of this flush's own: with depth-2 pipelining an
        # earlier flush's bitmap is still unread when this one lands
        words = torch.empty(n_batches * per, dtype=torch.int32,
                            pin_memory=self._cuda)
        # producer-thread prefetch: batch i+1's pack + H2D overlap batch
        # i's device step (the counting pipeline's double-buffering)
        for i, (dp, dv) in enumerate(prefetch_to_device(
                host_batches(), _PREFETCH, self.device,
                stager=self._stager)):
            bm = _filter_step(self.members, dp, dv, k, self.canonical, R, L)
            words[i * per : (i + 1) * per].copy_(bm, non_blocking=True)
        if not self._cuda:
            return words, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return words, event

    def begin(self, seqs):
        """Dispatch one read batch's device work without waiting for it.

        Returns an opaque pending object for finish().  filter_file
        keeps a small deque of these so that batch i's D2H and host
        attribution overlap batch i+1's read, pack and device step.
        Host legs run in C when built (fk_filter_prepare /
        fk_filter_bitmap_hits)."""
        k = self.k
        if len(seqs) == 0:
            return (seqs, None, None)
        joined = b"N".join(seqs)
        buf = np.frombuffer(joined, np.uint8)
        n = buf.size
        nw = n - k + 1
        if nw <= 0:
            return (seqs, None, None)
        halo = k - 1
        n_batches = -(-n // self.need)
        work = np.full(halo + n_batches * self.need, 4, np.uint8)
        if native.available():
            # one OpenMP LUT pass straight into the work buffer; the
            # bitmap attribution recomputes validity per read in C
            native.filter_prepare(buf, work[halo : halo + n])
            lens = np.fromiter((len(s) for s in seqs), np.int64,
                               len(seqs))
            starts = np.zeros(len(seqs), np.int64)
            np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1: separator
            payload = ("native", buf, starts, lens)
        else:
            b = _CODE_LUT[buf]
            cbad = _cumsum01(b > 3)
            # zero bad bases in [i, i+k) <=> the monotone prefix is
            # flat (equality avoids a subtract buffer)
            valid = cbad[k:] == cbad[:-k]
            # codes 0..3 pass; invalid (255) clamps to 4 = INVALID
            np.minimum(b, 4, out=work[halo : halo + n])
            payload = ("numpy", valid, nw)
        return (seqs, payload, self._dispatch_bitmaps(work))

    def begin_offsets(self, segs, nbases: int, nreads: int):
        """Offsets-flow begin (filter._filter_fastq_offsets): segments
        of (block data, seq_starts, joined_starts, lens, ...) are
        gather-encoded by the C leg straight into the (4-prefilled)
        work buffer: separators and padding are already in place, no
        joined bytes object ever exists on the host."""
        k = self.k
        n = nbases + nreads - 1 if nreads else 0  # joined length
        if nreads == 0 or n - k + 1 <= 0:
            return (int(nreads), None, None)
        halo = k - 1
        n_batches = -(-n // self.need)
        work = np.full(halo + n_batches * self.need, 4, np.uint8)
        view = work[halo : halo + n]
        for data, ss, js, lens, *_ in segs:
            native.filter_gather_prepare(data, ss, js, lens, view)
        payload = ("offsets", [
            (data, ss, js, lens) for data, ss, js, lens, *_ in segs
        ])
        return (int(nreads), payload, self._dispatch_bitmaps(work))

    def finish(self, pending) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a begin()'s bitmap; per-read (hits, windows)."""
        if pending[1] is None:
            n = pending[0] if isinstance(pending[0], int) else len(
                pending[0]
            )
            return np.zeros(n, np.int64), np.zeros(n, np.int64)
        seqs, payload, (words, event) = pending
        if event is not None:
            event.synchronize()  # this flush's copy, not the whole device
        words = words.numpy().view(np.uint32)
        k = self.k
        halo = k - 1
        # window starting at joined position p sits at bitmap index
        # p + halo (row 0's first halo slots cover p < 0)
        if payload[0] == "offsets":
            hs, ws = [], []
            for data, ss, js, lens in payload[1]:
                h, w = native.filter_bitmap_hits2(
                    data, ss, js, lens, k, words, halo
                )
                hs.append(h)
                ws.append(w)
            return np.concatenate(hs), np.concatenate(ws)
        if payload[0] == "native":
            _, buf, starts, lens = payload
            return native.filter_bitmap_hits(buf, starts, lens, k, words,
                                             halo)
        _, valid, nw = payload
        # view, not astype: unpackbits yields 0/1 uint8, bool is the
        # same itemsize
        allbits = np.unpackbits(
            words.view(np.uint8), bitorder="little"
        ).view(np.bool_)
        hit = allbits[halo : halo + nw]
        return _read_spans(seqs, hit & valid, valid, k)

    def hits_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        return self.finish(self.begin(seqs))

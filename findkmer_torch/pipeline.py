"""Streaming batch pipeline of the port: FASTA -> encoded rows -> device.

Counterpart of `findkmer_tpu/pipeline.py`.  The host batchers are the
JAX package's, carried over unchanged in behaviour; the readers, the
encoder and the loader of the C library they call are the port's own
copies under `findkmer_torch/io/`:

  1. io.fasta streams record chunks; io.encode maps them to uint8 codes.
  2. Records are joined into one virtual code stream with a single INVALID
     separator between records: a window spanning a record boundary
     contains the separator and is masked out.
  3. The stream is cut into rows of L owned codes, each prefixed with the
     previous row's last k-1 codes (the halo), so a window ends in exactly
     one row and is counted once across chunk joints.
  4. Rows are packed into (B, L+k-1) batches, 2-bit packed by default.

`prefetch_to_device` is the torch part: a producer thread runs the
batchers while pinned host buffers and a side CUDA stream keep the next
batches' H2D copies in flight during the current step.
`per_record_spectra` counts each record of an input on its own (count
--per-record), through the same batchers and one reused stager.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from findkmer_torch.config import Config
from findkmer_torch.io import native as native_mod
from findkmer_torch.io.encode import INVALID, encode_bytes
from findkmer_torch.io.fasta import (
    FastaReader,
    open_maybe_gzip,
    pushback_stream,
)
from findkmer_torch.io.fastq import FastqReader, sniff_format, sniff_head
from findkmer_torch.io.sam import BamReader, SamReader
from findkmer_torch.utils.malloc_tuning import tune_for_streaming

tune_for_streaming()  # keep big freed buffers on the heap (see _BatchEmitter)


@dataclass
class StreamStats:
    """Running observability counters."""

    records: int = 0
    bases: int = 0           # sequence bytes seen (excl. separators)
    valid_bases: int = 0     # ACGT bases
    batches: int = 0
    rows: int = 0
    h2d_bytes: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def code_stream(
    reader: FastaReader,
    *,
    prefer_native: bool = True,
    stats: Optional[StreamStats] = None,
) -> Iterator[np.ndarray]:
    """Encoded code chunks with one INVALID separator after each record.

    This is the plain (non-fused) encode path; the production fused
    strip+encode-into-work-buffer flow is _batches_fused."""
    sep = np.array([INVALID], dtype=np.uint8)
    for chunk in reader.chunks():
        if chunk.data:
            codes = encode_bytes(chunk.data, prefer_native=prefer_native)
            if stats is not None:
                stats.bases += codes.size
                stats.valid_bases += int(np.count_nonzero(codes < 4))
            yield codes
        if chunk.final:
            if stats is not None:
                stats.records += 1
            yield sep


class _BatchEmitter:
    """The shared work buffer + batch materializer.

    One persistent `work` buffer holds the flat stream window; each batch
    is a single strided copy (or fused C pack) out of it.  The output
    array is freshly allocated per batch (the prefetcher may still be
    copying the previous one into a pinned buffer) and
    utils.malloc_tuning keeps glibc from munmapping freed big buffers, so
    the pages stay warm.
    """

    def __init__(self, cfg: Config, stats: Optional[StreamStats]):
        k, L, B = cfg.k, cfg.chunk_len, cfg.batch_rows
        self.R = L + k - 1
        self.L, self.B = L, B
        self.need = B * L  # owned codes per batch
        self.halo = k - 1
        self.work = np.full(self.halo + self.need, INVALID, dtype=np.uint8)
        self.filled = 0  # owned codes currently in work[halo:]
        self.stats = stats
        self.pack = cfg.packed_h2d
        # tail shrink: an input that ends before the FIRST full batch
        # emits a ladder-rung-sized batch instead of padding to the full
        # (B, L) shape, so a small file does not pay a 67 Mbase-shaped
        # extraction.  Only the first batch, and only single-device.
        self._emitted = 0
        self._shrink_ok = cfg.devices == 1
        if self.pack:
            self._native_pack = native_mod.available()
            self.R8 = (self.R + 7) // 8 * 8

    def emit(self, rows: Optional[int] = None):
        work, L, R = self.work, self.L, self.R
        B = self.B if rows is None else rows
        need, halo, stats = B * L, self.halo, self.stats
        self.filled = 0
        self._emitted += 1
        if stats is not None:
            stats.batches += 1
            stats.rows += B
        if self.pack:
            # 2-bit + validity-bit device format: 0.375 B/base on the wire
            if self._native_pack:
                packed, validbits = native_mod.pack_rows(work, B, L, R)
            else:
                packed, validbits = _numpy_pack_rows(work, B, L, R, self.R8)
            if halo:
                work[:halo] = work[need : need + halo]
            if stats is not None:
                stats.h2d_bytes += packed.nbytes + validbits.nbytes
            return packed, validbits
        # raw byte rows: row i = work[i*L : i*L + R].  Copy the owned
        # region as one contiguous reshape and fix up the k-1 halo
        # columns with a tiny strided copy.
        out = np.empty((B, R), dtype=np.uint8)
        out[:, halo:] = work[halo : halo + need].reshape(B, L)
        if halo:
            out[:, :halo] = np.lib.stride_tricks.as_strided(
                work, shape=(B, halo), strides=(L, 1)
            )
            work[:halo] = work[need : need + halo]  # next batch's halo
        if stats is not None:
            stats.h2d_bytes += out.nbytes
        return out

    def finish(self):
        """Flush the partial tail batch (if any).

        A first-and-only partial batch shrinks to the smallest
        {1,1.5}x2^i ladder rung of rows covering the fill (see
        __init__); later tails keep the full shape."""
        if not self.filled:
            return []
        if self._shrink_ok and self._emitted == 0:
            from findkmer_torch.ops import sparse as sparse_ops

            rows = min(
                self.B,
                sparse_ops.ladder(-(-self.filled // self.L), floor=1),
            )
            self.work[self.halo + self.filled : self.halo + rows * self.L] = (
                INVALID
            )
            return [self.emit(rows)]
        self.work[self.halo + self.filled :] = INVALID
        return [self.emit()]


def batches_from_codes(
    codes: Iterator[np.ndarray],
    cfg: Config,
    *,
    stats: Optional[StreamStats] = None,
) -> Iterator[np.ndarray]:
    """Cut a virtual code stream into (B, L+k-1) uint8 row batches.

    Row i of a batch covers L owned stream positions plus the k-1 halo
    codes that precede them (INVALID-filled at stream start).  The final
    batch is INVALID-padded to full shape.
    """
    em = _BatchEmitter(cfg, stats)
    halo, need = em.halo, em.need
    for arr in codes:
        pos = 0
        n = arr.size
        while n - pos >= need - em.filled:
            take = need - em.filled
            em.work[halo + em.filled : halo + need] = arr[pos : pos + take]
            pos += take
            yield em.emit()
        rem = n - pos
        if rem:
            em.work[halo + em.filled : halo + em.filled + rem] = arr[pos:]
            em.filled += rem
    yield from em.finish()


def _batches_fused(
    reader, cfg: Config, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    """Fused reader->work-buffer batching: the C strip+encode pass writes
    DIRECTLY into the batch work buffer (no intermediate codes array, no
    second copy).  Requires the native encoder; reader chunks must carry
    raw bytes (FastaReader strip_ws=False, or FASTQ lines).

    Output is identical to batches_from_codes(code_stream(...)).
    """
    em = _BatchEmitter(cfg, stats)
    halo, need = em.halo, em.need
    for chunk in reader.chunks():
        data = chunk.data
        if data:
            buf = np.frombuffer(data, dtype=np.uint8)
            pos = 0
            n = buf.size
            while pos < n:
                space = need - em.filled
                take = min(n - pos, space)
                m = native_mod.encode_compact_into(
                    buf[pos : pos + take], em.work, halo + em.filled
                )
                if stats is not None:
                    stats.bases += m
                    stats.valid_bases += native_mod.count_acgt(
                        em.work, halo + em.filled, m
                    )
                em.filled += m
                pos += take
                if em.filled >= need:
                    yield em.emit()
        if chunk.final:
            if stats is not None:
                stats.records += 1
            # one INVALID separator isolates records (windows spanning
            # it are masked out); filled < need holds here because the
            # data loop emits whenever the buffer fills
            em.work[halo + em.filled] = INVALID
            em.filled += 1
            if em.filled >= need:
                yield em.emit()
    yield from em.finish()


def _numpy_pack_rows(work, B, L, R, R8):
    """Vectorized fallback for native.pack_rows (same output layout)."""
    rows = np.full((B, R8), INVALID, dtype=np.uint8)
    halo = R - L
    rows[:, halo:R] = work[halo : halo + B * L].reshape(B, L)
    if halo:
        rows[:, :halo] = np.lib.stride_tricks.as_strided(
            work, shape=(B, halo), strides=(L, 1)
        )
    valid = rows < 4
    safe = np.where(valid, rows, 0).astype(np.uint8)
    # MSB-first bit order (big-endian 2-bit stream; see encode.c)
    packed = (
        (safe[:, 0::4] << 6)
        | (safe[:, 1::4] << 4)
        | (safe[:, 2::4] << 2)
        | safe[:, 3::4]
    ).astype(np.uint8)
    validbits = np.packbits(valid, axis=1, bitorder="big")
    return packed, validbits


def _fastq_blocks(path, block_bytes: int = 1 << 22):
    """Offsets-based zero-copy FASTQ block reader (C record scanner,
    src/native/encode.c fk_fastq_scan): yields (data uint8 array,
    seq_start, seq_end, rec_start, rec_end) per ~4 MB block: no per-read
    byte slices, no per-line Python.  Same record contract as FastqReader
    (strict 4-line, blank lines at header positions, CRLF-stripped
    sequence spans, errors on wrapped FASTQ).  The port's copy of
    `findkmer_tpu.filter._fastq_blocks`."""
    f, own = open_maybe_gzip(path)
    try:
        tail = b""
        eof = False
        while True:
            chunks = [tail] if tail else []
            size = len(tail)
            while size < block_bytes and not eof:
                b = f.read(block_bytes)
                if not b:
                    eof = True
                    break
                chunks.append(b)
                size += len(b)
            if eof and size and not (chunks[-1].endswith(b"\n")):
                chunks.append(b"\n")  # unterminated final line
            data = b"".join(chunks)
            if not data:
                return
            buf = np.frombuffer(data, np.uint8)
            seq_s, seq_e, rec_s, rec_e, consumed, err = (
                native_mod.fastq_scan(buf)
            )
            if seq_s.size:
                yield buf, seq_s, seq_e, rec_s, rec_e
            if err:
                raise ValueError(
                    f"{path}: multi-line FASTQ is not supported "
                    "(expected @header/seq/+/quality groups)"
                )
            if eof:
                # strip ONLY newline characters: a space-only trailing
                # line is malformed to the strict line reader
                # (FastqReader), and the flows must agree on
                # accept/reject
                if data[consumed:].strip(b"\r\n"):
                    raise ValueError(f"{path}: truncated FASTQ record")
                return
            if consumed == 0 and len(data) >= block_bytes:
                # a single record larger than the block: widen and retry
                tail = data
                block_bytes *= 2
                continue
            tail = data[consumed:]
    finally:
        if own:
            f.close()


def _fastq_code_stream(
    path, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    """Offsets-based zero-copy FASTQ -> code stream: the C record scanner
    (_fastq_blocks) yields per-block offset arrays and
    fk_filter_gather_prepare LUT-encodes every read straight into one
    INVALID-prefilled code buffer, separators already in place."""
    for data, seq_s, seq_e, rec_s, rec_e in _fastq_blocks(path):
        lens = seq_e - seq_s
        n = int(seq_s.size)
        js = np.empty(n, np.int64)
        js[0] = 0
        np.cumsum(lens[:-1] + 1, out=js[1:])
        total = int(lens.sum()) + n  # one separator after EACH record
        buf = np.full(total, INVALID, np.uint8)
        native_mod.filter_gather_prepare(data, seq_s, js, lens, buf)
        if stats is not None:
            stats.records += n
            stats.bases += total - n
            stats.valid_bases += native_mod.count_acgt(buf, 0, total)
        yield buf


def _fastq_fast_ok(path, cfg: Config) -> bool:
    """Gate for the offsets-based FASTQ counting path: real file path,
    FASTQ format, no quality masking, native library built."""
    if path == "-" or cfg.min_qual > 0 or not cfg.use_native_encode:
        return False
    if os.environ.get("FINDKMER_FASTQ_FAST", "1") != "1":
        return False
    if not native_mod.available():
        return False
    if cfg.input_format == "fastq":
        return True
    if cfg.input_format != "auto":
        return False
    try:
        return sniff_format(path) == "fastq"
    except Exception:
        return False


def batches_from_file(
    path, cfg: Config, *, stats: Optional[StreamStats] = None
) -> Iterator[np.ndarray]:
    if _fastq_fast_ok(path, cfg):
        yield from batches_from_codes(
            _fastq_code_stream(path, stats=stats), cfg, stats=stats
        )
        return
    reader, fused = _open_reader(path, cfg)
    try:
        yield from _batches_from_reader(reader, fused, cfg, stats=stats)
    finally:
        reader.close()


def _open_reader(path, cfg: Config):
    """(reader, fused) for one input path."""
    fmt = cfg.input_format
    fused = cfg.use_native_encode and native_mod.available()
    if path == "-":
        # stdin: one non-seekable stream.  read() (NOT peek: a single
        # peek may return one byte from a dribbling producer) consumes
        # a head block for gzip magic + format sniffing; the head is
        # replayed through a pushback stream.
        import sys

        raw = sys.stdin.buffer
        head = raw.read(4096)
        if head[:2] == b"\x1f\x8b":
            import gzip

            f = gzip.GzipFile(fileobj=pushback_stream(head, raw))
            if fmt == "auto":
                head2 = f.read(4096)  # decompressed head for the sniff
                f = pushback_stream(head2, f)
                fmt = sniff_head(head2)
        else:
            f = pushback_stream(head, raw)
            if fmt == "auto":
                fmt = sniff_head(head)
        if fmt == "fastq":
            return FastqReader(f, min_qual=cfg.min_qual,
                               qual_offset=cfg.qual_offset), fused
        if fmt == "sam":
            return SamReader(f, min_qual=cfg.min_qual,
                             qual_offset=cfg.qual_offset), fused
        if fmt == "bam":
            return BamReader(f, min_qual=cfg.min_qual,
                             qual_offset=cfg.qual_offset), fused
        _check_no_qual(cfg, path)
        return FastaReader(f, strip_ws=not fused), fused
    if fmt == "auto":
        fmt = sniff_format(path)
    if fmt == "fastq":
        return FastqReader(path, min_qual=cfg.min_qual,
                           qual_offset=cfg.qual_offset), fused
    if fmt == "sam":
        return SamReader(path, min_qual=cfg.min_qual,
                         qual_offset=cfg.qual_offset), fused
    if fmt == "bam":
        return BamReader(path, min_qual=cfg.min_qual,
                         qual_offset=cfg.qual_offset), fused
    _check_no_qual(cfg, path)
    return FastaReader(path, strip_ws=not fused), fused


def _check_no_qual(cfg: Config, path) -> None:
    if cfg.min_qual:
        raise ValueError(
            f"--min-qual set but {path!r} sniffed as FASTA, which has "
            "no quality scores"
        )


def _batches_from_reader(reader, fused: bool, cfg: Config, *, stats=None):
    if fused:
        return _batches_fused(reader, cfg, stats=stats)
    # the non-fused branch runs only when the native lib is absent or
    # use_native_encode is off, so prefer_native could never pick the
    # C encoder here anyway
    return batches_from_codes(
        code_stream(reader, prefer_native=False, stats=stats),
        cfg,
        stats=stats,
    )


class _PinnedStager:
    """H2D staging for a CUDA device: a ring of reused pinned host slots
    and one side stream for the copies.

    A slot's pinned buffers are refilled only after the copy that last
    read them has finished (its event), so a reused buffer never races
    an in-flight DMA.  Each copy's event is also what the compute stream
    waits on before it uses the batch.  A slot holds flat byte buffers
    that only grow: a batch of another shape (the short tail batch, or
    the records of --per-record, one small batch each) is staged in a
    view of them, so pinned memory is allocated a few times per run, not
    once per shape change."""

    def __init__(self, slots: int, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        # per slot: (flat pinned uint8 buffers, event of their last copy)
        self.slots = [([], torch.cuda.Event()) for _ in range(slots)]
        self.next = 0

    def put(self, batch):
        """Start the H2D copy of one host batch; -> (tensors, event)."""
        arrs = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
        i = self.next
        self.next = (i + 1) % len(self.slots)
        bufs, event = self.slots[i]
        event.synchronize()  # its last copy has read the buffers
        views = []
        for j, a in enumerate(arrs):
            src = torch.from_numpy(a)
            if j == len(bufs):
                bufs.append(None)
            if bufs[j] is None or bufs[j].numel() < a.nbytes:
                bufs[j] = torch.empty(a.nbytes, dtype=torch.uint8,
                                      pin_memory=True)
            view = bufs[j][: a.nbytes].view(src.dtype).view(src.shape)
            view.copy_(src)
            views.append(view)
        with torch.cuda.stream(self.stream):
            devs = tuple(
                v.to(self.device, non_blocking=True) for v in views
            )
            event.record(self.stream)
        return devs if len(devs) > 1 else devs[0], event

    def take(self, staged):
        """Hand a staged batch to the current (compute) stream."""
        out, event = staged
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        # the tensors were allocated on the side stream; record their use
        # on the compute stream so the caching allocator does not hand
        # their memory out again before the step that reads them is done
        for t in out if isinstance(out, tuple) else (out,):
            t.record_stream(compute)
        return out


def _host_tensors(batch):
    """CPU device: the host batch as tensors sharing its memory."""
    if isinstance(batch, (tuple, list)):
        return tuple(torch.from_numpy(a) for a in batch)
    return torch.from_numpy(batch)


def prefetch_to_device(
    batches: Iterator[np.ndarray], depth: int, device: torch.device,
    *, threaded: bool = True, stager: Optional[_PinnedStager] = None,
) -> Iterator:
    """Keep `depth` batches' H2D transfers in flight ahead of consumption.

    A producer thread runs the host batching (FASTA parse, encode, pack;
    the numpy/C hot loops release the GIL), so end-to-end throughput
    approaches max(host, transfer, compute) instead of their sum.  On a
    CUDA device each batch is copied into one of depth + 1 reused pinned
    buffers and sent with a non_blocking copy on a side stream; the
    compute stream waits on that copy's event.  On the CPU the host
    arrays are wrapped as tensors without a copy.

    threaded=False batches in the caller's thread (the copies stay
    asynchronous): a thread per call would cost more than it overlaps for
    a short input, such as one record of --per-record.  `stager` reuses
    one `_PinnedStager` (its pinned buffers and side stream) across calls.
    """
    depth = max(1, depth)
    device = torch.device(device)
    if device.type == "cuda":
        stager = stager or _PinnedStager(depth + 1, device)
        put, take = stager.put, stager.take
    else:
        put, take = _host_tensors, (lambda staged: staged)
    if threaded:
        return _prefetch_threaded(batches, depth, put, take)
    return _prefetch_inline(batches, depth, put, take)


def _prefetch_inline(batches, depth: int, put, take) -> Iterator:
    from collections import deque

    dq: deque = deque()
    it = iter(batches)
    try:
        while True:
            while len(dq) < depth:
                b = next(it, None)
                if b is None:
                    break
                dq.append(put(b))
            if not dq:
                return
            yield take(dq.popleft())
    finally:
        if hasattr(batches, "close"):
            batches.close()


def _prefetch_threaded(batches, depth: int, put, take) -> Iterator:
    import queue
    import threading
    from collections import deque

    _END = object()
    host_q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # stop-aware put: a consumer that exits early (step raised)
        # sets `stop`, and the producer must never block forever on a
        # full queue; that would leak the thread, the open reader, and
        # the batch generator for the process lifetime
        while not stop.is_set():
            try:
                host_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not _put(b):
                    return
            _put(_END)
        except BaseException as e:  # surface errors in the consumer
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    dq: deque = deque()
    done = False
    try:
        while True:
            while not done and len(dq) < depth:
                item = host_q.get()
                if item is _END:
                    done = True
                elif isinstance(item, BaseException):
                    raise item
                else:
                    dq.append(put(item))
            if not dq:
                break
            yield take(dq.popleft())
    finally:
        stop.set()
        # drain until the producer has actually exited (one transient
        # empty read is NOT proof it finished: it may be mid-encode)
        while t.is_alive():
            try:
                host_q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join()
        if hasattr(batches, "close"):
            batches.close()  # deterministic reader/file cleanup


def run_count(
    paths,
    cfg: Config,
    device: torch.device,
    *,
    stats: Optional[StreamStats] = None,
    timers=None,
    row_sort: str = "auto",
    dense_kernel: str = "fused",
):
    """Count every batch of one file, or of a list of files counted as
    one input (records concatenated), on `device` -> (counter, state),
    not yet finalized.  row_sort and dense_kernel pick the counter's
    kernels (`models/counter.py`).

    Pass a utils.prof.PhaseTimers to get a host/dispatch breakdown
    (device work is async: "host_batches" is the wait for the next
    staged batch, "dispatch" is step submission; a sparse step also
    runs its compactions)."""
    from findkmer_torch.models.counter import make_counter

    paths = [paths] if isinstance(paths, (str, os.PathLike)) else list(paths)
    host_encoder(cfg.use_native_encode)  # build the C encoder first
    counter = make_counter(cfg, device, row_sort=row_sort,
                           dense_kernel=dense_kernel)
    state = counter.init_state()

    def host_batches():
        for p in paths:
            yield from batches_from_file(p, cfg, stats=stats)

    it = prefetch_to_device(host_batches(), cfg.prefetch, counter.device)
    try:
        while True:
            if timers is None:
                rows = next(it, None)
            else:
                with timers.phase("host_batches"):
                    rows = next(it, None)
            if rows is None:
                break
            if timers is None:
                state = counter.step(state, rows)
            else:
                with timers.phase("dispatch"):
                    state = counter.step(state, rows)
    finally:
        it.close()  # stops the producer thread if a step raised
    return counter, state


def count_file(
    path,
    cfg: Config,
    device: torch.device,
    *,
    stats: Optional[StreamStats] = None,
    timers=None,
    row_sort: str = "auto",
    dense_kernel: str = "fused",
):
    """Single-host end-to-end count of one file, or of a list of files
    counted as one input, on `device`.

    Returns the finalized spectrum: dense np counts, or sparse (codes
    uint64, counts int64); formatting lives in findkmer_torch/output.py.
    "finalize" in `timers` includes the final device drain."""
    counter, state = run_count(path, cfg, device, stats=stats,
                               timers=timers, row_sort=row_sort,
                               dense_kernel=dense_kernel)
    if timers is None:
        return counter.finalize(state)
    with timers.phase("finalize"):
        return counter.finalize(state, timers=timers)


class _ChunkIterReader:
    """Reader adapter over an in-hand chunk iterator (per-record slicing)."""

    def __init__(self, chunks_iter):
        self._it = chunks_iter

    def chunks(self):
        return self._it


def per_record_spectra(
    path,
    cfg: Config,
    device: torch.device,
    *,
    stats: Optional[StreamStats] = None,
    row_sort: str = "auto",
    dense_kernel: str = "fused",
):
    """Yield (header, finalized spectrum) per record of one input (one
    per FASTA record, one per FASTQ read), counted on `device`.

    One counter serves every record, each with a fresh `init_state()`.
    A record is batched in this thread (no producer thread per record)
    and staged through one pinned stager for the whole input, so
    thousands of short records mean neither thousands of threads nor of
    pinned allocations.  The sparse raw buffer is sized for one row of
    windows, not from the input's size (the CLI's hint for one combined
    spectrum); a longer record grows it.  Memory is bounded by one
    record's in-flight batches (and its spectrum, for sparse tables)."""
    from findkmer_torch.models.counter import make_counter

    cfg = cfg.replace(sparse_expected_entries=cfg.window_len)
    counter = make_counter(cfg, device, row_sort=row_sort,
                           dense_kernel=dense_kernel)
    stager = (_PinnedStager(cfg.prefetch + 1, counter.device)
              if counter.device.type == "cuda" else None)
    reader, fused = _open_reader(path, cfg)
    try:
        it = reader.chunks()

        def one_record(first):
            yield first
            if first.final:
                return
            for ch in it:
                yield ch
                if ch.final:
                    return

        while True:
            first = next(it, None)
            if first is None:
                return
            rec = one_record(first)
            batches = _batches_from_reader(
                _ChunkIterReader(rec), fused, cfg, stats=stats
            )
            state = counter.init_state()
            for rows in prefetch_to_device(batches, cfg.prefetch,
                                           counter.device, threaded=False,
                                           stager=stager):
                state = counter.step(state, rows)
            # drain rec in case the record was pure whitespace (no
            # batches consumed it past the final marker)
            for _ in rec:
                pass
            yield first.header, counter.finalize(state)
    finally:
        reader.close()


def host_encoder(use_native: bool = True) -> str:
    """Which host encoder the batchers run: "native" (the C library of
    findkmer_torch.io.native, which builds it at first use with $CC and
    then cc unless FINDKMER_AUTOBUILD=0) or "numpy", its fallback.
    Outputs are the same; rates differ about tenfold."""
    if use_native and native_mod.available():
        return "native"
    return "numpy"

"""Streaming FASTQ reader (4-line records) + format sniffing.

The port's copy of `findkmer_tpu/io/fastq.py`.  Each read is one record
(windows never span reads), quality lines are skipped unless --min-qual
masks by them, and non-ACGT bases in the sequence line mask windows as
usual.

Strict 4-line FASTQ only (@header / sequence / + / quality); the
multi-line variant is rejected with a clear error.  Quality lines may
contain '@' and '+' freely; the parser is positional, never
content-sniffing.

The hot path is block-buffered: newline positions come from one numpy
scan per multi-MB block and sequence lines are sliced out by line index
(mod 4), so per-read Python work is one RecordChunk object.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from findkmer_torch.io.fasta import RecordChunk, open_maybe_gzip


def mask_low_quality(
    seq: bytes, qual: bytes, min_qual: int, offset: int = 33
) -> bytes:
    """Replace bases with phred score < min_qual by 'N' (Jellyfish
    --min-qual-char class).  offset=33 for FASTQ/SAM text qualities,
    0 for BAM's raw phred bytes.  Masked bases behave exactly like N:
    every window containing one is dropped."""
    if len(qual) != len(seq):
        raise ValueError(
            f"quality length {len(qual)} != sequence length {len(seq)}"
        )
    q = np.frombuffer(qual, np.uint8)
    low = q < (offset + min_qual)
    if not low.any():
        return seq
    s = np.frombuffer(seq, np.uint8).copy()
    s[low] = 0x4E  # 'N'
    return s.tobytes()


class FastqReader:
    """Block-buffered streaming FASTQ reader, RecordChunk-compatible.

    Yields one final RecordChunk per read so downstream record isolation
    (pipeline.code_stream's INVALID separator) works unchanged.
    """

    def __init__(self, path_or_file, block_size: int = 1 << 22,
                 min_qual: int = 0, qual_offset: int = 33):
        self._f, self._own = open_maybe_gzip(path_or_file)
        self.block_size = int(block_size)
        # min_qual > 0 defers each yield to the quality line (phase 3)
        # and masks low-quality bases to 'N' before emitting the read
        self.min_qual = int(min_qual)
        self.qual_offset = int(qual_offset)

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def chunks(self) -> Iterator[RecordChunk]:
        leftover = b""
        line_idx = 0          # global line counter (record line = idx % 4)
        record_id = -1
        header = ""
        pending = None        # seq held back for quality masking
        while True:
            block = self._f.read(self.block_size)
            buf = leftover + block
            if not buf:
                break
            if not block:  # EOF: terminate a final unterminated line
                buf += b"\n"
                leftover = b""
            else:
                # hold back the trailing partial line
                cut = buf.rfind(b"\n") + 1
                leftover = buf[cut:]
                buf = buf[:cut]
            if not buf:
                if not block:
                    break
                continue
            arr = np.frombuffer(buf, dtype=np.uint8)
            ends = np.flatnonzero(arr == 0x0A)
            start = 0
            for e in ends:
                end = int(e)
                if end > start and buf[end - 1] == 0x0D:  # CRLF
                    end -= 1
                line = buf[start:end]
                phase = line_idx % 4
                if phase == 0:
                    if not line:
                        # tolerate blank lines between records only
                        start = e + 1
                        continue
                    if line[:1] != b"@":
                        raise ValueError(
                            f"FASTQ parse error at line {line_idx + 1}: "
                            f"expected '@header', got {line[:30]!r} "
                            "(only strict 4-line FASTQ is supported)"
                        )
                    header = line[1:].decode("ascii", "replace").strip()
                elif phase == 1:
                    if self.min_qual > 0:
                        pending = line  # yield at the quality line
                    else:
                        record_id += 1
                        yield RecordChunk(
                            record_id, header, line, final=True
                        )
                elif phase == 2:
                    if line[:1] != b"+":
                        raise ValueError(
                            f"FASTQ parse error at line {line_idx + 1}: "
                            f"expected '+', got {line[:30]!r} "
                            "(multi-line FASTQ is not supported)"
                        )
                elif pending is not None:
                    # phase 3 with min_qual: mask low-quality bases to
                    # 'N' and emit; otherwise quality is skipped entirely
                    try:
                        data = mask_low_quality(
                            pending, line, self.min_qual, self.qual_offset
                        )
                    except ValueError as e_:
                        raise ValueError(
                            f"FASTQ parse error at line {line_idx + 1}: "
                            f"{e_}"
                        ) from None
                    record_id += 1
                    yield RecordChunk(record_id, header, data, final=True)
                    pending = None
                line_idx += 1
                start = e + 1
            if not block:
                break
        if line_idx % 4 == 1:
            # ended right after a header with no sequence line
            raise ValueError("truncated FASTQ: header without sequence")
        if line_idx % 4 in (2, 3):
            # record ends after its sequence but before the quality
            # line.  Strict: a truncated file must ERROR, not silently
            # count/keep a tail read — and the offsets-based fast flows
            # (pipeline._fastq_blocks) raises here too, so leniency
            # would make the FINDKMER_FASTQ_FAST=1/0 paths diverge.
            raise ValueError(
                "truncated FASTQ: record ends before its quality line"
            )

    # ------------------------------------------------------------------
    def records(self):
        for ch in self.chunks():
            yield ch.header, ch.data


# SAM header-line tags (SAM spec §1.3); a '@'-line starting with one of
# these followed by a tab is a SAM header, not a FASTQ read name.
_SAM_HEADER_TAGS = (b"@HD", b"@SQ", b"@RG", b"@PG", b"@CO")


def sniff_head(head: bytes) -> str:
    """'fasta' | 'fastq' | 'sam' | 'bam' from a peeked (decompressed)
    prefix — no bytes consumed.

    BAM is its magic; '@' is FASTQ unless the first line is a SAM
    header tag; a headerless SAM is recognized by >= 11 tab fields with
    numeric FLAG/POS/MAPQ.  Anything else is FASTA (the historical
    default — an empty/garbage stream yields nothing either way)."""
    if head[:4] == b"BAM\x01":
        return "bam"
    i = 0
    while i < len(head) and head[i : i + 1].isspace():
        i += 1
    b = head[i : i + 1]
    if not b or b == b">":
        return "fasta"
    line = head[i:].split(b"\n", 1)[0]
    if b == b"@":
        if line[:3] in _SAM_HEADER_TAGS and line[3:4] in (b"\t", b"\r", b""):
            return "sam"
        return "fastq"
    fields = line.split(b"\t")
    if (
        len(fields) >= 11
        and fields[1].isdigit()
        and fields[3].isdigit()
        and fields[4].isdigit()
    ):
        return "sam"
    return "fasta"


def sniff_format(path) -> str:
    """Sniff a file's format from its (decompressed) head block."""
    f, own = open_maybe_gzip(path)
    try:
        return sniff_head(f.read(8192))
    finally:
        if own:
            f.close()

"""Streaming SAM/BAM readers (RecordChunk-compatible).

The port's copy of `findkmer_tpu/io/sam.py`.  Both readers yield one final
`RecordChunk` per alignment record, so the whole counting pipeline (record
isolation, N-masking, fused C encode) works unchanged downstream.

Counting semantics:

- Each record's SEQ is one logical read; windows never span records.
- Secondary (flag 0x100) and supplementary (flag 0x800) alignments are
  skipped so every read is counted exactly once: the same subset
  `samtools fasta` emits by default.
- Records with no stored sequence (SEQ '*', BAM l_seq=0) are skipped.
- Reverse-strand records (flag 0x10) are reverse-complemented back to
  the original read orientation (`samtools fasta` semantics), so the
  spectrum equals counting the raw reads regardless of how the aligner
  oriented them.  Under --canonical this is a no-op by definition.
- Unmapped reads (flag 0x4) are kept: they carry sequence.

SAM parsing is line-oriented over multi-MB blocks; BAM parsing is
record-framed binary over the gunzipped stream (BGZF is concatenated
gzip members, which `gzip.GzipFile` consumes natively).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from findkmer_torch.io.fasta import RecordChunk, open_maybe_gzip

FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800
_SKIP_MASK = FLAG_SECONDARY | FLAG_SUPPLEMENTARY

# DNA complement over raw ASCII; non-ACGT bases map to themselves (they
# are INVALID to the encoder either way, so orientation cannot unmask
# them).
_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")

# BAM 4-bit nucleotide codes, index 0..15 (SAM spec §4.2.3).
_NIB16 = b"=ACMGRSVTWYHKDBN"
_NIB_LUT = np.frombuffer(_NIB16, dtype=np.uint8)


def _orient(seq: bytes, flag: int) -> bytes:
    if flag & FLAG_REVERSE:
        return seq.translate(_COMP)[::-1]
    return seq


class SamReader:
    """Block-buffered streaming SAM reader.

    Header lines ('@HD', '@SQ', ...) are skipped wherever they appear —
    alignment QNAMEs cannot begin with '@' (SAM spec: QNAME is
    [!-?A-~]+, which excludes 0x40).
    """

    def __init__(self, path_or_file, block_size: int = 1 << 22,
                 min_qual: int = 0, qual_offset: int = 33):
        # min_qual > 0 masks bases with phred < min_qual to 'N' (QUAL
        # column, same orientation as SEQ, so mask before _orient —
        # complement maps N to N); reads with QUAL '*' pass unmasked
        self.min_qual = int(min_qual)
        self.qual_offset = int(qual_offset)
        self._f, self._own = open_maybe_gzip(path_or_file)
        self.block_size = int(block_size)

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def chunks(self) -> Iterator[RecordChunk]:
        leftover = b""
        rid = -1
        while True:
            block = self._f.read(self.block_size)
            buf = leftover + block
            if not buf:
                break
            if not block:  # EOF: terminate a final unterminated line
                buf += b"\n"
                leftover = b""
            else:
                cut = buf.rfind(b"\n") + 1
                leftover = buf[cut:]
                buf = buf[:cut]
            if not buf:
                if not block:
                    break
                continue
            for line in buf.split(b"\n"):
                if line.endswith(b"\r"):
                    line = line[:-1]
                if not line or line[:1] == b"@":
                    continue
                fields = line.split(b"\t")
                if len(fields) < 11:
                    raise ValueError(
                        f"malformed SAM line ({len(fields)} fields): "
                        f"{line[:60]!r}"
                    )
                flag = int(fields[1])
                seq = fields[9]
                if flag & _SKIP_MASK or seq == b"*":
                    continue
                if self.min_qual > 0 and fields[10] != b"*":
                    from findkmer_torch.io.fastq import mask_low_quality

                    seq = mask_low_quality(
                        seq, fields[10], self.min_qual, self.qual_offset
                    )
                rid += 1
                yield RecordChunk(
                    record_id=rid,
                    header=fields[0].decode("ascii", "replace"),
                    data=_orient(seq, flag),
                    final=True,
                )
            if not block:
                break

    def records(self):
        for ch in self.chunks():
            yield ch.header, ch.data


class BamReader:
    """Streaming BAM reader over the gunzipped record stream.

    Reads exactly one framed record at a time (4-byte block_size, then
    the block), so memory is bounded by the largest single record.
    Accepts plain uncompressed BAM too (open_maybe_gzip sniffs magic).
    """

    def __init__(self, path_or_file, min_qual: int = 0,
                 qual_offset: int = 33):
        # BAM stores RAW phred bytes (no +33): qual_offset is accepted
        # for interface symmetry but unused; 0xFF-filled qual = absent
        self.min_qual = int(min_qual)
        self._f, self._own = open_maybe_gzip(path_or_file)
        magic = self._read_exact(4, "BAM magic")
        if magic != b"BAM\x01":
            raise ValueError(
                f"not a BAM stream (magic {magic!r}, expected 'BAM\\x01')"
            )
        (l_text,) = struct.unpack("<i", self._read_exact(4, "header"))
        self._read_exact(l_text, "header text")
        (n_ref,) = struct.unpack("<i", self._read_exact(4, "ref count"))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._read_exact(4, "ref"))
            self._read_exact(l_name + 4, "ref entry")  # name + l_ref

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_exact(self, n: int, what: str) -> bytes:
        parts = []
        got = 0
        while got < n:
            b = self._f.read(n - got)
            if not b:
                raise ValueError(f"truncated BAM: EOF inside {what}")
            parts.append(b)
            got += len(b)
        return b"".join(parts) if len(parts) != 1 else parts[0]

    @staticmethod
    def _unpack_seq(packed: bytes, l_seq: int) -> bytes:
        """4-bit '=ACMGRSVTWYHKDBN' codes -> ASCII bytes (hi nibble
        first).  Ambiguity codes come out as their IUPAC letters, which
        the encoder masks as invalid — same behavior as FASTA input."""
        arr = np.frombuffer(packed, dtype=np.uint8)
        out = np.empty(arr.size * 2, dtype=np.uint8)
        out[0::2] = _NIB_LUT[arr >> 4]
        out[1::2] = _NIB_LUT[arr & 0x0F]
        return out[:l_seq].tobytes()

    def chunks(self) -> Iterator[RecordChunk]:
        rid = -1
        while True:
            head = self._f.read(4)
            if not head:
                break
            if len(head) < 4:
                raise ValueError("truncated BAM: EOF inside record size")
            (block_size,) = struct.unpack("<i", head)
            if block_size < 32:
                raise ValueError(f"corrupt BAM record (size {block_size})")
            rec = self._read_exact(block_size, "record")
            (l_read_name, n_cigar, flag, l_seq) = (
                rec[8],
                struct.unpack_from("<H", rec, 12)[0],
                struct.unpack_from("<H", rec, 14)[0],
                struct.unpack_from("<i", rec, 16)[0],
            )
            if flag & _SKIP_MASK or l_seq == 0:
                continue
            name = rec[32 : 32 + l_read_name - 1].decode("ascii", "replace")
            off = 32 + l_read_name + 4 * n_cigar
            n_packed = (l_seq + 1) // 2
            if off + n_packed > len(rec):
                raise ValueError("corrupt BAM record (seq past block end)")
            seq = self._unpack_seq(rec[off : off + n_packed], l_seq)
            if self.min_qual > 0:
                qual = rec[off + n_packed : off + n_packed + l_seq]
                if len(qual) < l_seq:
                    # same strictness as the seq-past-block-end check:
                    # a short qual slice is a truncated record, not a
                    # reason to silently count the read unmasked
                    raise ValueError(
                        "corrupt BAM record (qual past block end)"
                    )
                # BAM spec: absent quality = ALL bytes 0xFF; a real
                # qual string can start with 0xFF-free values only, so
                # per-spec absence is the all-bytes test, not qual[:1]
                if qual.count(0xFF) != l_seq:
                    from findkmer_torch.io.fastq import mask_low_quality

                    seq = mask_low_quality(seq, qual, self.min_qual,
                                           offset=0)
            rid += 1
            yield RecordChunk(
                record_id=rid,
                header=name,
                data=_orient(seq, flag),
                final=True,
            )

    def records(self):
        for ch in self.chunks():
            yield ch.header, ch.data
